"""The references against the program's CPU path at small sizes: a whole
run of each cell through the harness, the program on the CPU (the kernels'
plain versions) judged by the plain reference."""

from __future__ import annotations

import pytest
import torch

from portbench.reference import qwen3
from portbench.reference import summa as summa_ref
from portbench.tests.cells import SMALL, TINY_MODEL, run_small


@pytest.mark.parametrize("name", sorted(SMALL))
def test_program_on_the_cpu_agrees_with_the_reference(name):
    result, checks = run_small(name)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert all(c.ok for c in checks), checks


def test_summa_reference_is_the_f32_product():
    g = torch.Generator().manual_seed(0)
    a, b = (torch.randn(48, 48, generator=g) for _ in range(2))
    want = (a.double() @ b.double()).float()
    assert summa_ref.rel_err(summa_ref.product(a, b), want) < 1e-6
    assert summa_ref.rel_err(summa_ref.product(a, b, "tf32"), want) > 1e-5


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.0 - 2 ** -20,
                      2.0 ** -30 * (1 + 2 ** -11 + 2 ** -13)])
    got = summa_ref.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, -3.0,
                            2.0 ** -30 * (1 + 2 ** -10)]


def test_the_parameter_tree_is_the_steps():
    from portbench.drivers.train import port_config
    from repro_torch.core import tree as T
    from repro_torch.models import meta
    cfg = {"model": {**qwen3_model(), **TINY_MODEL},
           "port_config": "qwen3-0.6b"}
    pc = port_config(cfg)
    defs = meta.model_defs(pc, 1, 1, "hier")
    want = T.leaves(meta.abstract_params(defs, pc, meta.param_specs(
        defs, pc, tp_axis=None, fsdp_axis=None)))
    got = qwen3.leaves(qwen3.init_params(cfg["model"], 1, "cpu"))
    assert [tuple(w.shape) for _, w in got] == [tuple(w.shape)
                                                for w in want]


def qwen3_model() -> dict:
    import json
    from portbench import harness
    return json.loads((harness.HERE / "configs" / "qwen3-0.6b.json")
                      .read_text())["model"]


def test_init_is_a_function_of_the_seed():
    m = {**qwen3_model(), **TINY_MODEL}
    a, b = (qwen3.leaves(qwen3.init_params(m, 7, "cpu")) for _ in range(2))
    c = qwen3.leaves(qwen3.init_params(m, 8, "cpu"))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert not torch.equal(a[0][1], c[0][1])
