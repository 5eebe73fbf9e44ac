"""The port's dry run (``repro_torch.launch.dryrun``) on a reduced config
on ``small_topo(2, 2, 2)``, on meta tensors.

A train cell's fast / slow link bytes equal the reference's
``repro.bench.step_time.link_inventory`` of the reference's
``make_train_step`` on the same topology, config and batch (read off its
jaxpr, its units unrolled), plus on the fast tier the port's one
difference: it checkpoints each cross-entropy chunk, whose backward re-runs
the chunk's vocab max and two sums over tp, where the reference's scan keeps
them as residuals (hier's node run folds 2 ranks' rows: each record is a
rank's share, ``substrate.collectives.folded``).  They also equal the
port's ``step_time`` bench ``link_inventory`` of the same step run on the
CPU with real tensors.  The counted FLOP grow by the same amount for each
added pattern unit, and double (within 1%: the optimizer's
FLOP do not grow with the batch) from 2 to 4 rows a data-parallel rank;
the flash kernel's counted FLOP equal ``models.attention.attn_flops`` of
its calls (the forward twice a step under the remat, the backward 2.5
times it); the memory record counts each rank's shard.  A decode cell and
a skipped cell each give their record, and the CLI writes the reference's
cell tags.  The reference's ``repro.launch.dryrun`` is not imported: it
forces 512 XLA host devices in the process.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.bench.step_time import link_inventory
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_from_topo, small_topo
from repro_torch.models.attention import attn_flops
from repro_torch.runtime.steps import make_train_step

CFG = get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64, n_heads=4)
TOPO = small_topo(2, 2, 2)
T = 32

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

#: the reference's (fast, slow) link bytes per chip of its train step on
#: small_topo(2, 2, 2) for each mode, printed as one JSON object.  Its
#: jaxpr walk needs ``jax.extend`` imported, which would change how other
#: tests in the same process run the reference, hence a subprocess.
_REFERENCE = """
import json, sys, types
from repro.substrate import ensure_host_device_count
ensure_host_device_count(8)
import jax
import jax.extend
import jax.numpy as jnp
from repro.bench.step_time import link_inventory
from repro.configs import get_config
from repro.launch.mesh import make_mesh_from_topo, small_topo
from repro.runtime.steps import make_train_step

B, T = json.loads(sys.argv[1])
cfg = get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64, n_heads=4)
topo = small_topo(2, 2, 2)
names = topo.axis_names()
vc = types.SimpleNamespace(
    axis_names=names, axis_shapes=tuple(topo.axis_sizes[a] for a in names),
    slow_names=tuple(topo.slow_axes))
out = {}
for mode in ("hier", "naive"):
    b = make_train_step(cfg, topo, make_mesh_from_topo(topo), mode=mode,
                        unroll=cfg.n_units)
    state = jax.eval_shape(lambda: b.init_state(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, T + 1), jnp.int32)}
    out[mode] = link_inventory(b.fn, (state, batch), vc)
print(json.dumps(out))
"""


def _train(cfg=CFG, B=8, mode="hier"):
    return dryrun.trace_cell(cfg, ShapeSpec("train_t", T, B, "train"), TOPO,
                             mode=mode)


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's {mode: (fast, slow)} for 8 x T tokens, as a call:
    the subprocess starts with the module's first test and is read by the
    link-bytes tests, last in the file, so it runs beside the others."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             json.dumps([8, T])],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)

    @functools.cache
    def read():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        return json.loads(out.strip().splitlines()[-1])

    yield read
    proc.kill()
    proc.communicate()


def _xent_recompute_bytes(rows, T, tp, chunk=512):
    """Fast link bytes per chip of the port's cross-entropy recompute: per
    chunk of ``c`` tokens, the vocab max's all-gather of ``(tp, rows, c)``
    f32 and two all-reduces of ``(rows, c)`` f32 over tp (ring model)."""
    total = 0.0
    for t0 in range(0, T, chunk):
        one = rows * min(chunk, T - t0) * 4
        total += tp * one * (tp - 1) / tp + 2 * 2 * one * (tp - 1) / tp
    return total


def test_flops_grow_by_one_unit_each_unit_and_double_with_the_batch():
    flops = [_train(dataclasses.replace(CFG, n_layers=n))["cost"]["flops"]
             for n in (1, 2, 3)]
    assert flops[1] - flops[0] == flops[2] - flops[1] > 0
    f2, f4 = (_train(B=b)["cost"]["flops"] for b in (8, 16))
    assert f4 / f2 == pytest.approx(2.0, rel=1e-2)


def test_flash_flops_equal_attn_flops_and_memory_counts_shards():
    rec = _train()
    kern = rec["cost"]["kernels"]
    # hier: one domain run per node (its 2 x 2 ranks' 4 rows folded), 2
    # nodes; each layer's forward runs twice (the remat), its backward once
    one = attn_flops(8, T, T, CFG.n_heads, CFG.head_dim, causal=True,
                     window=None)
    L = CFG.n_layers
    assert kern["flash_attention"]["calls"] == 2 * L * 2
    assert kern["flash_attention"]["flops"] == 2 * L * one
    assert kern["flash_attention_bwd"]["flops"] == 2.5 * L * one
    assert rec["cost"]["domains"] == 2 and rec["cost"]["ranks"] == 8
    routes = rec["cost"]["flops_by_route"]
    assert sum(routes.values()) == pytest.approx(rec["cost"]["flops"])
    assert routes["tf32"] == kern["flash_attention"]["flops"] \
        + kern["flash_attention_bwd"]["flops"]      # bf16 operands
    mem = rec["memory"]
    assert mem["temp_bytes"] is None and mem["fits_80gb"]
    naive = _train(mode="naive")["memory"]
    # hier keeps params, m and v once per node (store 2): half of naive's
    assert naive["alias_bytes"] > mem["alias_bytes"] > naive["alias_bytes"] / 2
    r = rec["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] > 0
    assert 0 < r["useful_flops_ratio"] < 1


def test_a_decode_cell_and_a_skip_cell_give_their_records(tmp_path):
    rec = dryrun.trace_cell(CFG, ShapeSpec("decode_t", 64, 8, "decode"), TOPO,
                            mode="hier")
    assert rec["cost"]["flops"] > 0 and rec["n_units"] == CFG.n_units
    assert rec["memory"]["argument_bytes"] > rec["memory"]["output_bytes"] > 0
    assert set(rec) == {"memory", "cost", "collectives", "roofline",
                        "n_units"}
    skip = dryrun.run_cell("qwen3-0.6b", "long_500k", False, "hier")
    assert skip["status"] == "skip" and "reason" in skip
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                        "--mesh", "both", "--mode", "both",
                        "--out", str(tmp_path)]) == 0
    tags = sorted(p.name for p in tmp_path.iterdir())
    assert tags == [f"qwen3-0.6b__long_500k__{m}__{mode}.json"
                    for m in ("multi", "single") for mode in ("hier", "naive")]
    assert json.loads((tmp_path / tags[0]).read_text())["status"] == "skip"


def test_the_slstm_loop_traced_once_counts_as_every_step(monkeypatch):
    """``models.domains.scan`` traces one sLSTM step and counts it for the
    T steps: prefill's counts equal the loop run step by step; a train
    step's FLOP within 1/T (the traced step differentiates its carry, which
    step 0's zero carry does not need) and its bytes within 2%."""
    import repro_torch.models.xlstm as xl
    from repro_torch.models import domains

    def every_step(step, carry, xs, *args):
        out = []
        for x in xs:
            carry = step(carry, x, *args)
            out.append(carry)
        return out

    # one mLSTM and one sLSTM layer: the loop beside a chunkwise layer
    cfg = dataclasses.replace(get_config("xlstm-1.3b"),
                              pattern=("mlstm", "slstm")).reduced(
        n_layers=2, d_model=64, n_heads=4)
    for kind, Tk in (("prefill", 16), ("train", 8)):
        shape = ShapeSpec(f"{kind}_t", Tk, 8, kind)
        monkeypatch.setattr(xl, "scan", domains.scan)
        once = dryrun.trace_cell(cfg, shape, TOPO)
        monkeypatch.setattr(xl, "scan", every_step)
        full = dryrun.trace_cell(cfg, shape, TOPO)
        assert once["cost"]["loop_steps"] == Tk
        assert once["collectives"] == full["collectives"]
        if kind == "prefill":
            assert once["cost"] == dict(full["cost"], loop_steps=Tk)
        else:
            f, g = once["cost"]["flops"], full["cost"]["flops"]
            assert g <= f <= g * (1 + 1 / Tk)
            assert once["cost"]["bytes"] == pytest.approx(
                full["cost"]["bytes"], rel=2e-2)


@pytest.mark.parametrize("mode", ["hier", "naive"])
def test_train_link_bytes_equal_the_step_inventory(mode, reference):
    rec = _train(mode=mode)
    coll = rec["collectives"]
    want_fast, want_slow = reference()[mode]
    # 8 rows over the 4 data-parallel ranks, tp 2
    want_fast += _xent_recompute_bytes(8 // 4, T, 2)
    assert (coll["fast_bytes_per_dev"], coll["slow_bytes_per_dev"]) == \
        (want_fast, want_slow)
    vc = make_mesh_from_topo(TOPO, device="cpu")
    bundle = make_train_step(CFG, TOPO, vc, mode=mode)
    state = bundle.init_layout_state(0)
    tokens = torch.randint(0, CFG.vocab, (8, T + 1),
                           generator=torch.Generator().manual_seed(3))
    batch = bundle.layout_batch({"tokens": tokens})
    fast, slow = link_inventory(bundle.step, (state, batch), vc)
    assert (coll["fast_bytes_per_dev"], coll["slow_bytes_per_dev"]) == \
        (fast, slow)
    assert slow > 0 and fast > 0
    assert sum(coll["by_op"].values()) == pytest.approx(fast + slow)
