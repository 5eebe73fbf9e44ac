"""The granite cell cut small on the CPU: a whole run through the harness
is ``correct``; the control and every planted fault are not; each new
reader gives its hand-worked value, and nothing (no raise) where the
program has not what it reads; the work counts at the published widths."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import control, harness, work, work_moe
from portbench.trace import Trace

CELL = "train.granite-moe-3b-a800m.2x4.s2048"
TINY = {"hidden_size": 64, "intermediate_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 250}
PEAK = {"flops_per_s": 495e12, "bytes_per_s": 3.35e12}


def small_cell() -> harness.Cell:
    cell = harness.find_cell(harness.load_manifest(), CELL)
    config = json.loads(json.dumps(cell.config))
    config["model"].update(TINY)
    return harness.Cell(cell.name, cell.chips, config,
                        {**cell.traffic, "seq_len": 32}, cell.end_to_end,
                        cell.per_layer)


def model() -> dict:
    return harness.find_cell(harness.load_manifest(), CELL).config["model"]


def test_the_small_cell_on_the_cpu_is_correct():
    torch.manual_seed(0)
    result, checks = harness.run_cell(small_cell(), seed=3, seconds=0.05,
                                      trace=False, device=torch.device("cpu"),
                                      t_start=time.perf_counter())
    assert result["correct"] and result["failed"] == 0, checks
    assert {c.name for c in checks} == {"loss_gap", "grad1_gap",
                                        "update_gap", "tie_share",
                                        "dropped_share"}
    assert set(result["metrics"]) == {"setup_s", "train_tokens_per_s",
                                      "peak_mem_gib"}


def test_control_and_every_fault_fail_a_limit():
    cell = small_cell()
    got = control.readings(cell, 5, torch.device("cpu"))
    assert set(got) == {"control", "half_batch", "no_exchange",
                        "capacity_1.25", "sqrt_scale"}
    for stand_in, checks in got.items():
        assert {c.name for c in checks} == set(cell.config["limits"])
        assert not all(c.ok for c in checks), (stand_in, checks)
    drops = {c.name: c.value for c in got["capacity_1.25"]}
    assert drops["dropped_share"] > 0


def test_work_at_the_published_widths():
    m = model()
    # q, kv, o 6.29 M + router 61 k + 8 experts x 3 x 1536 x 512 a layer
    layer = 1536 * 1536 * 2 + 2 * 1536 * 512 + 1536 * 40 + 8 * 3 * 1536 * 512
    assert work_moe.active_matrix_params(m) == 8 * layer + 1536 * 49155
    flops = work_moe.moe_step_flops(m, 8, 2048)
    assert flops == pytest.approx(29.7e12, rel=0.01)
    experts = 6.0 * 8 * 8 * 3 * 1536 * 512 * 8 * 2048
    assert experts == pytest.approx(14.8e12, rel=0.01)
    one, nbytes = work_moe.experts_pass_work(m, 8, 2048)
    assert 3 * one * 8 == pytest.approx(experts)
    assert nbytes == 4 * (40 * 3 * 1536 * 512 + 131072 * (1536 + 1024)
                          + 131072 * (512 + 1536))


def _readings(counters, device=(), seconds=2.0, units=2, trace=True):
    cell = harness.find_cell(harness.load_manifest(), CELL)
    return harness.Readings(cell.config, cell.traffic,
                            harness.Window(units, seconds), counters, {},
                            Trace(list(device), []) if trace else None)


def test_new_readers_at_a_made_up_window(monkeypatch):
    m = model()
    one = work.bound_s(*work_moe.experts_pass_work(m, 8, 2048), PEAK)
    # 2 steps; 4 passes a layer (forward, its recompute, dX, dW), the
    # grouped kernel at a quarter of its bound's speed
    t = 2 * 8 * 4 * one * 4
    dev = [("void (anonymous namespace)::grouped_matmul<float, 0>", 0.0,
            t * 1e6 / 2),
           ("void (anonymous namespace)::grouped_matmul<float, 2>",
            t * 1e6 / 2, t * 1e6),
           ("void (anonymous namespace)::panel_matmul<float, 0>", t * 1e6,
            t * 1e6 + 5e3)]
    counters = {"steps": 2, "grouped_nn_launches": 128,
                "grouped_nt_launches": 64, "grouped_tn_launches": 64,
                "moe_forwards": 64, "moe_load_max_ratio_sum": 64 * 2.5}
    r = _readings(counters, dev)
    read = harness.metric_reader
    assert read("moe.experts_roofline")(r) == pytest.approx(25.0)
    assert read("moe.experts_ms")(r) == pytest.approx(1e3 * t / 2)
    assert read("moe.load_max_ratio")(r) == pytest.approx(2.5)
    assert read("moe.mfu_pct")(r) == pytest.approx(
        100 * 2 * work_moe.moe_step_flops(m, 8, 2048) / (2.0 * 495e12))
    from repro_torch.core import spans
    monkeypatch.setattr(spans, "totals", lambda: {
        "moe::route": {"calls": 64, "ms": 20.0},
        "moe::dispatch": {"calls": 64, "ms": 30.0},
        "moe::experts": {"calls": 64, "ms": 500.0},
        "moe::combine": {"calls": 64, "ms": 50.0}})
    assert read("moe.dispatch_ms")(r) == pytest.approx(50.0)


def test_new_readers_give_nothing_without_their_reading(monkeypatch):
    """An older program (no grouped kernel, no tally, no spans) and an
    untraced run: every new reader but the host clock's gives None."""
    from repro_torch.core import spans
    monkeypatch.setattr(spans, "totals", lambda: {})
    read = harness.metric_reader
    for r in (_readings({"steps": 2}), _readings({"steps": 2},
                                                 trace=False)):
        for name in ("moe.experts_roofline", "moe.experts_ms",
                     "moe.dispatch_ms", "moe.load_max_ratio"):
            assert read(name)(r) is None, name
        assert read("moe.mfu_pct")(r) > 0
