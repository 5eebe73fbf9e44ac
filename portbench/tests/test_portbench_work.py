"""The yardstick's FLOP and byte counts against hand-worked values, and the
per-layer readers on made-up readings."""

from __future__ import annotations

import json

import pytest

from portbench import harness, work
from portbench.trace import Trace

QWEN3 = json.loads((harness.HERE / "configs" / "qwen3-0.6b.json")
                   .read_text())["model"]
PEAK = {"flops_per_s": 495e12, "bytes_per_s": 3.35e12}


def test_summa_counts():
    assert work.summa_flops(64) == 2 * 64 ** 3
    # n 8 on 2x2: 2 rounds x 4 ranks x 3 panels of 4 x 4 floats
    assert work.summa_panel_bytes(8, 2, 2) == 2 * 4 * 3 * 16 * 4
    # the cell: 4 rounds x 16 ranks x 3 panels of 4096^2 floats
    assert work.summa_panel_bytes(16384, 4, 4) == 4 * 16 * 3 * 4096 ** 2 * 4
    with pytest.raises(ValueError):
        work.summa_panel_bytes(8, 2, 4)


def test_attention_counts():
    assert work.causal_pairs(2) == 3
    # B 1, T 2, H 1, kv 1, hd 2: 3 pairs x 2 products x 2 FLOP x hd
    assert work.flash_fwd_work(1, 2, 1, 1, 2) == (24.0, 4 * (8 + 8 + 2))
    assert work.flash_bwd_work(1, 2, 1, 1, 2) == (48.0, 4 * (16 + 16 + 2))
    f, b = work.flash_fwd_work(8, 2048, 16, 8, 128)
    assert f == 4 * 8 * 16 * (2048 * 2049 // 2) * 128
    assert b == 4 * (2 * 8 * 2048 * 16 * 128 + 2 * 8 * 2048 * 8 * 128
                     + 8 * 16 * 2048)


def test_model_flop_counts():
    layer = 1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024 + 3 * 1024 * 3072
    assert layer == 15_728_640
    assert work.matrix_params(QWEN3) == 28 * layer + 1024 * 151936 \
        == 595_984_384
    attn = 28 * work.flash_fwd_work(8, 2048, 16, 8, 128)[0]
    assert work.train_step_flops(QWEN3, 8, 2048) == \
        6.0 * 595_984_384 * 8 * 2048 + 3.0 * attn


def test_bound_is_the_slower_of_compute_and_memory():
    assert work.bound_s(495e12, 0, PEAK) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12, PEAK) == pytest.approx(1.0)
    assert work.bound_s(495e12, 6.7e12, PEAK) == pytest.approx(2.0)


def _readings(cell: str, *, seconds=1.0, units=1, counters=None,
              device=(), stats=None):
    c = harness.find_cell(harness.load_manifest(), cell)
    return harness.Readings(c.config, c.traffic,
                            harness.Window(units, seconds), counters or {},
                            stats or {}, Trace(list(device), []))


def test_summa_readers_at_a_made_up_window():
    n = 16384
    bound = work.bound_s(work.summa_flops(n),
                         work.summa_panel_bytes(n, 4, 4), PEAK)
    # two multiplies whose panel kernels ran exactly at the bound, and 5 ms
    # of other device work a multiply
    dev = [("void panel_matmul<float>", 0.0, bound * 2e6),
           ("Memcpy DtoD", bound * 2e6, bound * 2e6 + 10e3)]
    r = _readings("summa.n16384.hybrid", seconds=0.5, units=2,
                  counters={"multiplies": 2}, device=dev)
    read = harness.metric_reader
    assert read("summa.matmul_roofline")(r) == pytest.approx(100.0)
    assert read("summa.nonkernel_ms")(r) == pytest.approx(5.0)
    assert read("summa.idle_pct")(r) == pytest.approx(
        100 * (1 - (bound * 2 + 0.01) / 0.5))
    assert read("summa.mfu_pct")(r) == pytest.approx(
        100 * work.summa_flops(n) / (0.25 * 495e12))


def test_train_readers_at_a_made_up_window():
    fwd1 = work.bound_s(*work.flash_fwd_work(8, 2048, 16, 8, 128), PEAK)
    bwd1 = work.bound_s(*work.flash_bwd_work(8, 2048, 16, 8, 128), PEAK)
    # 2 steps of 28 layers; the forward ran twice a layer (the recompute),
    # each at the bound; the backward at half its bound's speed
    fwd_s, bwd_s = 2 * 28 * 2 * fwd1, 2 * 28 * bwd1 * 2
    dev = [("void (anonymous namespace)::flash_fwd<float, 128>", 0,
            fwd_s * 1e6),
           ("void (anonymous namespace)::flash_bwd_dq<float, 128>",
            fwd_s * 1e6, (fwd_s + bwd_s / 2) * 1e6),
           ("void (anonymous namespace)::prep<float>",
            (fwd_s + bwd_s / 2) * 1e6, (fwd_s + bwd_s) * 1e6)]
    r = _readings("train.qwen3-0.6b.2x4.s2048", seconds=5.0, units=2,
                  counters={"steps": 2, "flash_fwd_launches": 224,
                            "flash_bwd_launches": 112},
                  device=dev, stats={"state_bytes_per_node": 3 * 2 ** 30})
    read = harness.metric_reader
    assert read("train.flash_fwd_roofline")(r) == pytest.approx(100.0)
    assert read("train.flash_bwd_roofline")(r) == pytest.approx(50.0)
    assert read("train.state_gib")(r) == pytest.approx(3.0)
    assert read("train.mfu_pct")(r) == pytest.approx(
        100 * 2 * work.train_step_flops(QWEN3, 8, 2048) / (5.0 * 495e12))


def test_readers_return_nothing_without_their_reading():
    r = _readings("train.qwen3-0.6b.2x4.s2048",
                  counters={"steps": 1, "flash_fwd_launches": 0,
                            "flash_bwd_launches": 0})
    r.trace = None
    for name in ("train.flash_fwd_roofline", "train.flash_bwd_roofline",
                 "train.idle_pct"):
        assert harness.metric_reader(name)(r) is None
    r = _readings("summa.n16384.hybrid", counters={"multiplies": 1})
    assert harness.metric_reader("summa.matmul_roofline")(r) is None
