"""The port's serving path held against the JAX reference on the CPU.

The reduced ``qwen3-0.6b`` with the reference's ``init_params(0)`` weights
(through ``convert.params_from_reference``) generates in both packages:
``greedy_generate`` and ``scheduler.generate`` over heterogeneous prompts
give identical tokens and log-probs within 1e-4 of ``repro.serving``.
Temperature sampling draws from a ``torch.Generator`` keyed per
(seed, rid, token index), so it is held to slot independence within the
port, not to ``jax.random``'s draws.  The queue's admission and bucketing
cases are the reference's own (``tests/test_serving_engine.py``).  The
reduced ``recurrentgemma-9b`` (``rglru, rglru, local``, window 16) serves
through exact-length buckets with prompts below and past its window; its
pages hold the recurrent ``h`` / ``conv`` state beside the ring k / v.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import build_by_name as jbuild_by_name
from repro.serving.engine import greedy_generate as jgreedy
from repro.serving.scheduler import generate as jgenerate
from repro_torch.comm import Communicator, SharedWindow, WindowEpochError
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.models import ParallelCtx, build, build_by_name
from repro_torch.serving.engine import greedy_generate, materialize_params
from repro_torch.serving.kv_cache import KVCachePages
from repro_torch.serving.queue import AdmissionError, RequestQueue, bucket_len
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           _bucket_mode, generate)

ROOT = pathlib.Path(__file__).resolve().parent.parent
LP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def qwen():
    """(reference model, its params, port model, the same params)."""
    jm = jbuild_by_name("qwen3-0.6b", reduced=True)
    jp = jm.init_params(0)
    tm = build_by_name("qwen3-0.6b", reduced=True, device="cpu")
    return jm, jp, tm, params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def rgemma():
    """The reduced recurrentgemma-9b: (reference, params, port, params)."""
    jm = jbuild_by_name("recurrentgemma-9b", reduced=True)
    jp = jm.init_params(0)
    tm = build_by_name("recurrentgemma-9b", reduced=True, device="cpu")
    return jm, jp, tm, params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


def _prompts(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in lengths]


# ---------------------------------------------------------------------------
# Request queue + admission control (the reference's cases)
# ---------------------------------------------------------------------------

def test_queue_validates_and_backpressures():
    q = RequestQueue(max_pending=2, max_prompt_len=8)
    with pytest.raises(AdmissionError, match="empty"):
        q.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(AdmissionError, match="1-D"):
        q.submit(np.zeros((2, 3), np.int32), 4)
    with pytest.raises(AdmissionError, match="prompt"):
        q.submit(np.zeros(9, np.int32), 4)
    with pytest.raises(AdmissionError, match="max_new"):
        q.submit(np.zeros(3, np.int32), 0)
    q.submit(np.zeros(3, np.int32), 4)
    q.submit(np.zeros(3, np.int32), 4)
    with pytest.raises(AdmissionError, match="pending"):
        q.submit(np.zeros(3, np.int32), 4)
    assert len(q) == 2


def test_take_group_buckets_head_of_line_and_keeps_fifo():
    q = RequestQueue(lookahead=8)
    r0 = q.submit(np.zeros(6, np.int32), 1)    # bucket 8
    q.submit(np.zeros(10, np.int32), 1)        # bucket 16
    r2 = q.submit(np.zeros(7, np.int32), 1)    # bucket 8
    q.submit(np.zeros(4, np.int32), 1)         # bucket 4
    group = q.take_group(3, bucket="pow2")
    assert [r.rid for r in group] == [r0, r2]
    nxt = q.take_group(4, bucket="pow2")
    assert [bucket_len(r.prompt.size - 1, "pow2") for r in nxt] == [16]
    last = q.take_group(4, bucket="pow2")
    assert [bucket_len(r.prompt.size - 1, "pow2") for r in last] == [4]
    assert len(q) == 0


def test_bucket_len_modes():
    assert [bucket_len(n, "pow2") for n in (0, 1, 2, 3, 5, 8, 9)] == \
        [0, 1, 2, 4, 8, 8, 16]
    assert [bucket_len(n, "exact") for n in (0, 1, 5, 9)] == [0, 1, 5, 9]
    with pytest.raises(ValueError):
        bucket_len(3, "nope")


# ---------------------------------------------------------------------------
# KV pages: epoch fences + C1 accounting
# ---------------------------------------------------------------------------

def test_kv_pages_epoch_guard_and_c1(qwen):
    tm = qwen[2]
    pages = KVCachePages.for_model(tm, slots=2, s_max=16)
    _ = pages.cache                       # clean: readable
    sub = tm.cache_init(1, 16)
    sub["units"]["b0"]["k"].fill_(1.0)
    dirty = pages.admit(np.array([1]), sub)
    with pytest.raises(WindowEpochError):
        _ = dirty.cache                   # open epoch: dirty reads raise
    fenced = dirty.fence()
    k = fenced.cache["units"]["b0"]["k"]  # fence closed the epoch
    assert k[:, 1].eq(1).all() and not k[:, 0].any()   # slot 1 admitted
    e0 = pages.windows["units"]["b0"]["k"].epoch
    assert fenced.windows["units"]["b0"]["k"].epoch == e0 + 1
    with pytest.raises(WindowEpochError):
        _ = fenced.commit(fenced.cache).cache
    acct = fenced.assert_c1()
    assert acct["copies_per_node"] == 1   # paper C1 for inference state
    assert acct["resident_node_bytes"] == acct["logical_bytes"] == sum(
        t.nbytes for t in jax.tree.leaves(tm.cache_init(2, 16)))


def test_materialize_params_refuses_dirty_and_multichip_windows():
    one = Communicator(fast_axis="node", pods=1, chips=1)
    w = torch.ones(3)
    assert materialize_params({"a": SharedWindow(one, w)})["a"] is w
    with pytest.raises(ValueError, match="dirty"):
        materialize_params({"a": SharedWindow(one, w, dirty=True)})
    for chips in (4, None):
        wide = Communicator(fast_axis="node", pods=1, chips=chips)
        with pytest.raises(ValueError, match="SharedWindow"):
            materialize_params({"a": SharedWindow(wide, w)})


# ---------------------------------------------------------------------------
# Generation against the reference
# ---------------------------------------------------------------------------

def test_greedy_generate_matches_reference(qwen):
    jm, jp, tm, tp = qwen
    prompts = np.stack(_prompts(tm.cfg.vocab, [9, 9, 9]))
    want = jgreedy(jm, jp, prompts, max_new=6)
    got = greedy_generate(tm, tp, prompts, max_new=6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, **LP_TOL)


def test_scheduler_generate_matches_reference_on_heterogeneous_prompts(qwen):
    jm, jp, tm, tp = qwen
    prompts = _prompts(tm.cfg.vocab, [3, 9, 5, 1, 6, 12])
    want = jgenerate(jm, jp, prompts, max_new=5, slots=3, s_max=20)
    got = generate(tm, tp, prompts, max_new=5, slots=3, s_max=20)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, **LP_TOL)


def test_slot_refill_heterogeneous_identity(qwen):
    """5 heterogeneous requests through 2 slots: finished slots are
    refilled mid-flight and every request's stream equals its solo run."""
    tm, tp = qwen[2], qwen[3]
    prompts = _prompts(tm.cfg.vocab, [3, 9, 5, 1, 6])
    sched = ContinuousBatchingScheduler(tm, tp, slots=2, s_max=16)
    rids = [sched.queue.submit(p, 4) for p in prompts]
    results = sched.run()
    assert set(results) == set(rids)
    assert sum(s.admitted for s in sched.stats) == len(prompts)
    assert any(s.admitted and s.active > s.admitted for s in sched.stats)
    assert all((s.bucket >= 0) == bool(s.admitted) for s in sched.stats)
    assert not sched.active.any()
    for rid, p in zip(rids, prompts):
        solo = generate(tm, tp, [p], max_new=4, slots=1, s_max=16)
        np.testing.assert_array_equal(results[rid].tokens, solo.tokens)
        np.testing.assert_allclose(results[rid].logprobs, solo.logprobs,
                                   rtol=2e-5, atol=1e-5)


def test_temperature_sampling_is_slot_independent(qwen):
    """temperature > 0: the sampled stream of a request is a function of
    (seed, rid, token index) — not of slot count or batch neighbours."""
    tm, tp = qwen[2], qwen[3]
    prompts = _prompts(tm.cfg.vocab, [4, 7, 5], seed=11)
    a = generate(tm, tp, prompts, max_new=4, slots=2, temperature=1.0,
                 seed=7)
    b = generate(tm, tp, prompts, max_new=4, slots=3, temperature=1.0,
                 seed=7)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    c = generate(tm, tp, prompts, max_new=4, slots=2, temperature=1.0,
                 seed=8)
    assert not np.array_equal(a.tokens, c.tokens)
    g0 = generate(tm, tp, prompts, max_new=4, slots=2, seed=1)
    g1 = generate(tm, tp, prompts, max_new=4, slots=2, seed=2)
    np.testing.assert_array_equal(g0.tokens, g1.tokens)


def test_scheduler_refuses_the_live_tuner_and_uses_pow2_buckets(qwen,
                                                                  capsys):
    """Since the live tuner was ported the scheduler no longer refuses it:
    it feeds it one observation per decode step, keyed as the reference's
    scheduler keys it, and ``--live-tuning`` prints the tuner's EWMA."""
    from repro.serving.live_tuning import LiveTuner as JLiveTuner
    from repro.serving.scheduler import \
        ContinuousBatchingScheduler as JScheduler
    from repro_torch.core.plans import size_bucket
    from repro_torch.serving.live_tuning import LiveTuner

    jm, jp, tm, tp = qwen
    assert _bucket_mode(tm.cfg) == "pow2"
    tuner = LiveTuner(min_count=1)
    sched = ContinuousBatchingScheduler(tm, tp, slots=2, s_max=16,
                                        tuner=tuner)
    assert sched._tuner_key == JScheduler(
        jm, jp, slots=2, s_max=16, tuner=JLiveTuner())._tuner_key
    for p in _prompts(tm.cfg.vocab, [4, 6, 5]):
        sched.queue.submit(p, 3)
    sched.run()
    k = sched._tuner_key
    cell = tuner._cells[("serving", "1x1", "float32",
                         size_bucket(k["nbytes"]))]
    assert cell.count == {"sync": len(sched.stats)}
    assert tuner.estimate("serving", "1x1", "float32", k["nbytes"],
                          "sync") > 0
    serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                "--live-tuning"])
    assert "live tuner: serving/sync EWMA" in capsys.readouterr().out


def test_serve_launcher_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "6", "--slots", "3"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "qwen3-0.6b (reduced) on cpu: 6 requests, 3 slots" in out.stdout
    for key in ("tokens/sec", "decode step us", "request e2e ms"):
        assert key in out.stdout


def test_prefill_longer_than_the_cache_is_refused(qwen):
    """A pow2 bucket past s_max (the launcher's s_max = prompt_max +
    max_new with a short max_new): the reference fails inside the
    re-layout; the port says why."""
    tm, tp = qwen[2], qwen[3]
    toks = torch.zeros((1, 33), dtype=torch.int32)
    with pytest.raises(ValueError, match="s_max=27"):
        tm.prefill_fn(tp, {"tokens": toks}, 27)


# ---------------------------------------------------------------------------
# The hybrid model (rglru + local attention)
# ---------------------------------------------------------------------------

def test_hybrid_scheduler_matches_reference_and_solo_runs(rgemma):
    """Exact-length buckets; a prompt shorter than the window (the
    reference's NaN regression, tests/test_serving_engine.py) and one past
    it: the streams equal the reference scheduler's and each request's
    solo greedy_generate run."""
    jm, jp, tm, tp = rgemma
    assert _bucket_mode(tm.cfg) == "exact" and tm.cfg.window == 16
    prompts = _prompts(tm.cfg.vocab, [5, 24, 5])
    want = jgenerate(jm, jp, prompts, max_new=4, slots=2, s_max=32)
    got = generate(tm, tp, prompts, max_new=4, slots=2, s_max=32)
    assert np.isfinite(got.logprobs).all()
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, **LP_TOL)
    for i, p in enumerate(prompts):
        solo = greedy_generate(tm, tp, p[None], max_new=4, s_max=32)
        np.testing.assert_array_equal(got.tokens[i:i + 1], solo.tokens)
        np.testing.assert_allclose(got.logprobs[i:i + 1], solo.logprobs,
                                   **LP_TOL)


def test_hybrid_pages_hold_recurrent_state_once(rgemma):
    """The pages scatter h / conv on the slot axis of k / v (1 under units,
    0 under rem) and C1 counts every leaf."""
    cfg = dataclasses.replace(rgemma[2].cfg, n_layers=5)    # + a remainder
    tm = build(cfg, ParallelCtx.single(), device="cpu")
    pages = KVCachePages.for_model(tm, slots=3, s_max=24)
    names = {n for tree in pages.windows.values() for blk in tree.values()
             for n in blk}
    assert names == {"k", "v", "h", "conv"}
    sub = tm.cache_init(1, 24)
    sub["units"]["b0"]["h"].fill_(2.0)
    sub["rem"]["r1"]["conv"].fill_(3.0)
    cache = pages.admit(np.array([2]), sub).fence().cache
    h, conv = cache["units"]["b0"]["h"], cache["rem"]["r1"]["conv"]
    assert h[:, 2].eq(2).all() and not h[:, :2].any()
    assert conv[2].eq(3).all() and not conv[:2].any()
    acct = pages.assert_c1()
    assert acct["copies_per_node"] == 1
    assert acct["logical_bytes"] == sum(
        t.nbytes for t in jax.tree.leaves(tm.cache_init(3, 24)))


def test_serve_launcher_runs_the_hybrid_model_on_the_cpu():
    assert serve.main(["--arch", "recurrentgemma-9b", "--device", "cpu",
                       "--requests", "4", "--slots", "2"]) == 0
