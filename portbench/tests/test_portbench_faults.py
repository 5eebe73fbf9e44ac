"""A whole run, past the harness's look for a card, with the timed path
broken underneath: ``correct`` has to come out false for every fault the
cell can have."""

from __future__ import annotations

import functools

import pytest
import torch

from portbench.tests.cells import run_small


def _stale(monkeypatch):
    """A multiply that returns its first answer again (state unchanged)."""
    from repro_torch.apps import summa as app
    orig, first = app.summa, []

    def summa(a, b, **kw):
        if not first:
            first.append(orig(a, b, **kw))
        return first[0].clone()
    monkeypatch.setattr(app, "summa", summa)


def _half_rounds(monkeypatch):
    """Half of the work left out: every other panel product dropped."""
    from repro_torch.kernels import ops
    orig, calls = ops.matmul, [0]

    def matmul(a, b):
        calls[0] += 1
        out = orig(a, b)
        return out if calls[0] % 2 else torch.zeros_like(out)
    monkeypatch.setattr(ops, "matmul", matmul)


def _no_bridge(monkeypatch):
    """The exchange between nodes left out: the B-panel psum over the
    node axis returns the rank's own block."""
    from repro_torch.substrate import collectives as coll
    orig = coll.psum

    def psum(x, axis, *a, **kw):
        return x if axis == "node" else orig(x, axis, *a, **kw)
    monkeypatch.setattr(coll, "psum", psum)


def _altered_answer(monkeypatch):
    """One element of C altered where it is produced."""
    from repro_torch.apps import summa as app
    orig = app.summa

    def summa(a, b, **kw):
        c = orig(a, b, **kw)
        c[3, 5] += 1e-3 * c.abs().max()
        return c
    monkeypatch.setattr(app, "summa", summa)


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: AdamW stores nothing."""
    from repro_torch.runtime import steps
    monkeypatch.setattr(steps, "adamw_update_", lambda *a, **kw: None)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second node's rows, their loss and
    token counts are dropped, so the mean is over the rest."""
    from repro_torch.runtime import steps
    orig = steps._domain_grads

    @functools.wraps(orig)
    def domain_grads(*a, **kw):
        grads, loss, cnt = orig(*a, **kw)
        half = loss.shape[0] // 2
        from repro_torch.core import tree as T
        for g in T.leaves(grads):
            g[half:] = 0
        loss[half:] = 0
        cnt[half:] = 0
        return grads, loss, cnt
    monkeypatch.setattr(steps, "_domain_grads", domain_grads)


def _no_exchange(monkeypatch):
    """The gradient bridge between the nodes left out."""
    from repro_torch.models.parallel import ParallelCtx
    monkeypatch.setattr(ParallelCtx, "reduce_grads",
                        lambda self, grads, *a, **kw: grads)


def _altered_loss(monkeypatch):
    """The step's loss altered where it is produced."""
    from repro_torch.runtime import steps
    orig = steps._bridge_and_clip

    def bridge(*a, **kw):
        gl, loss_g, cnt_g, gnorm = orig(*a, **kw)
        return gl, loss_g * (1 + 1e-3), cnt_g, gnorm
    monkeypatch.setattr(steps, "_bridge_and_clip", bridge)


SUMMA = {"stale": _stale, "half_rounds": _half_rounds,
         "no_bridge": _no_bridge, "altered_answer": _altered_answer}
TRAIN = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
         "no_exchange": _no_exchange, "altered_loss": _altered_loss}


@pytest.mark.parametrize("fault", sorted(SUMMA))
def test_summa_fault_is_not_correct(monkeypatch, fault):
    SUMMA[fault](monkeypatch)
    result, checks = run_small("summa.n16384.hybrid")
    assert not result["correct"], checks
    assert result["failed"] >= 1


@pytest.mark.parametrize("fault", sorted(TRAIN))
def test_train_fault_is_not_correct(monkeypatch, fault):
    TRAIN[fault](monkeypatch)
    result, checks = run_small("train.qwen3-0.6b.2x4.s2048")
    assert not result["correct"], checks
    assert result["failed"] >= 1
