"""The port's checkpointer held to the reference's contract and file format.

``repro_torch.checkpoint.checkpointer.Checkpointer`` against the
reference's ``tests/test_substrates.py`` checkpoint cases (round trip and
GC, atomic commit, torn fallback with its warning, pinned-step fallback,
IO retry, terminal save failure, ``discard_after``, manifest dtypes, the
restart manager's pinned step), then across packages: a checkpoint the
reference's ``Checkpointer`` wrote restores in the port to the same state,
and the reverse, manifest and all.  Then the elastic use: the reduced
``qwen3-0.6b``'s train state saved from 2x4 restores onto 4x2 and
``2x(2x2)``, and one step from it equals (``torch.equal``) one step from
the same state laid out directly.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro_torch.checkpoint.checkpointer import (CheckpointSaveError,
                                                 Checkpointer)
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.runtime.fault_tolerance import RestartManager
from repro_torch.runtime.steps import make_cluster_train_step
from repro_torch.substrate import VirtualCluster


def _like(state):
    return T.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                            device="meta"), state)


def _tear(root, step):
    """Truncate a committed step's shard file (post-commit corruption)."""
    with open(os.path.join(str(root), f"step_{step:08d}", "shard_0.npz"),
              "wb") as f:
        f.write(b"torn")


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "nested": {"b": torch.ones((4,), dtype=torch.int32)},
             "step": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3):
        ck.save(s, state, blocking=True)
    assert ck.all_steps() == [2, 3]  # keep=2 gc'd step 1
    restored, step = ck.restore(_like(state))
    assert step == 3
    for a, b in zip(T.leaves(restored), T.leaves(state)):
        assert torch.equal(a, b)


def test_save_copies_before_the_caller_writes(tmp_path):
    """The train step donates its state and writes it in place: an async
    save holds the values it was given, not the next step's."""
    ck = Checkpointer(str(tmp_path))
    w = torch.zeros(1 << 16)
    ck.save(1, {"w": w})
    w.add_(1.0)                           # the next step, in place
    ck.wait()
    restored, _ = ck.restore({"w": w})
    assert torch.equal(restored["w"], torch.zeros(1 << 16))


def test_checkpoint_atomic_no_partial(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, {"x": torch.zeros(3)}, blocking=True)
    # a stale tmp dir from a crashed writer must not be visible
    os.makedirs(os.path.join(str(tmp_path), ".tmp-9-123"), exist_ok=True)
    assert ck.all_steps() == [5]


def test_restore_falls_back_past_torn_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        ck.save(s, {"w": torch.full((4,), float(s))}, blocking=True)
    _tear(tmp_path, 3)
    with pytest.warns(RuntimeWarning, match="checkpoint step 3 is torn"):
        restored, step = ck.restore({"w": torch.zeros(4)})
    assert step == 2
    assert torch.equal(restored["w"], torch.full((4,), 2.0))


def test_restore_every_step_torn_raises(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    for s in (1, 2):
        ck.save(s, {"w": torch.zeros(4)}, blocking=True)
        _tear(tmp_path, s)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(FileNotFoundError, match="every candidate"):
            ck.restore({"w": torch.zeros(4)})


def test_restore_torn_fallback_respects_pinned_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        ck.save(s, {"w": torch.full((4,), float(s))}, blocking=True)
    _tear(tmp_path, 2)
    with pytest.warns(RuntimeWarning, match="step 2 is torn"):
        restored, step = ck.restore({"w": torch.zeros(4)}, step=2)
    assert step == 1
    assert torch.equal(restored["w"], torch.full((4,), 1.0))


def test_save_retries_transient_io(tmp_path):
    ck = Checkpointer(str(tmp_path), io_retries=3, retry_backoff_s=0.001)
    orig, calls = ck._write, {"n": 0}

    def flaky(step, host_state):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("transient NFS hiccup")
        orig(step, host_state)

    ck._write = flaky
    ck.save(1, {"w": torch.ones(4)}, blocking=True)
    assert calls["n"] == 3
    _, step = ck.restore({"w": torch.zeros(4)})
    assert step == 1


def test_save_terminal_failure_surfaces_on_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), io_retries=1, retry_backoff_s=0.001)

    def broken(step, host_state):
        raise OSError("disk on fire")

    ck._write = broken
    ck.save(1, {"w": torch.ones(4)})
    with pytest.raises(CheckpointSaveError, match="after 2 attempts"):
        ck.wait()
    ck.wait()        # surfaced once, not re-raised forever


def test_discard_after_drops_newer_steps(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=10)
    for s in (2, 4, 6, 8):
        ck.save(s, {"w": torch.full((2,), float(s))}, blocking=True)
    assert ck.discard_after(4) == [6, 8]
    assert ck.all_steps() == [2, 4]
    assert ck.discard_after(4) == []


def test_restore_checks_manifest_dtypes(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(4)}, blocking=True)
    with pytest.raises(AssertionError, match="dtype"):
        ck.restore({"w": torch.zeros(4, dtype=torch.int32)})
    restored, _ = ck.restore({"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.ones(4))


def test_restart_resumes_pinned_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(100, {"w": torch.full((4,), 100.0)}, blocking=True)
    rm = RestartManager(ck)
    validated = ck.latest_step()
    ck.save(200, {"w": torch.full((4,), 200.0)}, blocking=True)
    ck.latest_step = lambda: validated
    state, step = rm.resume_or_init(lambda: {"w": torch.zeros(4)},
                                    like={"w": torch.empty(4,
                                                           device="meta")})
    assert step == 100
    assert torch.equal(state["w"], torch.full((4,), 100.0))


# ---------------------------------------------------------------------------
# Across packages: one file format
# ---------------------------------------------------------------------------

def _state_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"embed": rng.normal(size=(8, 4)).astype(np.float32),
                       "units": {"w": rng.normal(size=(2, 4, 4))
                                 .astype(np.float32)}},
            "m": {"x": rng.normal(size=(3,)).astype(np.float32)},
            "step": np.int32(5)}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    want = _state_np()
    JCheckpointer(str(tmp_path)).save(
        4, {"params": {"embed": jnp.asarray(want["params"]["embed"]),
                       "units": {"w": jnp.asarray(want["params"]["units"]
                                                  ["w"])}},
            "m": {"x": jnp.asarray(want["m"]["x"])},
            "step": jnp.int32(5)}, blocking=True)
    like = T.tree_map(lambda a: torch.empty(np.shape(a), device="meta",
                                            dtype=torch.from_numpy(
                                                np.asarray(a)).dtype), want)
    got, step = Checkpointer(str(tmp_path)).restore(like)
    assert step == 4
    for a, b in zip(T.leaves(got), T.leaves(want)):
        assert torch.equal(a, torch.as_tensor(b))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    want = _state_np(1)
    Checkpointer(str(tmp_path)).save(
        6, T.tree_map(lambda a: torch.as_tensor(np.asarray(a)), want),
        blocking=True)
    with open(tmp_path / "step_00000006" / "manifest.json") as f:
        man = json.load(f)
    assert set(man) == {"step", "time", "leaves"} and man["step"] == 6
    assert [r["path"] for r in man["leaves"]] == [
        "['m']['x']", "['params']['embed']", "['params']['units']['w']",
        "['step']"]
    assert man["leaves"][-1] == {"path": "['step']", "shape": [],
                                 "dtype": "int32"}
    got, step = JCheckpointer(str(tmp_path)).restore(
        T.tree_map(lambda a: np.zeros(np.shape(a), np.asarray(a).dtype),
                   want))
    assert step == 6
    for a, b in zip(T.leaves(got), T.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# The elastic use: save on one topology, restore onto another
# ---------------------------------------------------------------------------

def _tiny():
    return get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64,
                                            n_heads=4)


@pytest.mark.parametrize("label", ["4x2", "2x(2x2)"])
def test_train_state_restores_onto_another_topology(tmp_path, label):
    cfg = _tiny()
    src = make_cluster_train_step(cfg, VirtualCluster.from_label(
        "2x4", device="cpu"), global_batch=8)
    state = src.init_layout_state(0)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, src.host_state(state), blocking=True)
    dst = make_cluster_train_step(cfg, VirtualCluster.from_label(
        label, device="cpu"), global_batch=8)
    restored, step = ck.restore(dst.abstract_state(),
                                layout=dst.layout_state)
    assert step == 3
    fresh = dst.layout_state(src.unlayout_state(state))
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(8, 17)).astype(np.int32)
    got = dst.step(restored, dst.layout_batch({"tokens": toks}))
    want = dst.step(fresh, dst.layout_batch({"tokens": toks}))
    assert torch.equal(got[1]["loss"], want[1]["loss"])
    for a, b in zip(T.leaves(got[0]), T.leaves(want[0])):
        assert torch.equal(a, b)
