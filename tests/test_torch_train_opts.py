"""The port's cluster train step: its options, layouts and launcher.

``stepgraph`` and ``prefetch`` on against off must give the same bits
(``torch.equal``) — the reference's own contract for both; a global batch
that does not divide the data-parallel ranks is replicated, as the
reference's is; the global ``fn`` (the reference's smap'd form) and the
laid-out, donated ``step`` compute the same step; hier holds one copy of
the state per node (a quarter of naive's on 2x4); the launcher runs on the
CPU; and ``--ckpt`` / ``runtime.train_loop.train`` resume an interrupted
run to the uninterrupted run's losses and state.  The parity matrix against the reference is
``tests/test_torch_train.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.steps import make_cluster_train_step as jmake
from repro.substrate import VirtualCluster as JVC
from repro_torch.convert import train_state_from_reference
from repro_torch.core import tree as T
from repro_torch.runtime.steps import make_cluster_train_step
from repro_torch.substrate import VirtualCluster

from test_torch_train import _batches, _cfgs, _port_run

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.fixture(scope="module")
def ref_state():
    """The reference's init_params(0) state for the reduced config."""
    jcfg, _ = _cfgs()
    return jax.device_get(jmake(jcfg, JVC(pods=2, chips=4),
                                global_batch=8).init_state(0))


def test_hier_state_is_one_copy_per_node():
    _, cfg = _cfgs()
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    sizes = {}
    for mode in ("hier", "naive"):
        bundle = make_cluster_train_step(cfg, vc, mode=mode)
        state = bundle.init_layout_state(0)
        sizes[mode] = sum(t.numel() for g in ("params", "m", "v")
                          for t in T.leaves(state[g]))
        bundle.step(state, bundle.layout_batch(
            {"tokens": _batches(cfg.vocab, n=1)[0]}))
        sizes[mode] += bundle.stats["grad_bytes"] // 4
    assert sizes["naive"] == vc.chips * sizes["hier"]


@pytest.mark.parametrize("opt", ["stepgraph", "prefetch", "prefetch=1"])
def test_opts_are_bit_identical(opt, ref_state):
    _, cfg = _cfgs()
    jstate = ref_state
    batches = _batches(cfg.vocab, seed=3)
    *_, off, m_off = _port_run(cfg, 2, 4, "hier", jstate, batches)
    *_, on, m_on = _port_run(cfg, 2, 4, "hier", jstate, batches, (opt,))
    assert m_on == m_off
    for a, b in zip(T.leaves(on), T.leaves(off)):
        assert torch.equal(a, b)


def test_replicated_batch_when_it_does_not_divide():
    """8 ranks, global batch 4: every rank takes the whole batch and the
    count absorbs the overcount — the reference's rule."""
    jcfg, cfg = _cfgs()
    jb = jmake(jcfg, JVC(pods=2, chips=4), global_batch=4)
    jstate = jax.device_get(jb.init_state(0))
    toks = _batches(cfg.vocab, n=1, B=4)[0]
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    bundle = make_cluster_train_step(cfg, vc, global_batch=4)
    assert bundle.batch_spec["tokens"] == ()
    state = train_state_from_reference(jstate, vc, bundle.state_specs)
    _, m = bundle.step(state, bundle.layout_batch({"tokens": toks}))
    _, jm = jax.jit(jb.fn)(jstate, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(m["loss"][0]), float(jm["loss"]),
                               rtol=2e-4)
    assert float(m["tokens"][0]) == float(jm["tokens"]) == 8 * 4 * 16


def test_global_fn_matches_the_laid_out_step():
    """``bundle.fn`` (the reference's smap'd form, global in and out) and
    ``bundle.step`` (laid out, donated) compute the same step."""
    _, cfg = _cfgs()
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    bundle = make_cluster_train_step(cfg, vc)
    glob = bundle.init_state(0)
    toks = _batches(cfg.vocab, n=1)[0]
    new_glob, m1 = bundle.fn(glob, {"tokens": torch.from_numpy(toks)})
    laid = bundle.layout_state(glob)
    laid, m2 = bundle.step(laid, bundle.layout_batch({"tokens": toks}))
    assert float(m1["loss"]) == float(m2["loss"][0])
    for a, b in zip(T.leaves(new_glob), T.leaves(
            bundle.unlayout_state(laid))):
        assert torch.equal(a, b)


def test_train_launcher_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "2", "--seq", "32"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    steps = [ln for ln in out.stdout.splitlines() if " step " in ln]
    assert len(steps) == 2 and all("tokens/s" in ln for ln in steps)
    assert "state bytes: params" in out.stdout


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run(
        [sys.executable, "-c", "import sys; from repro_torch.launch.train "
         "import main; sys.exit(main(sys.argv[1:]))", *args],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_train_launcher_resumes_from_checkpoints(tmp_path, capsys):
    """``--ckpt``: a run stopped after 2 steps (saved at step 2) and rerun
    to 4 resumes from step 2 and prints steps 3-4 with the losses of an
    uninterrupted 4-step run, digit for digit (the launcher prints the
    loss in full).  The resume runs in a CLI subprocess, the others
    in-process."""
    from repro_torch.launch import train as launcher
    base = ["--reduced", "--device", "cpu", "--seq", "16", "--save-every",
            "2"]
    ck = str(tmp_path / "ck")
    assert launcher.main(base + ["--steps", "4", "--ckpt",
                                 str(tmp_path / "w")]) == 0
    assert launcher.main(base + ["--steps", "2", "--ckpt", ck]) == 0
    whole = capsys.readouterr().out.split("checkpoints in " + ck)[0]
    resumed = _launch(*base, "--steps", "4", "--ckpt", ck)
    assert "[train] resumed from step 2" in resumed

    def losses(text):
        return {ln.split()[2]: ln.split()[4] for ln in text.splitlines()
                if ln.startswith("[train] step ")}
    got, want = losses(resumed), losses(whole)
    assert sorted(got) == ["3", "4"] and sorted(want) == ["1", "2", "3", "4"]
    assert all(got[s] == want[s] for s in got)


def test_train_loop_resumed_equals_uninterrupted(tmp_path):
    """``runtime.train_loop.train`` stopped at step 3 (saved every 3) and
    re-entered to 5: its losses and final laid-out state ``torch.equal``
    the uninterrupted run's."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.runtime.train_loop import train
    _, cfg = _cfgs()
    bundle = make_cluster_train_step(
        cfg, VirtualCluster(pods=2, chips=4, device="cpu"), global_batch=8)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
    kw = dict(data_cfg=dcfg, save_every=3, log_every=0, seed=3)
    whole = train(bundle, steps=5, ckpt_dir=str(tmp_path / "w"), **kw)
    first = train(bundle, steps=3, ckpt_dir=str(tmp_path / "r"), **kw)
    second = train(bundle, steps=5, ckpt_dir=str(tmp_path / "r"), **kw)
    assert second.resumed_from == 3
    assert first.losses + second.losses == whole.losses
    for a, b in zip(T.leaves(second.state), T.leaves(whole.state)):
        assert torch.equal(a, b)
