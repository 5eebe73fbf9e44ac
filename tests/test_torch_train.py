"""The port's cluster train step held against the JAX reference.

``repro_torch.runtime.steps.make_cluster_train_step`` against
``repro.runtime.steps.make_cluster_train_step`` on the same stacked cluster
shape: the reduced ``qwen3-0.6b`` (2 layers, d 64), the reference's
``init_params(0)`` state carried across with ``convert``, the same numpy
token batches, 2 steps in ``hier`` and ``naive`` mode on 2x4 and 4x2.
Loss, grad norm, params, m and v must agree within the reference's own
tolerances (``tests/test_distributed.py``: loss rtol 2e-4, gnorm rtol 5e-3,
state rtol 2e-4 atol 2e-5).  The step's options, layouts and launcher are
held in ``tests/test_torch_train_opts.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.runtime.steps import make_cluster_train_step as jmake
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.runtime.steps import make_cluster_train_step
from repro_torch.substrate import VirtualCluster

STATE_TOL = dict(rtol=2e-4, atol=2e-5)


def _cfgs():
    return (jconfigs.get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64),
            configs.get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64))


def _batches(vocab, n=2, B=8, T=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(B, T + 1)).astype(np.int32)
            for _ in range(n)]


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_path(tree[k], path + (k,))]
    return [(path, tree)]


def _port_run(cfg, pods, chips, mode, state0, batches, opts=()):
    vc = VirtualCluster(pods=pods, chips=chips, device="cpu")
    bundle = make_cluster_train_step(cfg, vc, mode=mode, global_batch=8,
                                     opts=opts)
    state = train_state_from_reference(state0, vc, bundle.state_specs)
    metrics = []
    for toks in batches:
        state, m = bundle.step(state, bundle.layout_batch({"tokens": toks}))
        metrics.append({k: float(v[0]) for k, v in m.items()})
    return bundle, vc, state, metrics


@pytest.mark.parametrize("mode", ["hier", "naive"])
@pytest.mark.parametrize("pods,chips", [(2, 4), (4, 2)])
def test_cluster_train_step_matches_reference(pods, chips, mode):
    jcfg, cfg = _cfgs()
    jb = jmake(jcfg, JVC(pods=pods, chips=chips), mode=mode, global_batch=8)
    jstate = jax.device_get(jb.init_state(0))
    batches = _batches(cfg.vocab)
    bundle, vc, state, metrics = _port_run(cfg, pods, chips, mode, jstate,
                                           batches)
    fn = jax.jit(jb.fn)
    for toks, got in zip(batches, metrics):
        jstate, jm = fn(jstate, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(got["loss"], float(jm["loss"]),
                                   rtol=2e-4)
        np.testing.assert_allclose(got["gnorm"], float(jm["gnorm"]),
                                   rtol=5e-3)
        assert got["tokens"] == float(jm["tokens"])
    back = train_state_to_reference(state, vc, bundle.state_specs)
    want = jax.device_get(jstate)
    assert int(back["step"]) == int(want["step"]) == len(batches)
    for group in ("params", "m", "v"):
        for (path, a), (wpath, w) in zip(_leaves_with_path(back[group]),
                                         _leaves_with_path(want[group])):
            assert path == wpath
            np.testing.assert_allclose(a, np.asarray(w), **STATE_TOL,
                                       err_msg=f"{mode} {group} {path}")
