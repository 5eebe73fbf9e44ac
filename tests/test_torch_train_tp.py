"""The port's tensor-parallel train step held against the JAX reference.

``repro_torch.runtime.steps.make_cluster_train_step`` against
``repro.runtime.steps.make_cluster_train_step`` on the factored cluster
``2x(2x2)`` (2 pods, each node's fast tier over ``(dp, tp)`` = (2, 2), the
reference's production layout): the reference's ``init_state(0)`` carried
across with ``convert``, the same numpy token batches, 2 steps.  Cases:
the reduced ``qwen3-0.6b`` in ``head_tp`` with the kv heads tp-sharded (hier
and naive), an irregular kv map (H 6, kv 3: replicated kv heads whose
groups straddle the tp ranks), context-parallel attention (H 3) and the
reduced ``recurrentgemma-9b`` (RG-LRU + local attention, tied
embeddings).  Loss rtol 2e-4, gnorm rtol 5e-3; m and v per leaf within
rtol 2e-4 and an atol of 2e-5 of the leaf's largest |m| / v; params within
rtol 2e-4 atol 2e-5 but for elements where AdamW's sqrt(v_hat) < 1e-6
(``PERF.md`` §2).  Then the paper's claim for training state on this
layout: hier holds each tp shard once per node, naive once per store rank,
so naive / hier is the store size, 2.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.runtime.steps import make_cluster_train_step as jmake
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.analysis.state_rule import state_close as _state_close
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.core import tree as T
from repro_torch.runtime.steps import make_cluster_train_step
from repro_torch.substrate import VirtualCluster

LABEL = "2x(2x2)"
CASES = {
    "qwen3-head_tp-hier": ("qwen3-0.6b", "hier", {}),
    "qwen3-head_tp-naive": ("qwen3-0.6b", "naive", {}),
    "irregular-kv-map": ("qwen3-0.6b", "hier",
                         dict(n_heads=6, n_kv=3, d_model=48)),
    "cp": ("qwen3-0.6b", "hier", dict(n_heads=3, d_model=48)),
    "recurrentgemma-rglru": ("recurrentgemma-9b", "hier", {}),
}


def _clusters():
    return (JVC(pods=2, chips=4, fast_axis=("dp", "tp"), fast_shape=(2, 2),
                slow_axis="pod"),
            VirtualCluster.from_label(LABEL, device="cpu"))


def _batches(vocab, n=2, B=8, T_=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(B, T_ + 1)).astype(np.int32)
            for _ in range(n)]


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_path(tree[k], path + (k,))]
    return [(path, np.asarray(tree))]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_train_step_matches_reference(case):
    name, mode, kw = CASES[case]
    jcfg = jconfigs.get_config(name).reduced(**kw)
    cfg = configs.get_config(name).reduced(**kw)
    jvc, vc = _clusters()
    jb = jmake(jcfg, jvc, mode=mode, global_batch=8)
    jstate = jax.device_get(jax.jit(lambda: jb.init_state(0))())
    bundle = make_cluster_train_step(cfg, vc, mode=mode, global_batch=8)
    assert bundle.model.ctx.tp == 2
    state = train_state_from_reference(jstate, vc, bundle.state_specs)
    batches = _batches(cfg.vocab)
    fn = jax.jit(jb.fn).lower(jstate, {"tokens": batches[0]}).compile()
    for toks in batches:
        state, m = bundle.step(state, bundle.layout_batch({"tokens": toks}))
        jstate, jm = fn(jstate, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(float(m["loss"][0]), float(jm["loss"]),
                                   rtol=2e-4)
        np.testing.assert_allclose(float(m["gnorm"][0]), float(jm["gnorm"]),
                                   rtol=5e-3)
        assert float(m["tokens"][0]) == float(jm["tokens"])
    back = train_state_to_reference(state, vc, bundle.state_specs)
    want = jax.device_get(jstate)
    assert int(back["step"]) == int(want["step"]) == len(batches)
    assert [p for p, _ in _leaves_with_path(back["params"])] == \
        [p for p, _ in _leaves_with_path(want["params"])]
    _state_close(back, want, len(batches), case)


def test_hier_holds_half_the_state_of_naive_on_the_factored_cluster():
    """C1 for training state under tp: the node's store ranks share one
    copy of each tp shard in hier, each holds its own in naive — naive /
    hier = the store size (2), not the node's 4 chips, for every group."""
    cfg = configs.get_config("qwen3-0.6b").reduced()
    vc = VirtualCluster.from_label(LABEL, device="cpu")
    toks = _batches(cfg.vocab, n=1)[0]
    nbytes = {}
    for mode in ("hier", "naive"):
        bundle = make_cluster_train_step(cfg, vc, mode=mode, global_batch=8)
        state = bundle.init_layout_state(0)
        nbytes[mode] = {g: sum(t.numel() * t.element_size()
                               for t in T.leaves(state[g]))
                        for g in ("params", "m", "v")}
        state, _ = bundle.step(state, bundle.layout_batch({"tokens": toks}))
        nbytes[mode]["grads"] = bundle.stats["grad_bytes"]
        assert torch.isfinite(state["params"]["embed"]).all()
    for g in ("params", "m", "v", "grads"):
        assert nbytes["naive"][g] / nbytes["hier"][g] == 2.0, g
