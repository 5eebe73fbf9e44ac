"""The port's MoE train step held against the JAX reference on the
factored cluster ``2x(2x2)``.

``repro_torch.runtime.steps.make_cluster_train_step`` against
``repro.runtime.steps.make_cluster_train_step`` for the reduced
``granite-moe-3b-a800m`` (4 experts, top 2, d_ff_expert 32; at tp 2 ep 2,
tp_ff 1: each tp rank holds its 2 experts): the reference's
``init_state(0)`` carried across with ``convert`` (the expert leaves are
5-D, ``(tp, E_loc, d, 2, n_ff)`` per unit), the same numpy batches, 2
steps, hier and naive, at ``capacity_factor`` 8.0 (nothing drops, as the
reference's own ``test_moe_ep_tp``) and at the config's 1.25, where tokens
drop (counted by ``moe.routes``).  The hier step runs one model per
node with the node's ranks' rows folded into one batch; the MoE block
dispatches each rank's rows apart, with the reference's per-rank capacity,
so the drops are the reference's.  Loss rtol 2e-4, gnorm 5e-3, the state
under ``PERF.md`` §2's rule.  2x4 and the training C1 are
``tests/test_torch_moe_cluster_2x4.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import MoESpec as JMoESpec
from repro.runtime.steps import make_cluster_train_step as jmake
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.analysis.state_rule import state_close
from repro_torch.configs.base import MoESpec
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.models import moe
from repro_torch.runtime.steps import make_cluster_train_step
from repro_torch.substrate import VirtualCluster

NAME = "granite-moe-3b-a800m"


def cfgs(cf):
    j = jconfigs.get_config(NAME).reduced()
    t = configs.get_config(NAME).reduced()
    return (dataclasses.replace(j, moe=JMoESpec(4, 2, 32, cf)),
            dataclasses.replace(t, moe=MoESpec(4, 2, 32, cf)))


def clusters(label):
    if label == "2x4":
        return JVC(pods=2, chips=4), VirtualCluster(pods=2, chips=4,
                                                    device="cpu")
    return (JVC(pods=2, chips=4, fast_axis=("dp", "tp"), fast_shape=(2, 2),
                slow_axis="pod"),
            VirtualCluster.from_label(label, device="cpu"))


def check_train_step(label, mode, cf):
    """2 steps of both packages' train step from the same state."""
    jcfg, cfg = cfgs(cf)
    jvc, vc = clusters(label)
    jb = jmake(jcfg, jvc, mode=mode, global_batch=8)
    jstate = jax.device_get(jax.jit(lambda: jb.init_state(0))())
    bundle = make_cluster_train_step(cfg, vc, mode=mode, global_batch=8)
    state = train_state_from_reference(jstate, vc, bundle.state_specs)
    tp = bundle.model.ctx.tp
    ep, tp_ff = cfg.moe.ep_tp(tp)
    w_in = jstate["params"]["units"]["b0"]["moe"]["w_in"]
    assert w_in.shape == (cfg.n_units, tp, 4 // ep, cfg.d_model, 2,
                          32 // tp_ff)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab, size=(8, 17)).astype(np.int32)
               for _ in range(2)]
    fn = jax.jit(jb.fn).lower(jstate, {"tokens": batches[0]}).compile()
    dropped = 0
    for toks in batches:
        with moe.routes() as routes:
            state, m = bundle.step(state, bundle.layout_batch(
                {"tokens": toks}))
        assigned, kept = moe.drops(routes)
        dropped += assigned - kept
        jstate, jm = fn(jstate, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(float(m["loss"][0]), float(jm["loss"]),
                                   rtol=2e-4)
        np.testing.assert_allclose(float(m["gnorm"][0]), float(jm["gnorm"]),
                                   rtol=5e-3)
        assert float(m["tokens"][0]) == float(jm["tokens"])
    back = train_state_to_reference(state, vc, bundle.state_specs)
    state_close(back, jax.device_get(jstate), len(batches),
                f"{label} {mode} {cf}")
    assert (dropped > 0) == (cf == 1.25), dropped


@pytest.mark.parametrize("mode", ["hier", "naive"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_train_step_matches_reference_2x2x2(mode, cf):
    check_train_step("2x(2x2)", mode, cf)
