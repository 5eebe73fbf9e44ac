"""MoE serving on the stacked cluster held against the JAX reference.

The reduced ``granite-moe-3b-a800m`` (4 experts, top 2) served by the
port's ``ClusterModel`` (one run per memory domain, ``models.domains``) in
the ``serve_fsdp`` layout and in the default one, against the reference's
``vc.run`` of prefill then decode on 2x4 hier (the reference runs its
default layout: its ``serve_fsdp`` specs name the store axis twice for the
expert leaves, which JAX refuses).  In hier the reference's decode gathers
the node's store ranks' copies of the replicated batch and dispatches them
with a capacity from that count, so once tokens drop its ranks disagree
(ROADMAP Queue 3: a property of the reference); the port's node run takes
the node's token set once with that capacity, which is the reference's
member-0 output.  So at the config's ``capacity_factor`` 1.25 the port is
held to the reference's rank 0 (and the reference's ranks are shown to
disagree), at 8.0 (no drops) to every rank.  The factored cluster, the
recorded decoder and the serving C1 are ``tests/test_torch_moe_serving_tp.py``.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.configs.base import MoESpec as JMoESpec
from repro.models.transformer import build as jbuild
from repro.runtime.steps import cluster_ctx as jcluster_ctx
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.configs.base import MoESpec
from repro_torch.convert import params_from_reference
from repro_torch.models import moe
from repro_torch.models.transformer import build
from repro_torch.runtime.steps import cluster_ctx
from repro_torch.substrate import VirtualCluster
from repro_torch.substrate.cluster import P
from repro_torch.substrate.collectives import recording

F32_TOL = dict(rtol=2e-4, atol=2e-4)
NAME = "granite-moe-3b-a800m"
B, S_MAX, T0, STEPS = 4, 16, 8, 4
_RNG = np.random.default_rng(11)
PROMPT = _RNG.integers(0, 256, (B, T0 + 1)).astype(np.int32)
TOKS = _RNG.integers(0, 256, (STEPS, B, 1)).astype(np.int32)


def _cfgs(cf):
    j = jconfigs.get_config(NAME).reduced()
    t = configs.get_config(NAME).reduced()
    return (dataclasses.replace(j, moe=JMoESpec(4, 2, 32, cf)),
            dataclasses.replace(t, moe=MoESpec(4, 2, 32, cf)))


def _clusters(label):
    if label == "2x4":
        return JVC(pods=2, chips=4), VirtualCluster(pods=2, chips=4,
                                                    device="cpu")
    return (JVC(pods=2, chips=4, fast_axis=("dp", "tp"), fast_shape=(2, 2),
                slow_axis="pod"),
            VirtualCluster.from_label(label, device="cpu"))


def _data(vc, ctx):
    sizes = dict(zip(vc.axis_names, vc.axis_shapes))
    return math.prod(sizes[a] for a in ctx.fsdp_axes)


def _port(vc, cfg, mode="hier", opts=("serve_fsdp",)):
    ctx = cluster_ctx(vc, mode=mode, opts=opts)
    return build(cfg, ctx, data=_data(vc, ctx), device="cpu")


def _pspecs(m, serve):
    ctx = m.ctx
    return m.param_specs(serve=serve, tp_axis=ctx.tp_axis,
                         fsdp_axis=ctx.fsdp_axes[0] if ctx.fsdp_axes
                         else None)


@functools.lru_cache(maxsize=None)
def _ref_serve(label, cf, steps=STEPS):
    """The reference's prefill of PROMPT then ``steps`` decode steps of TOKS
    at positions T0.. (one ``lax.scan``), every rank's logits: (R, steps +
    1, B, V)."""
    jcfg, _ = _cfgs(cf)
    jvc, _ = _clusters(label)
    jctx = jcluster_ctx(jvc)
    jm = jbuild(jcfg, jctx, data=_data(jvc, jctx))
    jp = jm.init_params(0)
    leaves, tdef = jax.tree.flatten(jp)
    n = len(leaves)

    def specs(serve):
        return tuple(jax.tree.leaves(jm.param_specs(
            serve=serve, tp_axis=jctx.tp_axis, fsdp_axis=jctx.fsdp_axes[0])))

    def body(*args):
        train = jax.tree.unflatten(tdef, args[:n])
        serve = jax.tree.unflatten(tdef, args[n:2 * n])
        cache, lg = jm.prefill_fn(train, {"tokens": args[-2]}, S_MAX)
        if not steps:
            return lg[:, 0][None, None]

        def step(c, xs):
            tok, pos = xs
            c, out = jm.decode_fn(serve, c, tok, jnp.full((B,), pos,
                                                          jnp.int32))
            return c, out[:, 0]

        _, outs = jax.lax.scan(step, cache, (args[-1][:steps],
                                             T0 + jnp.arange(steps)))
        return jnp.concatenate([lg[:, 0][None], outs])[None]

    got = jvc.run(body, *leaves, *leaves, jnp.asarray(PROMPT),
                  jnp.asarray(TOKS),
                  in_specs=specs(False) + specs(True) + (JP(), JP()),
                  out_specs=JP(jvc.axis_names))
    return jp, np.asarray(got)


def _port_serve(m, vc, params, decode=None):
    """The port's prefill and STEPS decode steps: every rank's logits
    (R, STEPS + 1, B, V), the cache, the traffic record, the decode steps'
    (routing assignments, kept) (``moe.drops``)."""
    decode = decode or m.decode_fn
    with vc.bind():
        cache, lg = m.prefill_fn(vc.layout(params, _pspecs(m, False)),
                                 {"tokens": vc.layout(torch.from_numpy(
                                     PROMPT), P())}, S_MAX)
        sp = vc.layout(params, _pspecs(m, True))
        out = [lg[:, :, 0]]
        with recording() as rec, moe.routes() as routes:
            for i in range(STEPS):
                cache, lg = decode(sp, cache, vc.layout(torch.from_numpy(
                    TOKS[i]), P()), vc.layout(torch.full((B,), T0 + i),
                                              P()))
                out.append(lg[:, :, 0])
    return torch.stack(out, 1), cache, rec, moe.drops(routes)


@pytest.mark.parametrize("opts", [("serve_fsdp",), ()],
                         ids=["serve_fsdp", "default"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_cluster_serving_matches_reference_2x4(cf, opts):
    jp, want = _ref_serve("2x4", cf)
    _, cfg = _cfgs(cf)
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    m = _port(vc, cfg, opts=opts)
    got, cache, _, drops = _port_serve(m, vc, params_from_reference(
        jp, device="cpu"))
    got = got.numpy()
    assert got.shape == want.shape
    # prefill runs the train path on each rank's own batch: every rank
    np.testing.assert_allclose(got[:, 0], want[:, 0], **F32_TOL)
    # the port's node run is the reference's member 0 (store rank 0 of each
    # node) ...
    for r in (0, vc.chips):
        np.testing.assert_allclose(got[r], want[r], **F32_TOL)
    # ... and the node's ranks share it
    assert np.array_equal(got[0], got[1]) and cache.domains.count == vc.pods
    spread = max(np.abs(want[r] - want[0]).max() for r in range(vc.chips))
    if cf == 8.0:
        # no drops: every rank of the reference agrees, the port with each
        assert drops[1] == drops[0]
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        # drops in the node's gathered token set: the reference's ranks
        # disagree (each takes its own copy of it), the port is rank 0's
        assert spread > 1e-3
