"""xLSTM serving held against the JAX reference.

The reduced ``xlstm-1.3b`` (7 mLSTM + 1 sLSTM, d 64, 4 heads) served by the
port's ``ClusterModel`` (one run per memory domain, ``models.domains``) in
the ``serve_fsdp`` layout against the reference's ``vc.run`` of prefill
then 4 decode steps (B 4, a 9-token prompt, s_max 16): every rank's
logits and every rank's decode state after the last step (the mLSTM's
``C`` / ``n`` / ``m`` / ``conv`` of its heads and channel shard, the
sLSTM's ``h`` / ``c`` / ``n`` / ``m``) within ``F32_TOL``, on 2x4 hier.
Naive and the scheduler are ``tests/test_torch_xlstm_serving_naive.py``;
the factored cluster, the recorded decoder and the serving C1
``tests/test_torch_xlstm_serving_tp.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.models.transformer import build as jbuild
from repro.runtime.steps import cluster_ctx as jcluster_ctx
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core import tree as T
from repro_torch.models.transformer import build
from repro_torch.runtime.steps import cluster_ctx
from repro_torch.substrate import VirtualCluster
from repro_torch.substrate.cluster import P

F32_TOL = dict(rtol=2e-4, atol=2e-4)
NAME = "xlstm-1.3b"
B, S_MAX, T0, STEPS = 4, 16, 8, 4
_RNG = np.random.default_rng(12)
PROMPT = _RNG.integers(0, 256, (B, T0 + 1)).astype(np.int32)
TOKS = _RNG.integers(0, 256, (STEPS, B, 1)).astype(np.int32)


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


def _port(vc, mode="hier"):
    ctx = cluster_ctx(vc, mode=mode, opts=("serve_fsdp",))
    return build(configs.get_config(NAME).reduced(), ctx,
                 data=_data(vc, ctx), device="cpu")


def _pspecs(m, serve):
    ctx = m.ctx
    return m.param_specs(serve=serve, tp_axis=ctx.tp_axis,
                         fsdp_axis=ctx.fsdp_axes[0] if ctx.fsdp_axes
                         else None)


@functools.lru_cache(maxsize=None)
def _ref_serve(label, mode):
    """The reference's prefill of PROMPT then STEPS decode steps of TOKS at
    positions T0.. (one ``lax.scan``): the params, every rank's logits
    (R, STEPS + 1, B, V) and every rank's final cache leaves."""
    jvc, _ = _clusters(label)
    jctx = jcluster_ctx(jvc, mode=mode, opts=("serve_fsdp",))
    jm = jbuild(jconfigs.get_config(NAME).reduced(), jctx,
                data=_data(jvc, jctx))
    jp = jm.init_params(0)
    leaves, tdef = jax.tree.flatten(jp)
    n = len(leaves)

    def specs(serve):
        return tuple(jax.tree.leaves(jm.param_specs(
            serve=serve, tp_axis=jctx.tp_axis,
            fsdp_axis=jctx.fsdp_axes[0] if jctx.fsdp_axes else None)))

    def body(*args):
        train = jax.tree.unflatten(tdef, args[:n])
        serve = jax.tree.unflatten(tdef, args[n:2 * n])
        cache, lg = jm.prefill_fn(train, {"tokens": args[-2]}, S_MAX)

        def step(c, xs):
            tok, pos = xs
            c, out = jm.decode_fn(serve, c, tok, jnp.full((B,), pos,
                                                          jnp.int32))
            return c, out[:, 0]

        cache, outs = jax.lax.scan(step, cache, (args[-1],
                                                 T0 + jnp.arange(STEPS)))
        return (jnp.concatenate([lg[:, 0][None], outs])[None],) + tuple(
            x[None] for x in jax.tree.leaves(cache))

    n_out = len(jax.tree.leaves(jm.cache_init(B, S_MAX)))
    got = jvc.run(body, *leaves, *leaves, jnp.asarray(PROMPT),
                  jnp.asarray(TOKS),
                  in_specs=specs(False) + specs(True) + (JP(), JP()),
                  out_specs=(JP(jvc.axis_names),) * (1 + n_out))
    return jp, [np.asarray(x) for x in got]


def _port_serve(m, vc, params, decode=None):
    """The port's prefill and STEPS decode steps: every rank's logits
    (R, STEPS + 1, B, V) and the NodeCache."""
    decode = decode or m.decode_fn
    with vc.bind():
        cache, lg = m.prefill_fn(vc.layout(params, _pspecs(m, False)),
                                 {"tokens": vc.layout(torch.from_numpy(
                                     PROMPT), P())}, S_MAX)
        sp = vc.layout(params, _pspecs(m, True))
        out = [lg[:, :, 0]]
        for i in range(STEPS):
            cache, lg = decode(sp, cache, vc.layout(torch.from_numpy(
                TOKS[i]), P()), vc.layout(torch.full((B,), T0 + i), P()))
            out.append(lg[:, :, 0])
    return torch.stack(out, 1), cache


def _ranks(cache):
    """A NodeCache's per-rank leaves (R, *local), reference order."""
    return [a.reshape((-1,) + tuple(a.shape[3:]))
            for a in T.leaves(cache.rank_view())]


def test_cluster_serving_matches_reference_2x4_hier():
    check_serving("2x4", "hier")


def check_serving(label, mode):
    """Every rank's logits and final decode state against the
    reference's ``vc.run``."""
    jp, want = _ref_serve(label, mode)
    _, vc = _clusters(label)
    m = _port(vc, mode)
    got, cache = _port_serve(m, vc, params_from_reference(jp, device="cpu"))
    assert got.shape == want[0].shape
    np.testing.assert_allclose(got.numpy(), want[0], **F32_TOL)
    leaves = _ranks(cache)
    assert len(leaves) == len(want) - 1
    names = [n for k in sorted(cache["units"])
             for n in sorted(cache["units"][k])]
    assert set(names) == {"C", "n", "m", "conv", "h", "c"}
    for g, w, n in zip(leaves, want[1:], names):
        assert tuple(g.shape) == w.shape, n
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL, err_msg=n)
    lay = cache.domains
    assert lay.count == (vc.pods if mode == "hier" else vc.num_devices
                         // lay.tp)
