"""Cluster serving of the ``vit`` and ``encodec`` frontends held against
the JAX reference.

The reduced ``internvl2-1b`` and ``musicgen-medium`` on 2x4 with
``serve_fsdp`` (a ``ClusterModel`` run once per node): the prompt's every
batch leaf (``tokens`` + ``patches``; ``frames`` + ``labels``) carried to
the domain run, prefill in the train layout, then two decode steps in the
serve layout (a frame as ``encodec``'s decode input), against the
reference's ``vc.run`` of the same prefill and decode; the logits of the
first and last rank at ``F32_TOL``.  Single-device parity is
``tests/test_torch_frontends.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.models import make_batch as jmake_batch
from repro.models.transformer import build as jbuild
from repro.runtime.steps import cluster_ctx as jcluster_ctx
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import build
from repro_torch.runtime.steps import cluster_ctx
from repro_torch.substrate import VirtualCluster
from repro_torch.substrate.cluster import P

F32_TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ["internvl2-1b", "musicgen-medium"]
B, T0, S_MAX = 2, 8, 16


def _np(x):
    return x.detach().float().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _cluster(name):
    jvc = JVC(pods=2, chips=4)
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    jctx = jcluster_ctx(jvc, opts=("serve_fsdp",))
    jm = jbuild(jconfigs.get_config(name).reduced(), jctx, data=4)
    ctx = cluster_ctx(vc, opts=("serve_fsdp",))
    m = build(configs.get_config(name).reduced(), ctx, data=4, device="cpu")
    return jm, jvc, m, vc


def _jspecs(jm, serve):
    return tuple(jax.tree.leaves(jm.param_specs(
        serve=serve, tp_axis=None, fsdp_axis=jm.ctx.fsdp_axes[0])))


def _inputs(cfg):
    """The prompt batch and two decode inputs (tokens, or frames)."""
    batch = {k: np.array(v) for k, v in
             jmake_batch(cfg, B=B, T=T0 + 2, seed=5).items()}
    if cfg.frontend == "encodec":
        prompt = {"frames": batch["frames"][:, :T0],
                  "labels": batch["labels"][:, :T0]}
        steps = [batch["frames"][:, t:t + 1] for t in (T0, T0 + 1)]
    else:
        prompt = dict(batch, tokens=batch["tokens"][:, :T0 + 1])
        steps = [batch["tokens"][:, t:t + 1] for t in (T0, T0 + 1)]
    return prompt, steps


@pytest.mark.parametrize("name", NAMES)
def test_cluster_serving_matches_reference(name):
    jm, jvc, m, vc = _cluster(name)
    jp = jm.init_params(0)
    prompt, steps = _inputs(jm.cfg)
    leaves, tdef = jax.tree.flatten(jp)
    n, keys = len(leaves), sorted(prompt)

    def body(*args):
        pt = jax.tree.unflatten(tdef, args[:n])
        ps = jax.tree.unflatten(tdef, args[n:2 * n])
        b = dict(zip(keys, args[2 * n:2 * n + len(keys)]))
        c, lg0 = jm.prefill_fn(pt, b, S_MAX)
        out = [lg0]
        for i, x in enumerate(args[2 * n + len(keys):]):
            c, lg = jm.decode_fn(ps, c, x, jnp.int32(T0 + i))
            out.append(lg)
        return tuple(out)

    want = jvc.run(body, *leaves, *leaves,
                   *[jnp.asarray(prompt[k]) for k in keys],
                   *[jnp.asarray(s) for s in steps],
                   in_specs=_jspecs(jm, False) + _jspecs(jm, True)
                   + (JP(),) * (len(keys) + len(steps)),
                   out_specs=(JP(),) * (1 + len(steps)))
    params = params_from_reference(jp, device="cpu")
    fsdp = m.ctx.fsdp_axes[0]
    pt = vc.layout(params, m.param_specs(fsdp_axis=fsdp))
    ps = vc.layout(params, m.param_specs(serve=True, fsdp_axis=fsdp))
    with vc.bind():
        cache, lg = m.prefill_fn(pt, {k: vc.layout(torch.from_numpy(v), P())
                                      for k, v in prompt.items()}, S_MAX)
        got = [lg]
        for i, x in enumerate(steps):
            cache, lg = m.decode_fn(
                ps, cache, vc.layout(torch.from_numpy(x), P()),
                vc.layout(torch.tensor(T0 + i), P()))
            got.append(lg)
    for g, w in zip(got, want):
        assert g.shape == (vc.num_devices, B, 1, m.cfg.vocab_padded)
        for r in (0, vc.num_devices - 1):
            np.testing.assert_allclose(_np(g[r]), np.asarray(w),
                                       **F32_TOL)
