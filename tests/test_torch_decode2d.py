"""The 2-D decode layout held against the 1-D decode and the JAX reference.

The counterpart of ``tests/test_distributed.py::
test_decode2d_matches_baseline`` on ``{"data": 1, "model": 8}``: the
reduced ``qwen3-0.6b`` with 8 q / 4 kv heads (``decode2d_groups`` (4, 2))
and the reduced ``internvl2-1b`` (4 q / 2 kv heads: (2, 4), the split the
full model takes at tp 8), 4 decode steps from an empty cache through the
port's ``make_serve_steps`` with and without the ``decode2d`` opt — the
2-D weights re-laid out from the 1-D ones (``meta.decode2d_params``) —
at rtol / atol 2e-4, and the 2-D logits against the reference's
``make_serve_steps(opts=("decode2d",))``'s on its own re-laid-out
weights.  A per-slot position vector raises, as in the reference.  And
``make_serve_steps`` with a batch split over the data-parallel ranks of
``small_topo(2, 2, 2)`` (each node folding its ranks' rows) gives the
single-device model's prefill and decode logits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.topology import MeshTopology as JTopology
from repro.launch.mesh import make_mesh_from_topo as jmesh
from repro.models import make_batch as jmake_batch
from repro.models import meta as jmeta
from repro.runtime.steps import make_serve_steps as jmake_serve_steps
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.topology import MeshTopology
from repro_torch.launch.mesh import make_mesh_from_topo
from repro_torch.models import meta
from repro_torch.runtime.steps import make_serve_steps

TOL = dict(rtol=2e-4, atol=2e-4)
B, SMAX, STEPS = 2, 32, 4
CASES = {"qwen3-0.6b": dict(n_layers=2, d_model=64, n_heads=8, n_kv=4),
         "internvl2-1b": dict(n_layers=2, d_model=64, n_heads=4)}


def _cfgs(name):
    return (jconfigs.get_config(name).reduced(**CASES[name]),
            configs.get_config(name).reduced(**CASES[name]))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's decode2d logits after STEPS steps, its base params
    and the tokens."""
    jcfg, _ = _cfgs(name)
    topo = JTopology({"data": 1, "model": 8}, slow_axes=())
    mesh = jmesh(topo)
    tokens = np.array(jmake_batch(jcfg, B=B, T=16, seed=9)["tokens"])
    base = jmake_serve_steps(jcfg, topo, mesh, mode="hier", global_batch=B,
                             s_max=SMAX, compute_dtype=jnp.float32)
    bp = jax.device_get(base.model.init_params(0))
    sb = jmake_serve_steps(jcfg, topo, mesh, mode="hier", global_batch=B,
                           s_max=SMAX, opts=("decode2d",),
                           compute_dtype=jnp.float32)
    params = jax.device_get(sb.model.init_params(0))
    params.update({k: bp[k] for k in ("embed", "unembed", "final_ln")
                   if k in bp})
    for i in range(len(jcfg.pattern)):
        a, ab = params["units"][f"b{i}"], bp["units"][f"b{i}"]
        a["attn"] = dict(ab["attn"])
        for kind in ("wq", "wkv", "wo"):
            a["attn"][kind] = jnp.asarray(np.stack([
                jmeta.relayout_attn_decode2d(w, jcfg, 8, kind)
                for w in np.asarray(ab["attn"][kind])]))
        for k in a:
            if k != "attn":
                a[k] = ab[k]
    local = jax.eval_shape(lambda: sb.model.cache_init(sb.b_loc, SMAX))
    cache = jax.tree.map(lambda l: jnp.zeros((1, 8) + l.shape, l.dtype),
                         local)
    dec = jax.jit(sb.decode)
    for t in range(STEPS):
        cache, logits = dec(params, cache, tokens[:, t:t + 1], jnp.int32(t))
    return np.asarray(logits), bp, tokens


def _port_decode(name, params, opts):
    _, cfg = _cfgs(name)
    topo = MeshTopology({"data": 1, "model": 8}, slow_axes=())
    vc = make_mesh_from_topo(topo, device="cpu")
    sb = make_serve_steps(cfg, topo, vc, global_batch=B, s_max=SMAX,
                          opts=opts, compute_dtype=torch.float32)
    if opts:
        params = meta.decode2d_params(params, cfg, 8)
    lay = sb.layout_params(params)
    cache = sb.cache_init()
    _, _, tokens = _reference(name)
    for t in range(STEPS):
        cache, logits = sb.decode(lay, cache,
                                  sb.layout_tokens(tokens[:, t:t + 1]), t)
    return sb, lay, cache, logits


@pytest.mark.parametrize("name", list(CASES))
def test_decode2d_matches_baseline_and_reference(name):
    want, bp, _ = _reference(name)
    params = params_from_reference(bp, device="cpu")
    sb1, _, _, lg1 = _port_decode(name, params, ())
    sb2, lay2, cache2, lg2 = _port_decode(name, params, ("decode2d",))
    cfg = sb2.model.cfg
    g_h, g_s = meta.decode2d_groups(cfg, 8)
    # the 2-D layout: head-group weights, an S/g_s x kv/g_h cache
    assert tuple(lay2["units"]["b0"]["attn"]["wq"].shape) == (
        8, cfg.n_units, 1, cfg.d_model, cfg.n_heads * cfg.head_dim // g_h)
    assert tuple(cache2["units"]["b0"]["k"].shape)[-3:] == (
        SMAX // g_s, cfg.n_kv // g_h, cfg.head_dim)
    glob1, glob2 = sb1.unlayout_logits(lg1), sb2.unlayout_logits(lg2)
    np.testing.assert_allclose(glob2.numpy(), glob1.numpy(), **TOL)
    np.testing.assert_allclose(glob2.numpy(), want, **TOL)
    # every rank holds the same logits
    for r in range(8):
        assert torch.equal(lg2[r], lg2[0])


def test_decode2d_refuses_a_position_vector():
    _, bp, tokens = _reference("qwen3-0.6b")
    _, cfg = _cfgs("qwen3-0.6b")
    topo = MeshTopology({"data": 1, "model": 8}, slow_axes=())
    vc = make_mesh_from_topo(topo, device="cpu")
    sb = make_serve_steps(cfg, topo, vc, global_batch=B, s_max=SMAX,
                          opts=("decode2d",), compute_dtype=torch.float32)
    lay = sb.layout_params(meta.decode2d_params(
        params_from_reference(bp, device="cpu"), cfg, 8))
    posv = torch.zeros((vc.num_devices, B), dtype=torch.int64)
    with pytest.raises(ValueError, match="scalar pos"):
        sb.decode(lay, sb.cache_init(), sb.layout_tokens(tokens[:, :1]),
                  posv)


def test_serve_steps_split_batch_matches_the_single_device_model():
    """make_serve_steps with a batch the data-parallel ranks divide (4
    rows over (pod, data) = 4 ranks of small_topo(2, 2, 2)): each node
    folds its ranks' rows into one run; the prefill and two decode steps
    give the single-device model's logits, row for row."""
    from repro_torch.launch.mesh import small_topo
    from repro_torch.models import ParallelCtx, build, make_batch
    _, cfg = _cfgs("internvl2-1b")
    topo = small_topo(2, 2, 2)
    vc = make_mesh_from_topo(topo, device="cpu")
    sb = make_serve_steps(cfg, topo, vc, global_batch=4, s_max=16,
                          compute_dtype=torch.float32)
    assert sb.sharded and sb.b_loc == 1
    one = build(cfg, ParallelCtx.single(), device="cpu")
    params = one.init_params(0)
    batch = make_batch(cfg, 4, 8, seed=2, device="cpu")
    feed = make_batch(cfg, 4, 2, seed=3, device="cpu")["tokens"]
    c1, want = one.prefill_fn(params, batch, 16)
    cache, lg = sb.prefill(sb.layout_params(params, serve=False),
                           sb.layout_batch(batch))
    np.testing.assert_allclose(sb.unlayout_logits(lg).numpy(),
                               want.numpy(), **TOL)
    lay = sb.layout_params(params)
    for t in range(2):
        c1, want = one.decode_fn(params, c1, feed[:, t:t + 1], 8 + t)
        cache, lg = sb.decode(lay, cache, sb.layout_tokens(
            feed[:, t:t + 1]), 8 + t)
        np.testing.assert_allclose(sb.unlayout_logits(lg).numpy(),
                                   want.numpy(), **TOL)
