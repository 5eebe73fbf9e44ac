"""The ``vit`` and ``encodec`` frontends held against the JAX reference.

The reduced ``internvl2-1b`` (``vit``: patches through ``w_fe`` in place
of the token embedding at positions below ``n_prefix``, those labels
masked) and ``musicgen-medium`` (``encodec``: frames through ``w_fe``,
labels from the batch) on one device: the loss and every gradient
(``jax.value_and_grad`` of the reference's ``loss_fn``), prefill logits
and every cache leaf; ``musicgen``'s decode of frames continuing a prefill
against the prefill of the whole sequence (the counterpart of
``tests/test_models_smoke.py::test_decode_matches_prefill``, 1e-4) and
against the reference's decode.  A tp-2 domain run with ``n_prefix``
widened past the first tp rank's chunk (the prefix straddles the two
chunks): ``make_train_step`` on ``{"data": 1, "model": 2}`` against the
reference's single-device step under ``PERF.md`` §2's rule, and the
``ClusterModel`` prefill there against the reference's.  Cluster serving
of both models is ``tests/test_torch_frontends_serving.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import make_batch as jmake_batch
from repro.models.parallel import ParallelCtx as JCtx
from repro.models.transformer import build as jbuild
from repro_torch import configs
from repro_torch.analysis.state_rule import state_close
from repro_torch.convert import params_from_reference
from repro_torch.core import tree as T
from repro_torch.core.topology import MeshTopology
from repro_torch.launch.mesh import make_mesh_from_topo
from repro_torch.models import ParallelCtx, build
from repro_torch.substrate.cluster import P

from test_torch_mesh_steps import port_step, single_device_step

F32_TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ["internvl2-1b", "musicgen-medium"]
B, T0, S_MAX = 2, 8, 16


def _np(x):
    return x.detach().float().cpu().numpy()


def _batch_np(batch):
    return {k: np.array(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _single(name):
    """(reference model, port model, reference params) at reduced size on
    one device."""
    jcfg = jconfigs.get_config(name).reduced()
    cfg = configs.get_config(name).reduced()
    jm = jbuild(jcfg, JCtx.single())
    m = build(cfg, ParallelCtx.single(), device="cpu")
    return jm, m, jax.device_get(jm.init_params(0))


def _grad_close(got, want, what):
    """Every gradient leaf within rtol 2e-4 and 2e-4 of the leaf's largest
    (``core.tree`` and ``jax.tree`` both walk dicts in key order)."""
    for i, (g, w) in enumerate(zip(T.leaves(got), jax.tree.leaves(want))):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=2e-4,
                                   atol=2e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=f"{what} grad leaf {i}")


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name):
    jm, m, jp = _single(name)
    batch = jmake_batch(jm.cfg, B=B, T=16, seed=3)
    (jl, jc), jg = jax.value_and_grad(lambda p: jm.loss_fn(p, batch),
                                      has_aux=True)(jp)
    params = T.tree_map(lambda t: t.requires_grad_(True),
                        params_from_reference(jp, device="cpu"))
    loss, cnt = m.loss_fn(params, _batch_np(batch))
    grads = torch.autograd.grad(loss, T.leaves(params), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-4)
    assert float(cnt) == float(jc)
    if name == "internvl2-1b":       # the prefix's labels are masked
        assert float(cnt) == B * (16 + 1 - m.cfg.n_prefix)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, T.leaves(params))]
    _grad_close(T.unflatten(params, grads), jg, name)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_cache_match_reference(name):
    jm, m, jp = _single(name)
    batch = jmake_batch(jm.cfg, B=B, T=T0, seed=4)
    jc, jl = jm.prefill_fn(jp, batch, S_MAX)
    c, lg = m.prefill_fn(params_from_reference(jp, device="cpu"),
                         _batch_np(batch), S_MAX)
    np.testing.assert_allclose(_np(lg), np.asarray(jl), **F32_TOL)
    for g, w in zip(T.leaves(c), jax.tree.leaves(jc)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32_TOL)


def test_encodec_decode_continues_prefill():
    """Frames decoded one at a time after a prefill give the logits of the
    whole sequence's prefill (1e-4 of the largest), and the reference's
    decode logits."""
    jm, m, jp = _single("musicgen-medium")
    T_, T_0 = 32, 16
    batch = jmake_batch(jm.cfg, B=2, T=T_, seed=0)
    params = params_from_reference(jp, device="cpu")
    _, ref = m.prefill_fn(params, _batch_np(batch), T_)
    b0 = {"frames": np.array(batch["frames"][:, :T_0]),
          "labels": np.array(batch["labels"][:, :T_0])}
    cache, lg = m.prefill_fn(params, b0, T_)
    jcache, _ = jm.prefill_fn(jp, b0, T_)
    for i, t in enumerate(range(T_0, T_)):
        frame = np.array(batch["frames"][:, t:t + 1])
        cache, lg = m.decode_fn(params, cache, frame, T_0 + i)
        jcache, jl = jm.decode_fn(jp, jcache, jnp.asarray(frame),
                                  jnp.int32(T_0 + i))
    err = float((lg - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    assert err < 1e-4, err
    np.testing.assert_allclose(_np(lg), np.asarray(jl), **F32_TOL)


def test_vit_prefix_straddling_the_tp_chunks():
    """n_prefix 20 at T 32 on tp 2 (chunks of 16): rank 1's first 4
    positions are patches.  The train step is the reference's
    single-device step; the cluster prefill gives its logits."""
    red = dict(n_layers=2, d_model=64, n_heads=4)
    jcfg = dataclasses.replace(
        jconfigs.get_config("internvl2-1b").reduced(**red), n_prefix=20)
    cfg = dataclasses.replace(
        configs.get_config("internvl2-1b").reduced(**red), n_prefix=20)
    batch = jmake_batch(jcfg, B=4, T=32, seed=6)
    state0, want, jm_ = single_device_step(jcfg, batch)
    st, m, b = port_step(cfg, batch, (1, 1, 2), "hier", state0)
    assert b.model.ctx.tp == 2
    np.testing.assert_allclose(float(m["loss"][0]), float(jm_["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(m["gnorm"][0]), float(jm_["gnorm"]),
                               rtol=5e-3)
    state_close(st, want, 1, "vit prefix over two tp chunks")
    # prefill on the same cluster (train layout) against the reference's
    jm = jbuild(jcfg, JCtx.single())
    _, jl = jm.prefill_fn(state0["params"], batch, 32)
    vc = make_mesh_from_topo(MeshTopology({"data": 1, "model": 2}),
                             device="cpu")
    model = b.model
    lay = vc.layout(params_from_reference(state0["params"], "cpu"),
                    b.state_specs["params"])
    with vc.bind():
        _, lg = model.prefill_fn(lay, {k: vc.layout(torch.from_numpy(
            np.array(v)), P()) for k, v in batch.items()}, 32)
    for r in range(vc.num_devices):
        np.testing.assert_allclose(_np(lg[r]), np.asarray(jl), **F32_TOL)
