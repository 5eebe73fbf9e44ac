"""The training slice's pieces held against the JAX reference on the CPU.

``ParallelCtx.reduce_grads`` in every form (exact per-leaf metas, the
step-graph ``recorder=``, ``precision="lossy"`` with and without
``error_state`` and its residuals, ``compress=``, the legacy whole-tree
paths) against the reference's on the same cluster; the differentiable
collectives (``all_gather`` tiled and stacked, ``psum_scatter``, ``psum``,
the window read) against ``jax.vjp`` of the reference's; the streamed
cross-entropy and AdamW with their gradients and schedules; the sharded
parameter metadata (``_resolve_fsdp``, ``param_specs``,
``abstract_params``), the host layout helpers of ``core.shared_buffer``,
the compression shims, ``VirtualCluster.smap`` against the reference's
``shard_map`` and the prefetcher's lifecycle.  Sums agree within rtol 1e-5
/ atol 1e-6 (the order differs), gathers and layouts bit for bit.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.comm import Communicator as JComm
from repro.core import shared_buffer as jsb
from repro.models import layers as jlayers
from repro.models import meta as jmeta
from repro.models import parallel as jparallel
from repro.models.parallel import ParallelCtx as JCtx
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.runtime.steps import cluster_ctx as jcluster_ctx
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.comm import Communicator, WindowEpochError
from repro_torch.core import shared_buffer as sb
from repro_torch.core import tree as T
from repro_torch.models import layers, meta, parallel
from repro_torch.models.parallel import ParallelCtx, ParamGroup
from repro_torch.optim import adamw
from repro_torch.optim import compression
from repro_torch.runtime.steps import cluster_ctx
from repro_torch.substrate import P, VirtualCluster
from repro_torch.substrate import collectives as coll

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
LABELS = ["2x4", "4x2", "1x8", "8x1"]


def _pair(label):
    pods, chips = (int(x) for x in label.split("x"))
    return (JVC(pods=pods, chips=chips),
            VirtualCluster(pods=pods, chips=chips, device="cpu"))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# reduce_grads
# ---------------------------------------------------------------------------

# (local shape, fsdp_dim): sharded leaves and a leaf stored replicated
LEAVES = {"a": ((6, 4), 0), "b": ((8,), 0), "c": ((3, 5), None)}


def _grads(R, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(R,) + shp).astype(np.float32)
            for k, (shp, _) in LEAVES.items()}


def _metas(mod):
    return [mod.PMeta(shp, fsdp_dim=d) for shp, d in
            (LEAVES[k] for k in sorted(LEAVES))]


def _jreduce(jvc, ctx, grads, **kw):
    """The reference's reduce_grads over rank-major leaves (a (R, ...) leaf
    is each rank's local value).  An ``error_state`` is given as (R, ...)
    arrays shaped like the grads; the new residuals come back after the
    sums, broadcast to the grads' shapes."""
    keys = sorted(grads)
    errs = kw.pop("error_state", None)
    recorder = kw.pop("recorder", False)
    metas = _metas(jmeta) if kw.pop("metas", True) else None

    def body(*xs):
        tree = {k: x[0] for k, x in zip(keys, xs)}
        kk = dict(kw)
        if errs is not None:
            kk["error_state"] = {k: x[0] for k, x in
                                 zip(keys, xs[len(keys):])}
        if recorder:
            rec = JComm.from_cluster(jvc).record()
            out = ctx.reduce_grads(tree, metas, recorder=rec, **kk)
            out = rec.run().resolve(out)
        else:
            out = ctx.reduce_grads(tree, metas, **kk)
        if errs is None:
            return tuple(out[k][None] for k in keys)
        out, new = out
        return tuple(out[k][None] for k in keys) + tuple(
            jnp.broadcast_to(new[k], out[k].shape)[None] for k in keys)

    args = [grads[k] for k in keys]
    if errs is not None:
        args += [errs[k] for k in keys]
    spec = JP(jvc.axis_names)
    n_out = len(keys) * (1 if errs is None else 2)
    outs = jax.jit(jvc.smap(body, (spec,) * len(args), (spec,) * n_out))(
        *[jnp.asarray(a) for a in args])
    return [np.asarray(o) for o in outs]


def _treduce(vc, ctx, grads, **kw):
    tree = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    with vc.bind():
        if kw.pop("recorder", None):
            rec = Communicator.from_cluster(vc).record()
            out = ctx.reduce_grads(tree, _metas(meta), recorder=rec, **kw)
            out = rec.run().resolve(out)
        else:
            out = ctx.reduce_grads(tree, _metas(meta) if kw.pop(
                "metas", True) else None, **kw)
    return out


@pytest.mark.parametrize("mode", ["hier", "naive"])
@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("form", ["metas", "recorder", "legacy"])
def test_reduce_grads_exact_matches_reference(label, mode, form):
    jvc, vc = _pair(label)
    jctx, ctx = jcluster_ctx(jvc, mode=mode), cluster_ctx(vc, mode=mode)
    grads = _grads(vc.num_devices)
    kw = {"recorder": True} if form == "recorder" else (
        {"metas": False} if form == "legacy" else {})
    want = _jreduce(jvc, jctx, grads, **kw)
    got = _treduce(vc, ctx, grads, **kw)
    for k, w in zip(sorted(grads), want):
        np.testing.assert_allclose(_np(got[k]), w, **SUM_TOL,
                                   err_msg=f"{label} {mode} {form} {k}")


@pytest.mark.parametrize("label", ["2x4", "4x2"])
def test_reduce_grads_lossy_with_error_feedback_matches_reference(label):
    """Two rounds of the lossy bridge with residuals carried: the sums and
    the new residuals agree (the codes are the reference's, so the sums
    differ only in order)."""
    jvc, vc = _pair(label)
    jctx, ctx = jcluster_ctx(jvc), cluster_ctx(vc)
    keys = sorted(LEAVES)
    zeros = _grads(vc.num_devices)
    errs_j = {k: np.zeros_like(zeros[k]) for k in keys}
    errs_t = {k: torch.zeros(()) for k in keys}
    for rnd in range(2):
        grads = _grads(vc.num_devices, seed=10 + rnd)
        outs = _jreduce(jvc, jctx, grads, precision="lossy",
                        error_state=errs_j)
        got, new_t = _treduce(vc, ctx, grads, precision="lossy",
                              error_state=errs_t)
        for i, k in enumerate(keys):
            np.testing.assert_allclose(_np(got[k]), outs[i], **SUM_TOL)
            np.testing.assert_allclose(
                np.broadcast_to(_np(new_t[k]), outs[len(keys) + i].shape),
                outs[len(keys) + i], **SUM_TOL)
        errs_j = {k: outs[len(keys) + i] for i, k in enumerate(keys)}
        errs_t = {k: new_t[k] for k in keys}


@pytest.mark.parametrize("label", ["2x4", "1x8"])
@pytest.mark.parametrize("legacy", [False, True])
def test_reduce_grads_lossy_without_state_matches_reference(label, legacy):
    jvc, vc = _pair(label)
    jctx, ctx = jcluster_ctx(jvc), cluster_ctx(vc)
    grads = _grads(vc.num_devices, seed=4)
    kw = dict(precision="lossy", **({"metas": False} if legacy else {}))
    want = _jreduce(jvc, jctx, grads, **kw)
    got = _treduce(vc, ctx, grads, **kw)
    for k, w in zip(sorted(grads), want):
        np.testing.assert_allclose(_np(got[k]), w, **SUM_TOL)


def test_reduce_grads_compress_hook_and_errors():
    jvc, vc = _pair("2x4")
    ctx = cluster_ctx(vc)
    grads = _grads(8)
    seen = []

    def compress(g, axes):
        seen.append(axes)
        return coll.psum(g, axes)

    got = _treduce(vc, ctx, grads, compress=compress)
    want = _jreduce(jvc, jcluster_ctx(jvc), grads)
    for k, w in zip(sorted(grads), want):
        np.testing.assert_allclose(_np(got[k]), w, **SUM_TOL)
    assert seen == [ctx.grad_reduce_axes(m) for m in _metas(meta)]
    with pytest.raises(ValueError, match="lossy"):
        _treduce(vc, ctx, grads, error_state={k: torch.zeros(())
                                              for k in grads})
    with pytest.raises(ValueError, match="hier bridge"):
        _treduce(vc, cluster_ctx(vc, mode="naive"), grads, metas=False,
                 precision="lossy",
                 error_state={k: torch.zeros(()) for k in grads})


@pytest.mark.parametrize("label", LABELS)
def test_ctx_axes_and_communicators_match_reference(label):
    jvc, vc = _pair(label)
    for mode in ("hier", "naive"):
        j, t = jcluster_ctx(jvc, mode=mode), cluster_ctx(vc, mode=mode)
        assert (t.fsdp_axes, t.dp_axes, t.pod_axis) == \
            (j.fsdp_axes, j.dp_axes, j.pod_axis)
        for jm, tm in zip(_metas(jmeta), _metas(meta)):
            assert t.grad_reduce_axes(tm) == j.grad_reduce_axes(jm)
            axes = t.grad_reduce_axes(tm)
            if axes:
                tc, jc = t._axes_comm(axes), j._axes_comm(axes)
                assert (tc.fast_axis, tc.slow_axis) == \
                    (jc.fast_axis, jc.slow_axis)
        tc, jc = t.comm, j.comm
        assert (tc.fast_axis, tc.slow_axis) == (jc.fast_axis, jc.slow_axis)
    # the factored fast tier: its last axis is tensor-parallel
    jvc = JVC(pods=2, chips=4, fast_axis=("dp", "tp"), fast_shape=(2, 2))
    vc = VirtualCluster.from_label("2x(2x2)", device="cpu")
    for mode in ("hier", "naive"):
        j, t = jcluster_ctx(jvc, mode=mode), cluster_ctx(vc, mode=mode)
        assert (t.tp_axis, t.tp, t.fsdp_axes, t.dp_axes, t.pod_axis) == \
            (j.tp_axis, j.tp, j.fsdp_axes, j.dp_axes, j.pod_axis)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

def _vjp_case(name):
    """(reference fn, port fn) of one rank-local value, over 'data'."""
    if name == "all_gather":
        return (lambda x: lax.all_gather(x, "data", axis=1, tiled=True),
                lambda x: coll.all_gather(x, "data", axis=1))
    if name == "all_gather_stacked":
        return (lambda x: lax.all_gather(x, "data", axis=1, tiled=False),
                lambda x: coll.all_gather(x, "data", axis=1, tiled=False))
    if name == "psum_scatter":
        return (lambda x: lax.psum_scatter(x, "data", scatter_dimension=0,
                                           tiled=True),
                lambda x: coll.psum_scatter(x, "data", scatter_dimension=0))
    if name == "psum":
        return (lambda x: lax.psum(x, ("pod", "data")),
                lambda x: coll.psum(x, ("pod", "data")))
    if name == "window_read":
        return (lambda x: JComm(fast_axis="data", slow_axis="pod").window(
                    x, axis=0, epoch=1).read(),
                lambda x: Communicator(fast_axis="data", slow_axis="pod")
                .window(x, axis=0, epoch=1).read())
    raise ValueError(name)


@pytest.mark.parametrize("name", ["all_gather", "all_gather_stacked",
                                  "psum_scatter", "psum", "window_read"])
def test_collective_gradients_match_reference_vjp(name):
    jvc, vc = _pair("2x4")
    jf, tf = _vjp_case(name)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 4, 3)).astype(np.float32)      # (R, 4, 3)
    out_shape = jax.eval_shape(
        lambda v: jvc.smap(jf, (JP(jvc.axis_names),), JP(jvc.axis_names))(v),
        jax.ShapeDtypeStruct((8 * 4, 3), jnp.float32)).shape
    ct = rng.normal(size=(8,) + (out_shape[0] // 8,)
                    + out_shape[1:]).astype(np.float32)

    def body(xl, cl):
        _, vjp = jax.vjp(jf, xl)
        return vjp(cl)[0]

    spec = JP(jvc.axis_names)
    want = jax.jit(jvc.smap(body, (spec, spec), spec))(
        jnp.asarray(x.reshape(32, 3)), jnp.asarray(ct.reshape(
            (-1,) + ct.shape[2:])))
    xt = torch.from_numpy(x).requires_grad_(True)
    with vc.bind():
        y = tf(xt)
        (got,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    np.testing.assert_allclose(_np(got).reshape(32, 3), np.asarray(want),
                               **SUM_TOL)


def test_node_read_is_one_copy_and_splits_its_gradient():
    """The per-domain window read: a node's members joined once; its
    gradient is the split into the members' shards."""
    shards = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 3)
    shards.requires_grad_(True)
    full = Communicator(fast_axis="data").window(shards, axis=1,
                                                 epoch=1).read_node()
    assert torch.equal(full, torch.cat(list(shards.detach()), dim=1))
    ct = torch.randn_like(full)
    (g,) = torch.autograd.grad(full, shards, ct)
    assert torch.equal(g, torch.stack(ct.split(3, dim=1)))
    dirty = Communicator(fast_axis="data").window(shards, epoch=1).store(
        shards)
    with pytest.raises(WindowEpochError):
        dirty.read_node()


# ---------------------------------------------------------------------------
# streamed cross-entropy, AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,softcap", [(8, None), (5, 30.0), (64, None)])
def test_unembed_xent_and_its_gradient_match_reference(chunk, softcap):
    rng = np.random.default_rng(2)
    B, T, d, V = 2, 24, 16, 40
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, size=(B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)

    def jf(x_, w_):
        return jlayers.unembed_xent(x_, jnp.asarray(labels),
                                    jnp.asarray(mask), w_, JCtx.single(),
                                    chunk=chunk, softcap=softcap)

    jgx, jgw = jax.grad(lambda a, b: jf(a, b)[0], argnums=(0, 1))(x, w)
    jl, jc = jf(x, w)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    tl, tc = layers.unembed_xent(xt, torch.from_numpy(labels),
                                 torch.from_numpy(mask), wt,
                                 ParallelCtx.single(), chunk=chunk,
                                 softcap=softcap)
    gx, gw = torch.autograd.grad(tl, (xt, wt))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tc) == float(jc)
    np.testing.assert_allclose(_np(gx), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(_np(gw), np.asarray(jgw), rtol=1e-4,
                               atol=1e-6)
    rows, counts = layers.unembed_xent_rows(
        xt.detach(), torch.from_numpy(labels), torch.from_numpy(mask),
        wt.detach(), ParallelCtx.single(), chunk=chunk, softcap=softcap)
    np.testing.assert_allclose(float(rows.sum()), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(_np(counts), mask.sum(1))


def test_adamw_matches_reference():
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 4), "b": (4,), "u": {"x": (2, 3)}}

    def tree(f):
        return jax.tree.map(f, shapes, is_leaf=lambda x: isinstance(x, tuple))

    p, g, m, v = (tree(lambda s: rng.normal(size=s).astype(np.float32))
                  for _ in range(4))
    v = jax.tree.map(np.abs, v)
    jout = jadamw.adamw_update(p, g, m, v, jnp.int32(3), lr=3e-4,
                               weight_decay=0.1)
    conv = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    tout = adamw.adamw_update(conv(p), conv(g), conv(m), conv(v), 3,
                              lr=3e-4, weight_decay=0.1)
    for jt, tt in zip(jout, tout):
        for a, b in zip(jax.tree.leaves(jt), T.leaves(tt)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-8)
    # the donated form: the same bits, stored over the stacked state
    st = {k: conv({kk: np.stack([vv] * 2) for kk, vv in x.items()})
          for k, x in (("p", {"w": p["w"]}), ("g", {"w": g["w"]}),
                       ("m", {"w": m["w"]}), ("v", {"w": v["w"]}))}
    adamw.adamw_update_(st["p"], st["g"], st["m"], st["v"],
                        torch.tensor([3, 3]), lr=3e-4, weight_decay=0.1)
    assert torch.equal(st["p"]["w"][1], tout[0]["w"])
    assert torch.equal(st["v"]["w"][0], tout[2]["w"])
    jm, jv = jadamw.adamw_init(p)
    tm, tv = adamw.adamw_init(conv(p))
    assert all(not t.any() and t.dtype == torch.float32
               for t in T.leaves(tm) + T.leaves(tv))
    assert len(T.leaves(tm)) == len(jax.tree.leaves(jm))


def test_cosine_schedule_matches_reference():
    jf, tf = jadamw.cosine_schedule(3e-4, 10, 100), \
        adamw.cosine_schedule(3e-4, 10, 100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tf(s)), float(jf(s)), rtol=1e-6)


# ---------------------------------------------------------------------------
# sharded metadata, layouts, shims
# ---------------------------------------------------------------------------

def _spec_tuple(s):
    return tuple(s)


@pytest.mark.parametrize("data", [1, 2, 4, 8, 3])
@pytest.mark.parametrize("mode", ["hier", "naive"])
def test_param_specs_and_fsdp_dims_match_reference(data, mode):
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64)
    cfg = configs.get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64)
    for serve in (False, True):
        jd = jmeta.model_defs(jcfg, 1, data, mode, serve=serve)
        td = meta.model_defs(cfg, 1, data, mode, serve=serve)
        jl = jax.tree.leaves(jd, is_leaf=lambda x: isinstance(x,
                                                              jmeta.PMeta))
        tl = T.leaves(td)
        assert [m.fsdp_dim for m in tl] == [m.fsdp_dim for m in jl]
        assert [m.shape for m in tl] == [m.shape for m in jl]
    js = jmeta.param_specs(jd, jcfg, tp_axis=None, fsdp_axis="data")
    ts = meta.param_specs(td, cfg, tp_axis=None, fsdp_axis="data")
    assert [_spec_tuple(s) for s in T.leaves(ts)] == [
        _spec_tuple(s) for s in jax.tree.leaves(
            js, is_leaf=lambda x: isinstance(x, JP))]
    ab = meta.abstract_params(td, cfg, ts)
    jab = jmeta.abstract_params(jd, jcfg, js)
    for a, b in zip(T.leaves(ab), jax.tree.leaves(jab)):
        assert a.device.type == "meta" and tuple(a.shape) == b.shape
    # tp = 2: the tp dims and the specs over both axes (train layout)
    jd = jmeta.model_defs(jcfg, 2, data, mode)
    td = meta.model_defs(cfg, 2, data, mode)
    jl = jax.tree.leaves(jd, is_leaf=lambda x: isinstance(x, jmeta.PMeta))
    assert [(m.tp_dim, m.fsdp_dim) for m in T.leaves(td)] == \
        [(m.tp_dim, m.fsdp_dim) for m in jl]
    js = jmeta.param_specs(jd, jcfg, tp_axis="model", fsdp_axis="data")
    ts = meta.param_specs(td, cfg, tp_axis="model", fsdp_axis="data")
    assert [_spec_tuple(s) for s in T.leaves(ts)] == [
        _spec_tuple(s) for s in jax.tree.leaves(
            js, is_leaf=lambda x: isinstance(x, JP))]


def test_shared_buffer_helpers_match_reference():
    for shape, n, skip in (((8, 12), 4, ()), ((6, 6), 4, ()),
                           ((3, 8, 16), 8, (2,)), ((5,), 2, ())):
        assert sb.choose_shard_dim(shape, n, skip) == \
            jsb.choose_shard_dim(shape, n, skip)
    x = np.arange(48).reshape(4, 12)
    for dim in (None, 0, 1):
        np.testing.assert_array_equal(
            sb.shard_slice(torch.from_numpy(x), 1, 2, dim).numpy(),
            np.asarray(jsb.shard_slice(x, 1, 2, dim)))
    jvc, vc = _pair("2x4")
    rng = np.random.default_rng(6)
    a = rng.normal(size=(8 * 2, 8)).astype(np.float32)
    spec = JP(jvc.axis_names)
    for fn, tfn in ((jsb.fsdp_gather, sb.fsdp_gather),
                    (jsb.fsdp_scatter, sb.fsdp_scatter)):
        for dim in (None, 1):
            want = jax.jit(jvc.smap(lambda v: fn(v, dim, "data")[None],
                                    (spec,), spec))(jnp.asarray(a))
            got = vc.run(lambda v: tfn(v, dim, "data")[:, None], a)
            np.testing.assert_allclose(
                _np(got).reshape(np.asarray(want).shape), np.asarray(want),
                **SUM_TOL)


def test_compression_shims_warn_and_match_reference():
    jvc, vc = _pair("2x4")
    rng = np.random.default_rng(8)
    g = rng.normal(size=(8, 300)).astype(np.float32)
    spec = JP(jvc.axis_names)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jax.jit(jvc.smap(lambda v: jcomp.int8_bridge_psum(
            v[0], ("pod",))[None], (spec,), spec))(jnp.asarray(g))
        jinit, jleaf = jcomp.make_error_feedback({"g": jnp.zeros((300,))})
        want_ef = jax.jit(jvc.smap(lambda v: tuple(
            o[None] for o in jleaf(v[0], jnp.float32(0.0), ("pod",))),
            (spec,), (spec, spec)))(jnp.asarray(g))
    with pytest.warns(DeprecationWarning):
        got = vc.run(lambda v: compression.int8_bridge_psum(
            v[:, 0], ("pod",))[:, None], g[:, None])
    with pytest.warns(DeprecationWarning):
        init, leaf = compression.make_error_feedback(
            {"g": torch.zeros(300)})
    assert not init()["g"].any()
    with vc.bind():
        tot, err = leaf(torch.from_numpy(g), torch.zeros(()), ("pod",))
    np.testing.assert_allclose(_np(got).reshape(8, 300), np.asarray(want),
                               **SUM_TOL)
    np.testing.assert_allclose(_np(tot), np.asarray(want_ef[0]), **SUM_TOL)
    np.testing.assert_allclose(_np(err), np.asarray(want_ef[1]), **SUM_TOL)


@pytest.mark.parametrize("spec", [P(), P("data"), P(("pod", "data")),
                                  P(None, "pod"), P("pod", "data")])
def test_smap_lays_out_like_shard_map(spec):
    jvc, vc = _pair("2x4")
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    jspec = JP(*spec)

    def jbody(v):
        return v * (lax.axis_index(("pod", "data")) + 1).astype(v.dtype)

    def tbody(v):
        r = coll.axis_index(("pod", "data")) + 1
        return v * r.reshape((-1,) + (1,) * (v.dim() - 1)).to(v.dtype)

    want = jax.jit(jvc.smap(jbody, (jspec,), jspec))(jnp.asarray(x))
    got = vc.smap(tbody, (spec,), spec)(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    laid = vc.layout({"x": torch.from_numpy(x)}, {"x": spec})
    assert torch.equal(vc.unlayout(laid, {"x": spec})["x"],
                       torch.from_numpy(x))


# ---------------------------------------------------------------------------
# the prefetcher
# ---------------------------------------------------------------------------

def test_prefetch_schedule_matches_reference():
    for n in range(0, 6):
        for budget in (0, 1, 2, 3, 7):
            assert parallel.prefetch_schedule(n, budget) == \
                jparallel.prefetch_schedule(n, budget)


def test_param_group_lifecycle_and_torn_windows():
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    ctx = cluster_ctx(vc, opts=("prefetch",))
    assert ctx.prefetch == 2 and cluster_ctx(vc).prefetch == 0
    # one node's members: its 4 shards of w, its one copy of s
    params = {"w": torch.randn(4, 3, 5), "s": torch.randn(7)}
    metas = {"w": meta.PMeta((12, 5), fsdp_dim=0),
             "s": meta.PMeta((7,), fsdp_dim=None)}
    with vc.bind():
        grp = ParamGroup(ctx, params, metas)
        assert grp.state == "sharded"
        with pytest.raises(RuntimeError, match="before unshard"):
            grp.wait()
        grp.unshard()
        assert grp.state == "in_flight"
        full = grp.wait()
        assert grp.state == "unsharded"
        want = Communicator(fast_axis="data", slow_axis="pod").window(
            params["w"], axis=0, epoch=1).read_node()
        assert full["w"].shape == (12, 5)
        assert torch.equal(full["w"], want)
        assert torch.equal(full["s"], params["s"])
        grp.reshard()
        assert grp.state == "sharded"
        grp.unshard()
        win = grp._handles["w"].window
        object.__setattr__(grp._handles["w"], "window", win.store(win.shard))
        with pytest.raises(WindowEpochError, match="torn"):
            grp.wait()
    out = parallel.prefetch_walk(
        [ParamGroup(ParallelCtx.single(), {"x": torch.ones(2)},
                    {"x": meta.PMeta((2,))}) for _ in range(3)],
        lambda acc, k, full: acc + k * full["x"], torch.zeros(2), 2)
    assert torch.equal(out, torch.full((2,), 3.0))


# ---------------------------------------------------------------------------
# scheme="auto" on a per-rank scalar (the step's loss / count / grad norm)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", LABELS)
def test_auto_psum_of_a_per_rank_scalar_picks_a_scheme_that_takes_it(label):
    """The committed table may rank a split scheme first for one element
    (pipelined at 8x1); auto skips every scheme whose payload needs a dim
    and the flat sum serves."""
    from repro_torch.comm import registry, tuning
    vc = _pair(label)[1]
    comm = Communicator.from_cluster(vc)
    res = tuning.resolve_for(comm, "psum", elems=1,
                             result_class="replicated", payload_dims=0)
    assert registry.get_scheme(res.scheme).min_payload_dims("psum") == 0
    x = torch.arange(8, dtype=torch.float32)
    with vc.bind():
        got = comm.allreduce(x, result="replicated")
    assert torch.equal(got, torch.full((8,), 28.0))
