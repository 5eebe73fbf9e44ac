"""The tensor-parallel pieces of training held against the JAX reference.

On the factored cluster ``2x(2x2)`` (and ``2x(1x4)`` for the grouped forms,
two subgroups of 2 in each tp group of 4): every tp collective of
``ParallelCtx`` (``ag_tokens``, ``rs_tokens``, ``psum_tp``, ``pmax_tp``,
``group_all_gather``, ``group_psum``, ``matmul_rs`` with the ``overlap``
stream) and its gradient against ``jax.vjp`` of the reference's inside
``shard_map``; the vocab-parallel ``embed`` (sequence-parallel and not)
and ``unembed_xent`` with their gradients; ``grad_reduce_axes`` and the
parameter specs for every leaf of the reduced configs in both modes; the
step's ``prefetch`` (bit-identical) and ``overlap`` options at tp 2; the
topology labels and the launcher on ``2x(2x2)``.  Sums agree within rtol
1e-5 / atol 1e-6 (the order differs), gathers bit for bit.
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import meta as jmeta
from repro.models.parallel import ParallelCtx as JCtx
from repro.runtime.steps import cluster_ctx as jcluster_ctx
from repro.runtime.steps import make_cluster_train_step as jmake
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.core import tree as T
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, meta
from repro_torch.models.parallel import ParallelCtx
from repro_torch.runtime.steps import cluster_ctx, make_cluster_train_step
from repro_torch.substrate import VirtualCluster, default_matrix

SUM_TOL = dict(rtol=1e-5, atol=1e-6)
F32 = dict(compute_dtype=jnp.float32)


def _pair(fast_shape=(2, 2)):
    chips = fast_shape[0] * fast_shape[1]
    kw = dict(pods=2, chips=chips, fast_axis=("dp", "tp"),
              fast_shape=fast_shape, slow_axis="pod")
    return JVC(**kw), VirtualCluster(device="cpu", **kw)


def _ctxs(tp, opts=()):
    return (JCtx(tp_axis="tp", tp=tp, opts=frozenset(opts), **F32),
            ParallelCtx(tp_axis="tp", tp=tp, opts=frozenset(opts),
                        compute_dtype=torch.float32))


def _flat(a):
    return a.reshape((-1,) + a.shape[2:])


# ---------------------------------------------------------------------------
# the tp collectives and their gradients
# ---------------------------------------------------------------------------

def _tp_case(name, j, t):
    """(reference fn, port fn, local input shape) of one rank's value."""
    return {
        "ag_tokens": (j.ag_tokens, t.ag_tokens, (2, 3, 4)),
        "ag_tokens_dim2": (lambda x: j.ag_tokens(x, dim=2),
                           lambda x: t.ag_tokens(x, dim=2), (2, 3, 4)),
        "rs_tokens": (j.rs_tokens, t.rs_tokens, (2, 4, 3)),
        "psum_tp": (j.psum_tp, t.psum_tp, (3, 5)),
        "pmax_tp": (j.pmax_tp, t.pmax_tp, (3, 5)),
        "group_all_gather": (
            lambda x: j.group_all_gather(x, group=2, dim=1),
            lambda x: t.group_all_gather(x, group=2, dim=1), (3, 2)),
        "group_psum": (lambda x: j.group_psum(x, group=2),
                       lambda x: t.group_psum(x, group=2), (3, 2)),
    }[name]


@pytest.mark.parametrize("name,fast_shape", [
    (n, s) for n in ("ag_tokens", "ag_tokens_dim2", "rs_tokens", "psum_tp",
                     "pmax_tp") for s in ((2, 2), (1, 4))]
    + [("group_all_gather", (1, 4)), ("group_psum", (1, 4))])
def test_tp_collectives_and_gradients_match_reference_vjp(name, fast_shape):
    jvc, vc = _pair(fast_shape)
    j, t = _ctxs(fast_shape[1])
    jf, tf, shape = _tp_case(name, j, t)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(vc.num_devices,) + shape).astype(np.float32)
    spec = JP(jvc.axis_names)
    want = np.asarray(jax.jit(jvc.smap(jf, (spec,), spec))(_flat(x)))
    ct = rng.normal(size=want.shape).astype(np.float32)

    def body(xl, cl):
        _, vjp = jax.vjp(jf, xl)
        return vjp(cl)[0]

    want_g = jax.jit(jvc.smap(body, (spec, spec), spec))(_flat(x), ct)
    xt = torch.from_numpy(x).requires_grad_(True)
    with vc.bind():
        y = tf(xt)
        (g,) = torch.autograd.grad(y, xt, torch.from_numpy(
            ct.reshape(y.shape)))
    np.testing.assert_allclose(_flat(y.detach().numpy()), want, **SUM_TOL)
    np.testing.assert_allclose(_flat(g.numpy()), np.asarray(want_g),
                               **SUM_TOL)


@pytest.mark.parametrize("overlap", [False, True])
def test_matmul_rs_and_its_gradient_match_reference(overlap):
    """``rs_tokens(x @ w)``, with the ``overlap`` opt streamed through
    ``Communicator(fast_axis=tp).matmul_rs`` (2 panels)."""
    jvc, vc = _pair()
    j, t = _ctxs(2, ("overlap",) if overlap else ())
    rng = np.random.default_rng(3)
    R = vc.num_devices
    x = rng.normal(size=(R, 2, 8, 6)).astype(np.float32)
    w = rng.normal(size=(R, 6, 5)).astype(np.float32)
    ct = rng.normal(size=(R, 2, 4, 5)).astype(np.float32)
    spec = JP(jvc.axis_names)

    def body(xl, wl, cl):
        y, vjp = jax.vjp(j.matmul_rs, xl, wl)
        return (y,) + vjp(cl)

    want = jax.jit(jvc.smap(body, (spec,) * 3, (spec,) * 3))(
        _flat(x), _flat(w), _flat(ct))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    with vc.bind():
        y = t.matmul_rs(xt, wt)
        got = (y,) + torch.autograd.grad(y, (xt, wt), torch.from_numpy(ct))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_flat(a.detach().numpy()), np.asarray(b),
                                   **SUM_TOL)


# ---------------------------------------------------------------------------
# vocab-parallel embedding and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [True, False])
def test_vocab_parallel_embed_and_its_gradient_match_reference(sp):
    jvc, vc = _pair()
    j, t = _ctxs(2)
    rng = np.random.default_rng(5)
    R, B, T_, V_loc, d = vc.num_devices, 2, 6, 5, 4
    # ids past both shards and below 0 give zero rows
    ids = rng.integers(-1, 2 * V_loc + 1, size=(R, B, T_)).astype(np.int32)
    emb = rng.normal(size=(R, V_loc, d)).astype(np.float32)
    spec = JP(jvc.axis_names)

    def body(il, el):
        y, vjp = jax.vjp(lambda e: jlayers.embed(il, e, j, sp=sp), el)
        return y, vjp(jnp.ones_like(y) * jnp.arange(y.shape[-1]))[0]

    want_y, want_g = jax.jit(jvc.smap(body, (spec, spec), (spec, spec)))(
        _flat(ids), _flat(emb))
    et = torch.from_numpy(emb).requires_grad_(True)
    with vc.bind():
        y = layers.embed(torch.from_numpy(ids).long(), et, t, sp=sp)
        (g,) = torch.autograd.grad(y, et, torch.ones_like(y)
                                   * torch.arange(y.shape[-1]))
    assert y.shape[-2] == (T_ // 2 if sp else T_)
    np.testing.assert_allclose(_flat(y.detach().numpy()),
                               np.asarray(want_y), **SUM_TOL)
    np.testing.assert_allclose(_flat(g.numpy()), np.asarray(want_g),
                               **SUM_TOL)


@pytest.mark.parametrize("chunk,softcap", [(5, None), (4, 30.0), (64, None)])
def test_vocab_parallel_unembed_xent_and_its_gradients_match_reference(
        chunk, softcap):
    jvc, vc = _pair()
    j, t = _ctxs(2)
    rng = np.random.default_rng(6)
    R, B, T_, d, V_loc = vc.num_devices, 2, 12, 8, 10
    x = rng.normal(size=(R, B, T_ // 2, d)).astype(np.float32)
    w = (rng.normal(size=(R, d, V_loc)) * 0.3).astype(np.float32)
    # labels and mask are the full sequence, the same on both tp ranks
    labels = np.repeat(rng.integers(-1, 2 * V_loc, size=(R // 2, B, T_)),
                       2, axis=0).astype(np.int32)
    mask = np.repeat((rng.random((R // 2, B, T_)) > 0.2), 2,
                     axis=0).astype(np.float32)
    spec = JP(jvc.axis_names)

    def body(xl, wl, ll, ml):
        def f(a, b):
            return jlayers.unembed_xent(a, ll, ml, b, j, chunk=chunk,
                                        softcap=softcap)
        (loss, cnt), vjp = jax.vjp(f, xl, wl)
        gx, gw = vjp((jnp.float32(1.0), jnp.float32(0.0)))
        return loss[None], cnt[None], gx, gw

    want = jax.jit(jvc.smap(body, (spec,) * 4, (spec,) * 4))(
        _flat(x), _flat(w), _flat(labels), _flat(mask))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    with vc.bind():
        loss, cnt = layers.unembed_xent(
            xt, torch.from_numpy(labels), torch.from_numpy(mask), wt, t,
            chunk=chunk, softcap=softcap)
        gx, gw = torch.autograd.grad(loss.sum(), (xt, wt))
    for a, b in zip((loss, cnt, gx, gw), want):
        np.testing.assert_allclose(_flat(a.detach().numpy()[:, None])
                                   if a.dim() == 1 else _flat(a.numpy()),
                                   np.asarray(b), **SUM_TOL)


# ---------------------------------------------------------------------------
# metadata: reduction axes and specs of every leaf
# ---------------------------------------------------------------------------

CFGS = {"head_tp": ("qwen3-0.6b", {}),
        "irregular-kv-map": ("qwen3-0.6b", dict(n_heads=6, n_kv=3,
                                                d_model=48)),
        "cp": ("qwen3-0.6b", dict(n_heads=3, d_model=48)),
        "rglru": ("recurrentgemma-9b", {})}


@pytest.mark.parametrize("mode", ["hier", "naive"])
@pytest.mark.parametrize("case", list(CFGS))
def test_grad_reduce_axes_and_specs_match_reference(case, mode):
    name, kw = CFGS[case]
    jcfg = jconfigs.get_config(name).reduced(**kw)
    cfg = configs.get_config(name).reduced(**kw)
    jvc, vc = _pair()
    jc, tc = jcluster_ctx(jvc, mode=mode), cluster_ctx(vc, mode=mode)
    jd = jmeta.model_defs(jcfg, 2, 2, mode)
    td = meta.model_defs(cfg, 2, 2, mode)
    jl = jax.tree.leaves(jd, is_leaf=lambda m: isinstance(m, jmeta.PMeta))
    tl = T.leaves(td)
    assert [(m.shape, m.tp_dim, m.fsdp_dim) for m in tl] == \
        [(m.shape, m.tp_dim, m.fsdp_dim) for m in jl]
    assert [tc.grad_reduce_axes(m) for m in tl] == \
        [jc.grad_reduce_axes(m) for m in jl]
    assert any(tc.tp_axis in tc.grad_reduce_axes(m) for m in tl)
    jspecs = jmake(jcfg, jvc, mode=mode).state_specs["params"]
    tspecs = make_cluster_train_step(cfg, vc, mode=mode).state_specs[
        "params"]
    assert [tuple(s) for s in T.leaves(tspecs)] == [
        tuple(s) for s in jax.tree.leaves(
            jspecs, is_leaf=lambda s: isinstance(s, JP))]


# ---------------------------------------------------------------------------
# the step's options at tp 2, topology labels, the launcher
# ---------------------------------------------------------------------------

def _one_step(cfg, vc, opts):
    bundle = make_cluster_train_step(cfg, vc, mode="hier", global_batch=8,
                                     opts=opts)
    state = bundle.init_layout_state(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(8, 17))
    state, m = bundle.step(state, bundle.layout_batch({"tokens": toks}))
    return state, m


def test_prefetch_and_overlap_keep_the_tp_step():
    """``prefetch`` (the window reads of unit k+1 issued while unit k runs,
    one window per tp rank) gives the same bits; ``overlap`` (the output
    projection's reduce-scatter streamed in panels) the same step within
    rounding."""
    cfg = configs.get_config("qwen3-0.6b").reduced()
    vc = VirtualCluster.from_label("2x(2x2)", device="cpu")
    base, mb = _one_step(cfg, vc, ())
    pre, mp = _one_step(cfg, vc, ("prefetch",))
    ovl, mo = _one_step(cfg, vc, ("overlap",))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(base),
                                                 T.leaves(pre)))
    assert torch.equal(mb["loss"], mp["loss"])
    for a, b in zip(T.leaves(base), T.leaves(ovl)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(mb["gnorm"], mo["gnorm"], rtol=1e-5,
                               atol=0)


def test_topology_labels_round_trip_and_reject_bad_ones():
    for vc in default_matrix(device="cpu"):
        assert VirtualCluster.from_label(vc.label, device="cpu") == vc
    vc = VirtualCluster.from_label("1x(1x8)", device="cpu")
    assert (vc.fast_names, vc.fast_shape, vc.slow_names) == \
        (("dp", "tp"), (1, 8), ())
    for bad in ("2x", "2x(2x2x2)", "2x(2x2)-pod.dp", "x4"):
        with pytest.raises(ValueError):
            VirtualCluster.from_label(bad, device="cpu")


def test_launcher_trains_on_the_factored_cluster():
    out = io.StringIO()
    with redirect_stdout(out):
        assert launch_train.main(["--reduced", "--device", "cpu",
                                  "--topology", "2x(2x2)", "--steps", "2",
                                  "--seq", "16", "--mode", "naive"]) == 0
    text = out.getvalue()
    assert "naive on 2x(2x2)-pod.dp.tp" in text and "[train] step 2" in text
    assert "(4 replicas of each of 2 tp shards)" in text
