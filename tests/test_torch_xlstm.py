"""The port's xLSTM blocks held against the JAX reference on the CPU, at tp 1.

``repro_torch.models.xlstm`` against ``repro.models.xlstm`` with the same
numpy-seeded inputs and the reference's ``init_params(0)`` carried across
by ``convert``: the chunkwise ``mlstm_parallel`` (T 256 in chunks of 128,
with and without its final state; the port's cross-chunk prefix is a loop,
the reference's an associative scan, so they agree at the f32 tolerance),
a ragged T of 223 (the reference asserts T % chunk == 0, so it is held to
the reference's one-chunk form, valid for any T), ``mlstm_decode_step``,
``slstm_cell``, both blocks' prefill and decode and their gradients
against ``jax.grad``, and the reduced ``xlstm-1.3b`` (one unit: 7 mLSTM +
1 sLSTM, d 64, 4 heads) end to end: the loss and its gradients, prefill
and per-slot decode, decode continuing a prefill, and a prompt shorter
than the conv.  ``F32_TOL`` is the reference's rtol 2e-4 (atol 2e-4).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import make_batch as jmake_batch
from repro.models import meta as jmeta
from repro.models import xlstm as jx
from repro.models.parallel import ParallelCtx as JCtx
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import ParallelCtx, build, build_by_name, meta, xlstm
from repro_torch.models.transformer import MLSTM_CHUNK

F32_TOL = dict(rtol=2e-4, atol=2e-4)
JCTX, CTX = JCtx.single(), ParallelCtx.single()
NAME = "xlstm-1.3b"


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _pair(rng, shape, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _qkv(rng, B, T, h, hd):
    return [_pair(rng, s) for s in ((B, T, h, hd), (B, T, h, hd),
                                    (B, T, h, hd), (B, T, h), (B, T, h))]


# ---------------------------------------------------------------------------
# the recurrences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("return_state", [False, True])
def test_mlstm_parallel_matches_reference(return_state):
    ins = _qkv(np.random.default_rng(0), 2, 256, 3, 16)
    want = jax.jit(functools.partial(jx.mlstm_parallel, chunk=128,
                                     return_state=return_state))(
        *(a for a, _ in ins))
    got = xlstm.mlstm_parallel(*(b for _, b in ins), chunk=128,
                               return_state=return_state)
    if not return_state:
        want, got = (want, {}), (got, {})
    _close(got[0], want[0])
    assert set(got[1]) == set(want[1])
    for n in want[1]:
        assert tuple(got[1][n].shape) == want[1][n].shape
        _close(got[1][n], want[1][n])


@pytest.mark.parametrize("T", [223, 100, 129])
def test_mlstm_parallel_ragged_t_matches_the_one_chunk_form(T):
    """T not a multiple of the chunk: padded with neutral steps, the
    outputs and final state are the unpadded sequence's — the reference's
    ``chunk=T`` (one chunk).  The reference's own chunked form refuses
    such a T (ROADMAP Queue 3)."""
    ins = _qkv(np.random.default_rng(1), 2, T, 2, 8)
    want = jax.jit(functools.partial(jx.mlstm_parallel, chunk=T,
                                     return_state=True))(*(a for a, _ in ins))
    got = xlstm.mlstm_parallel(*(b for _, b in ins), chunk=128,
                               return_state=True)
    _close(got[0], want[0])
    for n in ("C", "n", "m"):
        _close(got[1][n], want[1][n])
    if T > 128:
        with pytest.raises(AssertionError, match="not divisible"):
            jx.mlstm_parallel(*(a for a, _ in ins), chunk=128)


def test_mlstm_decode_step_and_slstm_cell_match_reference():
    rng = np.random.default_rng(2)
    B, h, hd, vs = 3, 2, 8, 4
    st = {"C": _pair(rng, (B, h, hd, vs)), "n": _pair(rng, (B, h, hd)),
          "m": _pair(rng, (B, h))}
    q, k = _pair(rng, (B, h, hd)), _pair(rng, (B, h, hd))
    v, ig, fg = _pair(rng, (B, h, vs)), _pair(rng, (B, h)), _pair(rng, (B, h))
    for empty in (False, True):       # a filled state, then the empty one
        if empty:
            st = {"C": _pair(rng, (B, h, hd, vs), 0.0),
                  "n": _pair(rng, (B, h, hd), 0.0),
                  "m": (jnp.full((B, h), -1e30), torch.full((B, h), -1e30))}
        wst, wo = jx.mlstm_decode_step({n: a for n, (a, _) in st.items()},
                                       q[0], k[0], v[0], ig[0], fg[0])
        gst, go = xlstm.mlstm_decode_step({n: b for n, (_, b) in st.items()},
                                          q[1], k[1], v[1], ig[1], fg[1])
        _close(go, wo)
        for n in ("C", "n", "m"):
            _close(gst[n], wst[n])
    d, nh = 16, 4
    carry = [_pair(rng, (B, d)) for _ in range(4)]
    gx, r = _pair(rng, (B, 4, d)), _pair(rng, (nh, d // nh, 4, d // nh))
    want = jx.slstm_cell(tuple(a for a, _ in carry), gx[0], r[0], nh)
    got = xlstm.slstm_cell(tuple(b for _, b in carry), gx[1], r[1], nh)
    for a, b in zip(got, want):
        _close(a, b)
    cfg = configs.get_config(NAME)
    assert xlstm.slstm_scan_flops(cfg, 8, 2048) == jx.slstm_scan_flops(
        jconfigs.get_config(NAME), 8, 2048)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    j = jconfigs.get_config(NAME).reduced(**kw)
    return j, configs.ModelConfig(**dataclasses.asdict(j))


@pytest.fixture(scope="module")
def blocks():
    """The reduced xlstm's unit 0 params: (jcfg, cfg, jparams, params,
    jdefs, defs) per block kind."""
    jcfg, cfg = _cfgs()
    jm = jbuild(jcfg, JCTX)
    jp = jax.tree.map(lambda a: a[0], jm.init_params(0)["units"])
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    defs = meta.model_defs(cfg, 1, 1, "hier")["units"]
    out = {}
    for key, kind in (("b0", "mlstm"), ("b7", "slstm")):
        out[kind] = (jcfg, cfg, jp[key][kind], tp[key][kind],
                     jm.defs["units"][key][kind], defs[key][kind])
    return out


def _block_fns(kind):
    jfn = jx.mlstm_block if kind == "mlstm" else jx.slstm_block
    fn = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    return jfn, fn


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match_reference(blocks, kind):
    jcfg, cfg, jp, tp, jmt, tmt = blocks[kind]
    jfn, fn = _block_fns(kind)
    kw = {"chunk": 8} if kind == "mlstm" else {}
    rng = np.random.default_rng(3)
    jx_, tx = _pair(rng, (3, 16, cfg.d_model))
    jy, jst = jax.jit(lambda x, p: jfn(x, p, jmt, JCTX, jcfg,
                                       return_state=True, **kw))(jx_, jp)
    ty, tst = fn(tx, tp, tmt, CTX, cfg, return_state=True, **kw)
    _close(ty, jy)
    assert set(tst) == set(jst)
    for n in jst:
        assert tuple(tst[n].shape) == jst[n].shape
        _close(tst[n], jst[n])
    step = jax.jit(lambda x, p, st: jfn(x, p, jmt, JCTX, jcfg, state=st,
                                        decode=True))
    for _ in range(3):
        jx_, tx = _pair(rng, (3, 1, cfg.d_model))
        jy, jst = step(jx_, jp, jst)
        ty, tst = fn(tx, tp, tmt, CTX, cfg, state=tst, decode=True)
        _close(ty, jy)
        for n in jst:
            _close(tst[n], jst[n])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_gradients_match_reference(blocks, kind):
    """d(sum(out * w)) / d(x, every param) against ``jax.grad``, two
    mLSTM chunks (the cross-chunk prefix in the gradient)."""
    jcfg, cfg, jp, tp, jmt, tmt = blocks[kind]
    jfn, fn = _block_fns(kind)
    kw = {"chunk": 8} if kind == "mlstm" else {}
    rng = np.random.default_rng(4)
    jx_, tx = _pair(rng, (2, 16, cfg.d_model))
    jw, tw = _pair(rng, (2, 16, cfg.d_model))
    # weights drawn away from zero so every path carries gradient
    jp = jax.tree.map(lambda a: a + 0.05, jp)
    tp = {k: (v + 0.05).requires_grad_(True) for k, v in tp.items()}
    want = jax.jit(jax.grad(lambda x, p: jnp.sum(
        jfn(x, p, jmt, JCTX, jcfg, **kw) * jw), argnums=(0, 1)))(jx_, jp)
    tx.requires_grad_(True)
    (fn(tx, tp, tmt, CTX, cfg, **kw) * tw).sum().backward()
    _close(tx.grad, want[0])
    for n in want[1]:
        g, w = _np(tp[n].grad), np.asarray(want[1][n])
        np.testing.assert_allclose(g, w, rtol=2e-4,
                                   atol=2e-4 * np.abs(w).max())


def test_slstm_batch_split_that_does_not_tile_the_batch_raises():
    """At tp 2 a batch of 3 splits as nb 2 x bs 1: the port raises; the
    reference's block leaves row 2 out (its output there is the residual
    alone), and at tp 8 (nb 3) counts row 2 twice — held inside its
    shard_map."""
    from jax.sharding import PartitionSpec as JP
    from repro.substrate import VirtualCluster as JVC
    jcfg, cfg = _cfgs()
    jm = jbuild(jcfg, JCTX)
    p = jax.tree.map(lambda a: a[0], jm.init_params(0)["units"]["b7"][
        "slstm"])
    p = jax.tree.map(lambda a: a + 0.05, p)
    jmt = jm.defs["units"]["b7"]["slstm"]
    x = jnp.asarray(np.random.default_rng(5).normal(
        size=(3, 8, cfg.d_model)).astype(np.float32))
    jvc = JVC(pods=1, chips=2, fast_axis="tp")
    jctx = JCtx(tp_axis="tp", tp=2, compute_dtype=jnp.float32)
    out = jvc.run(lambda x_: jx.slstm_block(x_, p, jmt, jctx, jcfg), x,
                  in_specs=(JP(None, "tp"),), out_specs=JP(None, "tp"))
    one = jx.slstm_block(x, p, jmt, JCTX, jcfg)
    assert np.abs(np.asarray(out - one)[:2]).max() < 1e-5
    np.testing.assert_array_equal(np.asarray(out)[2], np.asarray(x)[2])
    assert np.abs(np.asarray(one - x)[2]).max() > 1e-3
    # tp 8 (nb 3, a group of 2 ranks a row, a third group clamped onto
    # row 2): row 2's block output counted twice
    jvc8 = JVC(pods=1, chips=8, fast_axis="tp")
    jctx8 = JCtx(tp_axis="tp", tp=8, compute_dtype=jnp.float32)
    out8 = jvc8.run(lambda x_: jx.slstm_block(x_, p, jmt, jctx8, jcfg), x,
                    in_specs=(JP(None, "tp"),), out_specs=JP(None, "tp"))
    d8 = np.asarray(out8 - x)
    np.testing.assert_allclose(d8[2], 2 * np.asarray(one - x)[2],
                               rtol=1e-4, atol=1e-6)
    assert np.abs(d8[:2] - np.asarray(one - x)[:2]).max() < 1e-5
    tctx = ParallelCtx(tp_axis="tp", tp=2)
    for t in (2, 8):
        with pytest.raises(ValueError, match="min\\(tp, B\\)"):
            xlstm._slstm_split(ParallelCtx(tp_axis="tp", tp=t), 3)
    assert xlstm._slstm_split(tctx, 4) == (2, 2, 1)
    assert xlstm._slstm_split(ParallelCtx(tp_axis="tp", tp=8), 4) == \
        (4, 1, 2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jm = jbuild(jcfg, JCTX)
    jp = jm.init_params(0)
    tm = build(cfg, CTX, device="cpu")
    return jm, jp, tm, params_from_reference(jax.tree.map(np.asarray, jp),
                                             "cpu")


def test_defs_and_cache_match_reference(model):
    jm, _, tm, _ = model
    for tp in (1, 2, 8):
        for serve in (False, True):
            jd = jmeta.model_defs(jconfigs.get_config(NAME), tp, 4, "hier",
                                  serve=serve)
            td = meta.model_defs(configs.get_config(NAME), tp, 4, "hier",
                                 serve=serve)
            want = [(m.shape, m.tp_dim, m.fsdp_dim, m.init)
                    for m in jax.tree.leaves(
                        jd, is_leaf=lambda x: isinstance(x, jmeta.PMeta))]
            got = [(m.shape, m.tp_dim, m.fsdp_dim, m.init)
                   for m in jax.tree.leaves(
                       td, is_leaf=lambda x: isinstance(x, meta.PMeta))]
            assert got == want
    want = jm.cache_init(2, 16)
    got = tm.cache_init(2, 16)
    assert set(got["units"]["b0"]) == {"C", "n", "m", "conv"}
    assert set(got["units"]["b7"]) == {"h", "c", "n", "m"}
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    leaves = jax.tree.leaves(got)
    assert len({b.data_ptr() for b in leaves}) == len(leaves)


def test_loss_and_gradients_match_reference(model):
    jm, jp, tm, tp = model
    batch = jmake_batch(jm.cfg, 2, 40, seed=6)     # 40 tokens: ragged mLSTM

    def jloss(p):
        s, c = jm.loss_fn(p, batch)
        return s / c
    wl, wg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = jax.tree.map(lambda a: a.detach().clone().requires_grad_(True),
                      tp)
    s, c = tm.loss_fn(tp, {"tokens": torch.from_numpy(np.array(
        batch["tokens"]))})
    (s / c).backward()
    np.testing.assert_allclose(float(s.detach() / c), float(wl), rtol=2e-5)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(wg),
                            jax.tree.leaves(tp)):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g.grad), w, rtol=2e-4,
                                   atol=2e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def test_prefill_then_per_slot_decode_match_reference(model):
    jm, jp, tm, tp = model
    rng = np.random.default_rng(7)
    B, T, s_max = 3, 12, 20
    toks = rng.integers(0, tm.cfg.vocab, size=(B, T + 1)).astype(np.int32)
    jc, jl = jax.jit(lambda p, b: jm.prefill_fn(p, b, s_max))(
        jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, s_max)
    _close(tl, jl)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        assert a.shape == tuple(b.shape)
        _close(b, a)
    pos = np.array([T, T - 5, T - 1], np.int32)
    tok = rng.integers(0, tm.cfg.vocab, size=(B, 1)).astype(np.int32)
    decode = jax.jit(jm.decode_fn)
    for _ in range(4):
        jc, jl = decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tc2, tl = tm.decode_fn(tp, tc, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        assert tc2 is tc                            # updated in place
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        pos = pos + 1
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        _close(b, a)


def test_decode_continues_prefill(model):
    """``tests/test_models_smoke.py::test_decode_matches_prefill`` for
    xlstm-1.3b: 16 decode steps from a 16-token prefill give the last
    logits of the 32-token prefill (rel 1e-4), in the port and against the
    reference's 32-token prefill."""
    jm, jp, tm, tp = model
    T, T0 = 32, 16
    batch = {"tokens": torch.from_numpy(np.array(jmake_batch(
        jm.cfg, B=2, T=T)["tokens"]))}
    _, ref = tm.prefill_fn(tp, batch, T)
    _, jref = jax.jit(lambda p, b: jm.prefill_fn(p, b, T))(
        jp, {"tokens": jnp.asarray(batch["tokens"].numpy())})
    cache, lg = tm.prefill_fn(tp, {"tokens": batch["tokens"][:, :T0 + 1]},
                              T)
    for t in range(T0, T):
        cache, lg = tm.decode_fn(tp, cache, batch["tokens"][:, t:t + 1], t)
    scale = float(ref.abs().max())
    assert float((lg - ref).abs().max()) / scale < 1e-4
    assert float(np.abs(_np(lg) - np.asarray(jref)).max()) / scale < 1e-4


def test_prompt_shorter_than_the_conv_decodes_like_a_prefill(model):
    """A 1- or 2-token prefill (shorter than the conv's K - 1 = 3) keeps a
    zero-padded conv state, so one decode step gives the logits of the
    one-longer prefill."""
    tm, tp = model[2], model[3]
    p = np.random.default_rng(8).integers(0, tm.cfg.vocab, 4).astype(
        np.int32)

    def batch(n):
        return {"tokens": torch.from_numpy(np.r_[p[:n], 0][None].astype(
            np.int32))}
    for n in (1, 2, 3):
        cache, _ = tm.prefill_fn(tp, batch(n), 8)
        assert cache["units"]["b0"]["conv"].shape[2] == 3
        _, got = tm.decode_fn(tp, cache, torch.from_numpy(p[None, n:n + 1]),
                              n)
        _, want = tm.prefill_fn(tp, batch(n + 1), 8)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_mchunk_opt_and_build_by_name():
    """``mchunk=N`` sets the training chunk (the reference's knob); the
    loss does not depend on it."""
    m = build_by_name(NAME, reduced=True, device="cpu")
    assert MLSTM_CHUNK == 128 and m.cfg.n_layers == 8
    params = m.init_params(0)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (2, 41)).astype(np.int32))}
    want = m.loss_fn(params, batch)
    ctx = ParallelCtx.single(opts=("mchunk=16",))
    got = build(m.cfg, ctx, device="cpu").loss_fn(params, batch)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    assert torch.isfinite(want[0]) and want[1] == 80
