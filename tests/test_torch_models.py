"""The port's dense model path held against the JAX reference on the CPU.

The reference's ``init_params(0)`` tree goes to the port through
``convert.params_from_reference``; token inputs come from numpy seeds.  The
reduced ``qwen3-0.6b`` (2 layers, d 64; GQA 1:1 there, so a 2:1 variant and
an ``attn`` + ``local`` (window 8) variant ride along) runs prefill and
per-slot decode in both packages: logits and caches within 1e-4.  So does
a reduced ``recurrentgemma-9b`` (5 layers: one ``rglru, rglru, local`` unit
plus an ``rglru, rglru`` remainder, window 16), below and past its window,
with its ``rglru`` pieces held one by one (the conv, the ``lam`` init, the
scan, the block's prefill and decode).  On the CPU
``models.attention.flash_attention`` and ``models.rglru.rglru_scan`` take
the kernels' plain versions; the kernels themselves are held to them on the
card (``tests/test_torch_gpu.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import build as jbuild_cfg
from repro.models import layers as jlayers
from repro.models import make_batch as jmake_batch
from repro.models import meta as jmeta
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro.models.parallel import ParallelCtx as JCtx
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import ParallelCtx, build, build_by_name, make_batch
from repro_torch.models import attention as attn
from repro_torch.models import layers, meta, rglru, xlstm
from repro_torch.models.parallel import ParamGroup, prefetch_walk
from repro_torch.core import tree as T
from repro_torch.substrate.cluster import Mesh, bind_mesh

TOL = dict(rtol=1e-4, atol=1e-4)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
JCTX, CTX = JCtx.single(), ParallelCtx.single()


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _pair(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jconfigs.list_configs())
def test_configs_and_reduced_match_reference(name):
    want, got = jconfigs.get_config(name), configs.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert got.param_count() == want.param_count()
    assert got.vocab_padded == want.vocab_padded


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_activations_match_reference():
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 5, 32))
    js, ts = _pair(rng, (32,))
    np.testing.assert_allclose(_np(layers.rms_norm(tx, ts, 1e-6)),
                               _np(jlayers.rms_norm(jx, js, 1e-6)), **TOL)
    ju, tu = _pair(rng, (2, 5, 32))
    for kind in ("swiglu", "geglu", "gelu"):
        up_j, up_t = (None, None) if kind == "gelu" else (ju, tu)
        np.testing.assert_allclose(
            _np(layers.activation(kind, tx, up_t)),
            _np(jlayers.activation(kind, jx, up_j)), **TOL)


def test_rope_and_rope_decode_match_reference():
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 7, 3, 16))
    pos = np.arange(5, 12)
    np.testing.assert_allclose(
        _np(layers.rope(tx, torch.from_numpy(pos), 1e6)),
        _np(jlayers.rope(jx, jnp.asarray(pos), 1e6)), **TOL)
    j1, t1 = _pair(rng, (2, 1, 3, 16))
    for p in (9, np.array([3, 40], np.int32)):       # scalar, per slot
        np.testing.assert_allclose(
            _np(layers.rope_decode(t1, torch.as_tensor(p), 1e4)),
            _np(jlayers.rope_decode(j1, jnp.asarray(p), 1e4)), **TOL)
    pe = np.arange(6)
    np.testing.assert_allclose(
        _np(layers.sinusoidal_pe(torch.from_numpy(pe), 32)),
        _np(jlayers.sinusoidal_pe(jnp.asarray(pe), 32)), **TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Tq,Tkv,nq,kv,hd,window,q_off,block", [
    (2, 16, 16, 4, 2, 16, None, 0, 1024),     # GQA, causal
    (1, 8, 24, 4, 1, 8, None, 16, 16),        # MQA, q_offset, padded block
    (1, 20, 20, 2, 2, 16, 6, 0, 8),           # window, padded block
    (2, 12, 12, 4, 4, 32, None, 0, 5),        # ragged block padding
])     # block: the reference's kv block (its padding path)
def test_flash_attention_matches_reference(B, Tq, Tkv, nq, kv, hd, window,
                                           q_off, block):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (B, Tq, nq, hd))
    jk, tk = _pair(rng, (B, Tkv, kv, hd))
    jv, tv = _pair(rng, (B, Tkv, kv, hd))
    want = jattn.flash_attention(jq, jk, jv, causal=True, window=window,
                                 q_offset=q_off, block=block)
    got = attn.flash_attention(tq, tk, tv, causal=True, window=window,
                               q_offset=q_off, H=nq, kv_total=kv)
    assert got.shape == (B, Tq, nq, hd)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("nq,kv,H,kv_total,q_hoff,kv_hoff,q_off", [
    (4, 2, 8, 4, 4, 2, 0),      # head_tp rank 1 of 2, kv sharded
    (3, 3, 6, 3, 3, 0, 0),      # kv replicated, rank 1's map 1, 2, 2
    (2, 2, 8, 2, 6, 0, 8),      # kv replicated, map 1, 1; q_offset
])
def test_flash_attention_refuses_head_shards(nq, kv, H, kv_total, q_hoff,
                                             kv_hoff, q_off):
    """Head-parallel shards (the name predates their port): the shard's kv
    map, the kernel's own or expanded per q head, against the
    reference's."""
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng, (2, 8, nq, 16))
    jk, tk = _pair(rng, (2, 8 + q_off, kv, 16))
    jv, tv = _pair(rng, (2, 8 + q_off, kv, 16))
    kw = dict(causal=True, window=None, q_offset=q_off, q_head_offset=q_hoff,
              kv_head_offset=kv_hoff, H=H, kv_total=kv_total)
    want = jattn.flash_attention(jq, jk, jv, **kw)
    got = attn.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_kv_head_map_and_attn_flops_match_reference():
    for args in ((4, 0, 4, 2), (8, 8, 16, 2, 1), (3, 0, 3, 1)):
        np.testing.assert_array_equal(attn._kv_head_map(*args).numpy(),
                                      np.asarray(jattn._kv_head_map(*args)))
    for kw in (dict(causal=True, window=None), dict(causal=False,
                                                    window=None),
               dict(causal=True, window=64)):
        assert attn.attn_flops(8, 2048, 2048, 16, 128, **kw) == \
            jattn.attn_flops(8, 2048, 2048, 16, 128, **kw)


@pytest.mark.parametrize("pos", [5, 19, np.array([2, 17, 30], np.int32)])
@pytest.mark.parametrize("window", [None, 8])
def test_cache_write_and_decode_attention_match_reference(pos, window):
    rng = np.random.default_rng(3)
    B, S, kv, H, hd = 3, 8 if window else 24, 2, 4, 16
    jc, tc = _pair(rng, (B, S, kv, hd))
    jvc, tvc = _pair(rng, (B, S, kv, hd))
    jn, tn = _pair(rng, (B, 1, kv, hd))
    jq, tq = _pair(rng, (B, 1, H, hd))
    jpos, tpos = jnp.asarray(pos), torch.as_tensor(pos)
    want_c = jattn.cache_write(jc, jn, JCTX, pos=jpos, window=window)
    got_c = attn.cache_write(tc.clone(), tn, CTX, pos=tpos, window=window)
    np.testing.assert_array_equal(_np(got_c), _np(want_c))
    ring = window is not None
    for w in ((window,) if ring else (None, 6)):    # non-ring: + a window
        want = jattn.decode_attention(jq, want_c, jvc, JCTX, pos=jpos, H=H,
                                      window=w, ring=ring)
        got = attn.decode_attention(tq, got_c, tvc, CTX, pos=tpos, H=H,
                                    window=w, ring=ring)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# the model: prefill + per-slot decode against the reference
# ---------------------------------------------------------------------------

def _hybrid_cfg():
    """Reduced recurrentgemma-9b at 5 layers: one (rglru, rglru, local)
    unit plus an (rglru, rglru) remainder; window 16."""
    return dataclasses.replace(
        jconfigs.get_config("recurrentgemma-9b").reduced(), n_layers=5)


def _variant(name):
    if name == "recurrentgemma-9b":
        return _hybrid_cfg()
    cfg = jconfigs.get_config("qwen3-0.6b").reduced()
    if name == "gqa":
        cfg = jconfigs.get_config("qwen3-0.6b").reduced(n_kv=2)
    elif name == "local":
        cfg = dataclasses.replace(cfg, pattern=("attn", "local"), window=8)
    return cfg


def _build_pair(name):
    """(reference model, its params, port model, the same params)."""
    cfg = _variant(name)
    jm = jbuild_cfg(cfg, JCTX)
    jp = jm.init_params(0)
    tm = build(configs.ModelConfig(**dataclasses.asdict(cfg)), CTX,
               device="cpu")
    return jm, jp, tm, params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module", params=["qwen3-0.6b", "gqa", "local",
                                        "recurrentgemma-9b"])
def pair(request):
    return _build_pair(request.param)


@pytest.fixture(scope="module")
def hybrid():
    return _build_pair("recurrentgemma-9b")


def test_prefill_then_per_slot_decode_match_reference(pair):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(4)
    B, T, s_max = 3, 12, 20
    toks = rng.integers(0, tm.cfg.vocab, size=(B, T + 1)).astype(np.int32)
    jc, jl = jax.jit(lambda p, b: jm.prefill_fn(p, b, s_max))(
        jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, s_max)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(_np(b), _np(a), **TOL)

    pos = np.array([T, T - 5, T - 1], np.int32)       # per-slot positions
    tok = rng.integers(0, tm.cfg.vocab, size=(B, 1)).astype(np.int32)
    decode = jax.jit(jm.decode_fn)
    for _ in range(4):
        jc, jl = decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tc, tl = tm.decode_fn(tp, tc, torch.from_numpy(tok),
                              torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        pos = pos + 1
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)


def test_cache_init_matches_reference_and_leaves_are_distinct(pair):
    jm, _, tm, _ = pair
    want = jax.tree.leaves(jm.cache_init(2, 16))
    got = jax.tree.leaves(tm.cache_init(2, 16))
    assert [a.shape for a in want] == [tuple(b.shape) for b in got]
    assert len({b.data_ptr() for b in got}) == len(got)  # written in place


def test_make_batch_and_build_by_name_match_reference():
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced()
    want = jmake_batch(jcfg, 3, 9, seed=5)
    m = build_by_name("qwen3-0.6b", reduced=True, device="cpu")
    got = make_batch(m.cfg, 3, 9, seed=5, device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert m.device == torch.device("cpu") and m.cfg.n_layers == 2


def test_init_params_keeps_the_reference_tree_and_rules():
    jm = jbuild_cfg(jconfigs.get_config("qwen3-0.6b").reduced(), JCTX)
    m = build_by_name("qwen3-0.6b", reduced=True, device="cpu")
    jp = jm.init_params(0)
    tp = m.init_params(0)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32
    u = tp["units"]["b0"]
    assert not u["attn"]["ln"].any() and not u["attn"]["q_norm"].any()
    L = m.cfg.n_layers
    for leaf, want in ((tp["embed"], 0.02),
                       (u["attn"]["wo"], 0.02 / np.sqrt(2.0 * L))):
        assert abs(leaf.std().item() / want - 1) < 0.05
    again = m.init_params(0)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(tp),
                                                 jax.tree.leaves(again)))


def test_unported_parts_raise_naming_their_roadmap_item():
    # training and serving at tp > 1 are ported (tests/test_torch_train_tp*
    # and tests/test_torch_serving_cluster.py hold them to the reference):
    # serve defs replicate attention over tp, one domain's prefill at tp 2
    # writes each rank's S/tp chunk and gives the tp-1 logits; the 2-D
    # decode layout waits for item 17
    tctx = ParallelCtx(tp_axis="model", tp=2)
    qcfg = configs.get_config("qwen3-0.6b")
    assert meta.model_defs(qcfg, 2, 1, "hier")["units"]["b0"]["attn"][
        "wq"].tp_dim == 1
    sdefs = meta.model_defs(qcfg, 2, 1, "hier", serve=True)
    assert sdefs["units"]["b0"]["attn"]["wq"].tp_dim is None
    assert sdefs["units"]["b0"]["ffn"]["w_in"].tp_dim == 2
    with pytest.raises(NotImplementedError, match="decode2d.*item 17"):
        meta.model_defs(qcfg, 2, 1, "hier", serve=True,
                        opts=frozenset({"decode2d"}))
    tm = build(qcfg.reduced(), dataclasses.replace(
        tctx, compute_dtype=torch.float32), device="cpu")
    sm = build(qcfg.reduced(), CTX, device="cpu")
    params = sm.init_params(0)
    mesh = Mesh(("model",), (2,), (), torch.device("cpu"))
    specs = tm.param_specs(tp_axis="model", fsdp_axis=None)
    # one domain's run: each leaf stacked per tp rank, the unit dim first
    tparams = {k: T.tree_map(
        lambda w, s, u=(k == "units"): mesh.layout(w, s).movedim(0, int(u)),
        params[k], specs[k]) for k in params}
    batch = make_batch(tm.cfg, 2, 8, device="cpu")
    with bind_mesh(mesh):
        cache, lg = tm.prefill_fn(tparams, batch, 16)
        zero = tm.cache_init(1, 16)
    _, want = sm.prefill_fn(params, batch, 16)
    np.testing.assert_allclose(_np(lg[0]), _np(want), **F32_TOL)
    kv_shape = (tm.cfg.n_units, 2, 2, 8, tm.cfg.n_kv, tm.cfg.head_dim)
    assert tuple(cache["units"]["b0"]["k"].shape) == kv_shape
    assert tuple(zero["units"]["b0"]["v"].shape) == kv_shape[:2] + (1,) \
        + kv_shape[3:]
    with pytest.raises(ValueError, match="tp_axis"):
        ParallelCtx(tp=2)
    assert ParallelCtx(fsdp_axes=("data",)).prefetch == 0
    grp = ParamGroup(CTX, {"w": torch.ones(2)}, {"w": meta.PMeta((2,))})
    assert grp.unshard().state == "in_flight"
    assert prefetch_walk([], None, "x", 2) == "x"
    assert CTX.reduce_grads({"g": torch.ones(1)}) == {"g": torch.ones(1)}
    with pytest.raises(NotImplementedError, match="item 16"):
        build_by_name("xlstm-1.3b", reduced=True, device="cpu")
    # the MoE family is ported (models/moe.py): it builds and runs
    moe = build_by_name("granite-moe-3b-a800m", reduced=True, device="cpu")
    assert set(moe.defs["units"]["b0"]) == {"attn", "moe"}
    loss, cnt = moe.loss_fn(moe.init_params(0),
                            make_batch(moe.cfg, 2, 8, device="cpu"))
    assert torch.isfinite(loss) and cnt == 16
    cfg = dataclasses.replace(configs.get_config("recurrentgemma-9b"),
                              pattern=("mlstm",))
    with pytest.raises(NotImplementedError, match="the mlstm block.*item 16"):
        build(cfg, CTX, device="cpu")
    m = build_by_name("internvl2-1b", reduced=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        m.prefill_fn(m.init_params(0), make_batch(m.cfg, 1, 4,
                                                  device="cpu"), 8)
    m = build_by_name("qwen3-0.6b", reduced=True, device="cpu")
    loss, cnt = m.loss_fn(m.init_params(0), make_batch(m.cfg, 2, 8,
                                                       device="cpu"))
    assert torch.isfinite(loss) and cnt == 16
    assert meta.attn_mode_for(m.cfg, 1) == "head_tp"


# ---------------------------------------------------------------------------
# the RG-LRU pieces of recurrentgemma-9b
# ---------------------------------------------------------------------------

def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng, (2, 9, 6))
    jw, tw = _pair(rng, (6, 4))
    np.testing.assert_allclose(_np(xlstm.causal_conv1d(tx, tw)),
                               _np(jxlstm.causal_conv1d(jx, jw)),
                               rtol=1e-6, atol=1e-6)


def test_lam_init_is_bit_equal_to_the_reference():
    """The RG-LRU decay parameter is deterministic (no draw): the port's
    float64 numpy arithmetic gives the reference's f32 leaf bit for bit,
    stacked or not."""
    for shape, stacked in (((4096,), 12), ((64,), None)):
        m = meta.PMeta(shape, tp_dim=0, init="lam")
        jm_ = jmeta.PMeta(shape, tp_dim=0, init="lam")
        got = meta.init_leaf(m, 38, stacked, generator=torch.Generator(),
                             device="cpu")
        want = np.asarray(jmeta.init_leaf(jm_, None, 38, stacked))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_rglru_scan_matches_the_reference_log_space_scan():
    """The port scans a = exp(log_a) through ops.lru_scan; the reference
    runs an associative scan in log space."""
    rng = np.random.default_rng(6)
    log_a = np.log(rng.uniform(0.5, 0.999, size=(2, 37, 24))).astype(
        np.float32)
    x = rng.normal(size=(2, 37, 24)).astype(np.float32)
    want = np.asarray(jax.jit(jrglru.rglru_scan)(jnp.asarray(log_a),
                                                 jnp.asarray(x)))
    got = rglru.rglru_scan(torch.from_numpy(log_a), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_rglru_block_prefill_and_decode_match_reference():
    cfg = _hybrid_cfg()
    jm = jbuild_cfg(cfg, JCTX)
    jp = jm.init_params(0)
    jb, jmt = jp["units"]["b0"]["rglru"], jm.defs["units"]["b0"]["rglru"]
    jb = jax.tree.map(lambda a: a[0], jb)
    tb = params_from_reference(jax.tree.map(np.asarray, jb), "cpu")
    tmt = meta.model_defs(configs.ModelConfig(**dataclasses.asdict(cfg)), 1,
                          1, "hier")["units"]["b0"]["rglru"]
    tcfg = configs.ModelConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng, (3, 11, cfg.d_model))
    prefill = jax.jit(lambda x, p: jrglru.rglru_block(
        x, p, jmt, JCTX, cfg, return_state=True))
    step = jax.jit(lambda x, p, st: jrglru.rglru_block(
        x, p, jmt, JCTX, cfg, state=st, decode=True))
    jy, jst = prefill(jx, jb)
    ty, tst = rglru.rglru_block(tx, tb, tmt, CTX, tcfg, return_state=True)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    for n in ("h", "conv"):
        assert tuple(tst[n].shape) == jst[n].shape
        np.testing.assert_allclose(_np(tst[n]), _np(jst[n]), **TOL)
    for _ in range(3):
        jx, tx = _pair(rng, (3, 1, cfg.d_model))
        jy, jst = step(jx, jb, jst)
        ty, tst = rglru.rglru_block(tx, tb, tmt, CTX, tcfg, state=tst,
                                    decode=True)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        for n in ("h", "conv"):
            np.testing.assert_allclose(_np(tst[n]), _np(jst[n]), **TOL)


def test_hybrid_prefill_past_the_window_then_decode_match_reference(hybrid):
    """The reduced recurrentgemma-9b with T = 40 past its window of 16:
    prefill logits and every cache leaf (ring k / v, h, conv), then 4
    decode steps at per-slot positions, against the reference."""
    jm, jp, tm, tp = hybrid
    rng = np.random.default_rng(8)
    B, T, s_max = 2, 40, 48
    toks = rng.integers(0, tm.cfg.vocab, size=(B, T + 1)).astype(np.int32)
    jc, jl = jax.jit(lambda p, b: jm.prefill_fn(p, b, s_max))(
        jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, s_max)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jc)]
    assert {n.split("'")[-2] for n in names} == {"k", "v", "h", "conv"}
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(_np(b), _np(a), **TOL)
    pos = np.array([T, T - 7], np.int32)
    tok = rng.integers(0, tm.cfg.vocab, size=(B, 1)).astype(np.int32)
    decode = jax.jit(jm.decode_fn)
    for _ in range(4):
        jc, jl = decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tc2, tl = tm.decode_fn(tp, tc, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        assert tc2 is tc                    # updated in place
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        pos = pos + 1
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)


def test_hybrid_prompt_shorter_than_the_conv_decodes_like_a_prefill(hybrid):
    """A 1- or 2-token prefill (shorter than the conv's K - 1 = 3) keeps a
    zero-padded conv state, so one decode step gives the logits of the
    one-longer prefill.  (The reference's state is the short tail, which
    its (B, K-1, dr) cache does not take.)"""
    tm, tp = hybrid[2], hybrid[3]
    p = np.random.default_rng(9).integers(0, tm.cfg.vocab, 4).astype(np.int32)

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
