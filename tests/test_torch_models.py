"""The port's dense model path held against the JAX reference on the CPU.

The reference's ``init_params(0)`` tree goes to the port through
``convert.params_from_reference``; token inputs come from numpy seeds.  The
reduced ``qwen3-0.6b`` (2 layers, d 64; GQA 1:1 there, so a 2:1 variant and
an ``attn`` + ``local`` (window 8) variant ride along) runs prefill and
per-slot decode in both packages: logits and caches within 1e-4.  On the
CPU ``models.attention.flash_attention`` takes the kernel's plain version;
the kernel itself is held to it on the card (``tests/test_torch_gpu.py``).
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
from repro.models.parallel import ParallelCtx as JCtx
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import ParallelCtx, build, build_by_name, make_batch
from repro_torch.models import attention as attn
from repro_torch.models import layers, meta
from repro_torch.models.parallel import ParamGroup, prefetch_walk

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


def test_flash_attention_refuses_head_shards():
    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(NotImplementedError, match="item 13"):
        attn.flash_attention(q, q, q, H=8)
    with pytest.raises(NotImplementedError, match="item 13"):
        attn.flash_attention(q, q, q, kv_total=2)


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

def _variant(name):
    cfg = jconfigs.get_config("qwen3-0.6b").reduced()
    if name == "gqa":
        cfg = jconfigs.get_config("qwen3-0.6b").reduced(n_kv=2)
    elif name == "local":
        cfg = dataclasses.replace(cfg, pattern=("attn", "local"), window=8)
    return cfg


@pytest.fixture(scope="module", params=["qwen3-0.6b", "gqa", "local"])
def pair(request):
    """(reference model, its params, port model, the same params)."""
    cfg = _variant(request.param)
    jm = jbuild_cfg(cfg, JCTX)
    jp = jm.init_params(0)
    tm = build(configs.ModelConfig(**dataclasses.asdict(cfg)), CTX,
               device="cpu")
    return jm, jp, tm, params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


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
    with pytest.raises(NotImplementedError, match="item 13"):
        ParallelCtx(tp_axis="model", tp=2)
    with pytest.raises(NotImplementedError, match="item 13"):
        ParallelCtx(fsdp_axes=("data",))
    with pytest.raises(NotImplementedError, match="item 13"):
        ParamGroup()
    with pytest.raises(NotImplementedError, match="item 13"):
        prefetch_walk([], None, None, 2)
    with pytest.raises(NotImplementedError, match="item 13"):
        CTX.reduce_grads({})
    for name in ("xlstm-1.3b", "granite-moe-3b-a800m", "recurrentgemma-9b"):
        with pytest.raises(NotImplementedError, match="item 16"):
            build_by_name(name, reduced=True, device="cpu")
    m = build_by_name("internvl2-1b", reduced=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        m.prefill_fn(m.init_params(0), make_batch(m.cfg, 1, 4,
                                                  device="cpu"), 8)
    m = build_by_name("qwen3-0.6b", reduced=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        m.loss_fn({}, {})
    assert meta.attn_mode_for(m.cfg, 1) == "head_tp"
