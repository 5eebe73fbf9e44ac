"""The flash-attention gradient on the CPU, held against the JAX reference.

The backward kernel (``csrc/flash_attention_bwd.cu``) runs only on the
card; here its plain counterpart — the autograd of
``kernels.flash_attention.flash_attention_plain`` — and the CPU emulation
of its arithmetic (``kernels.ref.flash_attention_bwd_tf32x3_emulated``:
the five products as 3xTF32 at the kernel's tile size, each tile folded
into the fp32 sums as the kernel folds it, P recomputed from the forward's
log-sum-exp, D, the rule for rows with no visible key, and the exact path
on non-finite or large inputs or non-finite fast-path gradients) are held
against ``jax.grad`` of ``repro.kernels.ref.attention_ref`` within 2e-4
(f32) and 2e-2 (bf16) of the largest gradient, over causal, windowed
(hd 256 too), GQA and ragged shapes (Tq / Tkv not multiples of the tile),
with ``q_offset`` putting rows before every key or past the window.  The
exact path must give the plain autograd's classes (NaN, +inf, -inf)
element for element.  The kernel itself is held to the same on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention_bwd as kbwd
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_plain

TOL = 2e-4

# (B, H, KV, Tq, Tkv, hd, causal, window, q_offset)
CASES = [(2, 4, 2, 40, 40, 16, True, None, 0),
         (1, 4, 1, 30, 50, 32, True, 8, 20),      # ragged, GQA 4:1
         (1, 2, 2, 24, 24, 16, False, None, 0),
         (1, 2, 1, 20, 20, 16, True, None, -6),   # rows before every key
         (1, 2, 1, 30, 12, 16, True, 4, 10),      # rows past the window
         (1, 2, 1, 20, 10, 16, False, 3, 12),
         (2, 8, 2, 70, 70, 64, True, 16, 0),
         (1, 4, 2, 40, 40, 256, True, 16, 0)]     # a window at hd 256


def _inputs(case, seed=0):
    B, H, KV, Tq, Tkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, H, Tq, hd), (B, KV, Tkv, hd), (B, KV, Tkv, hd),
             (B, H, Tq, hd))]


def _jax_grads(q, k, v, do, causal, window, q_offset):
    def f(q_, k_, v_):
        return jref.attention_ref(q_, k_, v_, causal=causal, window=window,
                                  q_offset=q_offset)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, what, tol=TOL):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= tol, f"{what} {name}: {err}"


@pytest.mark.parametrize("case", CASES)
def test_plain_autograd_matches_jax_grad(case):
    causal, window, qo = case[6:]
    q, k, v, do = _inputs(case)
    want = _jax_grads(q, k, v, do, causal, window, qo)
    got = kbwd.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, do)), causal=causal,
        window=window, q_offset=qo)
    _close(got, want, f"plain {case}")


def _emulated_vs_jax(case, dtype, tol):
    causal, window, qo = case[6:]
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(case, seed=1))
    kw = dict(causal=causal, window=window, q_offset=qo)
    o = flash_attention_plain(q, k, v, **kw)
    lse = ref.attention_lse(q, k, **kw)
    got = ref.flash_attention_bwd_tf32x3_emulated(q, k, v, o, do, lse, **kw)
    assert all(a.dtype == dtype for a in got)
    want = _jax_grads(*(x.float().numpy() for x in (q, k, v, do)), causal,
                      window, qo)
    _close(got, want, f"emulated {dtype} {case}", tol)


@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_algorithm_matches_jax_grad(case):
    """The five 3xTF32 products at the kernel's tiles, P from lse, D, the
    no-visible-key spread (f32, 2e-4 of the largest gradient)."""
    _emulated_vs_jax(case, torch.float32, TOL)


@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_algorithm_matches_jax_grad_bf16(case):
    """bf16 operands: the one TF32 product, gradients rounded to bf16 (2e-2
    of the largest gradient, against the f32 gradient of the rounded
    inputs)."""
    _emulated_vs_jax(case, torch.bfloat16, 2e-2)


def test_rows_with_no_visible_key_spread_do_over_dv():
    """Rows before every key: zero dq, zero share of dk, dO / Tkv on every
    key's dv — the plain softmax's uniform weights — and no NaN."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs((1, 2, 1, 12, 12, 16, True, None, -4), seed=2))
    kw = dict(causal=True, window=None, q_offset=-4)
    o = flash_attention_plain(q, k, v, **kw)
    lse = ref.attention_lse(q, k, **kw)
    assert torch.isinf(lse[..., :4]).all()
    dq, dk, dv = ref.flash_attention_bwd_tf32x3_emulated(q, k, v, o, do, lse,
                                                         **kw)
    assert torch.isfinite(dq).all() and torch.isfinite(dv).all()
    assert not dq[..., :4, :].any()
    # the masked rows alone contribute dO / Tkv to every key
    do_masked = torch.zeros_like(do)
    do_masked[..., :4, :] = do[..., :4, :]
    _, dk_m, dv_m = ref.flash_attention_bwd_tf32x3_emulated(
        q, k, v, o, do_masked, lse, **kw)
    assert not dk_m.any()
    spread = do[0, :, :4].sum(dim=(0, 1)) / 12
    torch.testing.assert_close(dv_m[0, 0], spread.expand(12, 16))


def test_lse_matches_jax_logsumexp():
    q, k, _, _ = _inputs((2, 4, 2, 30, 40, 32, True, 8, 10), seed=3)
    got = ref.attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                            causal=True, window=8, q_offset=10)
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, 2, axis=1)) \
        / math.sqrt(32)
    qpos = 10 + np.arange(30)[:, None]
    kpos = np.arange(40)[None, :]
    s = np.where((kpos <= qpos) & (qpos - kpos < 8), s, -np.inf)
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


SPECIAL = (math.inf, -math.inf, math.nan, float(np.finfo(np.float32).max),
           -3.4e38)


@pytest.mark.parametrize("where", ["q, k", "q, k, v", "q, k, do",
                                   "v, do near max"])
@pytest.mark.parametrize("shape", [(1, 4, 2, 64, 32, None),
                                   (1, 8, 1, 60, 64, 16)])
def test_exact_path_follows_plain_autograd_class_by_class(shape, where):
    B, H, KV, T, hd, window = shape
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn((B, n, T, hd), generator=g)
                   for n in (H, KV, KV, H))
    if where.startswith("q, k"):
        q[0, 1, 10, 3], q[0, 2, 40, 5] = SPECIAL[0], SPECIAL[3]
        k[0, 0, 20, 7], k[0, KV - 1, 30, 9] = SPECIAL[1], SPECIAL[4]
    if where == "q, k, v":
        v[0, KV - 1, 50, 11], v[0, 0, 30, 12] = SPECIAL[0], SPECIAL[2]
    if where == "q, k, do":
        do[0, 1, 50, 3], do[0, 0, 45, 4] = SPECIAL[0], SPECIAL[2]
    if where == "v, do near max":
        v[0, 0, 30, 12], do[0, 1, 50, 3] = SPECIAL[3], SPECIAL[4]
    kw = dict(causal=True, window=window, q_offset=0)
    o = flash_attention_plain(q, k, v, **kw)
    lse = ref.attention_lse(q, k, **kw)
    got = ref.flash_attention_bwd_tf32x3_emulated(q, k, v, o, do, lse, **kw)
    want = kbwd.flash_attention_bwd_plain(q, k, v, do, **kw)
    for a, b in zip(got, want):
        for cls in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(cls(a), cls(b))
        fin = torch.isfinite(b)
        top = b[fin].abs().max() if fin.any() else torch.tensor(0.0)
        assert ((a - b).abs()[fin] <= 2e-4 * (1 + top)).all()


def test_fast_path_overflow_takes_the_exact_path():
    """The recompute rule: 3xTF32 gives NaN where the fp32 product
    overflows to inf, so non-finite fast-path gradients send the call to
    the exact path, whose classes are the plain autograd's."""
    q, k, v, do = ref.bwd_overflow_inputs(torch.Generator().manual_seed(7))
    assert max(x.abs().max().item() for x in (q, k, v, do)) <= 1e15
    kw = dict(causal=True, window=None, q_offset=0)
    o = flash_attention_plain(q, k, v, **kw)
    lse = ref.attention_lse(q, k, **kw)
    vis = ref._visible(64, 64, True, None, 0, "cpu")
    fast = ref._bwd_tf32x3_fast(q, k, v, do, lse, (do * o).sum(-1), vis)
    assert torch.isnan(fast[1]).any() and torch.isfinite(fast[0]).all()
    got = ref.flash_attention_bwd_tf32x3_emulated(q, k, v, o, do, lse, **kw)
    want = kbwd.flash_attention_bwd_plain(q, k, v, do, **kw)
    assert torch.isinf(want[1]).sum() > 0
    for a, b in zip(got, want):
        for cls in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(cls(a), cls(b))


def test_head_splits_fill_two_waves_of_dkv_ctas():
    """The dk / dv pass splits the group's q heads only where its grid is
    under two waves of the card's CTA slots (132 SMs): not at qwen3's 8 kv
    heads, twice at the hybrid's one kv head; a power of 2, never past the
    group, a group of 6 included."""
    assert kbwd.head_splits(4, 8, 2048, 128, 2, 132) == 1
    assert kbwd.head_splits(8, 8, 2048, 128, 2, 132) == 1
    assert kbwd.head_splits(4, 1, 3071, 256, 16, 132) == 2
    assert kbwd.head_splits(1, 1, 130, 256, 8, 132) == 8
    assert kbwd.head_splits(1, 1, 40, 64, 6, 132) == 6
    assert kbwd.head_splits(1, 2, 200, 128, 1, 132) == 1
    assert kbwd.head_splits(2, 1, 1024, 64, 16, 132) == 16


def test_cpu_ops_take_the_plain_autograd():
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs((1, 4, 2, 20, 20, 16, True, None, 0), seed=5))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    want = kbwd.flash_attention_bwd_plain(q, k, v, do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # CPU operands never reach a kernel wrapper, with or without grad
    x = torch.ones(4, 4, requires_grad=True)
    assert ops.matmul(x, x).requires_grad
    assert ops.lru_scan(x[None], x[None]).requires_grad


def test_backward_source_is_built_with_the_others():
    assert "flash_attention_bwd.cu" in _cuda.SOURCES
    assert (_cuda.CSRC / "flash_attention_bwd.cu").exists()
    assert kbwd.SOURCE.name == "flash_attention_bwd.cu"
