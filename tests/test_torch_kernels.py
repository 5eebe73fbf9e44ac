"""The port's kernels and oracles held against the JAX reference.

Same numpy inputs (from a seed) go to ``repro.kernels`` and to
``repro_torch.kernels``.  Tolerances are the reference's own
(``tests/test_kernels.py``): F32 2e-4, BF16 2e-2, matmul rtol K-scaled and
atol x8.  On the CPU the port's ``ops.matmul`` takes the kernel's plain
version; the CUDA kernels themselves are checked on the card by
``tests/test_torch_gpu.py``.  ``ops.flash_attention``'s plain version is
held against the reference's Pallas kernel in interpret mode over the
parametrisation of ``tests/test_kernels.py``; so is ``ops.lru_scan``'s
(f32 2e-4, bf16 5e-2, and the a = 1 carry against ``cumsum``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import lru_scan as klru
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops, ref

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """One numpy draw as a (jax, torch) pair in ``dtype``."""
    x = rng.normal(size=shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,Tq,Tkv,hd,causal,window", [
    (1, 4, 4, 32, 32, 16, True, None),      # MHA square
    (2, 8, 2, 16, 16, 8, True, None),       # GQA 4:1
    (1, 4, 1, 8, 24, 8, True, None),        # MQA, q at the end
    (1, 2, 2, 32, 32, 8, True, 8),          # sliding window
    (1, 2, 2, 16, 16, 8, False, None),      # non-causal
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_reference(B, H, KV, Tq, Tkv, hd, causal,
                                         window, dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng, (B, H, Tq, hd), dtype)
    jk, tk = _pair(rng, (B, KV, Tkv, hd), dtype)
    jv, tv = _pair(rng, (B, KV, Tkv, hd), dtype)
    q_off = Tkv - Tq
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window,
                              q_offset=q_off)
    got = ref.attention_ref(tq, tk, tv, causal=causal, window=window,
                            q_offset=q_off)
    assert got.dtype == DTYPES[dtype][1]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("M,K,N", [(8, 16, 4), (33, 7, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ref_matches_reference(M, K, N, dtype):
    rng = np.random.default_rng(1)
    ja, ta = _pair(rng, (M, K), dtype)
    jb, tb = _pair(rng, (K, N), dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(ref.matmul_ref(ta, tb)),
                               _np(jref.matmul_ref(ja, jb)), **tol)


@pytest.mark.parametrize("B,T,C", [(1, 16, 8), (2, 33, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lru_scan_ref_matches_reference(B, T, C, dtype):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 1.0, size=(B, T, C)).astype(np.float32)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = jref.lru_scan_ref(jnp.asarray(a).astype(jd),
                             jnp.asarray(x).astype(jd))
    got = ref.lru_scan_ref(torch.from_numpy(a).to(td),
                           torch.from_numpy(x).to(td))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# ops.matmul (the SUMMA panel product) vs the reference's Pallas kernel
# ---------------------------------------------------------------------------

def _matmul_tol(dtype, K):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    return dict(rtol=tol["rtol"] * max(1, K // 256 + 1), atol=tol["atol"] * 8)


@pytest.mark.parametrize("M,K,N", [
    (128, 128, 128), (256, 128, 384), (128, 512, 128), (96, 160, 224),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_matmul_matches_pallas_interpret(M, K, N, dtype):
    rng = np.random.default_rng(3)
    ja, ta = _pair(rng, (M, K), dtype)
    jb, tb = _pair(rng, (K, N), dtype)
    want = jops.matmul(ja, jb, block_m=64, block_n=64, block_k=64,
                       interpret=True)
    got = ops.matmul(ta, tb)
    assert got.shape == (M, N) and got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), **_matmul_tol(dtype, K))


def test_ops_matmul_batched_is_per_rank_product():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(3, 10, 6)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 6, 7)).astype(np.float32))
    got = ops.matmul(a, b)
    for r in range(3):
        torch.testing.assert_close(got[r], ref.matmul_ref(a[r], b[r]))


@pytest.mark.parametrize("a_shape,b_shape,dtypes,err", [
    ((4, 5), (6, 3), ("float32", "float32"), ValueError),     # K mismatch
    ((2, 4, 5), (3, 5, 3), ("float32", "float32"), ValueError),  # batch
    ((4, 5), (5, 3), ("float32", "bfloat16"), TypeError),     # dtype mix
    ((4,), (4, 3), ("float32", "float32"), ValueError),       # rank
])
def test_ops_matmul_rejects_bad_operands(a_shape, b_shape, dtypes, err):
    a = torch.zeros(a_shape, dtype=DTYPES[dtypes[0]][1])
    b = torch.zeros(b_shape, dtype=DTYPES[dtypes[1]][1])
    with pytest.raises(err):
        ops.matmul(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors or raises — it never
    falls back to the plain version."""
    a, b = torch.ones(4, 4), torch.ones(4, 4)
    before = kmatmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        kmatmul.matmul_cuda(a, b)
    assert kmatmul.launches == before


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("layout", kmatmul.LAYOUTS)
def test_matmul_plain_layouts_are_the_transposed_products(layout, batch):
    """Each layout's plain version is ``op(a) @ op(b)`` with its operands
    given row-major: nt's ``b`` as (N, K), tn's ``a`` as (K, M)."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=batch + (5, 7)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=batch + (7, 4)).astype(np.float32))
    given_a = a.mT.contiguous() if layout == "tn" else a
    given_b = b.mT.contiguous() if layout == "nt" else b
    got = kmatmul.matmul_plain(given_a, given_b, layout)
    assert got.shape == batch + (5, 4)
    torch.testing.assert_close(got, a @ b)
    with pytest.raises(ValueError, match="do not match"):
        kmatmul.matmul_plain(given_a.mT, given_b, layout)


@pytest.mark.parametrize("transposed", [False, True])
def test_matmul_function_gives_autograds_gradients(transposed):
    """``ops.Matmul``'s CPU path (the layouts' plain versions) passes
    float64 ``gradcheck``, for a ``b`` given as the transpose of a
    contiguous tensor (a tied unembedding) too."""
    g = torch.Generator().manual_seed(7)
    a = torch.randn((2, 5, 3), dtype=torch.float64, generator=g,
                    requires_grad=True)
    b = torch.randn((2, 4, 3) if transposed else (2, 3, 4),
                    dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: ops.Matmul.apply(a, b.mT if transposed else b), (a, b))


def test_dense_keeps_torch_matmul_off_the_card():
    """``models.parallel.dense`` (``ParallelCtx.mm``'s product) gives CPU
    and meta tensors ``x @ w`` itself, batched or not, and launches
    nothing."""
    from repro_torch.models.parallel import dense
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 128, 8), generator=g)
    w, wr = torch.randn((8, 6), generator=g), torch.randn((2, 8, 6),
                                                          generator=g)
    before = kmatmul.launches
    assert torch.equal(dense(x, w), x @ w)
    assert torch.equal(dense(x, wr), torch.bmm(x, wr))
    assert dense(x.to("meta"), w.to("meta")).shape == (2, 128, 6)
    assert kmatmul.launches == before


# ---------------------------------------------------------------------------
# ops.flash_attention (the prefill attention) vs the reference's Pallas
# kernel in interpret mode — tests/test_kernels.py's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,Tq,Tkv,hd", [
    (1, 4, 4, 128, 128, 64),       # MHA square
    (2, 8, 2, 128, 128, 64),       # GQA 4:1
    (1, 4, 1, 64, 256, 32),        # MQA, Tq != Tkv (q at the end)
    (1, 3, 3, 96, 96, 16),         # non-128 shapes (padding path)
    (2, 4, 2, 256, 256, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_flash_attention_matches_pallas_interpret(B, H, KV, Tq, Tkv, hd,
                                                      dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng, (B, H, Tq, hd), dtype)
    jk, tk = _pair(rng, (B, KV, Tkv, hd), dtype)
    jv, tv = _pair(rng, (B, KV, Tkv, hd), dtype)
    q_off = Tkv - Tq
    want = jops.flash_attention(jq, jk, jv, causal=True, q_offset=q_off,
                                block_q=64, block_kv=64, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=q_off)
    assert got.shape == (B, H, Tq, hd) and got.dtype == DTYPES[dtype][1]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("window", [16, 64])
def test_ops_flash_attention_window_matches_pallas_interpret(window):
    rng = np.random.default_rng(1)
    B, H, T, hd = 1, 2, 128, 32
    jq, tq = _pair(rng, (B, H, T, hd), "float32")
    jk, tk = _pair(rng, (B, H, T, hd), "float32")
    jv, tv = _pair(rng, (B, H, T, hd), "float32")
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                block_q=32, block_kv=32, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_ops_flash_attention_noncausal_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    B, H, T, hd = 1, 2, 64, 32
    jq, tq = _pair(rng, (B, H, T, hd), "float32")
    jk, tk = _pair(rng, (B, H, T, hd), "float32")
    jv, tv = _pair(rng, (B, H, T, hd), "float32")
    want = jops.flash_attention(jq, jk, jv, causal=False, block_q=32,
                                block_kv=32, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_flash_attention_model_layout_is_the_transpose():
    """``layout="bthd"`` (the model's) gives the (B, H, T, hd) result
    transposed, from strided views read in place."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 40, 4, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(2, 40, 2, 2, 16)).astype(
        np.float32))
    k, v = kv[:, :, 0], kv[:, :, 1]            # strided, as attn_block's
    got = ops.flash_attention(q, k, v, window=8, q_offset=0, layout="bthd")
    want = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), window=8)
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=0)
    assert kflash.kernel_ready(k) and kflash.kernel_ready(v)
    assert not kflash.kernel_ready(q[..., 1:])


@pytest.mark.parametrize("shapes,kw,err", [
    (((1, 4, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)), {}, ValueError),  # GQA
    (((1, 4, 8, 16), (1, 2, 8, 8), (1, 2, 8, 8)), {}, ValueError),    # hd
    (((1, 4, 8, 16), (1, 2, 0, 16), (1, 2, 0, 16)), {}, ValueError),  # Tkv
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), {"window": 0},
     ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), {"layout": "tbhd"},
     ValueError),
    (((4, 8, 16), (2, 8, 16), (2, 8, 16)), {}, ValueError),           # rank
])
def test_ops_flash_attention_rejects_bad_operands(shapes, kw, err):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(err):
        ops.flash_attention(q, k, v, **kw)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 8, 16)
    before = kflash.launches
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attention_cuda(q, q, q)
    assert kflash.launches == before


# ---------------------------------------------------------------------------
# ops.lru_scan (the RG-LRU recurrence) vs the reference's Pallas kernel in
# interpret mode — tests/test_kernels.py's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,C,bt,bc", [
    (1, 256, 128, 64, 64), (2, 512, 64, 128, 64), (1, 100, 48, 32, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_lru_scan_matches_pallas_interpret(B, T, C, bt, bc, dtype):
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 0.999, size=(B, T, C)).astype(np.float32)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = jops.lru_scan(jnp.asarray(a).astype(jd), jnp.asarray(x).astype(jd),
                         block_t=bt, block_c=bc, interpret=True)
    got = ops.lru_scan(torch.from_numpy(a).to(td), torch.from_numpy(x).to(td))
    assert got.shape == (B, T, C) and got.dtype == td
    tol = F32_TOL if dtype == "float32" else dict(rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_ops_lru_scan_carries_state_like_cumsum():
    """a = 1 makes the scan a running sum: the carry flows over all of T
    (the reference kernel's carry across its time blocks)."""
    B, T, C = 1, 128, 32
    a, x = np.ones((B, T, C), np.float32), np.ones((B, T, C), np.float32)
    want = jops.lru_scan(jnp.asarray(a), jnp.asarray(x), block_t=32,
                         block_c=32, interpret=True)
    got = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    torch.testing.assert_close(got, torch.from_numpy(x).cumsum(1),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("a_shape,x_shape,dtypes,err", [
    ((1, 4, 8), (1, 4, 8), ("float32", "bfloat16"), TypeError),   # mix
    ((1, 4, 8), (1, 5, 8), ("float32", "float32"), ValueError),    # shape
    ((4, 8), (4, 8), ("float32", "float32"), ValueError),          # rank
])
def test_ops_lru_scan_rejects_bad_operands(a_shape, x_shape, dtypes, err):
    a = torch.zeros(a_shape, dtype=DTYPES[dtypes[0]][1])
    x = torch.zeros(x_shape, dtype=DTYPES[dtypes[1]][1])
    with pytest.raises(err):
        ops.lru_scan(a, x)
    with pytest.raises(TypeError):
        ops.lru_scan(torch.zeros(1, 2, 3).half(), torch.zeros(1, 2, 3).half())


def test_lru_scan_kernel_wrapper_refuses_cpu_tensors():
    a = torch.ones(1, 8, 4)
    before = klru.launches
    with pytest.raises(ValueError, match="CUDA"):
        klru.lru_scan_cuda(a, a)
    assert klru.launches == before
