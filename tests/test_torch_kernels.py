"""The port's kernels and oracles held against the JAX reference.

Same numpy inputs (from a seed) go to ``repro.kernels`` and to
``repro_torch.kernels``.  Tolerances are the reference's own
(``tests/test_kernels.py``): F32 2e-4, BF16 2e-2, matmul rtol K-scaled and
atol x8.  On the CPU the port's ``ops.matmul`` takes the kernel's plain
version; the CUDA kernel itself is checked on the card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
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
