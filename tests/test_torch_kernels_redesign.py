"""The redesigned kernels' arithmetic, emulated on the CPU, held against the
JAX reference's Pallas kernels.

``csrc/q4_matmul.cu`` (3xTF32 warpgroup products, the weight unpacked in
the register operand) and ``csrc/lru_scan.cu`` (T split into chunks across
CTAs, the carry passed forward) run only on the card.
``ref.q4_matmul_tf32x3_emulated`` and ``ref.lru_scan_chunked_emulated``
repeat their arithmetic here.  The same numpy inputs, from a seed, go to
them and to ``repro.kernels.quant.q4_matmul_pallas`` /
``repro.kernels.lru_scan.lru_scan_pallas`` in interpret mode, as the
reference's own kernel tests run those: f32 within 2e-4, bf16 within 2e-2,
and the f32 q4 product within 1e-5 of a float64 product (relative to its
largest entry).  The shapes include group 2, 6 and 64, N = 129 and T not a
multiple of the chunk.  The kernels themselves are held to their plain
versions on the card by ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import quantize as jqz
from repro.kernels.lru_scan import lru_scan_pallas
from repro.kernels.quant import q4_matmul_pallas
from repro_torch.comm import quantize as qz
from repro_torch.kernels import ref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


@pytest.mark.parametrize("M,K,N,group", [
    (8, 64, 16, 32),       # one scale row per 32-deep tile
    (5, 96, 129, 32),      # ragged M, N = 129 (unaligned packed rows)
    (16, 128, 40, 2),      # group 2: 16 scale rows per tile
    (12, 256, 72, 64),     # group 64: two tiles share a scale row
    (3, 12, 7, 6),         # group 6, K below one tile
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q4_emulation_matches_the_pallas_kernel(M, K, N, group, dtype):
    rng = np.random.default_rng(21)
    a = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    jd, td = DTYPES[dtype]
    jp, js = jax.jit(lambda v: jqz.quantize_q4(v, group=group))(
        jnp.asarray(w))
    want = q4_matmul_pallas(jnp.asarray(a).astype(jd), jp, js, group=group,
                            block_m=M, block_n=N, interpret=True)
    packed = torch.from_numpy(np.array(jp))
    scales = torch.from_numpy(np.array(js))
    got = ref.q4_matmul_tf32x3_emulated(torch.from_numpy(a).to(td), packed,
                                        scales, group)
    assert got.shape == (M, N) and got.dtype == td
    np.testing.assert_allclose(_np(got), np.asarray(want).astype(np.float32),
                               **TOL[dtype])
    if dtype == "float32":
        w64 = qz.dequantize_q4(packed, scales, group=group).double().numpy()
        exact = a.astype(np.float64) @ w64
        err = np.abs(got.double().numpy() - exact).max()
        assert err <= 1e-5 * np.abs(exact).max()


@pytest.mark.parametrize("B,T,C,chunk,block_t", [
    (1, 200, 48, 128, 40),     # T not a multiple of the chunk
    (2, 256, 128, 64, 64),     # whole chunks
    (3, 7, 5, 128, 7),         # T below one chunk, ragged C
    (1, 100, 130, 32, 50),     # C past two 64-channel tiles
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_scan_emulation_matches_the_pallas_kernel(B, T, C, chunk,
                                                          block_t, dtype):
    rng = np.random.default_rng(22)
    a = rng.uniform(0.5, 0.999, size=(B, T, C)).astype(np.float32)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = lru_scan_pallas(jnp.asarray(a).astype(jd),
                           jnp.asarray(x).astype(jd), block_t=block_t,
                           block_c=C, interpret=True)
    got = ref.lru_scan_chunked_emulated(torch.from_numpy(a).to(td),
                                        torch.from_numpy(x).to(td), chunk)
    assert got.shape == (B, T, C) and got.dtype == td
    np.testing.assert_allclose(_np(got), np.asarray(want).astype(np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("T", [64, 200, 1000])
def test_chunked_scan_carries_like_cumsum(T):
    """a = 1: the carries passed between chunks are integer sums, exact in
    f32, so the chunked scan is ``cumsum`` bit for bit."""
    x = torch.from_numpy(np.random.default_rng(23).integers(
        -5, 6, size=(2, T, 9)).astype(np.float32))
    got = ref.lru_scan_chunked_emulated(torch.ones_like(x), x)
    assert torch.equal(got, x.cumsum(1))
