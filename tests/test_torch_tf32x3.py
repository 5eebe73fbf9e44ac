"""The numerical contract of the kernels' 3xTF32 arithmetic, on the CPU.

The Hopper kernels (``csrc/matmul.cu``, ``csrc/flash_attention.cu``) run
their f32 products as three TF32 tensor-core products of a split operand,
big = tf32(x) (rounded to nearest, ties away) and small = x - big (which
the tensor core truncates to TF32).  ``repro_torch.kernels.ref`` emulates
that arithmetic; these tests hold the emulation to the JAX reference's
oracles (``repro.kernels.ref``) with the reference kernel tests' F32
tolerance (2e-4) and to a float64 product (rel_err 1e-5, SUMMA's gate),
and show that one TF32 product alone misses that gate.  The kernels
themselves are held to their plain versions on the card by
``tests/test_torch_gpu.py``.  The last test checks that a kernel's build
is named by its headers too (nothing is compiled).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _cuda, ref

F32_TOL = dict(rtol=2e-4, atol=2e-4)


def _operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, K)).astype(np.float32),
            rng.normal(size=(K, N)).astype(np.float32))


def _rel_err(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("M,K,N", [(32, 16384, 32), (64, 4096, 64)])
def test_tf32x3_product_matches_the_reference_and_float64(M, K, N):
    a, b = _operands(M, K, N)
    got = ref.matmul_tf32x3_emulated(torch.from_numpy(a), torch.from_numpy(b))
    want = np.array(jref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    torch.testing.assert_close(got, torch.from_numpy(want), **F32_TOL)
    assert _rel_err(got, a.astype(np.float64) @ b.astype(np.float64)) <= 1e-5


@pytest.mark.parametrize("M,K,N", [(32, 16384, 32), (64, 4096, 64)])
def test_one_tf32_product_misses_the_float64_gate(M, K, N):
    """Why three products: plain TF32 (big.big) is ~30x outside 1e-5."""
    a, b = _operands(M, K, N)
    got = ref.split_tf32(torch.from_numpy(a))[0] \
        @ ref.split_tf32(torch.from_numpy(b))[0]
    assert _rel_err(got, a.astype(np.float64) @ b.astype(np.float64)) > 1e-5


def test_split_is_exact_for_bf16_and_rounds_to_nearest():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    big, small = ref.split_tf32(x.to(torch.bfloat16))
    assert torch.equal(small, torch.zeros_like(small))
    assert torch.equal(big, x.to(torch.bfloat16).float())
    big, small = ref.split_tf32(x)
    assert torch.equal(big.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(big, dtype=torch.int32))
    assert torch.equal(small.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(small, dtype=torch.int32))
    # nearest, ties away from zero: |x - big| <= half a TF32 ulp of big
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 11)
    assert bool(((x - big).abs() <= ulp / 2).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert ref.split_tf32(tie)[0].tolist() == [1.0 + 2.0 ** -10,
                                               -(1.0 + 2.0 ** -10)]
    assert ((x - big - small).abs() <= 2.0 ** -20 * x.abs()).all()


@pytest.mark.parametrize("B,H,KV,T,hd,window", [
    (1, 4, 2, 96, 128, None),      # causal, GQA 2:1, hd 128
    (1, 4, 1, 80, 256, 24),        # sliding window, MQA, hd 256
])
def test_tf32x3_attention_matches_the_reference(B, H, KV, T, hd, window):
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, T, hd), (B, KV, T, hd), (B, KV, T, hd)))
    got = ref.attention_tf32x3_emulated(*map(torch.from_numpy, (q, k, v)),
                                        window=window)
    want = np.array(jref.attention_ref(*map(jnp.asarray, (q, k, v)),
                                        window=window))
    torch.testing.assert_close(got, torch.from_numpy(want), **F32_TOL)


def test_build_tag_covers_the_included_headers(tmp_path, monkeypatch):
    """An edit to a ``csrc/*.cuh`` header names a new build, as an edit to
    the source does; the tag is a hash, so nothing is compiled."""
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _cuda.tag("k.cu")
    assert _cuda.tag("k.cu") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _cuda.tag("k.cu")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _cuda.tag("k.cu") not in (first, second)
    assert not list(tmp_path.glob("*.so"))
