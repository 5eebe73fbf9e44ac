"""The numerical contract of the kernels' 3xTF32 arithmetic, on the CPU.

The Hopper kernels (``csrc/matmul.cu``, ``csrc/flash_attention.cu``) run
their f32 products as three TF32 tensor-core products of a split operand,
big = tf32(x) (rounded to nearest, ties away) and small = x - big (which
the tensor core truncates to TF32).  ``repro_torch.kernels.ref`` emulates
that arithmetic; these tests hold the emulation to the JAX reference's
oracles (``repro.kernels.ref``) with the reference kernel tests' F32
tolerance (2e-4) and to a float64 product (rel_err 1e-5, SUMMA's gate),
and show that one TF32 product alone misses that gate.  On infinite, NaN
and near-max operands the emulation, with the kernels' non-finite rule
(a tile holding a non-finite output is recomputed in fp32), gives what the
plain product gives, class by class; without the rule 3xTF32 gives NaN.
The kernels themselves are held to their plain versions on the card by
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


F32_MAX = float(np.finfo(np.float32).max)        # 3.4028235e38
NONFINITE = [float("inf"), float("-inf"), float("nan"), F32_MAX, -3.4e38]


def _same_classes(got: torch.Tensor, want: torch.Tensor) -> None:
    """Non-finite exactly where ``want`` is, with its class; the finite
    values within the F32 tolerance."""
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(kind(got), kind(want)), kind.__name__
    finite = torch.isfinite(want)
    torch.testing.assert_close(got[finite], want[finite], **F32_TOL)


@pytest.mark.parametrize("value", NONFINITE, ids=str)
@pytest.mark.parametrize("operand", ["a", "b"])
def test_tf32x3_product_keeps_ieee_classes_on_nonfinite_operands(value,
                                                                 operand):
    """One special entry in ``a`` (row 3) or ``b`` (row 7, column 2), and a
    column of exact 1.0 in ``b`` (its TF32 small part is 0, so a split
    that zeroes an infinite x's small part would still give inf . 0 in a
    cross term): the emulated kernel product equals ``a @ b`` by class
    and, where finite, by value.  The output spans 2 x 2 tiles of 128, so
    tiles the special entry does not touch keep the 3xTF32 sum."""
    a, b = (torch.from_numpy(x) for x in _operands(160, 96, 200, seed=3))
    b[:, 0] = 1.0
    if operand == "a":
        a[3, 5] = value
    else:
        b[7, 2] = value
    want = a @ b
    assert not torch.isfinite(want).all() or abs(value) < float("inf")
    got = ref.matmul_tf32x3_emulated(a, b)
    _same_classes(got, want)
    # without the rule 3xTF32 turns every product with an entry whose
    # TF32 rounding is not finite (inf, NaN, F32_MAX) into NaN
    raw = ref._tf32x3(a, b)
    touched = raw[3] if operand == "a" else raw[:, 2]
    if not torch.isfinite(ref.split_tf32(torch.tensor([value]))[0]).all():
        assert torch.isnan(touched).all()
    # tiles away from the entry are the 3xTF32 sum, untouched by the rule
    far = (slice(128, 160), slice(None)) if operand == "a" \
        else (slice(None), slice(128, 200))
    assert torch.equal(got[far], raw[far])


def test_tf32x3_attention_follows_the_plain_version_on_nonfinite_entries():
    """q, k and v each with one infinite and one near-max entry (causal,
    GQA): the flash kernel's emulated arithmetic with its rule (per q
    tile, and every tile when V holds a non-finite element) equals the
    plain version by class and, where finite, by value.  An infinite v
    reaches every row through the masked keys' zero weights, as in the
    plain version and in the reference's ``attention_ref``."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 4, 96, 64), (1, 2, 96, 64), (1, 2, 96, 64)))
    q[0, 1, 10, 3], q[0, 2, 70, 5] = float("inf"), F32_MAX
    _same_classes(ref.attention_tf32x3_emulated(q, k, v),
                  flash_attention_plain(q, k, v))
    k[0, 0, 20, 7], k[0, 1, 40, 9] = float("-inf"), F32_MAX
    _same_classes(ref.attention_tf32x3_emulated(q, k, v),
                  flash_attention_plain(q, k, v))
    v[0, 1, 50, 11], v[0, 0, 30, 12] = float("inf"), F32_MAX
    want = flash_attention_plain(q, k, v)
    assert not torch.isfinite(want[0, 2:, :, 11]).any()   # kv head 1
    _same_classes(ref.attention_tf32x3_emulated(q, k, v), want)


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
