"""The lru_scan backward (``kernels/lru_scan_bwd.py``,
``csrc/lru_scan_bwd.cu``) against the JAX reference's gradient.

The reference trains the RG-LRU through ``jax.vjp`` of its own associative
scan (``repro.kernels.ref.lru_scan_ref``); the port routes the forward
through its kernel and owes the backward.  The same numpy inputs, from a
seed, go to ``jax.vjp`` of the reference's scan and to the port:
``lru_scan_bwd_plain`` (the sequential fp32 loop, the card's kernel's plain
version) and the autograd of ``ops.lru_scan`` on the CPU, f32 within
``F32_TOL`` (2e-4, ``tests/test_kernels.py``'s).  The kernel's chunked
arithmetic (``ref.lru_scan_bwd_chunked_emulated``: 128-step chunks with a
carry passed backward, a one row ahead) is held to the plain version, T
not a multiple of the chunk included.  The kernel itself runs only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import lru_scan_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lru_scan_bwd import lru_scan_bwd_plain

F32_TOL = dict(rtol=2e-4, atol=2e-4)

SHAPES = [(2, 64, 16), (1, 300, 24), (3, 129, 5), (2, 1, 7)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, size=shape).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    gh = rng.normal(size=shape).astype(np.float32)
    return a, x, gh


@jax.jit
def _vjp(a, x, gh):
    h, vjp = jax.vjp(lru_scan_ref, a, x)
    return (h,) + vjp(gh)


def _jax_grads(a, x, gh):
    return tuple(np.asarray(v) for v in _vjp(a, x, gh))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_and_autograd_match_jax_vjp(shape):
    a, x, gh = _inputs(shape, 31)
    h_j, da_j, dx_j = _jax_grads(a, x, gh)
    at, xt = (torch.from_numpy(v).requires_grad_(True) for v in (a, x))
    h = ops.lru_scan(at, xt)
    np.testing.assert_allclose(h.detach().numpy(), h_j, **F32_TOL)
    da, dx = torch.autograd.grad(h, (at, xt), torch.from_numpy(gh))
    np.testing.assert_allclose(dx.numpy(), dx_j, **F32_TOL)
    np.testing.assert_allclose(da.numpy(), da_j, **F32_TOL)
    pdx, pda = lru_scan_bwd_plain(torch.from_numpy(a), h.detach(),
                                  torch.from_numpy(gh))
    np.testing.assert_allclose(pdx.numpy(), dx_j, **F32_TOL)
    np.testing.assert_allclose(pda.numpy(), da_j, **F32_TOL)


@pytest.mark.parametrize("shape,chunk", [((2, 300, 24), 128),
                                         ((1, 257, 9), 64),
                                         ((3, 40, 5), 16),
                                         ((1, 7, 3), 128)])
def test_chunked_emulation_matches_the_plain_backward(shape, chunk):
    a, x, gh = (torch.from_numpy(v) for v in _inputs(shape, 32))
    h = ops.lru_scan(a, x)
    want = lru_scan_bwd_plain(a, h, gh)
    got = ref.lru_scan_bwd_chunked_emulated(a, h, gh, chunk=chunk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_TOL)
    # the last chunk starts from a zero carry: the sequential loop's bits
    last = (shape[1] - 1) // chunk * chunk
    assert torch.equal(got[0][:, last:], want[0][:, last:])


def test_the_a_equals_one_carry_is_a_reversed_cumsum():
    ones = torch.ones((1, 300, 8))
    h = ops.lru_scan(ones, ones)
    dx, da = ref.lru_scan_bwd_chunked_emulated(ones, h, ones)
    assert torch.equal(dx, ones.flip(1).cumsum(1).flip(1))
    assert torch.equal(da[:, 0], torch.zeros(1, 8))


def test_the_rglru_scan_gradient_through_exp_matches_jax():
    """``rglru_scan`` takes log_a and exponentiates before the kernel:
    autograd carries da on through the exp, as the reference's log-space
    scan differentiates."""
    from repro_torch.models.rglru import rglru_scan
    rng = np.random.default_rng(33)
    log_a = -rng.uniform(0.001, 0.7, size=(2, 50, 6)).astype(np.float32)
    x = rng.normal(size=(2, 50, 6)).astype(np.float32)
    gh = rng.normal(size=(2, 50, 6)).astype(np.float32)
    dla_j, dx_j = jax.jit(lambda la, v, g: jax.vjp(
        lambda la_, v_: lru_scan_ref(jnp.exp(la_), v_), la, v)[1](g))(
        log_a, x, gh)
    lt, xt = (torch.from_numpy(v).requires_grad_(True) for v in (log_a, x))
    dla, dx = torch.autograd.grad(rglru_scan(lt, xt), (lt, xt),
                                  torch.from_numpy(gh))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **F32_TOL)
    np.testing.assert_allclose(dla.numpy(), np.asarray(dla_j), **F32_TOL)


def test_meta_tensors_count_the_backward_kernel():
    a, x = (torch.empty((2, 10, 4), device="meta", requires_grad=True)
            for _ in range(2))
    with ops.counting() as costs:
        ops.lru_scan(a, x).sum().backward()
    assert [c.name for c in costs] == ["lru_scan", "lru_scan_bwd"]
    assert costs[1].bytes == 5 * 4 * 80 and costs[1].flops == 3 * 80
    assert a.grad.shape == x.grad.shape == (2, 10, 4)
