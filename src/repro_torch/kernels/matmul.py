"""Hopper panel-matmul kernel: bind, launch — and its plain version.

The kernel (``csrc/matmul.cu``) replaces the TPU kernel
``src/repro/kernels/matmul.py::matmul_pallas``, the SUMMA per-panel product.
It is CUDA C++ for ``sm_90a`` with a plain C interface, built at first use by
``kernels._cuda`` and loaded with ``ctypes``: warpgroup tensor-core products
(``wgmma``) in 3xTF32 for f32, as accurate as an fp32 FMA loop.  The
source's header note says what bounds it and what the design gives up.

``matmul_cuda`` is the wrapper: it checks device, dtype, shape and
contiguity, raises on anything else, launches on the current stream and
counts the launch in ``launches``.  ``recomputes`` counts, on the card, the
output tiles that the non-finite rule recomputed with the fp32 FMA loop
(``csrc/tf32x3.cuh``): 0 wherever operands and product are finite.
``matmul_plain`` is the same function in plain PyTorch (fp32 product, cast
to ``a.dtype`` — ``ref.matmul_ref``); it serves CPU tensors and is what the
card's result is held against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _cuda

SOURCE = _cuda.CSRC / "matmul.cu"

#: Kernel launches made through ``matmul_cuda`` (reset it to 0 to count a run).
launches = 0
#: Output tiles recomputed under the non-finite rule (``recomputes.read()``,
#: ``recomputes.reset()``).
recomputes = _cuda.DeviceCounter()

_ENTRY = {torch.float32: "repro_matmul_f32",
          torch.bfloat16: "repro_matmul_bf16"}


@functools.lru_cache(maxsize=None)
def library() -> _cuda.Library:
    """Build ``csrc/matmul.cu`` (once per source hash), load it and bind
    its entry points."""
    lib = _cuda.library(SOURCE.name)
    for name in _ENTRY.values():
        fn = getattr(lib.cdll, name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    """Shape/dtype contract shared by the kernel and its plain version:
    (M, K) @ (K, N), or (B, M, K) @ (B, K, N), both f32 or both bf16."""
    if a.dtype != b.dtype or a.dtype not in _ENTRY:
        raise TypeError(f"matmul takes two float32 or two bfloat16 "
                        f"operands, got {a.dtype} and {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"matmul takes (M, K) @ (K, N) or (B, M, K) @ "
                         f"(B, K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul shapes do not match: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 product, output in
    ``a.dtype``.  (On the card, a caller disables TF32 to make this the
    IEEE fp32 product.)"""
    _check(a, b)
    return (a.float() @ b.float()).to(a.dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on ``a @ b`` (contiguous CUDA operands)."""
    global launches
    _check(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul_cuda needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda needs contiguous operands")
    batch = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    N = b.shape[-1]
    if batch > 65535 or (M + 127) // 128 > 65535 or max(M, N, K) >= 2**31:
        raise ValueError(f"matmul_cuda grid limit exceeded by "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    out = torch.empty(tuple(a.shape[:-1]) + (N,), dtype=a.dtype,
                      device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    fn = getattr(library().cdll, _ENTRY[a.dtype])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, M, N, K,
                 M * K, K * N, M * N,
                 recomputes.buffer(a.device).data_ptr(), stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed with CUDA error "
                           f"{err} for {tuple(a.shape)} @ {tuple(b.shape)}")
    launches += 1
    return out
