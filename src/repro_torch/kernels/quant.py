"""Hopper dequant-fused int4 matmul: bind, launch — and its plain version.

The kernel (``csrc/q4_matmul.cu``) replaces the TPU kernel
``src/repro/kernels/quant.py::q4_matmul_pallas``: ``a @ dequantize_q4(packed,
scales)`` for the ``q4_shared`` weight wire format, with the packed weight
unpacked and rescaled tile by tile inside the k loop (never densified in
device memory).  It is CUDA C++ for ``sm_90a`` with a plain C interface,
built at first use by ``kernels._cuda`` and loaded with ``ctypes``:
warpgroup tensor-core products (``wgmma``) in 3xTF32, as accurate as an
fp32 FMA loop, with the weight unpacked in the register operand.

Operands: ``a`` f32 or bf16 ``(M, K)``; ``packed`` uint8 ``(K // 2, N)``
(byte *r* = row 2r | row 2r+1 << 4, codes + 8); ``scales`` f32
``(K // group, N)``; or all three with one leading batch dim.  ``group`` is
even and divides K.  The output is ``(M, N)`` in ``a.dtype``, accumulated in
fp32.

``q4_matmul_cuda`` checks device, dtype, shape and contiguity, raises on
anything else, launches on the current stream and counts the launch in
``launches``; ``recomputes`` counts, on the card, the output tiles that the
non-finite rule recomputed with the fp32 FMA loop (``csrc/tf32x3.cuh``).
``q4_matmul_plain`` is the same function in plain PyTorch; it serves CPU
tensors and is what the card's result is held against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _cuda

SOURCE = _cuda.CSRC / "q4_matmul.cu"

#: Kernel launches made through ``q4_matmul_cuda`` (reset to 0 to count a run).
launches = 0
#: Output tiles recomputed under the non-finite rule (``recomputes.read()``,
#: ``recomputes.reset()``).
recomputes = _cuda.DeviceCounter()

_ENTRY = {torch.float32: "repro_q4_matmul_f32",
          torch.bfloat16: "repro_q4_matmul_bf16"}


@functools.lru_cache(maxsize=None)
def library() -> _cuda.Library:
    """Build ``csrc/q4_matmul.cu`` (once per source hash), load it and bind
    its entry points."""
    lib = _cuda.library(SOURCE.name)
    for name in _ENTRY.values():
        fn = getattr(lib.cdll, name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
           group: int) -> None:
    """Shape/dtype contract shared by the kernel and its plain version."""
    if a.dtype not in _ENTRY:
        raise TypeError(f"q4_matmul takes a float32 or bfloat16 activation, "
                        f"got {a.dtype}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"q4_matmul takes uint8 packed codes and float32 "
                        f"scales, got {packed.dtype} and {scales.dtype}")
    if a.dim() not in (2, 3) or packed.dim() != a.dim() \
            or scales.dim() != a.dim():
        raise ValueError(f"q4_matmul takes (M, K), (K/2, N), (K/g, N) "
                         f"operands or all three batched, got "
                         f"{tuple(a.shape)}, {tuple(packed.shape)}, "
                         f"{tuple(scales.shape)}")
    K, N = a.shape[-1], packed.shape[-1]
    if group < 2 or group % 2 or K % group:
        raise ValueError(f"K={K} must divide into even groups of {group}")
    if packed.shape[-2] * 2 != K or tuple(scales.shape[-2:]) != (
            K // group, N) or not (a.shape[:-2] == packed.shape[:-2]
                                   == scales.shape[:-2]):
        raise ValueError(f"q4_matmul shapes do not match: a "
                         f"{tuple(a.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, group {group}")


def q4_matmul_plain(a: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, group: int = 32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``a`` widened to fp32 times
    the dequantized weight, output in ``a.dtype``.  (On the card, a caller
    disables TF32 to make this the IEEE fp32 product.)"""
    from repro_torch.comm.quantize import dequantize_q4
    _check(a, packed, scales, group)
    w = dequantize_q4(packed, scales, group=group)
    return (a.float() @ w).to(a.dtype)


def q4_matmul_cuda(a: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor, group: int = 32) -> torch.Tensor:
    """Launch the Hopper kernel (contiguous CUDA operands on one device)."""
    global launches
    _check(a, packed, scales, group)
    if a.device.type != "cuda" or packed.device != a.device \
            or scales.device != a.device:
        raise ValueError(f"q4_matmul_cuda needs every operand on one CUDA "
                         f"device, got {a.device}, {packed.device} and "
                         f"{scales.device}")
    if not (a.is_contiguous() and packed.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("q4_matmul_cuda needs contiguous operands")
    batch = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    N = packed.shape[-1]
    if batch > 65535 or (M + 127) // 128 > 65535 or max(M, N, K) >= 2**31:
        raise ValueError(f"q4_matmul_cuda grid limit exceeded by a "
                         f"{tuple(a.shape)}, packed {tuple(packed.shape)}")
    out = torch.empty(tuple(a.shape[:-1]) + (N,), dtype=a.dtype,
                      device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    fn = getattr(library().cdll, _ENTRY[a.dtype])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), batch, M, N, K, group, M * K, (K // 2) * N,
                 (K // group) * N, M * N,
                 recomputes.buffer(a.device).data_ptr(), stream)
    if err:
        raise RuntimeError(f"q4_matmul kernel launch failed with CUDA error "
                           f"{err} for a {tuple(a.shape)}, packed "
                           f"{tuple(packed.shape)}")
    launches += 1
    return out
