"""Hopper linear-recurrence scan: bind, launch — and its plain version.

The kernel (``csrc/lru_scan.cu``) replaces the TPU kernel
``src/repro/kernels/lru_scan.py::lru_scan_pallas``: h_t = a_t * h_{t-1} +
x_t elementwise over channels on (B, T, C), h_{-1} = 0, an fp32 carry and
the output in x's dtype.  It is CUDA C++ for ``sm_90a`` with a plain C
interface, built at first use by ``kernels._cuda`` and loaded with
``ctypes``: T is split into chunks across CTAs, the carry passed forward
by a decoupled look-back (``ref.lru_scan_chunked_emulated`` repeats its
arithmetic on the CPU).  The source's header note says what bounds it and
what the design gives up.

``lru_scan_cuda`` checks device, dtype, shape and contiguity, raises on
anything else, launches on the current stream and counts the launch in
``launches``.  ``lru_scan_plain`` is the same function in plain PyTorch
(the sequential fp32 loop of ``ref.lru_scan_ref``); it serves CPU tensors
and is what the card's result is held against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import lru_scan_ref

SOURCE = _cuda.CSRC / "lru_scan.cu"

#: Kernel launches made through ``lru_scan_cuda`` (reset to 0 to count a
#: run).
launches = 0

_ENTRY = {torch.float32: "repro_lru_scan_f32",
          torch.bfloat16: "repro_lru_scan_bf16"}
#: The kernel's tiling (``csrc/lru_scan.cu``'s TT and CT): time steps per
#: chunk, channels per CTA.
CHUNK, CHANNELS = 128, 64


def scratch_bytes(B: int, T: int, C: int) -> int:
    """The kernel's scratch (``csrc/lru_scan.cu``, which refuses less): a
    ticket and a flag per CTA, padded to 16 bytes, then the aggregates and
    carries, 3 x (B, chunks, C) f32."""
    chunks = -(-T // CHUNK)
    tiles = B * -(-C // CHANNELS) * chunks
    return 4 * (-(-(tiles + 1) // 4) * 4) + 12 * B * chunks * C


@functools.lru_cache(maxsize=None)
def library() -> _cuda.Library:
    """Build ``csrc/lru_scan.cu`` (once per source hash), load it and bind
    its entry points."""
    lib = _cuda.library(SOURCE.name)
    for name in _ENTRY.values():
        fn = getattr(lib.cdll, name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    """Shape/dtype contract shared by the kernel and its plain version:
    a and x (B, T, C) of one dtype, float32 or bfloat16."""
    if a.dtype != x.dtype or a.dtype not in _ENTRY:
        raise TypeError(f"lru_scan takes float32 or bfloat16 a and x of one "
                        f"dtype, got {a.dtype} and {x.dtype}")
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"lru_scan takes a and x of one (B, T, C) shape, "
                         f"got {tuple(a.shape)} and {tuple(x.shape)}")


def lru_scan_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the sequential fp32 loop
    over T, output in x's dtype."""
    _check(a, x)
    return lru_scan_ref(a, x)


def lru_scan_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel (contiguous CUDA operands on one device)."""
    global launches
    _check(a, x)
    if a.device.type != "cuda" or x.device != a.device:
        raise ValueError(f"lru_scan_cuda needs a and x on one CUDA device, "
                         f"got {a.device} and {x.device}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("lru_scan_cuda needs contiguous operands")
    B, T, C = x.shape
    if max(B, T, C) >= 2**31:
        raise ValueError(f"lru_scan_cuda size limit exceeded by "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = getattr(library().cdll, _ENTRY[x.dtype])
    # the carries passed between T-chunks and their flags (the kernel
    # zeroes the flags)
    scratch = torch.empty(scratch_bytes(B, T, C), dtype=torch.uint8,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(a.data_ptr(), x.data_ptr(), out.data_ptr(), B, T, C,
                 scratch.data_ptr(), scratch.numel(), stream)
    if err:
        raise RuntimeError(f"lru_scan kernel launch failed with CUDA error "
                           f"{err} for {tuple(x.shape)} ({x.dtype})")
    launches += 1
    return out
