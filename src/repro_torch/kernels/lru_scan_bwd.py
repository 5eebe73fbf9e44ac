"""The lru_scan backward kernel: bind, launch — and its plain version.

The kernel (``csrc/lru_scan_bwd.cu``) computes the gradient of the forward
kernel's function (``kernels/lru_scan.py``: h_t = a_t * h_{t-1} + x_t):
given a, the forward's output h and the output's cotangent gh (B, T, C), the
reverse scan g_t = gh_t + a_{t+1} g_{t+1} (g_{T-1} = gh_{T-1}), written as
dx = g and, in the same pass, da_t = g_t h_{t-1} (h_{-1} = 0).  The TPU
kernel it is the gradient of (``src/repro/kernels/lru_scan.py::
lru_scan_pallas``) has no backward; the reference trains through the
autograd of its own ``lax.associative_scan``.  It is CUDA C++ for
``sm_90a`` with a plain C interface, built at first use by
``kernels._cuda`` and loaded with ``ctypes``: the forward's T-chunks with a
decoupled look-back, run backwards in time and reading a one row ahead
(``ref.lru_scan_bwd_chunked_emulated`` repeats its arithmetic on the CPU).
The source's header note says what bounds it.

``lru_scan_bwd_cuda`` checks device, dtype, shape and contiguity, raises on
anything else, launches on the current stream and counts the launch in
``launches``.  ``lru_scan_bwd_plain`` is the same function in plain PyTorch
(the sequential fp32 loop of ``ref.lru_scan_bwd_ref``); it is what the
card's result is held against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.lru_scan import _ENTRY as _FWD_ENTRY
from repro_torch.kernels.lru_scan import scratch_bytes
from repro_torch.kernels.ref import lru_scan_bwd_ref

SOURCE = _cuda.CSRC / "lru_scan_bwd.cu"

#: Kernel launches made through ``lru_scan_bwd_cuda`` (reset to 0 to count
#: a run).
launches = 0

_ENTRY = {torch.float32: "repro_lru_scan_bwd_f32",
          torch.bfloat16: "repro_lru_scan_bwd_bf16"}


@functools.lru_cache(maxsize=None)
def library() -> _cuda.Library:
    """Build ``csrc/lru_scan_bwd.cu`` (once per source hash), load it and
    bind its entry points."""
    lib = _cuda.library(SOURCE.name)
    for name in _ENTRY.values():
        fn = getattr(lib.cdll, name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, h: torch.Tensor, gh: torch.Tensor) -> None:
    """a, h and gh of one (B, T, C) shape and one dtype, float32 or
    bfloat16 (the forward's)."""
    if not (a.dtype == h.dtype == gh.dtype) or a.dtype not in _FWD_ENTRY:
        raise TypeError(f"lru_scan_bwd takes float32 or bfloat16 a, h and gh "
                        f"of one dtype, got {a.dtype}, {h.dtype}, {gh.dtype}")
    if a.dim() != 3 or not (a.shape == h.shape == gh.shape):
        raise ValueError(f"lru_scan_bwd takes a, h and gh of one (B, T, C) "
                         f"shape, got {tuple(a.shape)}, {tuple(h.shape)}, "
                         f"{tuple(gh.shape)}")


def lru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor, gh: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the sequential fp32 loop
    backwards over T; returns (dx, da) in a's dtype."""
    _check(a, h, gh)
    return lru_scan_bwd_ref(a, h, gh)


def lru_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor, gh: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel (contiguous CUDA operands on one device);
    returns (dx, da)."""
    global launches
    _check(a, h, gh)
    if a.device.type != "cuda" or not (h.device == gh.device == a.device):
        raise ValueError(f"lru_scan_bwd_cuda needs a, h and gh on one CUDA "
                         f"device, got {a.device}, {h.device}, {gh.device}")
    if not (a.is_contiguous() and h.is_contiguous() and gh.is_contiguous()):
        raise ValueError("lru_scan_bwd_cuda needs contiguous operands")
    B, T, C = gh.shape
    if max(B, T, C) >= 2**31:
        raise ValueError(f"lru_scan_bwd_cuda size limit exceeded by "
                         f"{tuple(gh.shape)}")
    dx, da = torch.empty_like(gh), torch.empty_like(gh)
    if dx.numel() == 0:
        return dx, da
    fn = getattr(library().cdll, _ENTRY[gh.dtype])
    # the carries passed between T-chunks and their flags (the kernel
    # zeroes the flags): the forward's layout
    scratch = torch.empty(scratch_bytes(B, T, C), dtype=torch.uint8,
                          device=gh.device)
    stream = torch.cuda.current_stream(gh.device).cuda_stream
    with torch.cuda.device(gh.device):
        err = fn(a.data_ptr(), h.data_ptr(), gh.data_ptr(), dx.data_ptr(),
                 da.data_ptr(), B, T, C, scratch.data_ptr(), scratch.numel(),
                 stream)
    if err:
        raise RuntimeError(f"lru_scan_bwd kernel launch failed with CUDA "
                           f"error {err} for {tuple(gh.shape)} ({gh.dtype})")
    launches += 1
    return dx, da
