"""Hopper flash attention: bind, launch — and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention_pallas``: causal /
sliding-window online-softmax attention with fp32 running max, sum and
output, ``q_offset``, GQA through kv head ``h // (H // KV)`` read in place,
scores masked to -1e30 and the output ``o / max(l, 1e-30)`` in q's dtype.
It is CUDA C++ for ``sm_90a`` with a plain C interface, built at first use
by ``kernels._cuda`` and loaded with ``ctypes``: its two products run on the
tensor cores (``mma.sync``) in 3xTF32 for f32.  The source's header note
says what bounds it and what the design gives up.

Layouts: ``layout="bhtd"`` takes q (B, H, Tq, hd) and k, v (B, KV, Tkv, hd)
— the TPU kernel's layout — and returns (B, H, Tq, hd); ``layout="bthd"``
takes the model's (B, Tq, H, hd) / (B, Tkv, KV, hd) and returns
(B, Tq, H, hd).  The kernel reads either through element strides (no
transpose copy); hd is one of ``HEAD_DIMS``; f32 or bf16.  The scores'
scale is ``scale``, 1 / sqrt(hd) where it is not given (Granite's
``attention_multiplier`` is 1/64 at hd 64).

``flash_attention_cuda`` checks device, dtype, shape and strides, raises on
anything else, launches on the current stream and counts the launch in
``launches``; with ``return_lse=True`` it also returns each row's fp32
log-sum-exp of the scaled scores (B, H, Tq), which the backward kernel
(``kernels.flash_attention_bwd``) recomputes P from — the output is the
same bits either way.  ``recomputes`` counts, on the card, the q tiles that the
non-finite rule sent to the kernel's exact loop (``csrc/tf32x3.cuh``): 0
wherever q, k, v and the output are finite.  ``flash_attention_plain``
is the same function in plain PyTorch (exact softmax over the whole key
axis, fp32); it serves CPU tensors and is what the card's result is held
against.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _cuda

SOURCE = _cuda.CSRC / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
NEG = -1e30

#: Kernel launches made through ``flash_attention_cuda`` (reset to 0 to
#: count a run).
launches = 0
#: q tiles recomputed under the non-finite rule (``recomputes.read()``,
#: ``recomputes.reset()``).
recomputes = _cuda.DeviceCounter()

_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}
_N_DIMS = 21


@functools.lru_cache(maxsize=None)
def library() -> _cuda.Library:
    """Build ``csrc/flash_attention.cu`` (once per source hash), load it and
    bind its entry points."""
    lib = _cuda.library(SOURCE.name)
    for name in _ENTRY.values():
        fn = getattr(lib.cdll, name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return lib


def _bhtd(x: torch.Tensor, layout: str) -> torch.Tensor:
    """(B, H, T, hd) view of an operand in ``layout``."""
    return x if layout == "bhtd" else x.transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], layout: str) -> None:
    """Shape/dtype contract shared by the kernel and its plain version."""
    if layout not in ("bhtd", "bthd"):
        raise ValueError(f"unknown layout {layout!r} (bhtd | bthd)")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k "
                        f"and v of one dtype, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes 4-d q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    q4, k4, v4 = (_bhtd(x, layout) for x in (q, k, v))
    B, H, _, hd = q4.shape
    KV, Tkv = k4.shape[1], k4.shape[2]
    if k4.shape != v4.shape or k4.shape[0] != B or k4.shape[3] != hd \
            or KV == 0 or H % KV:
        raise ValueError(f"flash_attention shapes do not match "
                         f"({layout}): q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (q heads "
                         f"must be a multiple of kv heads)")
    if Tkv == 0:
        raise ValueError("flash_attention needs at least one key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def softmax_scale(hd: int, scale: Optional[float]) -> float:
    """The scores' scale: ``scale``, or 1 / sqrt(hd)."""
    return 1.0 / math.sqrt(hd) if scale is None else float(scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          layout: str = "bhtd",
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: exact fp32 softmax over the
    whole key axis with the kernel's mask (-1e30 where kpos >= Tkv, beyond
    the causal limit or outside the window), GQA through a head reshape,
    output in q's dtype and layout."""
    _check(q, k, v, window, layout)
    q4, k4, v4 = (_bhtd(x, layout) for x in (q, k, v))
    B, H, Tq, hd = q4.shape
    KV, Tkv = k4.shape[1], k4.shape[2]
    qf = q4.float().reshape(B, KV, H // KV, Tq, hd) * softmax_scale(hd, scale)
    s = torch.einsum("bkgqd,bktd->bkgqt", qf, k4.float())
    qpos = q_offset + torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tkv, device=q.device)
    mask = torch.ones((Tq, Tkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask, s, torch.full((), NEG, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v4.float())
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = o.reshape(B, H, Tq, hd).to(q.dtype)
    return o if layout == "bhtd" else o.transpose(1, 2).contiguous()


def kernel_ready(x: torch.Tensor) -> bool:
    """Whether the kernel can read ``x`` in place: unit stride along hd,
    every other stride and the base address aligned to 4 elements."""
    return (x.stride(-1) == 1 and all(s % 4 == 0 for s in x.stride()[:-1])
            and x.data_ptr() % (4 * x.element_size()) == 0)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None, q_offset: int = 0,
                         layout: str = "bhtd", return_lse: bool = False,
                         scale: Optional[float] = None):
    """Launch the Hopper kernel (CUDA operands on one device that
    ``kernel_ready`` accepts); ``return_lse`` gives ``(out, lse)``."""
    global launches
    _check(q, k, v, window, layout)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention_cuda needs q, k and v on one "
                         f"CUDA device, got {q.device}, {k.device} and "
                         f"{v.device}")
    if not all(kernel_ready(x) for x in (q, k, v)):
        raise ValueError("flash_attention_cuda needs operands with a unit "
                         "stride along hd and 4-element aligned rows")
    q4, k4, v4 = (_bhtd(x, layout) for x in (q, k, v))
    B, H, Tq, hd = q4.shape
    KV, Tkv = k4.shape[1], k4.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if B * H > 65535 or max(Tq, Tkv, abs(q_offset)) >= 2**31:
        raise ValueError(f"flash_attention_cuda grid limit exceeded by q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    out = torch.empty(tuple(q.shape), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    o4 = _bhtd(out, layout)
    dims = (ctypes.c_longlong * _N_DIMS)(
        B, H, Tq, Tkv, hd, H // KV, int(causal), window or 0, q_offset,
        *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
        *o4.stride()[:3])
    fn = getattr(library().cdll, _ENTRY[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flag = torch.empty(1, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
                 dims, softmax_scale(hd, scale), flag.data_ptr(),
                 recomputes.buffer(q.device).data_ptr(),
                 lse.data_ptr() if return_lse else None, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err} for q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)} ({layout})")
    launches += 1
    return (out, lse) if return_lse else out
