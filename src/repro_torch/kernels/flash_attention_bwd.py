"""The flash-attention backward kernel: bind, launch — and its plain version.

The kernel (``csrc/flash_attention_bwd.cu``) computes the gradient of the
forward kernel's function (``kernels/flash_attention.py``): dq, dk, dv of
causal / windowed GQA attention from q, k, v, the forward's output, its
row log-sum-exp ``lse`` and the output's cotangent ``do``.  The TPU kernel
it is the gradient of (``src/repro/kernels/flash_attention.py::
flash_attention_pallas``) has no backward; the reference trains through
``jax.grad`` of its own attention.  It is CUDA C++ for ``sm_90a`` with a
plain C interface, built at first use by ``kernels._cuda`` and loaded with
``ctypes``.  All five products (S, dP, dV, dK, dQ) run on the tensor cores
as 3xTF32 ``mma.sync`` products (one TF32 product for bf16), P and dS stay
in registers, and the streamed side goes through a ``cp.async`` ring: a dq
pass (64 q rows a CTA, K / V streamed) and a dk / dv pass (64 keys a CTA,
Q / dO streamed), each recomputing S and dP from ``lse``.  The gradients
are deterministic (no atomics): at few kv heads the dk / dv pass splits
the group's q heads over CTAs (``head_splits``, from the card's SM count)
and a last launch adds the fp32 partials in split order.  What bounds it (the tensor cores' rate, 7 products per visible
(q, k) pair against the 5 its bound counts) and what it still gives up
(``wgmma``, TMA with a producer warp) are in the source's header note,
with the rule for rows with no visible key and the exact path that gives
the plain version's classes on non-finite or large inputs.

Operands take the forward's layouts (``"bhtd"`` or the model's ``"bthd"``)
and dtypes (f32, bf16); ``lse`` is (B, H, Tq) fp32.  The gradients come
back in the operands' shapes and dtype.  ``flash_attention_bwd_cuda``
checks device, dtype, shape and strides, raises on anything else,
launches on the current stream and counts one call (its launches) in
``launches``.  ``recomputes`` counts the fast-path CTAs whose gradients
were not finite and sent the call to the exact path: 0 wherever the
gradients are finite.  ``flash_attention_bwd_plain`` is the autograd of
``flash_attention_plain`` — the kernel's plain counterpart, which the
tests and ``chip_smoke.py`` hold it against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import (HEAD_DIMS, _bhtd, _check,
                                                 flash_attention_plain,
                                                 kernel_ready, softmax_scale)

SOURCE = _cuda.CSRC / "flash_attention_bwd.cu"

#: Backward calls made through ``flash_attention_bwd_cuda`` (each is one
#: prep, dq and dk / dv launch, the partials' sum when the heads are split,
#: and the exact path's two launches; reset to 0 to count a run).
launches = 0
#: Fast-path CTAs whose gradients were not finite (``recomputes.read()``,
#: ``recomputes.reset()``); each such call recomputes on the exact path.
recomputes = _cuda.DeviceCounter()

_ENTRY = {torch.float32: "repro_flash_attention_bwd_f32",
          torch.bfloat16: "repro_flash_attention_bwd_bf16"}
_N_DIMS = 34
#: Keys a dk / dv CTA holds (``Fast<HD>::R`` in the source) and the CTAs an
#: SM holds at each head_dim (``Fast<HD>::MIN_BLOCKS``).
_DKV_KEYS = 64
_DKV_CTAS_PER_SM = {16: 2, 32: 2, 64: 2, 128: 2, 256: 1}


@functools.lru_cache(maxsize=None)
def library() -> _cuda.Library:
    """Build ``csrc/flash_attention_bwd.cu`` (once per source hash), load
    it and bind its entry points."""
    lib = _cuda.library(SOURCE.name)
    for name in _ENTRY.values():
        fn = getattr(lib.cdll, name)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
    return lib


def head_splits(B: int, KV: int, Tkv: int, hd: int, group: int,
                sms: int) -> int:
    """The shares the dk / dv pass splits each group's q heads into: the
    least power of 2 whose grid fills two waves of the card's dk / dv CTA
    slots (``sms`` SMs), capped at ``group``.  Any value in [1, group] gives
    correct gradients; the same shapes on the same card always give the
    same value, and so the same bits."""
    slots = 2 * sms * _DKV_CTAS_PER_SM[hd]
    ctas = B * KV * -(-Tkv // _DKV_KEYS)
    splits = 1
    while splits < group and ctas * splits < slots:
        splits *= 2
    return min(splits, group)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True,
                              window: Optional[int] = None,
                              q_offset: int = 0, layout: str = "bhtd",
                              scale: Optional[float] = None
                              ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv): the autograd of ``flash_attention_plain`` at ``do``."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, window=window,
                                    q_offset=q_offset, layout=layout,
                                    scale=scale)
        return torch.autograd.grad(out, leaves, do)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None, q_offset: int = 0,
                             layout: str = "bhtd",
                             scale: Optional[float] = None
                             ) -> tuple[torch.Tensor, ...]:
    """Launch the backward kernel: (dq, dk, dv) in the operands' shapes and
    dtype (CUDA operands on one device that ``kernel_ready`` accepts)."""
    global launches
    _check(q, k, v, window, layout)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd needs o and do shaped and "
                         f"typed as q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)} {do.dtype}")
    xs = (q, k, v, o, do)
    if any(x.device.type != "cuda" or x.device != q.device for x in xs) \
            or lse.device != q.device:
        raise ValueError("flash_attention_bwd_cuda needs every operand on "
                         "one CUDA device")
    if not all(kernel_ready(x) for x in xs):
        raise ValueError("flash_attention_bwd_cuda needs operands with a "
                         "unit stride along hd and 4-element aligned rows")
    q4, k4, v4, o4, do4 = (_bhtd(x, layout) for x in xs)
    B, H, Tq, hd = q4.shape
    KV, Tkv = k4.shape[1], k4.shape[2]
    if lse.shape != (B, H, Tq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd needs a contiguous fp32 lse "
                         f"of shape {(B, H, Tq)}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_cuda takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if B * H > 65535 or max(Tq, Tkv, abs(q_offset)) >= 2**31:
        raise ValueError(f"flash_attention_bwd_cuda grid limit exceeded by "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    grads = tuple(torch.empty(tuple(x.shape), dtype=x.dtype,
                              device=x.device) for x in (q, k, v))
    if q.numel() == 0:
        return grads
    dq4, dk4, dv4 = (_bhtd(x, layout) for x in grads)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = head_splits(B, KV, Tkv, hd, H // KV, sms)
    dims = (ctypes.c_longlong * _N_DIMS)(
        B, H, Tq, Tkv, hd, H // KV, int(causal), window or 0, q_offset,
        splits, *(s for x in (q4, k4, v4, o4, do4, dq4, dk4, dv4)
                  for s in x.stride()[:3]))
    lib = library().cdll
    with torch.cuda.device(q.device):
        D = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
        stats = torch.empty((B, H, Tq, 6), dtype=torch.float32,
                            device=q.device)
        part = torch.empty((2 * splits * B * KV * Tkv * hd if splits > 1
                            else 0,), dtype=torch.float32, device=q.device)
        flag = torch.empty(2, dtype=torch.int32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[q.dtype])(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            do4.data_ptr(), lse.data_ptr(), dq4.data_ptr(), dk4.data_ptr(),
            dv4.data_ptr(), dims, softmax_scale(hd, scale), D.data_ptr(),
            stats.data_ptr(), flag.data_ptr(), part.data_ptr(),
            recomputes.buffer(q.device).data_ptr(), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed with "
                           f"CUDA error {err} for q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)} ({layout})")
    launches += 1
    return grads
