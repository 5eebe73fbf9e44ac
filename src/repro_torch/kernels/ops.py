"""Public wrappers: layout glue around the Hopper kernels.

``matmul`` takes any (M, K) @ (K, N) — or a leading batch on both operands
— and returns (M, N) in ``a.dtype`` with fp32 accumulation.  ``q4_matmul``
takes ``a`` (M, K) with the packed-int4 weight (K/2, N) and its group
scales (K/group, N) — or a leading batch on all three — and returns
``a @ dequantize_q4(...)`` the same way.  ``flash_attention`` takes q
(B, H, Tq, hd) and k, v (B, KV, Tkv, hd) — or the model's (B, T, heads, hd)
with ``layout="bthd"`` — and returns causal / windowed GQA attention in q's
layout and dtype.  ``lru_scan`` takes a, x (B, T, C) of one dtype and
returns h_t = a_t * h_{t-1} + x_t (fp32 carry from 0) in x's dtype.  The
kernels mask their own ragged edges, so no padding is needed.  CPU tensors
take a kernel's plain version; CUDA tensors take the kernel, or the wrapper
raises.

Gradients.  On CUDA, ``flash_attention`` with grad enabled and an input
that requires grad runs through ``FlashAttention``, an autograd Function
whose forward is the kernel (with its row log-sum-exp) and whose backward
is the backward kernel (``kernels.flash_attention_bwd``).  ``matmul``,
``q4_matmul`` and ``lru_scan`` have no backward kernel yet: on CUDA they
refuse such a call instead of returning a tensor without a gradient (the
ROADMAP Queue 2 item named in the error gives each one its backward).  On
the CPU the plain versions' own autograd serves.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain,
                                                 kernel_ready)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.lru_scan import lru_scan_cuda, lru_scan_plain
from repro_torch.kernels.matmul import matmul_cuda, matmul_plain
from repro_torch.kernels.quant import q4_matmul_cuda, q4_matmul_plain


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the flash kernel reads it in place: itself, or a fresh
    (aligned, contiguous) copy."""
    if kernel_ready(x):
        return x
    return x.clone() if x.is_contiguous() else x.contiguous()


def _no_backward(name: str, item: str, *tensors: torch.Tensor) -> None:
    """Refuse a grad-carrying call of a kernel that has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"ops.{name} has no backward kernel yet ({item}): on the card it "
            f"would return a result without a gradient; call it under "
            f"torch.no_grad() or on tensors that do not require grad")


_MM_ITEM = "ROADMAP Queue 2, backward kernels for the panel and q4 matmuls"
_SCAN_ITEM = "ROADMAP Queue 2, a backward kernel for lru_scan"


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, b):
        return matmul_plain(a, b)
    _no_backward("matmul", _MM_ITEM, a, b)
    return matmul_cuda(a.contiguous(), b.contiguous())


def q4_matmul(a: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
              group: int = 32) -> torch.Tensor:
    if _on_cpu(a, packed, scales):
        return q4_matmul_plain(a, packed, scales, group)
    _no_backward("q4_matmul", _MM_ITEM, a, packed, scales)
    return q4_matmul_cuda(a.contiguous(), packed.contiguous(),
                          scales.contiguous(), group)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, layout: str = "bhtd") -> torch.Tensor:
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, layout=layout)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    layout)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, layout=layout)


class FlashAttention(torch.autograd.Function):
    """The flash kernel with its backward kernel: the forward keeps q, k, v,
    the output and the row log-sum-exp; the backward launches
    ``flash_attention_bwd_cuda`` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, layout):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        layout=layout, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        layout=layout)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out,
                                              _kernel_operand(do), lse,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None


def lru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, x):
        return lru_scan_plain(a, x)
    _no_backward("lru_scan", _SCAN_ITEM, a, x)
    return lru_scan_cuda(a.contiguous(), x.contiguous())
