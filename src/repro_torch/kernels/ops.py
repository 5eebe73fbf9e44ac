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
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain,
                                                 kernel_ready)
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


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, b):
        return matmul_plain(a, b)
    return matmul_cuda(a.contiguous(), b.contiguous())


def q4_matmul(a: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
              group: int = 32) -> torch.Tensor:
    if _on_cpu(a, packed, scales):
        return q4_matmul_plain(a, packed, scales, group)
    return q4_matmul_cuda(a.contiguous(), packed.contiguous(),
                          scales.contiguous(), group)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, layout: str = "bhtd") -> torch.Tensor:
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, layout=layout)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, layout=layout)


def lru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, x):
        return lru_scan_plain(a, x)
    return lru_scan_cuda(a.contiguous(), x.contiguous())
