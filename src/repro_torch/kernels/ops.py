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

Gradients.  On CUDA, ``flash_attention`` and ``lru_scan`` with grad
enabled and an input that requires grad run through an autograd Function
whose forward is the kernel and whose backward is the backward kernel:
``FlashAttention`` (the forward with its row log-sum-exp; backward
``kernels.flash_attention_bwd``) and ``LruScan`` (the forward's output
kept; backward ``kernels.lru_scan_bwd``).  There is no fallback: a backward
kernel that fails to build or launch raises.  ``matmul`` and ``q4_matmul``
have no backward kernel: on CUDA they refuse such a call instead of
returning a tensor without a gradient (the ROADMAP item named in the error).
On the CPU the plain versions' own autograd serves.

Meta tensors (a dry run: ``launch.dryrun``).  ``flash_attention`` and
``lru_scan``, the kernels a dry-run cell reaches, have a meta branch that
launches nothing: it returns outputs of the kernel's shapes and dtype and,
inside ``counting()``, notes each call's analytic cost as a
``KernelCost`` — the FLOP and bytes that ``chip_smoke.py``'s bounds use
(flash: ``models.attention.attn_flops``, its backward 2.5 times that;
lru_scan: 2 FLOP and 12 bytes an f32 element, its backward 3 FLOP and 20
bytes) — the backward's when autograd reaches it.  The FLOP counter of
``torch.utils.flop_counter`` cannot see inside a kernel, so this is how a
dry run counts them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, Optional

import torch

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain,
                                                 kernel_ready)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.lru_scan import lru_scan_cuda, lru_scan_plain
from repro_torch.kernels.lru_scan_bwd import lru_scan_bwd_cuda
from repro_torch.kernels.matmul import matmul_cuda, matmul_plain
from repro_torch.kernels.quant import q4_matmul_cuda, q4_matmul_plain


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _on_meta(*tensors: torch.Tensor) -> bool:
    return any(t.device.type == "meta" for t in tensors)


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One kernel call's analytic cost on meta tensors: ``flops``, the
    ``bytes`` it must move (each input read once, each output written
    once) and the ``route`` whose peak rate prices its FLOP
    (``analysis.roofline.PEAK``)."""

    name: str
    flops: float
    bytes: float
    route: str


_COSTS: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "repro_torch_kernel_costs", default=None)


@contextlib.contextmanager
def counting() -> Iterator[list[KernelCost]]:
    """Collect a ``KernelCost`` for every kernel call made on meta tensors
    inside (forward and backward)."""
    costs: list[KernelCost] = []
    token = _COSTS.set(costs)
    try:
        yield costs
    finally:
        _COSTS.reset(token)


def _note(cost: Optional[KernelCost]) -> None:
    sink = _COSTS.get()
    if sink is not None and cost is not None:
        sink.append(cost)


def _product_route(dtype: torch.dtype) -> str:
    """The tensor-core route of the flash kernels' products: 3xTF32 for
    f32, one TF32 product for bf16."""
    return "3xtf32" if dtype == torch.float32 else "tf32"


class _MetaKernel(torch.autograd.Function):
    """A kernel call on meta tensors: an empty output of the kernel's shape
    and dtype, its cost noted; the backward's cost noted when autograd
    reaches it, with empty gradients of the inputs' shapes."""

    @staticmethod
    def forward(ctx, shape, dtype, fwd, bwd, *inputs):
        _note(fwd)
        ctx.bwd = bwd
        ctx.like = [(t.shape, t.dtype) for t in inputs]
        return torch.empty(shape, dtype=dtype, device="meta")

    @staticmethod
    def backward(ctx, grad):
        _note(ctx.bwd)
        return (None, None, None, None) + tuple(
            torch.empty(s, dtype=d, device="meta") for s, d in ctx.like)


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


_MM_ITEM = ("ROADMAP, measured gaps: backward kernels for the panel and q4 "
            "matmuls")


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
    if _on_meta(q, k, v):
        return _meta_flash(q, k, v, causal, window, layout)
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


def _meta_flash(q, k, v, causal, window, layout) -> torch.Tensor:
    """The flash kernel on meta tensors: its output, and its cost (and its
    backward kernel's) as ``chip_smoke.py`` bounds them."""
    from repro_torch.models.attention import attn_flops
    bhtd = layout == "bhtd"
    B, H, Tq, hd = (q.shape if bhtd else q.transpose(1, 2).shape)
    Tkv = k.shape[2 if bhtd else 1]
    flops = attn_flops(B, Tq, Tkv, H, hd, causal=causal, window=window)
    el = q.element_size()
    route = _product_route(q.dtype)
    fwd = KernelCost("flash_attention", flops,
                     el * (2 * q.numel() + 2 * k.numel()), route)
    bwd = KernelCost("flash_attention_bwd", 2.5 * flops,
                     el * (4 * q.numel() + 4 * k.numel()) + 4 * B * H * Tq,
                     route)
    return _MetaKernel.apply(tuple(q.shape), q.dtype, fwd, bwd, q, k, v)


def lru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, x):
        return lru_scan_plain(a, x)
    if _on_meta(a, x):
        n, el = x.numel(), x.element_size()
        return _MetaKernel.apply(
            tuple(x.shape), x.dtype,
            KernelCost("lru_scan", 2.0 * n, 3 * n * el, "fma"),
            KernelCost("lru_scan_bwd", 3.0 * n, 5 * n * el, "fma"), a, x)
    a, x = a.contiguous(), x.contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad):
        return LruScan.apply(a, x)
    return lru_scan_cuda(a, x)


class LruScan(torch.autograd.Function):
    """The lru_scan kernel with its backward kernel: the forward keeps a
    and its output h; the backward launches ``lru_scan_bwd_cuda`` on them
    and the output's cotangent (dx = g, da = g h_{t-1}, one pass)."""

    @staticmethod
    def forward(ctx, a, x):
        h = lru_scan_cuda(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        dx, da = lru_scan_bwd_cuda(a, h, gh.contiguous())
        return da, dx
