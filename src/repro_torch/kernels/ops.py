"""Public wrappers: layout glue around the Hopper kernels.

``matmul`` takes any (M, K) @ (K, N) — or a leading batch on both operands
— and returns (M, N) in ``a.dtype`` with fp32 accumulation; a ``b`` that is
the transpose of a contiguous (N, K) is read as it lies.  ``q4_matmul``
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
kept; backward ``kernels.lru_scan_bwd``).  ``matmul`` runs through
``Matmul``: the forward keeps ``a`` and ``b``, the backward takes both
gradients from the same kernel in its other layouts (NT and TN), each only
where it is needed, so no transposed operand is copied; ``grouped_matmul``
(the dropless MoE block's experts: rows sorted into segments, segment g
times ``w[g]``) runs through ``GroupedMatmul`` the same way, on the
kernel's grouped entry.  The MoE block's row movements run through
``MoeDispatch`` (tokens to expert order; backward: each token's k rows
summed in order) and ``MoeCombine`` (each token's k expert rows times its
gates, summed in order; backward: the gate times the gradient into each
buffer row and the gates' dot products), on the entries of
``kernels.moe_gather`` for CUDA tensors and their plain versions
otherwise (CPU and meta).  There is no fallback: a backward kernel that fails to build or launch raises.
``q4_matmul`` has no backward kernel: on CUDA it refuses such a call instead
of returning a tensor without a gradient (the ROADMAP item named in the
error).  On the CPU the plain versions' own autograd serves every op (the
``Matmul`` Function, called directly, runs the layouts' plain versions).

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

from repro_torch.kernels import moe_gather
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain,
                                                 kernel_ready)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.lru_scan import lru_scan_cuda, lru_scan_plain
from repro_torch.kernels.lru_scan_bwd import lru_scan_bwd_cuda
from repro_torch.kernels.matmul import (grouped_matmul_cuda,
                                        grouped_matmul_plain, matmul_cuda,
                                        matmul_plain)
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


def _product(a: torch.Tensor, b: torch.Tensor, layout: str) -> torch.Tensor:
    """The panel kernel in ``layout`` (its plain version on the CPU)."""
    if _on_cpu(a, b):
        return matmul_plain(a, b, layout)
    return matmul_cuda(a.contiguous(), b.contiguous(), layout)


def _transposed(b: torch.Tensor) -> Optional[torch.Tensor]:
    """``b``'s transpose where ``b`` is the transpose of a contiguous
    tensor (a tied unembedding, ``emb.T``), else None."""
    if b.dim() < 2 or b.is_contiguous() or not b.mT.is_contiguous():
        return None
    return b.mT


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bt = _transposed(b)
    return _product(a, b, "nn") if bt is None else _product(a, bt, "nt")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, b):
        return matmul_plain(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return Matmul.apply(a, b)
    return _forward(a, b)


class Matmul(torch.autograd.Function):
    """The panel kernel with its gradients on the same kernel.  The forward
    keeps ``a`` and ``b`` (what autograd's product keeps) and runs NN (NT
    for a ``b`` given as ``bt.T``); the backward runs dA = dC B^T as NT
    (NN) and dB = A^T dC as TN (dB^T = dC^T A as TN), each operand read
    where it lies and each gradient only where it is needed."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _forward(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        bt = _transposed(b)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product(dc, b, "nt") if bt is None else \
                _product(dc, bt, "nn")
        if ctx.needs_input_grad[1]:
            db = _product(a, dc, "tn") if bt is None else \
                _product(dc, a, "tn").mT
        return da, db


def _grouped(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
             layout: str) -> torch.Tensor:
    """The grouped entry in ``layout`` (its plain version on the CPU)."""
    if _on_cpu(a, b):
        return grouped_matmul_plain(a, b, offsets, layout)
    return grouped_matmul_cuda(a.contiguous(), b.contiguous(), offsets,
                               layout)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Rows sorted into segments times each segment's matrix: x (R, K), w
    (G, K, N), offsets (G + 1,) int32 -> (R, N), rows ``offsets[g]`` to
    ``offsets[g + 1]`` times ``w[g]``.  On the card through
    ``GroupedMatmul`` (the offsets stay on the device)."""
    if _on_cpu(x, w):
        return grouped_matmul_plain(x, w, offsets)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w, offsets)
    return _grouped(x, w, offsets, "nn")


class GroupedMatmul(torch.autograd.Function):
    """The grouped entry with its gradients on the same kernel: the forward
    keeps x, w and the offsets and runs NN; the backward runs dX = dY w[g]^T
    as NT and dW[g] = x_g^T dY_g as TN (an empty segment's dW is zero),
    each only where it is needed."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        return _grouped(x, w, offsets, "nn")

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped(dy, w, offsets, "nt")
        if ctx.needs_input_grad[1]:
            dw = _grouped(x, dy, offsets, "tn")
        return dx, dw, None


def _moe_gather(entry: str, *tensors: torch.Tensor):
    """The ``moe_gather`` entry on its kernel for CUDA tensors, its plain
    version otherwise."""
    if any(t.device.type == "cuda" for t in tensors):
        return getattr(moe_gather, f"{entry}_cuda")(
            *(t.contiguous() for t in tensors))
    return getattr(moe_gather, f"{entry}_plain")(*tensors)


class MoeDispatch(torch.autograd.Function):
    """Tokens x (b, N, d) into expert order through ``table`` (b, R) (``N``:
    a zero row) -> (b, R, d), by ``dispatch``; ``inv`` (b, N, k), each
    token's cells in ascending order (``R``: none), carries the gradient
    back by ``dispatch_bwd``, each token's k rows summed in that order (no
    scatter-add)."""

    @staticmethod
    def forward(ctx, x, table, inv):
        ctx.save_for_backward(inv)
        return _moe_gather("dispatch", x, table, inv)

    @staticmethod
    def backward(ctx, d_buf):
        (inv,) = ctx.saved_tensors
        return _moe_gather("dispatch_bwd", d_buf, inv), None, None


class MoeCombine(torch.autograd.Function):
    """The expert rows src (b, S, d) back to tokens (b, N, d) by
    ``combine``: row ``inv[t, j]`` (``S``: a zero row) times ``g[t, j]``,
    added in ascending j.  ``back`` (b, S), each cell's slot ``t * k + j``
    (``N * k``: empty), carries the gradients back by ``combine_bwd`` in
    one pass: the gate times dy into each cell a slot reaches (zeros in the
    empty ones) and each gate's dot product of dy with its row."""

    @staticmethod
    def forward(ctx, src, g, inv, back):
        ctx.save_for_backward(src, g, inv, back)
        return _moe_gather("combine", src, g, inv)

    @staticmethod
    def backward(ctx, dy):
        src, g, inv, back = ctx.saved_tensors
        d_src, d_g = _moe_gather("combine_bwd", dy, g, inv, src, back)
        return (d_src if ctx.needs_input_grad[0] else None,
                d_g if ctx.needs_input_grad[1] else None, None, None)


def q4_matmul(a: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
              group: int = 32) -> torch.Tensor:
    if _on_cpu(a, packed, scales):
        return q4_matmul_plain(a, packed, scales, group)
    _no_backward("q4_matmul", _MM_ITEM, a, packed, scales)
    return q4_matmul_cuda(a.contiguous(), packed.contiguous(),
                          scales.contiguous(), group)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, layout: str = "bhtd",
                    scale: Optional[float] = None) -> torch.Tensor:
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, layout=layout,
                                     scale=scale)
    if _on_meta(q, k, v):
        return _meta_flash(q, k, v, causal, window, layout)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    layout, scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, layout=layout,
                                scale=scale)


class FlashAttention(torch.autograd.Function):
    """The flash kernel with its backward kernel: the forward keeps q, k, v,
    the output and the row log-sum-exp; the backward launches
    ``flash_attention_bwd_cuda`` on them at the forward's scale."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, layout, scale=None):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        layout=layout, return_lse=True,
                                        scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        layout=layout, scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out,
                                              _kernel_operand(do), lse,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


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
