"""Plain PyTorch oracles for every kernel (the allclose ground truth), and
CPU emulations of the kernels' 3xTF32 arithmetic (test aids, never on a
main path)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Tq, hd); k, v: (B, KV, Tkv, hd).  Exact softmax attention
    with GQA head mapping, fp32 throughout."""
    B, H, Tq, hd = q.shape
    KV, Tkv = k.shape[1], k.shape[2]
    group = H // KV
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) / math.sqrt(hd)
    qpos = q_offset + torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tkv, device=q.device)
    mask = torch.ones((Tq, Tkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask[None, None], s, torch.full((), -1e30,
                                                    device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def lru_scan_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t along dim 1, fp32 carry."""
    af, xf = a.float(), x.float()
    h = torch.zeros_like(xf[:, 0])
    out = torch.empty_like(xf)
    for t in range(xf.shape[1]):
        h = af[:, t] * h + xf[:, t]
        out[:, t] = h
    return out.to(x.dtype)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` as the kernels carry it on the tensor cores, two f32 tensors
    ``(big, small)``: big = tf32(x), rounded to nearest (ties away) on the
    10-bit mantissa through an int32 view, the bits of cvt.rna.tf32.f32;
    small = x - big as the tensor core reads it, truncated to TF32."""
    xf = x.float()
    big = ((xf.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    small = ((xf - big).view(torch.int32) & -0x2000).view(torch.float32)
    return big, small


def matmul_tf32x3_emulated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels compute it: 3xTF32, a_small b_big +
    a_big b_small + a_big b_big (each product of two TF32 values exact in
    f32, the sums in f32).  Output in ``a.dtype``."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    return ((as_ @ bb + ab @ bs) + ab @ bb).to(a.dtype)


def attention_tf32x3_emulated(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None,
                              q_offset: int = 0) -> torch.Tensor:
    """The flash kernel's plain version (q (B, H, Tq, hd), k and v (B, KV,
    Tkv, hd), pre-scaled q, -1e30 masks, fp32 softmax) with its two
    products, q.k and p.v, as emulated 3xTF32."""
    B, H, Tq, hd = q.shape
    KV, Tkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Tq, hd) * (1.0 / math.sqrt(hd))
    s = matmul_tf32x3_emulated(qf, k.float()[:, :, None].transpose(-1, -2))
    qpos = q_offset + torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tkv, device=q.device)
    mask = torch.ones((Tq, Tkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = matmul_tf32x3_emulated(p, v.float()[:, :, None])
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, H, Tq, hd).to(q.dtype)
