"""Plain PyTorch oracles for every kernel (the allclose ground truth)."""

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
