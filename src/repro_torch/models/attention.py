"""Attention: flash-style prefill through the Hopper kernel, and decode.

The reference's ``repro/models/attention.py`` for the single-device ctx.
``flash_attention`` (prefill) takes the model's (B, T, heads, hd) layout and
goes through ``kernels.ops.flash_attention``: the hand-written kernel
(``csrc/flash_attention.cu``) on CUDA tensors, its plain version on CPU
tensors — there is no third route.  Decode attention is a one-query
product over the cache, outside any kernel in the reference too, and stays
plain PyTorch.

Training runs through the same ``attn_block``: on CUDA tensors that carry
gradients ``ops.flash_attention`` takes the kernel with its backward kernel
(``ops.FlashAttention``).  The tensor-parallel modes (``head_tp`` at
tp > 1, ``cp``, split-K decode) are the tp half of ROADMAP Queue 1 item 13
and raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm, rope
from repro_torch.models.parallel import ParallelCtx

NEG = -1e30


def _kv_head_map(nq_local: int, q_head_offset, H: int, kv: int,
                 kv_head_offset=0, device=None) -> torch.Tensor:
    """kv-head index (local to the kv shard) for each local q head."""
    group = H // kv
    return (q_head_offset + torch.arange(nq_local, device=device)) // group \
        - kv_head_offset


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset=0, H: Optional[int] = None,
                    kv_total: Optional[int] = None) -> torch.Tensor:
    """q: (B, Tq, nq, hd); k, v: (B, Tkv, kv, hd) (full KV).

    ``q_offset``: global position of q[.., 0, ..]; kv positions past Tkv
    are masked.  ``H`` / ``kv_total`` are the global head counts; at
    tp = 1 they are the local ones (a head-parallel shard raises)."""
    nq, kv = q.shape[2], k.shape[2]
    if (H or nq) != nq or (kv_total or kv) != kv:
        raise NotImplementedError("head-parallel attention shards are the "
                                  "tp half of ROADMAP Queue 1 item 13, not "
                                  "ported yet")
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=int(q_offset), layout="bthd")


def attn_flops(B: int, Tq: int, Tkv: int, H: int, hd: int, *,
               causal: bool, window: Optional[int]) -> float:
    """Analytic matmul FLOPs of one attention call (QK^T + PV), global."""
    if window is not None:
        eff = min(window, Tkv)
        pairs = B * Tq * eff
    elif causal and Tq == Tkv:
        pairs = B * Tq * (Tq + 1) // 2
    else:
        pairs = B * Tq * Tkv
    return 4.0 * pairs * H * hd


# ---------------------------------------------------------------------------
# Train/prefill block
# ---------------------------------------------------------------------------

def attn_block(x_sp: torch.Tensor, p: dict, meta: dict, ctx: ParallelCtx,
               cfg, *, mode: str, window: Optional[int], t_offset: int = 0,
               return_kv: bool = False):
    """x_sp: (B, T, d).  Returns the new x (and this layer's (k, v) when
    ``return_kv`` — used by prefill to build the cache)."""
    if mode != "head_tp":
        raise NotImplementedError("context-parallel attention is the tp half "
                                  "of ROADMAP Queue 1 item 13, not ported "
                                  "yet")
    H, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    eps = cfg.norm_eps
    B, T, d = x_sp.shape
    h = rms_norm(x_sp, ctx.gather_w(p["ln"], meta["ln"].fsdp_dim), eps)
    wq = ctx.gather_w(p["wq"], meta["wq"].fsdp_dim)
    wkv = ctx.gather_w(p["wkv"], meta["wkv"].fsdp_dim)
    wo = ctx.gather_w(p["wo"], meta["wo"].fsdp_dim)

    q = (h @ wq).reshape(B, T, H, hd)
    kvp = (h @ wkv.reshape(d, -1)).reshape(B, T, 2, kv, hd)
    k, v = kvp[:, :, 0], kvp[:, :, 1]
    if cfg.qk_norm:
        q = rms_norm(q, ctx.gather_w(p["q_norm"], meta["q_norm"].fsdp_dim),
                     eps)
        k = rms_norm(k, ctx.gather_w(p["k_norm"], meta["k_norm"].fsdp_dim),
                     eps)
    if cfg.pos == "rope":
        rdt = ctx.compute_dtype if ctx.has("bf16_rope") else None
        t = t_offset + torch.arange(T, device=x_sp.device)
        q = rope(q, t, cfg.rope_theta, rdt)
        k = rope(k, t, cfg.rope_theta, rdt)

    o = flash_attention(q, k, v, causal=True, window=window,
                        q_offset=t_offset, H=H, kv_total=kv)
    out = x_sp + ctx.matmul_rs(o.reshape(B, T, H * hd), wo)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, ctx: ParallelCtx, *, pos, H: int,
                     window: Optional[int] = None,
                     ring: bool = False) -> torch.Tensor:
    """q: (B, 1, H, hd); k/v_cache: (B, S, kv, hd).  ``pos``: current
    position — a scalar shared by the batch, or a (B,) vector of per-slot
    positions (continuous batching over heterogeneous sequence lengths).
    ``ring``: the cache is a ring buffer of size ``window`` (global kv index
    = pos - window + 1 .. pos, stored mod window).  GQA groups the q heads
    of each kv head (no repeat of the cache)."""
    B, _, nH, hd = q.shape
    S, kv = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(hd)
    slot = torch.arange(S, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    if pos.dim() == 1:                   # per-slot positions: (B, 1)
        pos = pos[:, None]
    if ring:
        W = window
        # slot s holds global index: the largest g <= pos with g % W == s
        gidx = pos - ((pos - slot) % W)
        valid = (gidx >= 0) & (gidx <= pos) & (pos - gidx < W)
    else:
        gidx = slot
        valid = gidx <= pos
        if window is not None:
            valid &= (pos - gidx) < window

    qg = q.float().reshape(B, kv, nH // kv, hd) * scale     # h = kv*G + g
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    mask = valid if valid.dim() == 2 else valid[None]       # (B | 1, S)
    s = torch.where(mask[:, None, None, :], s,
                    torch.full((), NEG, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, nH, hd).to(q.dtype)


def cache_write(cache: torch.Tensor, new: torch.Tensor, ctx: ParallelCtx, *,
                pos, window: Optional[int] = None) -> torch.Tensor:
    """Write (B, 1, kv, hd) into the (B, S, kv, hd) cache at position
    ``pos`` — a shared scalar or a (B,) vector of per-slot positions (ring
    buffer when ``window``; as in the reference at tp = 1, a position past
    the cache lands at ``pos mod S``).  Unlike the reference, which returns
    a new array, the write is in place (one row per slot instead of a copy
    of the cache); the cache is returned."""
    B, S = cache.shape[:2]
    pos = torch.as_tensor(pos, device=cache.device).expand(B)
    gpos = pos % window if window is not None else pos
    rows = torch.arange(B, device=cache.device)
    cache[rows, gpos % S] = new[:, 0].to(cache.dtype)
    return cache
