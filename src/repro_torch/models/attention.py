"""Attention: flash-style prefill through the Hopper kernel, and decode.

The reference's ``repro/models/attention.py``.  ``flash_attention``
(prefill) takes the model's (B, T, heads, hd) layout and goes through
``kernels.ops.flash_attention``: the hand-written kernel
(``csrc/flash_attention.cu``) on CUDA tensors, its plain version on CPU
tensors — there is no third route.  Decode attention is a one-query
product over the cache, outside any kernel in the reference too, and stays
plain PyTorch.

Training runs through the same ``attn_block``: on CUDA tensors that carry
gradients ``ops.flash_attention`` takes the kernel with its backward kernel
(``ops.FlashAttention``).  With a tp axis (``models.parallel``: the tp
ranks stacked on a leading axis) the block runs in one of the reference's
two modes, chosen per arch by head divisibility:

* ``head_tp`` — the q heads (and the kv heads when they divide by tp) are
  sharded; x is all-gathered to the full T and the output reduce-scattered
  (``matmul_rs``).  The tp ranks fold into the kernel's batch: one launch
  for all of them, q ``(tp*B, T, H/tp, hd)``.  Where a rank's kv map is the
  kernel's own ``h // (H_loc / kv_loc)`` the kv heads go in as they are;
  where it is not (replicated kv heads whose groups straddle ranks), each
  rank's kv heads are expanded per q head first (glue: ``kv_loc = H/tp``).
* ``cp`` — context parallel, for any head count: each rank's queries are
  its T-chunk, K / V are all-gathered over tp.  The kernel takes one
  scalar ``q_offset``, so it is launched once per tp rank, each with
  ``Tq = T/tp`` against the full ``Tkv = T`` at ``q_offset = rank * T/tp``;
  each rank's gathered K / V takes its own cotangent, which the gather's
  transpose (the reduce-scatter) sums as the reference's does.

Serving at tp > 1 splits the decode cache along T: prefill hands each tp
rank the full-T, all-heads K / V of a layer (``attn_block(return_kv=True)``:
in ``head_tp`` the tp-sharded kv heads are gathered first), the model cuts
its rank's S/tp chunk of the cache from it, and decode (every head on every
tp rank) attends over the local chunk and merges the partial softmaxes
across tp: ``pmax_tp`` of the row max, ``psum_tp`` of the sums and of p·v
(split-K); ``cache_write`` stores the new token only on the tp rank that
owns its slot.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import residual, rms_norm, rope
from repro_torch.models.parallel import ParallelCtx

NEG = -1e30


def _kv_head_map(nq_local: int, q_head_offset, H: int, kv: int,
                 kv_head_offset=0, device=None) -> torch.Tensor:
    """kv-head index (local to the kv shard) for each local q head."""
    group = H // kv
    return (q_head_offset + torch.arange(nq_local, device=device)) // group \
        - kv_head_offset


def _kv_heads(nq: int, kv: int, q_head_offset: int, H: int, kv_total: int,
              kv_head_offset: int) -> Optional[list[int]]:
    """The local kv head of each local q head, or ``None`` where that is
    the kernel's own map ``h // (nq / kv)``."""
    heads = _kv_head_map(nq, q_head_offset, H, kv_total,
                         kv_head_offset).tolist()
    if nq % kv == 0 and heads == [h // (nq // kv) for h in range(nq)]:
        return None
    return heads


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset=0, q_head_offset=0, kv_head_offset=0,
                    H: Optional[int] = None,
                    kv_total: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Tq, nq, hd); k, v: (B, Tkv, kv, hd) (full KV).

    ``q_offset``: global position of q[.., 0, ..] (a sequence-parallel
    chunk); kv positions past Tkv are masked.  ``q_head_offset``: global
    index of q head 0 (a head-parallel shard), ``kv_head_offset`` that of
    kv head 0; ``H`` / ``kv_total`` the global head counts.  Where the
    shard's kv map is not the kernel's own, k and v are expanded per q head
    before the call.  ``scale``: the scores' scale (None: 1 / sqrt(hd))."""
    nq, kv = q.shape[2], k.shape[2]
    heads = _kv_heads(nq, kv, q_head_offset, H or nq, kv_total or kv,
                      kv_head_offset)
    if heads is not None:
        idx = torch.tensor(heads, device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=int(q_offset), layout="bthd",
                               scale=scale)


def _attend_tp(q, k, v, ctx: ParallelCtx, *, mode: str, window, t_offset,
               T_loc: int, H: int, kv: int, scale=None) -> torch.Tensor:
    """Attention of the stacked tp ranks: q (R, B, Tq, nq, hd), k / v
    (R, B, Tkv, kv_loc, hd) -> (R, B, Tq, nq, hd).  ``head_tp``: one launch
    with the ranks folded into the batch; ``cp``: one launch per rank at
    its chunk's ``q_offset``."""
    R, B, Tq, nq, hd = q.shape
    kv_loc = k.shape[-2]
    ranks = ctx.tp_ranks()
    if mode == "cp":
        return torch.stack([flash_attention(
            q[i], k[i], v[i], causal=True, window=window,
            q_offset=t_offset + r * T_loc, H=H, kv_total=kv, scale=scale)
            for i, r in enumerate(ranks)])
    maps = [_kv_heads(nq, kv_loc, r * nq, H, kv,
                      r * kv_loc if kv_loc != kv else 0) for r in ranks]
    if any(m is not None for m in maps):
        own = [h // (nq // kv_loc) for h in range(nq)] \
            if nq % kv_loc == 0 else None
        idx = torch.tensor([m if m is not None else own for m in maps],
                           device=k.device)[:, None, None, :, None]
        k = torch.take_along_dim(k, idx, dim=3)
        v = torch.take_along_dim(v, idx, dim=3)
        kv_loc = nq
    o = ops.flash_attention(
        q.reshape(R * B, Tq, nq, hd), k.reshape(R * B, -1, kv_loc, hd),
        v.reshape(R * B, -1, kv_loc, hd), causal=True, window=window,
        q_offset=t_offset, layout="bthd", scale=scale)
    return o.reshape(R, B, Tq, nq, hd)


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
    """x_sp: (B, T/tp, d) per rank (stacked with a tp axis).  Returns the
    new x (and, with ``return_kv``, this layer's (k, v) for the prefill
    cache: (B, T, kv, hd), every kv head over the full T on every tp
    rank)."""
    H, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    eps = cfg.norm_eps
    T_loc = x_sp.shape[-2]
    h = rms_norm(x_sp, ctx.at(ctx.gather_w(p["ln"], meta["ln"].fsdp_dim),
                              x_sp.dim()), eps)
    wq = ctx.gather_w(p["wq"], meta["wq"].fsdp_dim)
    wkv = ctx.gather_w(p["wkv"], meta["wkv"].fsdp_dim)   # (d, 2, kv_loc hd)
    wo = ctx.gather_w(p["wo"], meta["wo"].fsdp_dim)
    kv_loc = wkv.shape[-1] // hd

    if mode == "head_tp":
        hq = ctx.ag_tokens(h)                              # (B, T, d)
        n_q = H // ctx.tp
    else:                                                  # cp
        hq = h
        n_q = H
    lead = tuple(hq.shape[:-1])
    q = ctx.mm(hq, wq).reshape(lead + (n_q, hd))
    kvp = ctx.mm(hq, wkv.flatten(-2)).reshape(lead + (2, kv_loc, hd))
    k, v = kvp[..., 0, :, :], kvp[..., 1, :, :]
    if cfg.qk_norm:
        q = rms_norm(q, ctx.at(ctx.gather_w(
            p["q_norm"], meta["q_norm"].fsdp_dim), q.dim()), eps)
        k = rms_norm(k, ctx.at(ctx.gather_w(
            p["k_norm"], meta["k_norm"].fsdp_dim), k.dim()), eps)
    if cfg.pos == "rope":
        rdt = ctx.compute_dtype if ctx.has("bf16_rope") else None
        t = t_offset + torch.arange(q.shape[-3], device=x_sp.device)
        if mode == "cp":                                   # (R, T/tp)
            t = t + (ctx.tp_rank * T_loc)[:, None]
        q = rope(q, t, cfg.rope_theta, rdt)
        k = rope(k, t, cfg.rope_theta, rdt)

    if not ctx.tp_axis:
        o = flash_attention(q, k, v, causal=True, window=window,
                            q_offset=t_offset, H=H, kv_total=kv,
                            scale=cfg.attn_scale)
    else:
        if mode == "cp":
            k, v = ctx.ag_tokens(k), ctx.ag_tokens(v)      # (B, T, kv, hd)
        o = _attend_tp(q, k, v, ctx, mode=mode, window=window,
                       t_offset=t_offset, T_loc=T_loc, H=H, kv=kv,
                       scale=cfg.attn_scale)
    o = o.reshape(o.shape[:-2] + (n_q * hd,))
    if mode == "head_tp":
        out = residual(x_sp, ctx.matmul_rs(o, wo), cfg.residual_scale)
    else:
        out = residual(x_sp, ctx.mm(o, wo), cfg.residual_scale)
    if return_kv:
        if mode == "head_tp" and kv_loc != kv:     # tp-sharded kv heads
            k, v = ctx.gather_tp(k, 2), ctx.gather_tp(v, 2)
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, ctx: ParallelCtx, *, pos, H: int,
                     window: Optional[int] = None,
                     ring: bool = False,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (..., B, 1, H, hd) (every head on every tp rank); k/v_cache:
    (..., B, S/tp, kv, hd), each rank's chunk of the T-sharded cache (the
    leading dims are the stacked tp ranks; none without a tp axis).
    ``pos``: current global position — a scalar shared by the batch, or a
    (B,) vector of per-slot positions (continuous batching over
    heterogeneous sequence lengths).  ``ring``: the cache is a ring buffer
    of size ``window`` (global kv index = pos - window + 1 .. pos, stored
    mod window).  GQA groups the q heads of each kv head (no repeat of the
    cache).  Split-K: each rank scores its chunk, the row max is
    ``pmax_tp``'d and the exponent sums and p·v are ``psum_tp``'d (no-ops
    without a tp axis).  ``scale``: the scores' scale (None: 1 /
    sqrt(hd))."""
    *lead, B, _, nH, hd = q.shape
    S_loc, kv = k_cache.shape[-3], k_cache.shape[-2]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    base = torch.as_tensor(ctx.tp_rank, device=q.device) * S_loc
    slot = base.reshape(*lead, 1, 1) \
        + torch.arange(S_loc, device=q.device)             # (..., 1, S_loc)
    pos = torch.as_tensor(pos, device=q.device)
    if pos.dim() == 1:                   # per-slot positions: (B, 1)
        pos = pos[:, None]
    if ring:
        W = window
        # slot s holds global index: the largest g <= pos with g % W == s
        gidx = pos - ((pos - slot) % W)
        valid = (gidx >= 0) & (gidx <= pos) & (pos - gidx < W)
    else:
        valid = slot <= pos
        if window is not None:
            valid &= (pos - slot) < window                 # (..., B|1, S_loc)

    qg = q.float().reshape(*lead, B, kv, nH // kv, hd) * scale  # h = kv*G+g
    s = torch.einsum("...bkgd,...bskd->...bkgs", qg, k_cache.float())
    s = torch.where(valid[..., None, None, :], s,
                    torch.full((), NEG, device=q.device))
    m = ctx.pmax_tp(s.amax(dim=-1))
    p = torch.exp(s - m[..., None])
    l_ = ctx.psum_tp(p.sum(dim=-1))
    o = ctx.psum_tp(torch.einsum("...bkgs,...bskd->...bkgd", p,
                                 v_cache.float()))
    out = o / l_[..., None].clamp_min(1e-30)
    return out.reshape(*lead, B, 1, nH, hd).to(q.dtype)


def cache_write(cache: torch.Tensor, new: torch.Tensor, ctx: ParallelCtx, *,
                pos, window: Optional[int] = None) -> torch.Tensor:
    """Write ``new`` (..., B, 1, kv, hd) into the T-sharded (..., B, S/tp,
    kv, hd) cache at global position ``pos`` — a shared scalar or a (B,)
    vector of per-slot positions (ring buffer when ``window``).  Every tp
    rank computes the same ``new``; only the rank that owns the slot
    (``pos // (S/tp)``) stores it.  As in the reference, a position past
    the cache lands at ``pos mod S`` at tp = 1 and is stored nowhere at
    tp > 1.  Unlike the reference, which returns a new array, the write is
    in place (one row per slot instead of a copy of the cache); the cache
    is returned."""
    B, S_loc = cache.shape[-4], cache.shape[-3]
    pos = torch.as_tensor(pos, device=cache.device).expand(B)
    gpos = pos % window if window is not None else pos
    owner = gpos // S_loc
    local = gpos - owner * S_loc
    rows = torch.arange(B, device=cache.device)
    new = new[..., 0, :, :].to(cache.dtype)                 # (..., B, kv, hd)
    if ctx.tp_axis:
        hit = ctx.tp_rank[:, None] == owner                 # (R, B)
        new = torch.where(hit[..., None, None], new,
                          cache[..., rows, local, :, :])
    cache[..., rows, local, :, :] = new
    return cache
