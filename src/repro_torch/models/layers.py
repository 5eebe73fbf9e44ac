"""Shared layer math: norms, positions, embeddings, FFN, decode logits.

The reference's ``repro/models/layers.py`` in PyTorch: pure functions of
(params, inputs, ctx); the residual stream is (B, T, d), and with a tp axis
it is sequence-parallel, (B, T/tp, d) per rank behind the stacked tp ranks'
axis (``models.parallel``).  The embedding and the unembedding are
vocab-parallel: each tp rank holds a vocab shard.  ``unembed_xent`` is the
streamed training loss: logits exist one chunk of ``chunk`` tokens at a
time, and each chunk is recomputed in the backward
(``torch.utils.checkpoint``) instead of kept.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.parallel import ParallelCtx
from repro_torch.substrate.collectives import keep_mesh


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def residual(x: torch.Tensor, branch: torch.Tensor, scale: float = 1.0
             ) -> torch.Tensor:
    """The residual stream after a block's branch: ``x + scale * branch``
    (Granite's residual multiplier; 1 adds the branch as it is)."""
    return x + branch if scale == 1.0 else x + scale * branch


def activation(kind: str, gate: torch.Tensor, up: Optional[torch.Tensor]
               ) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    return F.silu(gate) * up


def _freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
            dt: torch.dtype) -> torch.Tensor:
    x1, x2 = torch.chunk(x.to(dt), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         compute_dtype=None) -> torch.Tensor:
    """x: (..., B, T, n, hd); positions: (T,) global token positions, or
    (R, T) per stacked rank for x (R, B, T, n, hd).

    ``compute_dtype``: rotate in this dtype (the angle tables stay fp32)."""
    freqs = _freqs(x.shape[-1], theta, x.device)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] \
        * freqs                                                # (.., T, hd/2)
    dt = compute_dtype or torch.float32
    cos = torch.cos(ang).unsqueeze(-2).unsqueeze(-4).to(dt)  # (.., 1, T, 1, .)
    sin = torch.sin(ang).unsqueeze(-2).unsqueeze(-4).to(dt)
    return _rotate(x, cos, sin, dt)


def rope_decode(x: torch.Tensor, pos, theta: float,
                compute_dtype=None) -> torch.Tensor:
    """Decode-step rope: x is (B, 1, n, hd); ``pos`` is a position scalar
    shared by the batch, or a (B,) vector of per-slot positions (continuous
    batching).  The scalar path matches ``rope(x, pos[None], ...)``."""
    pos = torch.as_tensor(pos, device=x.device)
    if pos.dim() == 0:
        return rope(x, pos[None], theta, compute_dtype)
    freqs = _freqs(x.shape[-1], theta, x.device)
    ang = pos.float()[:, None] * freqs[None, :]                # (B, hd/2)
    dt = compute_dtype or torch.float32
    cos = torch.cos(ang)[:, None, None, :].to(dt)
    sin = torch.sin(ang)[:, None, None, :].to(dt)
    return _rotate(x, cos, sin, dt)


def sinusoidal_pe(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., T) -> (..., T, d) classic transformer PE."""
    half = d // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0)) * torch.arange(
        half, dtype=torch.float32) / half).to(positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Vocab-parallel embedding / unembedding
# ---------------------------------------------------------------------------

def embed(ids: torch.Tensor, emb: torch.Tensor, ctx: ParallelCtx, *,
          sp: bool = False) -> torch.Tensor:
    """Lookup in the vocab shard ``emb`` (V/tp, d); out-of-range ids give
    zero rows.  With a tp axis, ``ids`` (R, B, T) and ``emb`` (R, V/tp, d)
    are stacked per rank: every rank looks every token up in its shard and
    the partials are reduce-SCATTERED over the token dim into the (B, T/tp,
    d) sequence-parallel stream (``sp=True``), or psum'd (``sp=False``)."""
    v_loc = emb.shape[-2]
    local = ids - ctx.at(ctx.tp_rank * v_loc, ids.dim())
    valid = (local >= 0) & (local < v_loc)
    local = local.clamp(0, v_loc - 1)
    if ctx.tp_axis:
        ranks = torch.arange(emb.shape[0], device=emb.device)
        rows = emb[ctx.at(ranks, local.dim()), local]
    else:
        rows = emb[local]
    out = (rows * valid[..., None]).to(ctx.compute_dtype)
    return ctx.rs_tokens(out) if sp else ctx.psum_tp(out)


def _scaled_logits(logits: torch.Tensor, logit_scale: float,
                   softcap: Optional[float], vocab: Optional[int],
                   ctx: ParallelCtx) -> torch.Tensor:
    """Logits over the rank's vocab shard divided by ``logit_scale``
    (Granite's ``logits_scaling``), then soft-capped; with ``vocab`` the
    padded rows' columns (``vocab`` and up) are -inf, out of the
    softmax."""
    if logit_scale != 1.0:
        logits = logits / logit_scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if vocab is not None:
        v_loc = logits.shape[-1]
        col = ctx.at(ctx.tp_rank * v_loc, logits.dim()) + torch.arange(
            v_loc, device=logits.device)
        logits = logits.masked_fill(col >= vocab, float("-inf"))
    return logits


def _chunk_nll(xc, lc, mc, unemb, softcap, ldt, ctx, logit_scale=1.0,
               vocab=None):
    """One chunk's per-row (nll sum, count): (B, chunk) rows of logits over
    the rank's vocab shard in ``ldt``; the vocab max (``pmax_tp``) a
    stabilizer only (the gradient flows through the sum of exponentials),
    the sums over the shards ``psum_tp``, fp32 reductions."""
    logits = _scaled_logits(ctx.mm(xc.to(ldt), unemb.to(ldt)), logit_scale,
                            softcap, vocab, ctx)
    mx = ctx.pmax_tp(logits.amax(dim=-1).float()).detach()
    p = torch.exp(logits - mx[..., None].to(ldt))
    se = ctx.psum_tp(torch.sum(p, dim=-1, dtype=torch.float32))
    lse = mx + torch.log(se)
    v_loc = unemb.shape[-1]
    lloc = lc - ctx.at(ctx.tp_rank * v_loc, lc.dim())
    ok = (lloc >= 0) & (lloc < v_loc)
    corr = ctx.psum_tp((torch.gather(
        logits, -1, lloc.clamp(0, v_loc - 1)[..., None].long())[..., 0]
        * ok).float())
    nll = (lse - corr) * mc
    return nll.sum(dim=-1), mc.sum(dim=-1)


def unembed_xent_rows(x: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, unemb: torch.Tensor,
                      ctx: ParallelCtx, *, chunk: int = 512,
                      softcap: Optional[float] = None,
                      logit_scale: float = 1.0, vocab: Optional[int] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``unembed_xent`` per batch row: ((..., B) nll sums, (..., B) token
    counts), each row summed over its chunks in order.  A cluster step that
    folds several ranks' rows into one run splits these back into the
    ranks' partials."""
    xg = ctx.ag_tokens(x)                                 # (.., B, T, d)
    T = xg.shape[-2]
    chunk = min(chunk, T)
    ldt = ctx.compute_dtype if ctx.has("bf16_xent") else torch.float32
    total = torch.zeros(xg.shape[:-2], dtype=torch.float32, device=x.device)
    count = torch.zeros(xg.shape[:-2], dtype=torch.float32, device=x.device)
    # the chunk's collectives re-run in the backward's recompute
    fn = keep_mesh(_chunk_nll)
    for t0 in range(0, T, chunk):
        args = (xg[..., t0:t0 + chunk, :], labels[..., t0:t0 + chunk],
                mask[..., t0:t0 + chunk], unemb, softcap, ldt, ctx,
                logit_scale, vocab)
        if torch.is_grad_enabled() and (x.requires_grad
                                        or unemb.requires_grad):
            s, c = checkpoint(fn, *args, use_reentrant=False)
        else:
            s, c = fn(*args)
        total, count = total + s, count + c
    return total / ctx.tp, count / ctx.tp


def unembed_xent(x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 unemb: torch.Tensor, ctx: ParallelCtx, *, chunk: int = 512,
                 softcap: Optional[float] = None, logit_scale: float = 1.0,
                 vocab: Optional[int] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streamed vocab-parallel cross-entropy: x (B, T/tp, d) sequence-
    parallel, labels / mask the FULL (B, T), unemb the vocab shard
    (d, V/tp).  x is gathered to full T first, so the vocab psums combine
    the same tokens on every tp rank; the nll is then tp-replicated and the
    sums are divided by tp, so the caller's flat reduction over (tp, dp)
    is exact.  Returns the (nll sum, token count) partials — per stacked
    rank with a tp axis.  Logits never exceed (B, chunk, V/tp).
    ``bf16_xent`` keeps the logits in the compute dtype.  With ``vocab``
    the softmax runs over the padded vocabulary's first ``vocab`` rows
    alone."""
    total, count = unembed_xent_rows(x, labels, mask, unemb, ctx,
                                     chunk=chunk, softcap=softcap,
                                     logit_scale=logit_scale, vocab=vocab)
    return total.sum(dim=-1), count.sum(dim=-1)


def decode_logits(x: torch.Tensor, unemb: torch.Tensor, ctx: ParallelCtx, *,
                  softcap: Optional[float] = None,
                  logit_scale: float = 1.0,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """x: (B, 1, d) -> full-vocab f32 logits (B, 1, V); with a tp axis the
    vocab shards' logits are all-gathered, so every tp rank holds the full
    row.  With ``vocab`` the padded rows' logits are -inf."""
    logits = _scaled_logits(ctx.mm(x.float(), unemb.float()), logit_scale,
                            softcap, vocab, ctx)
    return ctx.gather_tp(logits, logits.dim() - 2)


# ---------------------------------------------------------------------------
# Dense FFN (Megatron-SP: AG tokens -> col / row parallel -> RS tokens)
# ---------------------------------------------------------------------------

def _ffn_body(x: torch.Tensor, p: dict, meta: dict, ctx: ParallelCtx, *,
              act: str, eps: float, gather: bool) -> torch.Tensor:
    w_ln = ctx.gather_w(p["ln"], meta["ln"].fsdp_dim)
    w_in = ctx.gather_w(p["w_in"], meta["w_in"].fsdp_dim)  # (d, g, dff/tp)
    h = rms_norm(x, ctx.at(w_ln, x.dim()), eps)
    if gather:
        h = ctx.ag_tokens(h)                               # (B, T, d)
    u = ctx.mm(h, w_in.flatten(-2)).unflatten(-1, w_in.shape[-2:])
    if act == "gelu":
        a = activation(act, u[..., 0, :], None)
    else:
        a = activation(act, u[..., 0, :], u[..., 1, :])
    return ctx.ag_matmul(a, p["w_out"], meta["w_out"].fsdp_dim)


def ffn(x_sp: torch.Tensor, p: dict, meta: dict, ctx: ParallelCtx, *,
        act: str, eps: float, residual_scale: float = 1.0) -> torch.Tensor:
    return residual(x_sp, ctx.rs_tokens(_ffn_body(
        x_sp, p, meta, ctx, act=act, eps=eps, gather=True)), residual_scale)


def ffn_decode(x: torch.Tensor, p: dict, meta: dict, ctx: ParallelCtx, *,
               act: str, eps: float, residual_scale: float = 1.0
               ) -> torch.Tensor:
    """Decode-shape FFN: one token per sequence, no token gather (the
    token is replicated over tp); column / row parallel with one
    ``psum_tp``."""
    return residual(x, ctx.psum_tp(_ffn_body(x, p, meta, ctx, act=act,
                                             eps=eps, gather=False)),
                    residual_scale)
