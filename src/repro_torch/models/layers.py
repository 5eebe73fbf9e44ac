"""Shared layer math: norms, positions, embeddings, FFN, decode logits.

The reference's ``repro/models/layers.py`` in PyTorch, for a ctx without
a tensor-parallel axis: pure functions of (params, inputs, ctx); the
residual stream is (B, T, d).  ``unembed_xent`` is the streamed training
loss: logits exist one chunk of ``chunk`` tokens at a time, and each chunk
is recomputed in the backward (``torch.utils.checkpoint``) instead of kept.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.parallel import ParallelCtx


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


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
    """x: (..., T, n, hd); positions: (T,) global token positions.

    ``compute_dtype``: rotate in this dtype (the angle tables stay fp32)."""
    freqs = _freqs(x.shape[-1], theta, x.device)
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] \
        * freqs[None, :]                                       # (T, hd/2)
    dt = compute_dtype or torch.float32
    cos = torch.cos(ang)[None, :, None, :].to(dt)
    sin = torch.sin(ang)[None, :, None, :].to(dt)
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
    """(T,) -> (T, d) classic transformer PE."""
    half = d // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0)) * torch.arange(
        half, dtype=torch.float32) / half).to(positions.device)
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / decode logits (the whole vocab is local at tp = 1)
# ---------------------------------------------------------------------------

def embed(ids: torch.Tensor, emb: torch.Tensor, ctx: ParallelCtx
          ) -> torch.Tensor:
    """Lookup in the (V, d) table.  Out-of-range ids give zero rows, as in
    the reference's vocab-parallel lookup."""
    v = emb.shape[0]
    valid = (ids >= 0) & (ids < v)
    out = emb[ids.clamp(0, v - 1)] * valid[..., None]
    return out.to(ctx.compute_dtype)


def _chunk_nll(xc, lc, mc, unemb, softcap, ldt):
    """One chunk's per-row (nll sum, count): (B, chunk) rows of logits in
    ``ldt``, the max a stabilizer only (the gradient flows through the
    sum of exponentials), fp32 reductions."""
    logits = xc.to(ldt) @ unemb.to(ldt)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    mx = logits.amax(dim=-1).float().detach()
    p = torch.exp(logits - mx[..., None].to(ldt))
    se = torch.sum(p, dim=-1, dtype=torch.float32)
    lse = mx + torch.log(se)
    v = unemb.shape[1]
    ok = (lc >= 0) & (lc < v)
    corr = (torch.gather(logits, -1, lc.clamp(0, v - 1)[..., None].long())
            [..., 0] * ok).float()
    nll = (lse - corr) * mc
    return nll.sum(dim=-1), mc.sum(dim=-1)


def unembed_xent_rows(x: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, unemb: torch.Tensor,
                      ctx: ParallelCtx, *, chunk: int = 512,
                      softcap: Optional[float] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``unembed_xent`` per batch row: ((B,) nll sums, (B,) token counts),
    each row summed over its chunks in order.  A cluster step that folds
    several ranks' rows into one run splits these back into the ranks'
    partials."""
    B, T, d = x.shape
    chunk = min(chunk, T)
    ldt = ctx.compute_dtype if ctx.has("bf16_xent") else torch.float32
    total = torch.zeros(B, dtype=torch.float32, device=x.device)
    count = torch.zeros(B, dtype=torch.float32, device=x.device)
    for t0 in range(0, T, chunk):
        args = (x[:, t0:t0 + chunk], labels[:, t0:t0 + chunk],
                mask[:, t0:t0 + chunk], unemb, softcap, ldt)
        if torch.is_grad_enabled() and (x.requires_grad
                                        or unemb.requires_grad):
            s, c = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            s, c = _chunk_nll(*args)
        total, count = total + s, count + c
    return total, count


def unembed_xent(x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 unemb: torch.Tensor, ctx: ParallelCtx, *, chunk: int = 512,
                 softcap: Optional[float] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streamed cross-entropy: x (B, T, d), labels / mask (B, T), unemb
    (d, V).  Returns the (nll sum, token count) partials — the caller
    reduces them.  Logits never exceed (B, chunk, V); the max is a
    stabilizer only.  ``bf16_xent`` keeps the logits in the compute
    dtype."""
    total, count = unembed_xent_rows(x, labels, mask, unemb, ctx,
                                     chunk=chunk, softcap=softcap)
    return total.sum(), count.sum()


def decode_logits(x: torch.Tensor, unemb: torch.Tensor, ctx: ParallelCtx, *,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """x: (B, 1, d) -> full-vocab f32 logits (B, 1, V)."""
    logits = x.float() @ unemb.float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def _ffn_body(x: torch.Tensor, p: dict, meta: dict, ctx: ParallelCtx, *,
              act: str, eps: float) -> torch.Tensor:
    w_ln = ctx.gather_w(p["ln"], meta["ln"].fsdp_dim)
    w_in = ctx.gather_w(p["w_in"], meta["w_in"].fsdp_dim)   # (d, g, dff)
    h = rms_norm(x, w_ln, eps)
    u = torch.einsum("btd,dgf->btgf", h, w_in)
    if act == "gelu":
        a = activation(act, u[:, :, 0], None)
    else:
        a = activation(act, u[:, :, 0], u[:, :, 1])
    return ctx.ag_matmul(a, p["w_out"], meta["w_out"].fsdp_dim)


def ffn(x_sp: torch.Tensor, p: dict, meta: dict, ctx: ParallelCtx, *,
        act: str, eps: float) -> torch.Tensor:
    return x_sp + ctx.rs_tokens(_ffn_body(x_sp, p, meta, ctx, act=act,
                                          eps=eps))


def ffn_decode(x: torch.Tensor, p: dict, meta: dict, ctx: ParallelCtx, *,
               act: str, eps: float) -> torch.Tensor:
    """Decode-shape FFN: one token per sequence."""
    return x + ctx.psum_tp(_ffn_body(x, p, meta, ctx, act=act, eps=eps))
