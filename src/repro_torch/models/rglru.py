"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The reference's ``repro/models/rglru.py``.  The recurrence h_t = a_t *
h_{t-1} + x_t is elementwise over the d_rnn channels, so it shards them
over tp (``dr_loc = d_rnn / tp`` per rank): the only collectives are the
sequence-parallel all-gather in and reduce-scatter out.  The reference
scans it in log space with ``lax.associative_scan``; here prefill runs it
through
``kernels.ops.lru_scan`` on a = exp(log_a): the hand-written kernel
(``csrc/lru_scan.cu``) on CUDA tensors, its plain version on CPU tensors.
Decode (T = 1) is one step, ``exp(log_a) * h_prev + x``, and launches no
kernel, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm
from repro_torch.models.parallel import ParallelCtx
from repro_torch.models.xlstm import _conv_state, causal_conv1d

C_COEF = 8.0


def rglru_scan(log_a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t, elementwise, a = exp(log_a).  (..., B, T,
    C) inputs; leading dims (stacked ranks) fold into the batch."""
    shape = x.shape
    a = torch.exp(log_a).reshape((-1,) + tuple(shape[-2:]))
    return ops.lru_scan(a, x.reshape(a.shape)).reshape(shape)


def rglru_block(x_sp, p, meta, ctx: ParallelCtx, cfg, *,
                state: dict | None = None, decode: bool = False,
                return_state: bool = False):
    """x_sp: (B, T/tp, d) per rank (stacked with a tp axis) or (B, 1, d)
    decode.  The decode state (``h`` (B, dr/tp), ``conv`` (B, K-1, dr/tp))
    is each tp rank's channel shard: decode's only collective is the
    ``psum_tp`` of the output projection."""
    eps = cfg.norm_eps
    nd = x_sp.dim()
    h_in = rms_norm(x_sp, ctx.at(ctx.gather_w(p["ln"], meta["ln"].fsdp_dim),
                                 nd), eps)
    hg = h_in if decode else ctx.ag_tokens(h_in)             # (B, T, d)
    lead = tuple(hg.shape[:-1])

    w_x = ctx.gather_w(p["w_x"], meta["w_x"].fsdp_dim)       # (d, 2, dr/tp)
    u = ctx.mm(hg, w_x.flatten(-2)).reshape(lead + (2, -1))
    y_gate = F.gelu(u[..., 0, :], approximate="tanh")        # (B, T, dr/tp)
    x_br = u[..., 1, :]

    conv_w = ctx.gather_w(p["conv"], meta["conv"].fsdp_dim)  # (dr/tp, K)
    if decode:
        xin = torch.cat([state["conv"], x_br], dim=-2)
        xc = causal_conv1d(xin, conv_w)[..., -1:, :]
        new_conv = xin[..., 1:, :]
    else:
        xc = causal_conv1d(x_br, conv_w)

    w_rg = ctx.gather_w(p["w_rg"], meta["w_rg"].fsdp_dim)    # (d, 2, dr/tp)
    g = ctx.mm(hg, w_rg.flatten(-2)).reshape(lead + (2, -1)).float()
    r = torch.sigmoid(g[..., 0, :])
    i = torch.sigmoid(g[..., 1, :])
    lam = ctx.gather_w(p["lam"], meta["lam"].fsdp_dim).float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))   # jax's softplus
    log_a = -C_COEF * ctx.at(softplus, nd) * r               # (B, T, dr/tp)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    gx = beta * i * xc.float()

    if decode:
        h_new = torch.exp(log_a[..., 0, :]) * state["h"] + gx[..., 0, :]
        h_seq = h_new.unsqueeze(-2)
        new_state = {"h": h_new, "conv": new_conv}
    else:
        h_seq = rglru_scan(log_a, gx)                        # (B, T, dr)
        new_state = None
        if return_state:
            new_state = {"h": h_seq[..., -1, :].clone(),
                         "conv": _conv_state(x_br, cfg.conv_kernel)}

    o = h_seq.to(hg.dtype) * y_gate
    w_out = ctx.gather_w(p["w_out"], meta["w_out"].fsdp_dim)  # (dr/tp, d)
    y = ctx.mm(o, w_out)
    if decode:
        return x_sp + ctx.psum_tp(y), new_state
    out = x_sp + ctx.rs_tokens(y)
    return (out, new_state) if return_state else out


def rglru_state_init(cfg, B: int, ctx: ParallelCtx, dtype=torch.float32,
                     device="cpu") -> dict:
    dr = cfg.rnn_width // max(ctx.tp, 1)
    return {"h": torch.zeros((B, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.conv_kernel - 1, dr), dtype=dtype,
                                device=device)}
