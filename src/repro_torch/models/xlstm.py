"""xLSTM blocks: mLSTM (chunkwise-parallel linear attention with a matrix
memory) and sLSTM (a sequential scalar-memory RNN).  arXiv:2405.04517.

The reference's ``repro/models/xlstm.py`` over the port's stacked ranks
(``models.parallel``): with a tp axis every activation and weight carries a
leading axis of the tp ranks, products go through ``ctx.mm`` or a batched
einsum, and a per-rank slice of a weight the tp ranks replicate is an index
gather by ``ctx.tp_rank``.  Neither block reaches a Pallas kernel in the
reference, and neither launches a hand-written kernel here.

* mLSTM: the inner width is head-major and tp-sharded; q / k / gates come
  from a group all-gather of the head's inputs, v from the rank's v-slice.
  Intra-chunk masked linear attention, then the cross-chunk state
  recurrence ``C = D C + dC``, ``n = D n + dn``.
* sLSTM: a Python loop over time, the batch split over the tp ranks; its
  recurrent FLOPs are reported analytically (``slstm_scan_flops``).

What is the port's own, not the reference's:

* The cross-chunk prefix is a plain loop over the T / chunk chunks (the
  reference runs it with ``lax.associative_scan``): the same recurrence
  summed in another order, so equal at the f32 tolerance, not bit for bit.
* Ragged T: the reference asserts that T is a multiple of the chunk, so it
  cannot prefill most prompt lengths.  Here T is padded up to a multiple
  with neutral steps (input gate -1e30, forget gate log 0: they add and
  decay nothing) and the stabilizer ``m`` is taken over the real positions,
  so the outputs at real positions and the final state are those of the
  unpadded sequence.
* The intra-chunk weights are exponentiated with the upper triangle masked
  to -inf first (the reference masks after ``exp``), so no overflow there
  can turn the gradient into NaN; the values are the same.
* Head groups (tp > n_heads): rank r holds head ``r // g`` (g = tp / nh
  ranks share a head, contiguous, as ``group_all_gather`` groups them);
  the reference takes head ``(r * hpc) % nh``, which is the same only when
  g = 1 or nh = 1.
* ``slstm_block`` raises ``ValueError`` where the tp ranks' batch split
  does not tile the batch (B not a multiple of ``nb = min(tp, B)``, or tp
  not a multiple of ``nb``); the reference there leaves rows out of the
  block's output (or counts one twice).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spans import span
from repro_torch.models.domains import scan
from repro_torch.models.layers import rms_norm
from repro_torch.models.parallel import ParallelCtx

NEG = -1e30          # the empty state's stabilizer, a padded step's gate


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (..., B, T, C), w (..., C, K) (leading dims
    alike: stacked ranks)."""
    K = w.shape[-1]

    def tap(k):                                   # (..., 1, 1, C)
        return w[..., k].unsqueeze(-2).unsqueeze(-2)

    out = x * tap(-1)
    for j in range(1, K):
        shifted = torch.nn.functional.pad(x, (0, 0, j, 0))[..., :-j, :]
        out = out + shifted * tap(K - 1 - j)
    return out


def _conv_state(x_br: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 conv inputs (a copy, not a view of the prefill's
    activations), left-padded with zeros — the conv's own padding — when
    the prompt is shorter than that.  (The reference returns the short
    tail, which no (B, K-1, dr) cache takes.)"""
    tail = x_br[..., -(K - 1):, :]
    return F.pad(tail, (0, 0, K - 1 - tail.shape[-2], 0))


def _head_layout(ctx: ParallelCtx, nh: int, hd: int):
    """hpc: heads per chip, g: chips per head, vs: local v-slice width."""
    tp = ctx.tp
    hpc = max(nh // tp, 1)
    g = max(tp // nh, 1)
    return hpc, g, hd // g


# ---------------------------------------------------------------------------
# mLSTM chunkwise-parallel form
# ---------------------------------------------------------------------------

def mlstm_parallel(q, k, v, ig, fg, *, chunk: int = 128,
                   return_state: bool = False):
    """q, k: (..., T, h, hd); v: (..., T, h, vs); ig, fg: (..., T, h) raw
    gates (leading dims: rows).  Returns (..., T, h, vs) (+ the final
    stabilized state ``C`` (..., h, hd, vs), ``n`` (..., h, hd), ``m``
    (..., h) with ``return_state``).  Stabilized with a per-sequence
    input-gate max; any T (padded to a multiple of the chunk)."""
    lead = tuple(q.shape[:-3])
    T, h, hd = q.shape[-3:]
    vs, dt = v.shape[-1], q.dtype
    S = min(chunk, T)
    nc = -(-T // S)
    pad = nc * S - T
    rows = (-1, T)
    q, k, v = (x.reshape(rows + tuple(x.shape[-2:])).float()
               for x in (q, k, v))
    ig = ig.reshape(rows + (h,)).float()
    N = q.shape[0]
    scale = hd ** 0.5

    log_f = F.logsigmoid(fg.reshape(rows + (h,)).float())   # (N, T, h)
    m = ig.amax(dim=1, keepdim=True).detach()               # (N, 1, h)
    li = ig - m                                             # log i', <= 0
    if pad:                                      # neutral steps at the end
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))
        li = F.pad(li, (0, 0, 0, pad), value=NEG)

    def heads(x):     # (N, nc*S, h, e) -> (N, nc, h, S, e)
        return x.reshape(N, nc, S, h, -1).permute(0, 1, 3, 2, 4)

    qh, kh, vh = heads(q), heads(k), heads(v)
    Fc = log_f.reshape(N, nc, S, h).permute(0, 1, 3, 2).cumsum(-1)
    lic = li.reshape(N, nc, S, h).permute(0, 1, 3, 2)       # (N, nc, h, S)
    Ftot = Fc[..., -1]                                      # (N, nc, h)

    with span("xlstm::mlstm_intra"):
        # A[t, s] = exp(F[t] - F[s] + li[s]) (q_t . k_s), s <= t
        smat = (qh @ kh.transpose(-1, -2)) / scale          # (N,c,h,t,s)
        logw = Fc[..., :, None] - Fc[..., None, :] + lic[..., None, :]
        tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        wq = torch.exp(logw.masked_fill(~tri, float("-inf"))) * smat
        o_intra = wq @ vh                                   # (N,c,h,t,vs)
        den_intra = wq.sum(-1)                              # (N,c,h,t)
        # chunk summaries: dC = sum_s exp(Ftot - F[s] + li[s]) k_s v_s^T
        kw = torch.exp(Ftot[..., None] - Fc + lic)[..., None] * kh
        dC = kw.transpose(-1, -2) @ vh                      # (N,c,h,hd,vs)
        dn = kw.sum(-2)                                     # (N,c,h,hd)
        D = torch.exp(Ftot)                                 # (N,c,h)
        decay = torch.exp(Fc)                               # (N,c,h,t)

    with span("xlstm::mlstm_prefix"):
        # the state before chunk c (C, n_: None while it is zero) and chunk
        # c's read of it; per-chunk operands by ``unbind`` (one backward
        # node each, not a full-size zero-filled gradient per chunk)
        Ds, dCs, dns = D.unbind(1), dC.unbind(1), dn.unbind(1)
        qs, decays = qh.unbind(1), decay.unbind(1)
        C = n_ = None
        o_inter = [torch.zeros_like(o_intra[:, 0])]
        den_inter = [torch.zeros_like(den_intra[:, 0])]
        for c in range(1, nc + 1 if return_state else nc):
            C = dCs[c - 1] if C is None else \
                Ds[c - 1][..., None, None] * C + dCs[c - 1]
            n_ = dns[c - 1] if n_ is None else \
                Ds[c - 1][..., None] * n_ + dns[c - 1]
            if c < nc:
                o_inter.append((qs[c] @ C) * decays[c][..., None] / scale)
                den_inter.append((qs[c] @ n_[..., None])[..., 0]
                                 * decays[c] / scale)

    num = o_intra + torch.stack(o_inter, 1)
    den = den_intra + torch.stack(den_inter, 1)
    den = torch.clamp_min(den.abs(), 1.0)
    out = (num / den[..., None]).permute(0, 1, 3, 2, 4)     # (N,c,t,h,vs)
    out = out.reshape(N, nc * S, h, vs)[:, :T]
    out = out.reshape(lead + (T, h, vs)).to(dt)
    if return_state:
        state = {"C": C.reshape(lead + (h, hd, vs)),
                 "n": n_.reshape(lead + (h, hd)),
                 "m": m[:, 0].reshape(lead + (h,))}
        return out, state
    return out


def mlstm_decode_step(state: dict, q, k, v, ig, fg):
    """One-token recurrence.  state: C (..., h, hd, vs), n (..., h, hd), m
    (..., h); q, k: (..., h, hd); v: (..., h, vs); ig, fg: (..., h)."""
    C, n, m = state["C"], state["n"], state["m"]
    hd = q.shape[-1]
    log_f = F.logsigmoid(fg.float())
    m_new = torch.maximum(log_f + m, ig.float())
    fp = torch.exp(log_f + m - m_new)
    ip = torch.exp(ig.float() - m_new)
    kf, vf = k.float(), v.float()
    C = fp[..., None, None] * C + ip[..., None, None] \
        * (kf[..., :, None] * vf[..., None, :])
    n = fp[..., None] * n + ip[..., None] * kf
    qf = q.float() / (hd ** 0.5)
    num = (qf[..., None, :] @ C)[..., 0, :]
    den = ((qf * n).sum(-1)).abs()
    den = torch.maximum(den, torch.exp(-m_new))
    out = num / den[..., None]
    return {"C": C, "n": n, "m": m_new}, out.to(q.dtype)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def _rank_heads(w: torch.Tensor, ctx: ParallelCtx, hpc: int, g: int,
                vs: int = 0) -> torch.Tensor:
    """This rank's ``hpc`` heads of a tp-replicated (nh, hd, e) weight —
    per stacked rank ``(tp, nh, hd, e) -> (tp, hpc, hd, e)`` with a tp axis,
    head ``(tp_rank // g) * hpc`` first — and with ``vs`` its v-slice
    ``(tp_rank % g) * vs`` of the last dim."""
    if not ctx.tp_axis:
        return w
    r = ctx.tp_rank
    ranks = torch.arange(w.shape[0], device=w.device)[:, None]
    idx = ((r // g) * hpc)[:, None] + torch.arange(hpc, device=w.device)
    w = w[ranks, idx]
    if vs and vs != w.shape[-1]:
        cols = ((r % g) * vs)[:, None] + torch.arange(vs, device=w.device)
        w = w.take_along_dim(cols[:, None, None, :], dim=-1)
    return w


def _head_mm(x: torch.Tensor, w: torch.Tensor, ctx: ParallelCtx):
    """Per-head product: x (..., T, h, d) by w ([tp,] h, d, e)."""
    if ctx.tp_axis:
        return torch.einsum("rbthd,rhde->rbthe", x, w)
    return torch.einsum("bthd,hde->bthe", x, w)


def mlstm_block(x_sp, p, meta, ctx: ParallelCtx, cfg, *, chunk: int = 128,
                state: dict | None = None, decode: bool = False,
                return_state: bool = False):
    """x_sp: (B, T/tp, d) per rank (stacked with a tp axis) or (B, 1, d)
    decode.  The decode state (``C`` (B, hpc, hd, vs), ``n`` (B, hpc, hd),
    ``m`` (B, hpc), ``conv`` (B, K-1, din/tp)) is each tp rank's heads and
    channel shard: decode's only collectives are the head group's gather
    and the ``psum_tp`` of the down projection."""
    nh, din = cfg.n_heads, cfg.d_inner
    hd = din // nh
    hpc, g, vs = _head_layout(ctx, nh, hd)
    nd = x_sp.dim()

    def w_(name):
        return ctx.gather_w(p[name], meta[name].fsdp_dim)

    h = rms_norm(x_sp, ctx.at(w_("ln"), nd), cfg.norm_eps)
    hg = h if decode else ctx.ag_tokens(h)                  # (B, T, d)
    lead = tuple(hg.shape[:-1])

    u = ctx.mm(hg, w_("w_up").flatten(-2)).reshape(lead + (2, -1))
    z_loc, x_loc = u[..., 0, :], u[..., 1, :]               # (B,T,din/tp)

    conv_w = w_("conv")                                     # (din/tp, K)
    if decode:
        xin = torch.cat([state["conv"], x_loc], dim=-2)
        xc = causal_conv1d(xin, conv_w)[..., -1:, :]
        new_conv = xin[..., 1:, :]
    else:
        xc = causal_conv1d(x_loc, conv_w)
    xc = F.silu(xc)

    # the head group's gather: (B, T, hpc, vs) -> (B, T, hpc, hd)
    xh = ctx.group_all_gather(xc.reshape(lead + (hpc, vs)), group=g, dim=3)
    q = _head_mm(xh, _rank_heads(w_("wq"), ctx, hpc, g), ctx)
    k = _head_mm(xh, _rank_heads(w_("wk"), ctx, hpc, g), ctx)
    gates = _head_mm(xh, _rank_heads(w_("wif"), ctx, hpc, g), ctx)
    v = _head_mm(xh, _rank_heads(w_("wv"), ctx, hpc, g, vs), ctx)
    ig, fg = gates[..., 0], gates[..., 1]

    if decode:
        with span("xlstm::mlstm_decode"):
            new_state, o = mlstm_decode_step(
                {n: state[n] for n in ("C", "n", "m")},
                q[..., 0, :, :], k[..., 0, :, :], v[..., 0, :, :],
                ig[..., 0, :], fg[..., 0, :])
        o = o.unsqueeze(-3)
        new_state["conv"] = new_conv
    elif return_state:
        o, new_state = mlstm_parallel(q, k, v, ig, fg, chunk=chunk,
                                      return_state=True)
        new_state["conv"] = _conv_state(x_loc, cfg.conv_kernel)
    else:
        o = mlstm_parallel(q, k, v, ig, fg, chunk=chunk)
        new_state = None

    o = o.reshape(lead + (hpc * vs,)) * F.silu(z_loc)
    y = ctx.mm(o, w_("w_down"))                             # (B, T, d)
    if decode:
        return x_sp + ctx.psum_tp(y), new_state
    out = x_sp + ctx.rs_tokens(y)
    return (out, new_state) if return_state else out


def mlstm_state_init(cfg, B: int, ctx: ParallelCtx, dtype=torch.float32,
                     device="cpu") -> dict:
    nh = cfg.n_heads
    hd = cfg.d_inner // nh
    hpc, g, vs = _head_layout(ctx, nh, hd)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, hpc, hd, vs), **f32),
            "n": torch.zeros((B, hpc, hd), **f32),
            "m": torch.full((B, hpc), NEG, **f32),
            "conv": torch.zeros((B, cfg.conv_kernel - 1,
                                 cfg.d_inner // max(ctx.tp, 1)),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# sLSTM (sequential; batch-split over tp)
# ---------------------------------------------------------------------------

def slstm_cell(carry, gx, r_w, nh: int):
    """carry: (h, c, n, m) each (..., b, d); gx: (..., b, 4, d) input-side
    gates; r_w: (..., nh, dh, 4, dh) recurrent block-diagonal weights."""
    h, c, n, m = carry
    d = h.shape[-1]
    dh = d // nh
    hr = h.reshape(tuple(h.shape[:-1]) + (nh, dh))
    gr = torch.einsum("...bhd,...hdgf->...bhgf", hr, r_w)  # (..,b,nh,4,dh)
    g = gx + gr.transpose(-3, -2).reshape(gx.shape)
    it, ft, zt, ot = g.unbind(-2)
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c_new = fp * c + ip * torch.tanh(zt)
    n_new = fp * n + ip
    h_new = torch.sigmoid(ot) * c_new / torch.clamp_min(n_new, 1e-6)
    return (h_new, c_new, n_new, m_new)


def _slstm_split(ctx: ParallelCtx, B: int):
    """The tp ranks' batch split: (nb sequence groups, bs rows each, cps
    ranks per group).  Raises where it does not tile the batch."""
    tp = ctx.tp
    nb = min(tp, B)
    if B % nb or tp % nb:
        raise ValueError(
            f"the sLSTM batch split needs B ({B}) and tp ({tp}) to be "
            f"multiples of min(tp, B) = {nb}: the reference leaves rows "
            f"out of the block's output there")
    return nb, B // nb, tp // nb


def slstm_block(x_sp, p, meta, ctx: ParallelCtx, cfg, *,
                state: dict | None = None, decode: bool = False,
                return_state: bool = False):
    """x_sp: (B, T/tp, d) per rank (stacked with a tp axis) or (B, 1, d)
    decode.  Train / prefill: tp rank r runs rows ``seq_idx * bs ..`` of
    the gathered batch through the time loop, ``seq_idx = r // cps``, and
    the primary rank of each group (``r % cps == 0``) contributes them to
    the reduce-scatter out.  Decode is replicated over tp: every rank
    steps every row, no collective."""
    d, nh = cfg.d_model, cfg.n_heads
    nd = x_sp.dim()

    def w_(name):
        return ctx.gather_w(p[name], meta[name].fsdp_dim)

    h_in = rms_norm(x_sp, ctx.at(w_("ln"), nd), cfg.norm_eps)
    hg = h_in if decode else ctx.ag_tokens(h_in)            # (B, T, d)
    lead = tuple(hg.shape[:-1])
    B, T = lead[-2], lead[-1]

    r_w = w_("r").float()                                   # (nh,dh,4,dh)
    gx = ctx.mm(hg, w_("w_x").flatten(-2)).reshape(lead + (4, d)) \
        + ctx.at(w_("b"), nd + 1)
    gx = gx.float()                                         # (B, T, 4, d)
    w_out = w_("w_out")                                     # (d, d)

    if decode:
        carry = (state["h"], state["c"], state["n"], state["m"])
        new = slstm_cell(carry, gx[..., 0, :, :], r_w, nh)
        hs = new[0].unsqueeze(-2).to(hg.dtype)              # (B, 1, d)
        return x_sp + ctx.mm(hs, w_out), dict(zip(("h", "c", "n", "m"),
                                                 new))

    nb, bs, cps = _slstm_split(ctx, B)
    dev = gx.device
    if ctx.tp_axis:
        r = ctx.tp_rank
        ranks = torch.arange(gx.shape[0], device=dev)[:, None]
        rows = ((r // cps) * bs)[:, None] + torch.arange(bs, device=dev)
        primary = (r % cps == 0).to(torch.float32)          # (tp,)
        gxm = gx[ranks, rows]                               # (tp,bs,T,4,d)
    else:
        gxm = gx

    z = gxm.new_zeros(tuple(gxm.shape[:-3]) + (d,))
    carry = (z, z, z, torch.full_like(z, NEG))
    with span("xlstm::slstm_loop"):
        # unbind: one backward node, not T
        carries = scan(lambda c, x, w: slstm_cell(c, x, w, nh), carry,
                       gxm.unbind(-3), r_w)
    carry = carries[-1]
    hs = torch.stack([c[0] for c in carries], -2).to(hg.dtype)  # (bs,T,d)
    y_me = ctx.mm(hs, w_out)

    new_state = None
    if return_state:
        if ctx.tp_axis:
            def widen(s):   # (tp, bs, d) -> (tp, B, d), the primary's rows
                full = s.new_zeros(s.shape[:1] + (B,) + s.shape[2:])
                full = full.index_put((ranks, rows),
                                      s * primary[:, None, None])
                return ctx.psum_tp(full)
            new_state = dict(zip(("h", "c", "n", "m"), map(widen, carry)))
        else:
            new_state = dict(zip(("h", "c", "n", "m"), carry))

    if ctx.tp_axis:
        y_full = y_me.new_zeros(lead + (d,))
        y_full = y_full.index_put(
            (ranks, rows), y_me * primary.to(y_me.dtype)[:, None, None, None])
        out = x_sp + ctx.rs_tokens(y_full)
    else:
        out = x_sp + y_me
    return (out, new_state) if return_state else out


def slstm_state_init(cfg, B: int, device="cpu") -> dict:
    """The empty state, f32 whatever the compute dtype (as the
    reference's)."""
    z = torch.zeros((B, cfg.d_model), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full_like(z, NEG)}


def slstm_scan_flops(cfg, B: int, T: int) -> float:
    """Analytic recurrent FLOPs hidden inside the time loop (per layer)."""
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    return 2.0 * B * T * nh * dh * 4 * dh
