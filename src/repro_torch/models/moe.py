"""Mixture-of-Experts block: top-k routing and capacity dispatch, EP-aware.

The reference's ``repro/models/moe.py``.  Train / prefill: the experts are
sharded over the tp axis, factored as ``(ep, tp_ff) = MoESpec.ep_tp(tp)``
(granite's 40 experts at tp 2: ep 2, tp_ff 1); every tp rank sees the
sequence-parallel gather of the tokens, computes its local experts'
capacity buffers, and ONE reduce-scatter combines the expert-parallel
partial sums, the ffn-TP partial sums and the sequence-parallel return.
Serve (decode): tokens move, weights stay — in hier the experts' d_ff is
stored over the node's store ranks (``data_dim``), which the node's run
reads as one buffer, and the dispatch counts the node's gathered token set.

The port's ranks are stacked (``models.parallel``), so every rank's tables
are built at once: the dispatch is batched over the leading dims of its
token ids — the tp ranks (each with its own expert group, ``e0`` per rank)
and the members whose rows a domain run folds into one batch
(``ParallelCtx.fold``: each member is dispatched apart, with its own
capacity, as the reference's per-rank block is).

Dispatch and combine are two gathers, transposes of each other, through
the slot table and its inverse (``_Dispatch``, ``_RowGather``): no
scatter-add, so no atomics, and each token's k contributions add in
ascending expert order — the order the reference's scatter adds them in.
The card's results are fixed run to run.  The expert products are batched
einsums, as in the reference (which computes them outside any Pallas
kernel).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import activation, rms_norm
from repro_torch.models.meta import store_dim
from repro_torch.models.parallel import ParallelCtx


_routes: Optional[dict] = None


@contextlib.contextmanager
def routes(replay: Optional[list] = None):
    """Within the block every ``moe_block`` forward appends, in call order,
    to the yielded dict: its routing ids (``"idx"``), the smallest gap
    between its k-th and (k+1)-th logit (``"margin"``), its routing
    assignments to its ranks' local experts (``"assigned"``) and those the
    capacity kept (``"kept"``) — device tensors, no sync; a rematerialised
    forward appends again.  With ``replay`` (an earlier block's ``"idx"``
    list, e.g. the CPU's) each forward takes the next entry instead of its
    own top k; the gate stays the softmax of its own logits at those
    ids."""
    global _routes
    prev, _routes = _routes, {"idx": [], "margin": [], "assigned": [],
                              "kept": [], "replay": replay}
    try:
        yield _routes
    finally:
        _routes = prev


def drops(rec: dict) -> tuple[int, int]:
    """(routing assignments, kept) summed over a ``routes()`` record."""
    return (sum(int(a) for a in rec["assigned"]),
            sum(int(k) for k in rec["kept"]))


def _route_hooked(h: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """``route`` under ``routes()``: recorded, or replayed."""
    if _routes is None:
        return route(h, router_w, top_k)
    logits = torch.matmul(h.float(), router_w.float())
    if _routes["replay"] is not None:
        idx = _routes["replay"][len(_routes["idx"])].to(logits.device)
        gate = torch.softmax(logits.gather(-1, idx), dim=-1)
    else:
        idx, gate = route(h, router_w, top_k)
    top = torch.topk(logits, min(top_k + 1, logits.shape[-1]), dim=-1)[0]
    _routes["idx"].append(idx.detach())
    _routes["margin"].append((top[..., top_k - 1] - top[..., -1]).min()
                             .detach())
    return idx, gate


def route(h: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """h (..., N, d), router_w broadcastable (..., d, E) -> (idx (..., N, k)
    int64, gate (..., N, k) f32), the gate softmaxed over the top k.  A
    stable descending sort keeps ``lax.top_k``'s order (ties: the lower
    expert first)."""
    logits = torch.matmul(h.float(), router_w.float())
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate = torch.softmax(vals[..., :top_k], dim=-1)
    return idx[..., :top_k], gate


def dispatch_tables(idx: torch.Tensor, *, e0, n_local: int, capacity: int):
    """Gather / combine tables for the local expert group, batched over
    idx's leading dims.

    idx (..., N, k): global expert ids; ``e0`` an int or a tensor
    broadcastable to ``idx.shape[:-2]`` (each batch entry's first local
    expert).  Returns ``table`` (..., n_local, capacity), the token feeding
    each expert slot (``N``: empty), and ``slot`` (..., n_local,
    capacity), the routing slot ``t * k + j`` it came from (-1: empty);
    both int64."""
    lead, (N, k) = tuple(idx.shape[:-2]), tuple(idx.shape[-2:])
    dev = idx.device
    flat = idx.reshape(lead + (N * k,)).long()
    e0 = torch.as_tensor(e0, device=dev).long()
    local = flat - e0.reshape(tuple(e0.shape) + (1,) * (flat.dim()
                                                         - e0.dim()))
    key = torch.where((local >= 0) & (local < n_local), local,
                      torch.full_like(local, n_local))
    order = torch.argsort(key, dim=-1, stable=True)
    skey = torch.gather(key, -1, order)
    counts = torch.zeros(lead + (n_local + 1,), dtype=torch.long,
                         device=dev).scatter_add_(-1, key,
                                                  torch.ones_like(key))
    starts = torch.cumsum(counts, -1) - counts
    pos = torch.arange(N * k, device=dev) - torch.gather(starts, -1, skey)
    keep = (skey < n_local) & (pos < capacity)
    cell = torch.where(keep, skey * capacity + pos,
                       torch.full_like(pos, n_local * capacity))
    size = lead + ((n_local + 1) * capacity,)
    table = torch.full(size, N, dtype=torch.long, device=dev).scatter_(
        -1, cell, torch.where(keep, order // k, torch.full_like(order, N)))
    slot = torch.full(size, -1, dtype=torch.long, device=dev).scatter_(
        -1, cell, torch.where(keep, order, torch.full_like(order, -1)))
    cut = lead + (n_local + 1, capacity)
    return (table.reshape(cut)[..., :n_local, :],
            slot.reshape(cut)[..., :n_local, :])


def combine_tables(slot: torch.Tensor, N: int, k: int):
    """The inverse of ``slot`` for the gather combine.  Returns ``inv``
    (..., N, k): each token's buffer cells ``e * C + c`` sorted ascending
    (the sentinel ``E * C`` — dropped or another group's expert — last),
    ``perm`` (..., N, k): the routing slots in that order, and ``back``
    (..., E, C): each buffer cell's position ``t * k + j`` in the sorted
    order (``N * k``: empty)."""
    lead, (E, C) = tuple(slot.shape[:-2]), tuple(slot.shape[-2:])
    dev = slot.device
    s = slot.reshape(lead + (E * C,))
    cells = torch.arange(E * C, device=dev).expand(lead + (E * C,))
    inv = torch.full(lead + (N * k + 1,), E * C, dtype=torch.long,
                     device=dev).scatter_(
        -1, torch.where(s >= 0, s, torch.full_like(s, N * k)), cells)
    inv, perm = torch.sort(inv[..., :N * k].reshape(lead + (N, k)), dim=-1,
                           stable=True)
    back = torch.full(lead + (E * C + 1,), N * k, dtype=torch.long,
                      device=dev).scatter_(
        -1, inv.reshape(lead + (N * k,)),
        torch.arange(N * k, device=dev).expand(lead + (N * k,)))
    return inv, perm, back[..., :E * C].reshape(lead + (E, C))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (b, M, d), idx (b, ...) in [0, M] -> (b, ..., d): row ``idx`` of
    each batch entry's x, a zero row for ``M``."""
    b, M, d = x.shape
    pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1).reshape(-1, d)
    off = torch.arange(b, device=x.device).reshape(
        (b,) + (1,) * (idx.dim() - 1)) * (M + 1)
    return pad.index_select(0, (idx + off).reshape(-1)).reshape(
        tuple(idx.shape) + (d,))


def _ordered_sum(r: torch.Tensor, w=None) -> torch.Tensor:
    """Sum over the k axis (-2) of r (..., N, k, d), term by term in k
    order (each term times ``w[..., j]`` with a weight (..., N, k))."""
    k = r.shape[-2]
    y = r[..., 0, :] if w is None else r[..., 0, :] * w[..., 0, None]
    for j in range(1, k):
        y = y + (r[..., j, :] if w is None else r[..., j, :] * w[..., j, None])
    return y


class _Dispatch(torch.autograd.Function):
    """buf = tokens gathered through ``table`` (b, E, C, d); its gradient
    is the gather back through ``inv``, each token's k slots summed in
    ascending expert order (no scatter-add)."""

    @staticmethod
    def forward(ctx_, x, table, inv):
        ctx_.save_for_backward(inv)
        ctx_.shape = tuple(table.shape) + (x.shape[-1],)
        return _rows(x, table)

    @staticmethod
    def backward(ctx_, g):
        (inv,) = ctx_.saved_tensors
        b, E, C, d = ctx_.shape
        return _ordered_sum(_rows(g.reshape(b, E * C, d), inv)), None, None


class _RowGather(torch.autograd.Function):
    """Each token's k buffer rows (b, N, k, d), gathered through ``inv``;
    its gradient is the gather back through ``back`` (every buffer cell
    feeds at most one token slot)."""

    @staticmethod
    def forward(ctx_, buf, inv, back):
        ctx_.save_for_backward(back)
        b, E, C, d = buf.shape
        ctx_.shape = (b, E, C, d)
        return _rows(buf.reshape(b, E * C, d), inv)

    @staticmethod
    def backward(ctx_, g):
        (back,) = ctx_.saved_tensors
        b, E, C, d = ctx_.shape
        N, k = g.shape[1], g.shape[2]
        return _rows(g.reshape(b, N * k, d), back), None, None


def dispatch(tokens: torch.Tensor, table: torch.Tensor, inv: torch.Tensor
             ) -> torch.Tensor:
    """tokens (..., N, d) -> the expert buffers (..., E, C, d) through
    ``table`` (``N`` gives a zero row); deterministic gradient."""
    lead = tuple(table.shape[:-2])
    b = math.prod(lead)
    out = _Dispatch.apply(tokens.reshape((b,) + tuple(tokens.shape[-2:])),
                          table.reshape((b,) + tuple(table.shape[-2:])),
                          inv.reshape((b,) + tuple(inv.shape[-2:])))
    return out.reshape(lead + tuple(out.shape[1:]))


def combine(out_buf: torch.Tensor, gate: torch.Tensor, inv: torch.Tensor,
            perm: torch.Tensor, back: torch.Tensor) -> torch.Tensor:
    """The expert outputs (..., E, C, d) back to tokens (..., N, d): each
    token's rows times its gates, added in ascending expert order (the
    tables of ``combine_tables``)."""
    lead = tuple(inv.shape[:-2])
    b = math.prod(lead)
    rows = _RowGather.apply(
        out_buf.reshape((b,) + tuple(out_buf.shape[-3:])),
        inv.reshape((b,) + tuple(inv.shape[-2:])),
        back.reshape((b,) + tuple(back.shape[-2:])))
    g = torch.gather(gate, -1, perm).to(out_buf.dtype)
    y = _ordered_sum(rows, g.reshape(rows.shape[:-1]))
    return y.reshape(lead + tuple(y.shape[1:]))


def expert_ffn(buf: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
               act: str) -> torch.Tensor:
    """buf (..., [m,] E_loc, C, d); w_in (..., E_loc, d, 2, dff_loc) — the
    explicit gate / up axis, so dff sharding never splits the halves;
    w_out (..., E_loc, dff_loc, d).  A member axis ``m`` of buf (the
    folded ranks) shares the weights."""
    lhs = "...mecd" if buf.dim() == w_in.dim() else "...ecd"
    u = torch.einsum(f"{lhs},...edgf->{lhs[:-1]}gf", buf, w_in)
    a = activation(act, u[..., 0, :], u[..., 1, :])
    return torch.einsum(f"{lhs[:-1]}f,...efd->{lhs}", a, w_out)


def _local(w: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """A stored ``(tp, E_loc, ...)`` expert leaf's rank slice: the
    tp-sharded dim 0 has one entry per rank (after the stacked tp
    ranks' axis, if any)."""
    return w.select(1 if ctx.tp_axis else 0, 0)


def moe_block(x_sp: torch.Tensor, p: dict, meta: dict, ctx: ParallelCtx,
              cfg, *, serve: bool = False) -> torch.Tensor:
    """x_sp: (B, T/tp, d) (train / prefill) or (B, 1, d) (serve), behind
    the stacked tp ranks' axis with a tp axis."""
    spec = cfg.moe
    E, k = spec.num_experts, spec.top_k
    ep, tp_ff = spec.ep_tp(ctx.tp)
    n_local = E // ep
    lead = (x_sp.shape[0],) if ctx.tp_axis else ()

    h = rms_norm(x_sp, ctx.at(ctx.gather_w(p["ln"], store_dim(meta["ln"])),
                              x_sp.dim()), cfg.norm_eps)
    # serve: the node's run stands for its store ranks' copies of the
    # replicated batch (the reference gathers them), so the capacity counts
    # them; train: the folded members are dispatched apart
    hg = h if serve else ctx.ag_tokens(h)                  # (.., B, T, d)
    m = 1 if serve else ctx.fold
    copies = ctx.node_copies if serve else 1
    d = hg.shape[-1]
    tokens = hg.reshape(lead + (m, -1, d))                 # (.., m, N, d)
    N = tokens.shape[-2]

    router = ctx.gather_w(p["router"], store_dim(meta["router"]))
    w_in = _local(ctx.gather_w(p["w_in"], store_dim(meta["w_in"])), ctx)
    w_out = _local(ctx.gather_w(p["w_out"], store_dim(meta["w_out"])), ctx)
    with record_function("moe::route"):
        idx, gate = _route_hooked(tokens, ctx.at(router, tokens.dim()), k)
        ep_idx, _ = ctx.tp_group_rank(tp_ff)               # outer=ep
        e0 = ep_idx * n_local
        if ctx.tp_axis:
            e0 = e0.to(x_sp.device).reshape(-1, 1)         # (tp, 1)
        capacity = int(N * copies * k / E * spec.capacity_factor) + 1
        table, slot = dispatch_tables(idx, e0=e0, n_local=n_local,
                                      capacity=capacity)
        inv, perm, back = combine_tables(slot, N, k)
    if _routes is not None:
        lo = e0.reshape(-1, 1, 1, 1) if ctx.tp_axis else e0  # (.., m, N, k)
        _routes["assigned"].append(((idx >= lo) & (idx < lo + n_local))
                                   .sum())
        _routes["kept"].append((slot >= 0).sum())
    with record_function("moe::dispatch"):
        buf = dispatch(tokens, table, inv)                 # (.., m, E, C, d)
    with record_function("moe::experts"):
        out_buf = expert_ffn(buf, w_in, w_out, cfg.act)
    with record_function("moe::combine"):
        y = combine(out_buf, gate, inv, perm, back).reshape(hg.shape)
    if serve:
        return x_sp + ctx.psum_tp(y)
    return x_sp + ctx.rs_tokens(y)   # combines EP + ffn-TP partials + SP


def aux_load_balance_loss(idx: torch.Tensor, gate: torch.Tensor, E: int
                          ) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction dispatched x mean gate)."""
    onehot = F.one_hot(idx.long(), E).float()              # (N, k, E)
    frac = torch.mean(torch.sum(onehot, dim=1), dim=0)     # (E,)
    prob = torch.mean(torch.sum(onehot * gate[..., None], dim=1), dim=0)
    return E * torch.sum(frac * prob)
