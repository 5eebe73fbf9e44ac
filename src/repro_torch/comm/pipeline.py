"""Pipelined (chunked two-phase) collectives + fused collective-matmul.

The plain ``hier`` schedule runs the bridge stage only after the whole node
region is assembled.  Segmenting the message (Zhou et al.,
arXiv:2007.11496) splits it into ``n_chunks`` pieces, each staged through
one of TWO alternating ``SharedWindow`` epochs (double buffering, the paper's
§6 rule applied per segment).  Every primitive here produces the same values
as its unchunked ``naive``/``hier`` counterpart (the split/merge is pure
layout algebra) and moves the same total bytes.

The fused ``ag_matmul`` / ``ag_matmul_rows`` / ``matmul_rs`` apply the same
chunking to compute overlap.  On the card each chunk's collective runs on a
side CUDA stream, so the gather of chunk *k+1* (or the scatter of chunk
*k*) overlaps the panel matmul of chunk *k* on the current stream; CUDA
events keep buffer ``k % 2`` from being reused before chunk *k-2* was
consumed (``_ReuseFence``).  On the CPU the fence is a no-op.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from repro_torch.comm import primitives as p
from repro_torch.comm.window import SharedWindow
from repro_torch.kernels import ops
from repro_torch.substrate import collectives as coll

DEFAULT_CHUNKS = 2


# ---------------------------------------------------------------------------
# Chunk layout algebra (pure local reshapes over the stacked rank axis)
# ---------------------------------------------------------------------------

def _split_blocked(x: torch.Tensor, axis: int, n_chunks: int
                   ) -> list[torch.Tensor]:
    """Contiguous split of local ``axis`` into ``n_chunks`` pieces."""
    n = x.shape[axis + 1]
    if n_chunks < 1 or n % n_chunks:
        raise ValueError(f"cannot split dim {n} into n_chunks={n_chunks}")
    return list(torch.chunk(x, n_chunks, dim=axis + 1))


def _split_strided(x: torch.Tensor, axis: int, n_chunks: int, blocks: int
                   ) -> list[torch.Tensor]:
    """Strided split: view local ``axis`` as (blocks, n_chunks, piece);
    chunk *j* is every block's *j*-th piece."""
    moved = x.movedim(axis + 1, 1)
    R, n = moved.shape[:2]
    rest = tuple(moved.shape[2:])
    if n_chunks < 1 or n % (blocks * n_chunks):
        raise ValueError(f"cannot stride dim {n} over blocks={blocks} x "
                         f"n_chunks={n_chunks}")
    piece = n // (blocks * n_chunks)
    r = moved.reshape((R, blocks, n_chunks, piece) + rest)
    return [r[:, :, j].reshape((R, blocks * piece) + rest).movedim(1, axis + 1)
            for j in range(n_chunks)]


def _merge_strided(parts: list[torch.Tensor], axis: int, blocks: int
                   ) -> torch.Tensor:
    """Inverse of ``_split_strided``: part *j* holds every block's *j*-th
    piece; the merge restores block-major element order."""
    if len(parts) == 1:
        return parts[0]
    moved = [q.movedim(axis + 1, 1) for q in parts]
    R = moved[0].shape[0]
    piece = moved[0].shape[1] // blocks
    rest = tuple(moved[0].shape[2:])
    r = torch.stack([m.reshape((R, blocks, piece) + rest) for m in moved],
                    dim=2)
    return r.reshape((R, blocks * len(parts) * piece) + rest).movedim(
        1, axis + 1)


def _merge_blocked(parts: list[torch.Tensor], axis: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis + 1)


# ---------------------------------------------------------------------------
# The double-buffer reuse discipline on the card
# ---------------------------------------------------------------------------

class _ReuseFence:
    """Streams and events of one chunked loop.  ``stream("side")`` runs a
    chunk's collective on a side stream; ``handoff`` makes one stream wait
    for the other before it touches tensors the other made; ``enter(j,
    s)`` makes stream ``s`` wait until buffer ``j % 2``'s previous tenant
    was consumed, and ``exit(j, s)`` records that consumption on ``s`` —
    only when a later chunk will reuse the buffer.  Every method is a no-op
    on the CPU, where eager order already serializes the loop."""

    def __init__(self, n_chunks: int, device: torch.device):
        self.n = n_chunks
        self.free: list[Optional[torch.cuda.Event]] = [None, None]
        self.streams = None
        if device.type == "cuda":
            self.streams = {"main": torch.cuda.current_stream(device),
                            "side": torch.cuda.Stream(device=device)}

    def stream(self, on: str):
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[on])

    def handoff(self, to: str, *tensors: torch.Tensor) -> None:
        if self.streams is None:
            return
        other = "side" if to == "main" else "main"
        self.streams[to].wait_stream(self.streams[other])
        for t in tensors:
            t.record_stream(self.streams[to])

    def enter(self, j: int, on: str) -> None:
        if self.streams is not None and self.free[j % 2] is not None:
            self.streams[on].wait_event(self.free[j % 2])

    def exit(self, j: int, on: str) -> None:
        if self.streams is not None and j + 2 < self.n:
            self.free[j % 2] = self.streams[on].record_event()


def _token_after(out: torch.Tensor) -> Optional[torch.cuda.Event]:
    """An event on the current stream after ``out`` was produced (``None``
    on the CPU)."""
    if out.device.type != "cuda":
        return None
    return torch.cuda.current_stream(out.device).record_event()


# ---------------------------------------------------------------------------
# The double-buffered two-phase pipeline driver
# ---------------------------------------------------------------------------

def _node_comm(fast_axis) -> SimpleNamespace:
    """Minimal node-communicator view for a staged ``SharedWindow``."""
    return SimpleNamespace(fast_axis=fast_axis, slow_axis=None,
                           pods=None, chips=None)


def two_phase_pipeline(chunks: list[torch.Tensor], *, stage_a: Callable,
                       stage_b: Callable, fast_axis, axis: int
                       ) -> list[torch.Tensor]:
    """Run ``stage_b(stage_a(chunk))`` per chunk with double-buffered window
    epochs between the stages.  Chunk *k*'s staged buffer (``k % 2``) opens
    a dirty epoch; a fresh buffer closes by bookkeeping alone, a reused one
    with ``fence_local`` on the event recorded after chunk *k-2*'s stage b
    read it.  Both stages are device copies on one card, so they share the
    current stream; ``n_chunks == 1`` is exactly the unchunked path."""
    comm = _node_comm(fast_axis)
    n = len(chunks)
    free: list[Optional[torch.cuda.Event]] = [None, None]
    outs = []
    for k, ck in enumerate(chunks):
        b = k % 2
        win = SharedWindow(comm, stage_a(ck), axis=axis, epoch=k, dirty=True)
        win = win.fence_local(free[b] if k >= 2 else None)
        out = stage_b(win.shard)
        if k + 2 < n:                 # someone will reuse this buffer
            free[b] = _token_after(out)
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# Pipelined collective primitives
# ---------------------------------------------------------------------------

def pipelined_all_gather(x, *, fast_axis, slow_axis=None, axis: int = 0,
                         n_chunks: int = DEFAULT_CHUNKS):
    """Chunked two-phase allgather == ``hier_all_gather`` bit-for-bit."""
    chunks = _split_blocked(x, axis, n_chunks)
    ranks = p.axis_size(fast_axis) * (p.axis_size(slow_axis)
                                      if slow_axis is not None else 1)

    def stage_a(ck):
        return coll.all_gather(ck, p._axes(fast_axis), axis=axis)

    def stage_b(region):
        if slow_axis is None:
            return region
        return coll.all_gather(region, p._axes(slow_axis), axis=axis)

    outs = two_phase_pipeline(chunks, stage_a=stage_a, stage_b=stage_b,
                              fast_axis=fast_axis, axis=axis)
    return _merge_strided(outs, axis, blocks=ranks)


def pipelined_broadcast(x, *, root: int = 0, fast_axis, slow_axis=None,
                        axis: int = 0, n_chunks: int = DEFAULT_CHUNKS):
    """Chunked two-phase broadcast == ``hier_broadcast`` bit-for-bit: the
    bridge bcast between leaders (stage a), then the intra-pod fan-out."""
    root_pod, root_local = p._flat_root(root, fast_axis, slow_axis)
    fast = p._axes(fast_axis)
    me_fast = p.axis_index(fast)

    def stage_a(ck):
        if slow_axis is None:
            return p._select(me_fast == root_local, ck)
        slow = p._axes(slow_axis)
        lead = p._select((p.axis_index(slow) == root_pod)
                         & (me_fast == root_local), ck)
        return coll.psum(lead, slow)

    def stage_b(lead):
        return coll.psum(p._select(me_fast == root_local, lead), fast)

    outs = two_phase_pipeline(_split_blocked(x, axis, n_chunks),
                              stage_a=stage_a, stage_b=stage_b,
                              fast_axis=fast_axis, axis=axis)
    return _merge_blocked(outs, axis)


def pipelined_psum(x, *, fast_axis, slow_axis=None, axis: int = 0,
                   n_chunks: int = DEFAULT_CHUNKS):
    """Chunked two-phase allreduce == ``hier_psum``: intra-pod
    reduce-scatter (the window store), then bridge allreduce + gather."""
    def stage_a(ck):
        return coll.psum_scatter(ck, p._axes(fast_axis),
                                 scatter_dimension=axis)

    def stage_b(shard):
        if slow_axis is not None:
            shard = coll.psum(shard, p._axes(slow_axis))
        return coll.all_gather(shard, p._axes(fast_axis), axis=axis)

    outs = two_phase_pipeline(_split_blocked(x, axis, n_chunks),
                              stage_a=stage_a, stage_b=stage_b,
                              fast_axis=fast_axis, axis=axis)
    return _merge_blocked(outs, axis)


def pipelined_reduce_scatter(x, *, fast_axis, slow_axis=None, axis: int = 0,
                             n_chunks: int = DEFAULT_CHUNKS):
    """Chunked two-phase reduce-scatter: rank *r* ends with the same flat
    1/R slice as ``naive_reduce_scatter`` (the two-phase sum reassociates
    the adds: equal within float rounding, not bitwise)."""
    ranks = p.axis_size(fast_axis) * (p.axis_size(slow_axis)
                                      if slow_axis is not None else 1)
    chunks = _split_strided(x, axis, n_chunks, blocks=ranks)

    def stage_a(ck):
        if slow_axis is None:
            return ck
        return coll.psum_scatter(ck, p._axes(slow_axis),
                                 scatter_dimension=axis)

    def stage_b(pod_slice):
        return coll.psum_scatter(pod_slice, p._axes(fast_axis),
                                 scatter_dimension=axis)

    outs = two_phase_pipeline(chunks, stage_a=stage_a, stage_b=stage_b,
                              fast_axis=fast_axis, axis=axis)
    return _merge_blocked(outs, axis)


# ---------------------------------------------------------------------------
# Fused collective-matmul (compute overlap)
# ---------------------------------------------------------------------------

def _batched(mm: Callable) -> Callable:
    """Per-rank product over the stacked rank axis: ``a`` (R, ..., K) @
    ``b`` (R, K, N) with any leading per-rank dims of ``a`` folded into
    rows — one batched call for all R ranks."""
    def run(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        lead = tuple(a.shape[1:-1])
        out = mm(a.reshape(a.shape[0], -1, a.shape[-1]), b)
        return out.reshape((a.shape[0],) + lead + (b.shape[-1],))
    return run


def _resolve_mm(use_kernel: bool) -> Callable:
    return _batched(ops.matmul if use_kernel else torch.matmul)


def ag_matmul(x, w_shard, *, fast_axis, n_chunks: int = DEFAULT_CHUNKS,
              use_kernel: bool = False):
    """``x @ all_gather(w_shard, axis=0)`` — the FSDP window read fused into
    the matmul.  ``w_shard`` (R, K/c, N) is each rank's shard of the weight
    along the contraction dim; each chunk gathers a strided K-panel and
    accumulates its partial product in fp32.  ``use_kernel=True`` routes
    the panels through the Hopper kernel."""
    mm = _resolve_mm(use_kernel)
    c = p.axis_size(fast_axis)
    R, s, n_out = w_shard.shape
    if s % n_chunks:
        raise ValueError(f"weight shard rows {s} must divide by "
                         f"n_chunks={n_chunks}")
    if x.shape[-1] != c * s:
        raise ValueError(f"x contraction dim {x.shape[-1]} != gathered "
                         f"weight rows {c * s}")
    piece = s // n_chunks
    lead = tuple(x.shape[:-1])
    xr = x.reshape(lead + (c, n_chunks, piece))
    fence = _ReuseFence(n_chunks, x.device)
    fence.handoff("side", w_shard)
    acc = torch.zeros(lead + (n_out,), dtype=torch.float32, device=x.device)
    for j in range(n_chunks):
        fence.enter(j, "side")
        with fence.stream("side"):
            panel = coll.all_gather(w_shard[:, j * piece:(j + 1) * piece],
                                    p._axes(fast_axis), axis=0)
        fence.handoff("main", panel)
        xj = xr[..., :, j, :].reshape(lead + (c * piece,))
        acc += mm(xj, panel).float()
        fence.exit(j, "main")
    return acc.to(x.dtype)


def ag_matmul_rows(a_shard, b, *, fast_axis, n_chunks: int = DEFAULT_CHUNKS,
                   use_kernel: bool = False):
    """``all_gather(a_shard, axis=0) @ b`` — the row-panel flavor (the SUMMA
    A-panel window): chunks produce disjoint row panels, no accumulation;
    the strided merge restores rank-major row order."""
    mm = _resolve_mm(use_kernel)
    c = p.axis_size(fast_axis)
    rows = a_shard.shape[1]
    if rows % n_chunks:
        raise ValueError(f"shard rows {rows} must divide by "
                         f"n_chunks={n_chunks}")
    piece = rows // n_chunks
    fence = _ReuseFence(n_chunks, a_shard.device)
    fence.handoff("side", a_shard)
    outs = []
    for j in range(n_chunks):
        fence.enter(j, "side")
        with fence.stream("side"):
            panel = coll.all_gather(a_shard[:, j * piece:(j + 1) * piece],
                                    p._axes(fast_axis), axis=0)
        fence.handoff("main", panel)
        outs.append(mm(panel, b))
        fence.exit(j, "main")
    return _merge_strided(outs, 0, blocks=c)


def matmul_rs(x, w, *, axis_name, scatter_dim: int = 0,
              n_chunks: int = DEFAULT_CHUNKS, use_kernel: bool = False):
    """``reduce_scatter(x @ w)`` over ``axis_name`` along local
    ``scatter_dim`` — the partial-sum store fused into the matmul: the
    scatter of panel *k* overlaps the matmul of panel *k+1*."""
    mm = _resolve_mm(use_kernel)
    n = p.axis_size(axis_name)
    chunks = _split_strided(x, scatter_dim, n_chunks, blocks=n)
    fence = _ReuseFence(n_chunks, x.device)
    outs = []
    for j, xc in enumerate(chunks):
        fence.enter(j, "main")
        prod = mm(xc, w)
        fence.handoff("side", prod)
        with fence.stream("side"):
            outs.append(coll.psum_scatter(prod, p._axes(axis_name),
                                          scatter_dimension=scatter_dim))
        fence.exit(j, "side")
    fence.handoff("main", *outs)
    return _merge_blocked(outs, scatter_dim)
