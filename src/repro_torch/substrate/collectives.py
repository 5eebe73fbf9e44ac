"""Collectives over the stacked rank axis (the port's ``jax.lax`` layer).

Every function takes a stacked tensor ``(R, *local)`` and mesh axis names.
It groups the rank axis by those axes (the other axes are independent
groups, as in ``shard_map``), does the exchange as device work on the
cluster's one device, and returns a NEW stacked tensor: each rank's result
is its own private buffer, so a replicated result really occupies one copy
per rank.  ``axis`` arguments are LOCAL dims (stacked dim ``axis + 1``).

The substrate records what it runs.  Inside ``recording()``, each collective
whose group has more than one member appends a ``CollectiveRecord``: the
op, the tier (``slow`` when the group spans pods), the group size, the
per-rank output payload bytes and the per-rank ring messages.  The records
are the port's counterpart of the reference's compiled-HLO collective parse;
``repro_torch.analysis.traffic`` prices them.

``all_gather``, ``psum`` and ``psum_scatter`` carry gradients with the
reference's transposes, each an explicit ``torch.autograd.Function`` whose
backward is the substrate's own collective (recorded, in the same fixed
left-to-right order): ``all_gather`` <-> ``psum_scatter``, and ``psum``
(of values replicated over its group) transposes to ``psum``, as
``lax.psum`` does under ``shard_map`` without replication checking.  The
backward runs under the mesh and the record of its forward, so it works
outside ``VirtualCluster.bind`` and on autograd's device threads;
``keep_mesh`` does the same for a function that autograd re-runs in the
backward (a rematerialised block).

Each of the three also takes ``group``: the members of every group over
``axes`` split into contiguous subgroups of that size, each exchanging
only within itself — the reference's ``axis_index_groups`` of contiguous
ranges (``ParallelCtx.group_all_gather`` / ``group_psum``).
"""


from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Iterator, Optional

import torch

from repro_torch.substrate.cluster import _MESH, Axis, active_mesh


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective as it ran: ``op`` in the reference's HLO spelling
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), ``tier`` (``fast``/``slow``), ``group`` ranks,
    ``out_bytes`` of each rank's output, ``messages`` per rank."""

    op: str
    tier: str
    group: int
    out_bytes: int
    messages: int


_RECORD: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "repro_torch_traffic", default=None)


@contextlib.contextmanager
def recording() -> Iterator[list[CollectiveRecord]]:
    """Collect a ``CollectiveRecord`` for every collective run inside."""
    rec: list[CollectiveRecord] = []
    token = _RECORD.set(rec)
    try:
        yield rec
    finally:
        _RECORD.reset(token)


@contextlib.contextmanager
def muted() -> Iterator[None]:
    """Record nothing inside: for a run that repeats, on other ranks, the
    work a record already holds per rank (a model run once per memory
    domain records its first domain's)."""
    token = _RECORD.set(None)
    try:
        yield
    finally:
        _RECORD.reset(token)


def note_window_read(out: torch.Tensor, n: int, lead: int = 0) -> None:
    """Record a read of one node's shared window (``SharedWindow.read_node``:
    its ``n`` members' shards joined into one buffer ``out``, behind
    ``lead`` leading dims of one window each) as what it stands for on a
    node of ``n`` ranks: each rank's all-gather of the full buffer and,
    once ``out``'s gradient is computed, the transpose — each rank's
    reduce-scatter of its shard.  On one card the read is a view and moves
    nothing; the record prices the read as the reference's program runs
    it."""
    rec = _RECORD.get()
    if rec is None or n <= 1:
        return
    per_rank = out.numel() // max(1, math.prod(out.shape[:lead]))
    full = per_rank * out.element_size()
    rec.append(CollectiveRecord(op="all-gather", tier="fast", group=n,
                                out_bytes=full, messages=n - 1))
    if out.requires_grad:
        store = CollectiveRecord(op="reduce-scatter", tier="fast", group=n,
                                 out_bytes=full // n, messages=n - 1)
        out.register_hook(lambda g: rec.append(store))


def _note(op: str, axes: Axis, out: torch.Tensor,
          group: Optional[int] = None) -> None:
    rec = _RECORD.get()
    if rec is None:
        return
    mesh = active_mesh()
    n = group or mesh.size(axes)
    if n <= 1:
        return
    messages = {"all-reduce": 2 * (n - 1), "collective-permute": 1}.get(
        op, n - 1)
    rec.append(CollectiveRecord(
        op=op, tier="slow" if mesh.crosses_pods(axes) else "fast", group=n,
        out_bytes=out[0].numel() * out.element_size(), messages=messages))


def _local(axis: int, x: torch.Tensor) -> int:
    nd = x.dim() - 1
    if not -nd <= axis < nd:
        raise ValueError(f"axis {axis} out of range for local rank {nd}")
    return axis % nd


def axis_size(axes: Axis) -> int:
    return active_mesh().size(axes)


def axis_index(axes: Axis) -> torch.Tensor:
    """(R,) int64: every rank's linearized index over ``axes``."""
    return active_mesh().index(axes)


def _groups(mesh, x: torch.Tensor, axes: Axis, group: Optional[int]
            ) -> torch.Tensor:
    """(R, *local) -> (G, n, *local) over ``axes``; with ``group``, every
    group's members split into contiguous subgroups of that size (rows of
    ``group`` members)."""
    g = mesh.to_groups(x, axes)
    if group is None:
        return g
    n = g.shape[1]
    if group < 1 or n % group:
        raise ValueError(f"subgroups of {group} do not tile a group of {n}")
    return g.reshape((-1, group) + tuple(g.shape[2:]))


def _ungroup(mesh, y: torch.Tensor, axes: Axis) -> torch.Tensor:
    """Inverse of ``_groups``: (rows, members, *local) -> (R, *local)."""
    n = mesh.size(axes)
    return mesh.from_groups(y.reshape((-1, n) + tuple(y.shape[2:])), axes)


def _replicate(mesh, full: torch.Tensor, n: int, axes: Axis
               ) -> torch.Tensor:
    """(G, *local) group results -> one private copy per member of each
    group of ``n``."""
    per_member = full.unsqueeze(1).expand((full.shape[0], n)
                                          + tuple(full.shape[1:]))
    return _ungroup(mesh, per_member, axes).contiguous()


def _all_gather(x: torch.Tensor, axes: Axis, axis: int, tiled: bool,
                group: Optional[int] = None) -> torch.Tensor:
    mesh = active_mesh()
    ax = _local(axis, x) if tiled else axis % x.dim()
    g = _groups(mesh, x, axes, group)                   # (G, n, *local)
    n = g.shape[1]
    full = g.movedim(1, ax + 1)
    if tiled:
        shp = list(x.shape[1:])
        shp[ax] *= n
        full = full.reshape([g.shape[0]] + shp)
    out = _replicate(mesh, full, n, axes)
    _note("all-gather", axes, out, group)
    return out


def _group_sum(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(G, n, *local) -> (G, *local): the members added left to right, in
    ``dtype`` (half-width floats accumulate in f32 and round once, as
    ``torch.sum`` does).  A fixed order for every shape: ``sum(dim=1)``
    picks its order by shape, so a packed buffer would not reduce bit for
    bit like its leaves."""
    acc_dtype = torch.float32 if dtype in (torch.float16, torch.bfloat16) \
        else dtype
    acc = g[:, 0].to(acc_dtype, copy=True)
    for i in range(1, g.shape[1]):
        acc.add_(g[:, i])
    return acc.to(dtype)


def _psum(x: torch.Tensor, axes: Axis, group: Optional[int] = None
          ) -> torch.Tensor:
    mesh = active_mesh()
    g = _groups(mesh, x, axes, group)
    out = _replicate(mesh, _group_sum(g, x.dtype), g.shape[1], axes)
    _note("all-reduce", axes, out, group)
    return out


class _Replay:
    """The mesh (``None`` where none is bound) and traffic record a
    collective or a rematerialised block ran under, restored around its
    backward (which autograd may run on another thread)."""

    def __init__(self):
        self.mesh, self.rec = _MESH.get(), _RECORD.get()

    def __enter__(self):
        self._tokens = (_MESH.set(self.mesh), _RECORD.set(self.rec))

    def __exit__(self, *exc):
        _MESH.reset(self._tokens[0])
        _RECORD.reset(self._tokens[1])


def keep_mesh(fn):
    """``fn`` that always runs under the mesh and traffic record bound when
    ``keep_mesh`` was called: for a function with collectives inside that
    autograd re-runs in the backward (``torch.utils.checkpoint``), which may
    be on another thread."""
    replay = _Replay()

    def run(*args, **kwargs):
        with replay:
            return fn(*args, **kwargs)
    return run


class _AllGatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, axis, tiled, group):
        ctx.replay, ctx.axes, ctx.tiled = _Replay(), axes, tiled
        ctx.group = group
        # the gathered local dim (untiled: the new one)
        ctx.axis = _local(axis, x) if tiled else axis % x.dim()
        return _all_gather(x, axes, axis, tiled, group)

    @staticmethod
    def backward(ctx, g):
        with ctx.replay:
            piece = _psum_scatter(g.contiguous(), ctx.axes, ctx.axis,
                                  ctx.group)
            if not ctx.tiled:
                piece = piece.squeeze(ctx.axis + 1)
            return piece, None, None, None, None


class _PsumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, group):
        ctx.replay, ctx.axes, ctx.group = _Replay(), axes, group
        return _psum(x, axes, group)

    @staticmethod
    def backward(ctx, g):
        with ctx.replay:
            return _psum(g.contiguous(), ctx.axes, ctx.group), None, None


class _PsumScatterFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, group):
        ctx.replay, ctx.axes, ctx.dim = _Replay(), axes, dim
        ctx.group = group
        return _psum_scatter(x, axes, dim, group)

    @staticmethod
    def backward(ctx, g):
        with ctx.replay:
            return _all_gather(g.contiguous(), ctx.axes, ctx.dim, True,
                               ctx.group), None, None, None


def _tracks_grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def all_gather(x: torch.Tensor, axes: Axis, *, axis: int = 0,
               tiled: bool = True, group: Optional[int] = None
               ) -> torch.Tensor:
    """Every member gets the members' buffers in group order: concatenated
    along local ``axis`` (``tiled``) or stacked as a new local ``axis``.
    Gradient: ``psum_scatter`` of the cotangent along that axis."""
    if _tracks_grad(x):
        return _AllGatherFn.apply(x, axes, axis, tiled, group)
    return _all_gather(x, axes, axis, tiled, group)


def psum(x: torch.Tensor, axes: Axis, *, group: Optional[int] = None
         ) -> torch.Tensor:
    """Every member gets the group sum, in ``x``'s dtype (an int16 payload
    stays int16 on the wire, as ``lax.psum`` keeps it).  Gradient: ``psum``
    of the cotangent."""
    if _tracks_grad(x):
        return _PsumFn.apply(x, axes, group)
    return _psum(x, axes, group)


def psum_scatter(x: torch.Tensor, axes: Axis, *,
                 scatter_dimension: int = 0, group: Optional[int] = None
                 ) -> torch.Tensor:
    """Group sum, split along local ``scatter_dimension``: member *i* gets
    piece *i* (tiled).  Gradient: ``all_gather`` of the cotangent."""
    if _tracks_grad(x):
        return _PsumScatterFn.apply(x, axes, scatter_dimension, group)
    return _psum_scatter(x, axes, scatter_dimension, group)


def pmax(x: torch.Tensor, axes: Axis) -> torch.Tensor:
    """Every member gets the group's elementwise maximum."""
    mesh = active_mesh()
    g = mesh.to_groups(x, axes)
    out = _replicate(mesh, g.amax(dim=1), g.shape[1], axes)
    _note("all-reduce", axes, out)
    return out


def _psum_scatter(x: torch.Tensor, axes: Axis, scatter_dimension: int,
                  group: Optional[int] = None) -> torch.Tensor:
    mesh = active_mesh()
    ax = _local(scatter_dimension, x)
    g = _groups(mesh, x, axes, group)
    G, n = g.shape[:2]
    local = list(x.shape[1:])
    if local[ax] % n:
        raise ValueError(f"scatter dim {local[ax]} does not tile over "
                         f"{n} ranks")
    s = _group_sum(g, x.dtype)
    pieces = s.reshape([G] + local[:ax] + [n, local[ax] // n]
                       + local[ax + 1:]).movedim(ax + 1, 1)
    out = _ungroup(mesh, pieces, axes).contiguous()
    _note("reduce-scatter", axes, out, group)
    return out


def all_to_all(x: torch.Tensor, axes: Axis, *, axis: int = 0) -> torch.Tensor:
    """Personalized exchange along local ``axis``: the buffer is n equal
    chunks, chunk *j* goes to member *j*, and the result is ordered by
    source member.  (A dim of extent n with chunk 1 is the reference's
    untiled form with equal split and concat axes.)"""
    mesh = active_mesh()
    ax = _local(axis, x)
    g = mesh.to_groups(x, axes)
    G, n = g.shape[:2]
    local = list(x.shape[1:])
    if local[ax] % n:
        raise ValueError(f"all-to-all dim {local[ax]} must tile over "
                         f"{n} ranks")
    y = g.reshape([G, n] + local[:ax] + [n, local[ax] // n] + local[ax + 1:])
    y = y.transpose(1, ax + 2).reshape([G, n] + local)
    out = mesh.from_groups(y, axes).contiguous()
    _note("all-to-all", axes, out)
    return out


def dynamic_update_slice_in_dim(x: torch.Tensor, update: torch.Tensor,
                                start: torch.Tensor, *, axis: int
                                ) -> torch.Tensor:
    """Per rank *r*: a copy of ``x[r]`` with ``update[r]`` written along local
    ``axis`` from ``start[r]`` on (``lax.dynamic_update_slice_in_dim`` with a
    start that differs by rank).  A start past the end is clamped so the
    update fits, as in the reference."""
    ax = _local(axis, x)
    size, n = update.shape[ax + 1], x.shape[ax + 1]
    first = start.to(device=x.device, dtype=torch.long).clamp(0, n - size)
    idx = first[:, None] + torch.arange(size, device=x.device)
    out = x.movedim(ax + 1, 1).clone()
    ranks = torch.arange(x.shape[0], device=x.device)[:, None]
    out[ranks, idx] = update.movedim(ax + 1, 1).to(x.dtype)
    return out.movedim(1, ax + 1).contiguous()


def ppermute(x: torch.Tensor, axes: Axis, perm) -> torch.Tensor:
    """Member ``dst`` receives member ``src``'s buffer for every
    ``(src, dst)`` pair; members that receive nothing get zeros."""
    mesh = active_mesh()
    g = mesh.to_groups(x, axes)
    out_g = torch.zeros_like(g)
    for src, dst in perm:
        out_g[:, dst] = g[:, src]
    out = mesh.from_groups(out_g, axes).contiguous()
    _note("collective-permute", axes, out)
    return out
