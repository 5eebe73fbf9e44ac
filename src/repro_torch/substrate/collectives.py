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
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, Optional

import torch

from repro_torch.substrate.cluster import Axis, active_mesh


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


def _note(op: str, axes: Axis, out: torch.Tensor) -> None:
    rec = _RECORD.get()
    if rec is None:
        return
    mesh = active_mesh()
    n = mesh.size(axes)
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


def _replicate(mesh, full: torch.Tensor, n: int, axes: Axis
               ) -> torch.Tensor:
    """(G, *local) group results -> one private copy per member."""
    per_member = full.unsqueeze(1).expand((full.shape[0], n)
                                          + tuple(full.shape[1:]))
    return mesh.from_groups(per_member, axes).contiguous()


def all_gather(x: torch.Tensor, axes: Axis, *, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every member gets the members' buffers in group order: concatenated
    along local ``axis`` (``tiled``) or stacked as a new local ``axis``."""
    mesh = active_mesh()
    ax = _local(axis, x) if tiled else axis % x.dim()
    g = mesh.to_groups(x, axes)                         # (G, n, *local)
    n = g.shape[1]
    full = g.movedim(1, ax + 1)
    if tiled:
        shp = list(x.shape[1:])
        shp[ax] *= n
        full = full.reshape([g.shape[0]] + shp)
    out = _replicate(mesh, full, n, axes)
    _note("all-gather", axes, out)
    return out


def psum(x: torch.Tensor, axes: Axis) -> torch.Tensor:
    """Every member gets the group sum."""
    mesh = active_mesh()
    g = mesh.to_groups(x, axes)
    out = _replicate(mesh, g.sum(dim=1), g.shape[1], axes)
    _note("all-reduce", axes, out)
    return out


def psum_scatter(x: torch.Tensor, axes: Axis, *,
                 scatter_dimension: int = 0) -> torch.Tensor:
    """Group sum, split along local ``scatter_dimension``: member *i* gets
    piece *i* (tiled)."""
    mesh = active_mesh()
    ax = _local(scatter_dimension, x)
    g = mesh.to_groups(x, axes)
    G, n = g.shape[:2]
    local = list(x.shape[1:])
    if local[ax] % n:
        raise ValueError(f"scatter dim {local[ax]} does not tile over "
                         f"{n} ranks")
    s = g.sum(dim=1)
    pieces = s.reshape([G] + local[:ax] + [n, local[ax] // n]
                       + local[ax + 1:]).movedim(ax + 1, 1)
    out = mesh.from_groups(pieces, axes).contiguous()
    _note("reduce-scatter", axes, out)
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
