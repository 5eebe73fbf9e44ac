"""Collective primitives for the two-tier stacked cluster.

The implementation layer of ``repro_torch.comm``: every function takes a
stacked tensor ``(R, *local)`` (one row per rank, (pod, chip) order) plus
mesh axis names, and works on the rank axis through
``repro_torch.substrate.collectives``.  ``fast_axis`` is the intra-pod tier
(the paper's shared-memory node); ``slow_axis`` is the cross-pod tier (the
network between nodes).  Each may be a single name or a tuple of names.
``axis`` arguments are local dims, as in the reference.

Callers should not use these free functions directly: construct a
``repro_torch.comm.Communicator`` and dispatch through the scheme registry.

Three families, mirroring the paper's comparison (the chunked
``pipelined`` family lives in ``repro_torch.comm.pipeline``):

* ``naive_*``   — pure-MPI analogue: single flat phase, result fully
                  replicated (one private copy per rank).
* ``hier_*``    — two-phase (intra-pod, then bridge) schedule producing the
                  same fully-replicated result.
* ``shared_*``  — the paper's memory-optimal scheme: the result exists ONCE
                  per pod, sharded over ``fast_axis`` (the shared-memory
                  window).  Readers load it with ``shared_read``.

Multi-leader refinement (paper ref [14]): chip *i* of every pod leads shard
*i*, so the bridge exchange is spread over all chips.
"""

from __future__ import annotations

import torch

from repro_torch.substrate import collectives as coll
from repro_torch.substrate.cluster import names_of


_axes = names_of


def axis_size(ax) -> int:
    return coll.axis_size(_axes(ax))


def axis_index(ax) -> torch.Tensor:
    """(R,) linearized index over a (possibly tuple) axis, row-major."""
    return coll.axis_index(_axes(ax))


def _select(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per rank: ``x`` where ``mask`` holds, zeros elsewhere."""
    keep = mask.view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _world(fast_axis, slow_axis) -> tuple:
    return (_axes(slow_axis) if slow_axis else ()) + _axes(fast_axis)


# ---------------------------------------------------------------------------
# Allgather (paper §4.1)
# ---------------------------------------------------------------------------

def naive_all_gather(x, *, fast_axis, slow_axis=None, axis: int = 0):
    """Pure-MPI analogue: one flat all-gather; full private copy per rank."""
    return coll.all_gather(x, _world(fast_axis, slow_axis), axis=axis)


def hier_all_gather(x, *, fast_axis, slow_axis=None, axis: int = 0):
    """Two-phase allgather: intra-pod gather, then bridge exchange of whole
    node regions."""
    node_region = coll.all_gather(x, _axes(fast_axis), axis=axis)
    if slow_axis is None:
        return node_region
    return coll.all_gather(node_region, _axes(slow_axis), axis=axis)


def shared_all_gather(x, *, fast_axis, slow_axis=None, axis: int = 0):
    """Paper's scheme: partitions stay in place (no intra-pod copies); only
    the bridge exchange runs.  Chip *i* ends holding shard *i* of the pod's
    single shared copy: the concatenation over pods of every pod's chip-*i*
    contribution, so the copy is in (local_rank, pod) order."""
    if slow_axis is None:
        return x  # single node: the partition already is the window
    return coll.all_gather(x, _axes(slow_axis), axis=axis)


def shared_read(shard, *, fast_axis, axis: int = 0):
    """Load the pod-shared buffer (an intra-pod gather at use time)."""
    return coll.all_gather(shard, _axes(fast_axis), axis=axis)


def shared_to_rank_order(full, *, num_pods: int, chips_per_pod: int,
                         axis: int = 0):
    """Reorder a ``shared_read`` result from (local, pod, chunk) layout to
    SMP rank order (pod, local, chunk) along local ``axis``."""
    moved = full.movedim(axis + 1, 1)
    R, n = moved.shape[:2]
    rest = tuple(moved.shape[2:])
    chunk = n // (num_pods * chips_per_pod)
    r = moved.reshape((R, chips_per_pod, num_pods, chunk) + rest)
    r = r.transpose(1, 2).reshape((R, n) + rest)
    return r.movedim(1, axis + 1)


def shared_all_gather_v(x_padded, valid, *, slow_axis=None, axis: int = 0):
    """Irregular variant (paper Figs 4/10): per-chip contributions of
    different true lengths, padded to a common max.  Returns the bridge-
    gathered padded blocks plus the gathered valid-counts; on a single node
    the gathered leading pod dim has extent 1."""
    if slow_axis is None:
        return x_padded.unsqueeze(axis + 1), valid.unsqueeze(1)
    blocks = coll.all_gather(x_padded, _axes(slow_axis), axis=axis,
                             tiled=False)
    counts = coll.all_gather(valid, _axes(slow_axis), axis=0, tiled=False)
    return blocks, counts


# ---------------------------------------------------------------------------
# Broadcast (paper §4.2)
# ---------------------------------------------------------------------------

def naive_broadcast(x, *, root: int, fast_axis, slow_axis=None):
    """Pure-MPI analogue: every rank ends with a private full copy."""
    names = _world(fast_axis, slow_axis)
    return coll.psum(_select(axis_index(names) == root, x), names)


def _flat_root(root, fast_axis, slow_axis) -> tuple[int, int]:
    """(root_pod, root_local) of a flat SMP rank in (pod, chip) order."""
    if root is None:
        root = 0
    c = axis_size(fast_axis)
    total = c * (axis_size(slow_axis) if slow_axis is not None else 1)
    if not 0 <= root < total:
        raise ValueError(f"root={root} out of range for {total} ranks")
    return root // c, root % c


def hier_broadcast(x, *, root: int | None = None, fast_axis,
                   slow_axis=None):
    """Two-phase broadcast to full replication: bridge bcast between
    leaders, then intra-pod bcast (leader -> children copies)."""
    root_pod, root_local = _flat_root(root, fast_axis, slow_axis)
    fast = _axes(fast_axis)
    me_fast = axis_index(fast)
    if slow_axis is not None:
        slow = _axes(slow_axis)
        lead = _select((axis_index(slow) == root_pod)
                       & (me_fast == root_local), x)
        lead = coll.psum(lead, slow)     # bridge bcast (only leaders nonzero)
    else:
        lead = _select(me_fast == root_local, x)
    return coll.psum(_select(me_fast == root_local, lead), fast)


def shared_broadcast(x, *, root: int | None = None, fast_axis,
                     slow_axis=None, axis: int = 0):
    """Paper's scheme: ONE shared copy per pod, sharded over ``fast_axis``.
    Phase 1 scatters the root chip's message over its pod (the write into
    the shared window); phase 2 sends shard *i* across pods once."""
    root_pod, root_local = _flat_root(root, fast_axis, slow_axis)
    fast = _axes(fast_axis)
    contrib = _select(axis_index(fast) == root_local, x)
    shard = coll.psum_scatter(contrib, fast, scatter_dimension=axis)
    if slow_axis is None:
        return shard
    slow = _axes(slow_axis)
    return coll.psum(_select(axis_index(slow) == root_pod, shard), slow)


# ---------------------------------------------------------------------------
# Allreduce / reductions
# ---------------------------------------------------------------------------

def naive_psum(x, *, fast_axis, slow_axis=None):
    """Flat allreduce; result replicated per rank."""
    return coll.psum(x, _world(fast_axis, slow_axis))


def hier_psum(x, *, fast_axis, slow_axis=None, axis: int = 0):
    """Two-phase allreduce to full replication: intra-pod reduce-scatter,
    bridge allreduce on shards (multi-leader), intra-pod allgather."""
    shard = coll.psum_scatter(x, _axes(fast_axis), scatter_dimension=axis)
    if slow_axis is not None:
        shard = coll.psum(shard, _axes(slow_axis))
    return coll.all_gather(shard, _axes(fast_axis), axis=axis)


def shared_psum_scatter(x, *, fast_axis, slow_axis=None, axis: int = 0):
    """Paper's memory-optimal reduction: the sum exists once per pod,
    sharded over ``fast_axis`` (intra-pod RS, bridge allreduce on shards)."""
    shard = coll.psum_scatter(x, _axes(fast_axis), scatter_dimension=axis)
    if slow_axis is not None:
        shard = coll.psum(shard, _axes(slow_axis))
    return shard


def naive_reduce_scatter(x, *, fast_axis, slow_axis=None, axis: int = 0):
    """Flat MPI_Reduce_scatter analogue: every rank ends with its 1/R slice
    of the global sum, rank-major (pod, chip) order."""
    return coll.psum_scatter(x, _world(fast_axis, slow_axis),
                             scatter_dimension=axis)


# ---------------------------------------------------------------------------
# All-to-all
# ---------------------------------------------------------------------------

def naive_all_to_all(x, *, fast_axis, slow_axis=None, axis: int = 0):
    """One flat all-to-all over every rank: the local buffer along ``axis``
    is R chunks in flat rank order; the result is ordered by source rank."""
    return coll.all_to_all(x, _world(fast_axis, slow_axis), axis=axis)


def hier_all_to_all(x, *, fast_axis, slow_axis=None, axis: int = 0):
    """Node-aware two-phase all-to-all (same result as the flat one): node
    superchunks cross pods once, then ranks redistribute within the node,
    one exchange per fast-tier axis."""
    fast = _axes(fast_axis)
    if slow_axis is not None:
        x = coll.all_to_all(x, _axes(slow_axis), axis=axis)
    pods = axis_size(slow_axis) if slow_axis is not None else 1
    fast_sizes = tuple(axis_size(a) for a in fast)
    chips = 1
    for s in fast_sizes:
        chips *= s
    moved = x.movedim(axis + 1, 1)
    R, n = moved.shape[:2]
    rest = tuple(moved.shape[2:])
    if n % (pods * chips):
        raise ValueError(f"all-to-all buffer dim {n} must tile over "
                         f"{pods * chips} ranks")
    chunk = n // (pods * chips)
    y = moved.reshape((R, pods) + fast_sizes + (chunk,) + rest)
    for i, a in enumerate(fast):
        if fast_sizes[i] > 1:
            y = coll.all_to_all(y, a, axis=1 + i)
    return y.reshape((R, n) + rest).movedim(1, axis + 1)
