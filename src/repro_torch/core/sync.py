"""Synchronization primitives (paper §6: heavy barrier vs light-weight flags).

The stacked cluster runs eagerly in one process: every rank's work is
enqueued on one device stream in program order, so that order stands in for
the reference's data-dependence tokens.  These helpers keep the paper's two
mechanisms explicit: each returns a per-rank value ``(R,)`` that depends on
the participants it synchronizes with.
"""

from __future__ import annotations

import torch

from repro_torch.comm.primitives import _axes, _select, axis_index
from repro_torch.substrate import collectives as coll


def barrier(token: torch.Tensor, axis) -> torch.Tensor:
    """Heavy-weight barrier: a scalar allreduce over ``axis`` (the paper's
    ``MPI_Barrier(sharedmemComm)``)."""
    return coll.psum(token, _axes(axis))  # raw-collective: the barrier


def flag_chain(token: torch.Tensor, axis) -> torch.Tensor:
    """Light-weight point-to-point flags: a ring of sends per axis, each
    process waiting only for its predecessor."""
    out = token
    for a in _axes(axis):
        n = coll.axis_size(a)
        # raw-collective: the flag primitive itself
        out = coll.ppermute(out, a, [(i, (i + 1) % n) for i in range(n)])
    return out


def leader_flag(token: torch.Tensor, *, fast_axis) -> torch.Tensor:
    """Children signal the leader (chip 0 of the pod) that their partitions
    are ready — the paper's first barrier, light-weight flavor."""
    contrib = _select(axis_index(fast_axis) != 0, token)
    # raw-collective: the barrier primitive itself
    return coll.psum(contrib, _axes(fast_axis))
