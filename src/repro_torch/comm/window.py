"""SharedWindow: the MPI-3 shared-memory window as a first-class object.

In the paper, replicated data lives once per node in an
``MPI_Win_allocate_shared`` segment; on-node ranks load/store it directly,
and integrity is guarded by synchronization epochs: stores made in one
epoch become readable only after the epoch is closed.

Here the window is the pod-sharded buffer the ``shared`` scheme produces:
rank *i* of a pod holds shard *i* of the node's single copy, and on the one
device those shards are one allocation.  ``SharedWindow`` wraps the stacked
shards ``(R, *shard)`` together with its communicator and an epoch counter:

* ``read()``        — load the full node buffer (intra-pod gather at use);
* ``read_node()``   — for a window over ONE node's members: the node's
                      buffer once (the per-memory-domain model run);
* ``store(x)``      — replace the local shards, opening a dirty epoch;
* ``accumulate(x)`` — reduce-scatter partial contributions into the window;
* ``fence()``       — close the epoch with a node barrier (``core.sync``);
* ``fence_local(e)``— close the epoch with stream ordering only.

Reading a dirty window raises ``WindowEpochError`` — the paper's rule that
no process reads until all writers finished.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.comm import primitives as p
from repro_torch.substrate import collectives as coll


class WindowEpochError(RuntimeError):
    """A read hit an open (dirty) store epoch — call ``fence()`` first."""


@dataclasses.dataclass(frozen=True)
class SharedWindow:
    """One node-shared buffer: the stacked shards + their epoch state.

    ``comm`` is the ``Communicator`` whose fast tier is the node; ``axis``
    is the local dim the buffer is sharded over.
    """

    comm: object                      # Communicator (typed loosely: no cycle)
    shard: torch.Tensor
    axis: int = 0
    epoch: int = 0
    dirty: bool = False
    lead: int = 0                     # per-rank dims before the members

    # -- stores (open an epoch) ----------------------------------------------
    def store(self, shard: torch.Tensor) -> "SharedWindow":
        """Replace every rank's partition (a direct store into the
        segment).  The window is dirty until the next fence."""
        return dataclasses.replace(self, shard=shard, dirty=True)

    def accumulate(self, x: torch.Tensor) -> "SharedWindow":
        """Reduce partial contributions from every on-node rank into the
        window shards (intra-pod reduce-scatter — the gradient store)."""
        shard = coll.psum_scatter(x, p._axes(self.comm.fast_axis),
                                  scatter_dimension=self.axis)
        return dataclasses.replace(self, shard=shard, dirty=True)

    # -- synchronization ------------------------------------------------------
    def fence(self) -> "SharedWindow":
        """Close the current epoch (``MPI_Win_fence`` on the node comm): a
        node barrier; the shards are left exactly as stored."""
        from repro_torch.core import sync
        token = torch.ones(self.shard.shape[0], device=self.shard.device)
        sync.barrier(token, self.comm.fast_axis)
        return dataclasses.replace(self, dirty=False, epoch=self.epoch + 1)

    def fence_local(self, event: Optional[torch.cuda.Event] = None
                    ) -> "SharedWindow":
        """Close the epoch with local ordering only: the current stream
        waits for ``event`` (a CUDA event recorded after the buffer's
        previous reader; ``None`` on the CPU, where eager order already
        serializes).  Zero bytes moved, values untouched."""
        if event is not None:
            torch.cuda.current_stream(self.shard.device).wait_event(event)
        return dataclasses.replace(self, dirty=False, epoch=self.epoch + 1)

    # -- loads ---------------------------------------------------------------
    def _check_clean(self) -> None:
        if self.dirty:
            raise WindowEpochError(
                "read from a dirty SharedWindow: a store/accumulate opened "
                "an epoch that was never closed — call fence() before "
                "reading (paper §6: readers wait for all writers)")

    def read(self) -> torch.Tensor:
        """The full node buffer for every rank, in (local_rank, pod)
        element order — the load from the shared segment."""
        self._check_clean()
        return p.shared_read(self.shard, fast_axis=self.comm.fast_axis,
                             axis=self.axis)

    def read_node(self) -> torch.Tensor:
        """The node's buffer as ONE tensor, for a window whose ``shard`` is
        a single node's members ``(n, *shard)`` — what a model run once per
        memory domain reads (``models.parallel``): the members' shards
        joined along ``axis`` in member order, one copy for the node
        (behind ``lead`` leading dims: the tp ranks', one window each).
        Its gradient splits the cotangent back into the members' shards,
        the node's reduce-scatter store with the sum over the node's ranks
        already taken by the batch the run folds together."""
        self._check_clean()
        out = node_read(self.shard, self.axis, lead=self.lead)
        coll.note_window_read(out, self.shard.shape[self.lead], self.lead)
        return out

    def read_rank_order(self) -> torch.Tensor:
        """Full buffer in SMP (pod, local_rank) rank order; needs the
        communicator's static shape."""
        full = self.read()
        if self.comm.pods is None or self.comm.chips is None:
            raise ValueError("read_rank_order needs a Communicator with "
                             "static pods/chips counts")
        return p.shared_to_rank_order(full, num_pods=self.comm.pods,
                                      chips_per_pod=self.comm.chips,
                                      axis=self.axis)


# ---------------------------------------------------------------------------
# FSDP-style parameter access (the window applied along a weight dim).
# ---------------------------------------------------------------------------

def node_read(shards: torch.Tensor, axis: int, lead: int = 0
              ) -> torch.Tensor:
    """One node's members ``(*lead, n, *shard)`` joined along local
    ``axis`` of the shard (differentiable: the transpose is the split)."""
    shape = list(shards.shape[:lead]) + list(shards.shape[lead + 1:])
    shape[lead + axis] *= shards.shape[lead]
    return shards.movedim(lead, lead + axis).reshape(shape)


def window_gather(x: torch.Tensor, dim: Optional[int], fast_axis
                  ) -> torch.Tensor:
    """Load from the pod-shared parameter store: intra-pod all-gather along
    local ``dim``.  ``dim=None``: the tensor is replicated, the load is
    free."""
    if dim is None:
        return x
    return p.shared_read(x, fast_axis=fast_axis, axis=dim)


def window_scatter(x: torch.Tensor, dim: Optional[int], fast_axis
                   ) -> torch.Tensor:
    """Explicit store: reduce-scatter partial contributions back to shards
    (``dim=None``: plain psum of the replicated tensor)."""
    axes = p._axes(fast_axis)
    if dim is None:
        return coll.psum(x, axes)
    return coll.psum_scatter(x, axes, scatter_dimension=dim)
