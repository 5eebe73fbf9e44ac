"""One-copy-per-node parameter store (the MPI-3 shared window analogue).

The reference's ``repro/core/shared_buffer.py``.  The window semantics live
in ``repro_torch.comm.window`` (``SharedWindow`` and the FSDP-style
``window_gather`` / ``window_scatter``); this module keeps the host-side
layout helpers (choosing shard dims, slicing for init and checkpoint) and
the two device-side calls, which go over the stacked rank axis: a tensor
that is logically replicated across a node is physically sharded over the
node's ranks and gathered at use (``fsdp_gather``, the load); the store is
a reduce-scatter (``fsdp_scatter``), which is also the load's gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm.window import window_gather, window_scatter


def choose_shard_dim(shape: tuple[int, ...], n: int,
                     skip_dims: tuple[int, ...] = ()) -> Optional[int]:
    """The dim to shard a tensor over ``n`` ranks: the largest dim divisible
    by ``n`` (ties -> earliest), skipping ``skip_dims``.  None -> keep it
    replicated."""
    best, best_size = None, 0
    for d, s in enumerate(shape):
        if d in skip_dims or s % n != 0:
            continue
        if s > best_size:
            best, best_size = d, s
    return best


def shard_slice(x, idx: int, n: int, dim: Optional[int]):
    """Host-side: shard ``idx`` of ``n`` along ``dim`` (None -> as-is)."""
    if dim is None:
        return x
    size = x.shape[dim] // n
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(idx * size, (idx + 1) * size)
    return x[tuple(sl)]


def fsdp_gather(x: torch.Tensor, dim: Optional[int], fast_axis
                ) -> torch.Tensor:
    """Load from the node-shared window: the stacked ``(R, *shard)`` shards
    gathered along local ``dim`` within each node; its gradient is the
    node's reduce-scatter (the store)."""
    return window_gather(x, dim, fast_axis)


def fsdp_scatter(x: torch.Tensor, dim: Optional[int], fast_axis
                 ) -> torch.Tensor:
    """Explicit store: reduce-scatter partial contributions back to
    shards."""
    return window_scatter(x, dim, fast_axis)
