"""Carry state between the reference's arrays and the port's tensors.

The reference package hands values across as numpy arrays: a rank-major
``(R*m, ...)`` array is what its ``VirtualCluster.run`` takes and returns,
and a ``SharedWindow``'s shards come back the same way (rank-major concat
of every rank's local shard).  These helpers lay such an array out as the
port's stacked ``(R, m, ...)`` tensor on a chosen device, and back.
bfloat16 arrays cross as their 16-bit patterns; they come back as float32
(numpy has no bfloat16 of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.window import SharedWindow
from repro_torch.substrate import VirtualCluster


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr)          # a writable copy the tensor may own
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_stacked(arr, vc) -> torch.Tensor:
    """Rank-major ``(R*m, ...)`` array -> stacked ``(R, m, ...)`` tensor on
    the cluster's device."""
    return vc.stack(_tensor(arr).to(vc.device))


def from_stacked(t: torch.Tensor) -> np.ndarray:
    """Stacked ``(R, m, ...)`` tensor -> rank-major ``(R*m, ...)`` array."""
    flat = VirtualCluster.unstack(t)
    if flat.dtype == torch.bfloat16:
        flat = flat.float()
    return flat.detach().cpu().numpy()


def window_from_shards(shards, comm, vc, *, axis: int = 0, epoch: int = 0,
                       dirty: bool = False) -> SharedWindow:
    """The reference window's rank-major shards -> the port's window."""
    return SharedWindow(comm, to_stacked(shards, vc), axis=axis, epoch=epoch,
                        dirty=dirty)


def window_to_shards(win: SharedWindow) -> tuple[np.ndarray, dict]:
    """The port's window -> rank-major shards plus its epoch state (the
    reference window's ``shard`` leaf and aux data)."""
    return from_stacked(win.shard), {"axis": win.axis, "epoch": win.epoch,
                                     "dirty": win.dirty}
