"""Carry state between the reference's arrays and the port's tensors.

The reference package hands values across as numpy arrays: a rank-major
``(R*m, ...)`` array is what its ``VirtualCluster.run`` takes and returns,
and a ``SharedWindow``'s shards come back the same way (rank-major concat
of every rank's local shard).  These helpers lay such an array out as the
port's stacked ``(R, m, ...)`` tensor on a chosen device, and back.
bfloat16 arrays cross as their 16-bit patterns; they come back as float32
(numpy has no bfloat16 of its own).  ``params_from_reference`` puts the
reference model's parameter tree onto a device as the port's;
``train_state_from_reference`` / ``train_state_to_reference`` carry a
cluster train step's state ``{"params", "m", "v", "step"}`` across, so both
packages start the same step from the same state — a ``make_train_step``
bundle's under its ``state_specs`` too, the ``frontend`` leaf of a
``vit`` / ``encodec`` model with the rest.  The 2-D decode layout's
weights come from a baseline tree through ``models.meta.decode2d_params``.
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


def params_from_reference(tree, device="cuda") -> dict:
    """The reference's ``init_params`` tree (nested dicts of arrays, units
    stacked on a leading ``n_units`` dim) as the port's tensors on
    ``device`` — the same layout, so ``repro_torch.models`` reads it as
    it is."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return _tensor(tree).to(device)


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


def train_state_from_reference(state, vc, specs) -> dict:
    """The reference's train state as its ``smap`` returns it (global
    arrays: a sharded leaf's shards joined, a replicated leaf once) -> the
    port's state laid out on ``vc`` under ``specs`` (the bundle's
    ``state_specs``): stacked ``(R, *local)`` tensors on its device — a
    tp-sharded leaf split over the tp axis as over the store axes, a
    tp-replicated one copied to every tp rank."""
    return vc.layout(params_from_reference(state, vc.device), specs)


def train_state_to_reference(state, vc, specs) -> dict:
    """Inverse of ``train_state_from_reference``: the global numpy arrays
    the reference's step takes (member 0 of every replica)."""
    def out(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    glob = vc.unlayout(state, specs)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return out(x)
    return walk(glob)
