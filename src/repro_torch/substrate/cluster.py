"""VirtualCluster: a single-process two-tier cluster on one device.

The paper's two-tier cluster (shared-memory nodes joined by a network) is
laid out on ONE device:

* slow tier — ``pods`` (the network / MPI bridge communicator);
* fast tier — ``chips`` per pod (the shared-memory node).

Every per-rank value is one tensor with a leading *rank axis* of extent
``pods * chips`` in (pod, chip) order.  A collective is device work over
that axis (``repro_torch.substrate.collectives``): it regroups the rank axis
by the named mesh axes it spans, exactly as ``shard_map`` collectives group
devices by mesh axis.  On one card a node's shared window is literally one
allocation that the node's ranks read.

Axis handling: ``fast_axis`` / ``slow_axis`` may each be one name or a tuple
of names (with per-name sizes in ``fast_shape`` / ``slow_shape``).  A
single-pod cluster has no bridge tier at all (``slow is None``).

``run(body, *rank_major_inputs)`` splits dim 0 of each input into
``(R, m, ...)``, binds the mesh (so collectives inside ``body`` can resolve
axis names), calls ``body`` on the stacked tensors and concatenates the rank
axis back — the inputs and outputs mean what the reference's
``VirtualCluster.run`` gives with its default rank-sharded specs.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch

Axis = Union[str, Sequence[str]]


def names_of(ax: Optional[Axis]) -> tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the rank axis: ``names`` in mesh order (slow tier
    outer, fast tier inner), their ``shape``, which names are slow, and the
    device the stacked tensors live on."""

    names: tuple[str, ...]
    shape: tuple[int, ...]
    slow_names: tuple[str, ...]
    device: torch.device

    @property
    def num_ranks(self) -> int:
        return math.prod(self.shape)

    def _dims(self, axes: Axis) -> list[int]:
        out = []
        for a in names_of(axes):
            if a not in self.names:
                raise ValueError(f"unknown mesh axis {a!r}; mesh axes are "
                                 f"{self.names}")
            out.append(self.names.index(a))
        return out

    def size(self, axes: Axis) -> int:
        return math.prod(self.shape[d] for d in self._dims(axes))

    def crosses_pods(self, axes: Axis) -> bool:
        """True when a group over ``axes`` spans more than one pod."""
        return any(a in self.slow_names and self.size(a) > 1
                   for a in names_of(axes))

    def index(self, axes: Axis) -> torch.Tensor:
        """(R,) int64: each rank's linearized index over ``axes``
        (row-major in the order given)."""
        r = torch.arange(self.num_ranks, device=self.device)
        idx = torch.zeros_like(r)
        for d in self._dims(axes):
            stride = math.prod(self.shape[d + 1:])
            idx = idx * self.shape[d] + (r // stride) % self.shape[d]
        return idx

    def _order(self, axes: Axis) -> tuple[list[int], list[int]]:
        idx = self._dims(axes)
        rest = [d for d in range(len(self.names)) if d not in idx]
        return rest, idx

    def to_groups(self, x: torch.Tensor, axes: Axis) -> torch.Tensor:
        """(R, *local) -> (G, n, *local): one row per group over ``axes``,
        members in their linearized ``axes`` order."""
        if x.shape[0] != self.num_ranks:
            raise ValueError(f"rank axis has extent {x.shape[0]}, the mesh "
                             f"has {self.num_ranks} ranks")
        rest, idx = self._order(axes)
        k, local = len(self.names), tuple(x.shape[1:])
        y = x.reshape(self.shape + local).permute(
            rest + idx + list(range(k, k + len(local))))
        n = math.prod(self.shape[d] for d in idx)
        return y.reshape((-1, n) + local)

    def from_groups(self, y: torch.Tensor, axes: Axis) -> torch.Tensor:
        """Inverse of ``to_groups``: (G, n, *local) -> (R, *local)."""
        rest, idx = self._order(axes)
        order = rest + idx
        k, local = len(self.names), tuple(y.shape[2:])
        z = y.reshape(tuple(self.shape[d] for d in order) + local)
        inv = [order.index(d) for d in range(k)]
        z = z.permute(inv + list(range(k, k + len(local))))
        return z.reshape((self.num_ranks,) + local)


_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def active_mesh() -> Mesh:
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("collective called outside VirtualCluster.run / "
                           "VirtualCluster.bind: no mesh axes are bound")
    return mesh


@contextlib.contextmanager
def bind_mesh(mesh: Mesh) -> Iterator[Mesh]:
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


@dataclasses.dataclass(frozen=True)
class VirtualCluster:
    """One point of the topology matrix: ``pods`` nodes x ``chips`` per
    node, stacked on ``device``.

    ``fast_axis``/``slow_axis`` name the mesh axes of each tier; a tuple of
    names splits that tier over several mesh axes whose sizes are given by
    ``fast_shape``/``slow_shape`` (products must equal ``chips``/``pods``).
    """

    pods: int = 2
    chips: int = 4
    fast_axis: Axis = "data"
    slow_axis: Optional[Axis] = "pod"
    fast_shape: Optional[tuple[int, ...]] = None
    slow_shape: Optional[tuple[int, ...]] = None
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        if self.pods < 1 or self.chips < 1:
            raise ValueError(f"bad shape {self.pods}x{self.chips}")
        fast = names_of(self.fast_axis)
        slow = names_of(self.slow_axis)
        if not fast:
            raise ValueError("fast_axis is required")
        if self.pods > 1 and not slow:
            raise ValueError("multi-pod cluster needs a slow_axis")
        fshape = self.fast_shape if self.fast_shape is not None \
            else (self.chips,)
        sshape = self.slow_shape if self.slow_shape is not None \
            else (self.pods,)
        if len(fshape) != len(fast) or math.prod(fshape) != self.chips:
            raise ValueError(f"fast_shape {fshape} does not factor "
                             f"chips={self.chips} over axes {fast}")
        if len(sshape) != len(slow) or math.prod(sshape) != self.pods:
            raise ValueError(f"slow_shape {sshape} does not factor "
                             f"pods={self.pods} over axes {slow}")
        if set(fast) & set(slow):
            raise ValueError("fast and slow axis names must be disjoint")
        object.__setattr__(self, "fast_axis", fast if len(fast) > 1
                           else fast[0])
        object.__setattr__(self, "slow_axis", (slow if len(slow) > 1
                                               else slow[0]) if slow else None)
        object.__setattr__(self, "fast_shape", tuple(fshape))
        object.__setattr__(self, "slow_shape", tuple(sshape))
        object.__setattr__(self, "device", torch.device(self.device))

    # -- shape ---------------------------------------------------------------
    @property
    def num_devices(self) -> int:
        """Ranks of the cluster (the rank axis extent)."""
        return self.pods * self.chips

    @property
    def fast(self) -> Axis:
        return self.fast_axis

    @property
    def slow(self) -> Optional[Axis]:
        """Slow-tier axis arg; ``None`` on a single node (pods == 1)."""
        return self.slow_axis if self.pods > 1 else None

    @property
    def fast_names(self) -> tuple[str, ...]:
        return names_of(self.fast_axis)

    @property
    def slow_names(self) -> tuple[str, ...]:
        return names_of(self.slow) if self.pods > 1 else ()

    @property
    def axis_names(self) -> tuple[str, ...]:
        """Mesh axis order: slow (outer) then fast (inner) — rank order is
        (pod, chip), the SMP placement of the paper."""
        return self.slow_names + self.fast_names

    @property
    def axis_shapes(self) -> tuple[int, ...]:
        return (self.slow_shape if self.pods > 1 else ()) + self.fast_shape

    @property
    def label(self) -> str:
        """Stable test id, e.g. ``2x4``, ``1x8``, ``2x(2x2)-pod.dp.tp``."""
        def side(shape):
            s = "x".join(str(d) for d in shape)
            return f"({s})" if len(shape) > 1 else s
        base = f"{side(self.slow_shape)}x{side(self.fast_shape)}"
        if len(self.fast_names) > 1 or len(self.slow_names) > 1:
            base += "-" + ".".join(self.axis_names)
        return base

    @property
    def mesh(self) -> Mesh:
        return Mesh(self.axis_names, self.axis_shapes, self.slow_names,
                    self.device)

    # -- elastic shrink / grow ----------------------------------------------
    def with_pods(self, pods: int) -> "VirtualCluster":
        """This cluster re-shaped to ``pods`` nodes (same chips per node).
        Failure is node-granular in the two-tier layout, so a resize changes
        the slow-tier extent only; a factored slow tier is rejected."""
        if pods < 1:
            raise ValueError(f"cannot shrink below one node (pods={pods})")
        if len(self.slow_names) > 1:
            raise ValueError(
                f"cannot resize a factored slow tier {self.slow_names}: "
                "no single pod extent to rewrite")
        if pods > 1 and not names_of(self.slow_axis):
            raise ValueError("single-node cluster has no slow axis to grow "
                             "over — build a multi-pod VirtualCluster")
        return dataclasses.replace(
            self, pods=pods,
            slow_shape=(pods,) if names_of(self.slow_axis) else None)

    def without_pod(self, pod: int = -1) -> "VirtualCluster":
        """The surviving cluster after losing node ``pod`` (survivors
        renumber densely, as ranks do after ``MPI_Comm_split``)."""
        if self.pods == 1:
            raise ValueError("cannot lose the last node: no survivors to "
                             "rebuild a cluster from")
        if not -self.pods <= pod < self.pods:
            raise ValueError(f"pod {pod} out of range for {self.pods} nodes")
        return self.with_pods(self.pods - 1)

    # -- execution -----------------------------------------------------------
    def bind(self):
        """Context manager binding this cluster's mesh axes, for callers
        that build stacked ``(R, ...)`` tensors themselves."""
        return bind_mesh(self.mesh)

    def stack(self, x) -> torch.Tensor:
        """Rank-major ``(R*m, ...)`` -> stacked ``(R, m, ...)`` on the
        cluster's device."""
        t = torch.as_tensor(x, device=self.device)
        R = self.num_devices
        if t.dim() == 0 or t.shape[0] % R:
            raise ValueError(f"leading dim {tuple(t.shape)[:1]} does not "
                             f"split over {R} ranks")
        return t.reshape((R, t.shape[0] // R) + tuple(t.shape[1:]))

    @staticmethod
    def unstack(t: torch.Tensor) -> torch.Tensor:
        """Stacked ``(R, m, ...)`` -> rank-major ``(R*m, ...)``; a stacked
        per-rank scalar ``(R,)`` stays ``(R,)``."""
        if t.dim() < 2:
            return t
        return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))

    def run(self, body, *args):
        """One-shot: split rank-major inputs, run the body over the stacked
        rank axis, concatenate its outputs back to rank-major."""
        stacked = [self.stack(a) for a in args]
        with self.bind():
            out = body(*stacked)
        if isinstance(out, (tuple, list)):
            return type(out)(self.unstack(o) for o in out)
        return self.unstack(out)

    def rank_major_input(self, m: int = 6, extra: int = 3,
                         seed: int = 0) -> torch.Tensor:
        """(pods*chips*m, extra) float32, ``m`` rows per global rank — the
        reference's numbers for the same seed."""
        rng = np.random.default_rng(seed)
        return torch.as_tensor(rng.normal(
            size=(self.num_devices * m, extra)).astype(np.float32),
            device=self.device)


def default_matrix(max_devices: int = 8, device: Union[str, torch.device]
                   = "cuda") -> tuple[VirtualCluster, ...]:
    """The standard topology matrix: single node (no bridge at all), the
    2x4 shape, its transpose, one chip per pod (bridge only — the paper's
    worst case), and a tuple-axis mesh whose fast tier spans two named axes
    (the production (dp, tp) layout)."""
    matrix = (
        VirtualCluster(pods=1, chips=8, device=device),
        VirtualCluster(pods=2, chips=4, device=device),
        VirtualCluster(pods=4, chips=2, device=device),
        VirtualCluster(pods=8, chips=1, device=device),
        VirtualCluster(pods=2, chips=4, fast_axis=("dp", "tp"),
                       fast_shape=(2, 2), slow_axis="pod", device=device),
    )
    return tuple(vc for vc in matrix if vc.num_devices <= max_devices)
