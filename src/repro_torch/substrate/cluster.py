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

``smap(body, in_specs, out_specs)`` is the general form, the reference's
``shard_map`` over the cluster's mesh: each spec is a ``P`` — the port's own
partition spec, one entry per dim: ``None``, a mesh axis name or a tuple of
names — or a tree of them matching the arguments.  ``layout`` hands every
rank the block of a global tensor that ``shard_map`` would (a dim split
over the linearized index of its axes, replicated over the axes the spec
does not name); ``unlayout`` puts a stacked result back together, taking
member 0 of every axis the spec does not name, as ``shard_map`` does for an
unmapped output.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re
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

    def coord(self, rank: int, axes: Axis) -> int:
        """Rank ``rank``'s linearized index over ``axes`` (host int)."""
        idx = 0
        for d in self._dims(axes):
            stride = math.prod(self.shape[d + 1:])
            idx = idx * self.shape[d] + (rank // stride) % self.shape[d]
        return idx

    def _blocks(self, shape: tuple[int, ...], spec: "P") -> list:
        """Per rank: the slices of a global ``shape`` it holds under
        ``spec``."""
        if len(spec) > len(shape):
            raise ValueError(f"spec {spec} has more entries than the "
                             f"{len(shape)}-d value it lays out")
        out = []
        for r in range(self.num_ranks):
            sl = []
            for d, n in enumerate(shape):
                axes = names_of(spec[d]) if d < len(spec) else ()
                k = self.size(axes)
                if n % k:
                    raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                     f"split over {axes} ({k} ranks)")
                c = self.coord(r, axes)
                sl.append(slice(c * (n // k), (c + 1) * (n // k)))
            out.append(tuple(sl))
        return out

    def layout(self, x, spec: "P") -> torch.Tensor:
        """Global tensor -> stacked ``(R, *local)``: rank *r* gets its
        block under ``spec`` (a copy per rank, on the mesh's device).  A
        host tensor moves to the device whole first, so the per-rank
        blocks are device copies, not strided host-to-device ones."""
        x = torch.as_tensor(x, device=self.device)
        blocks = self._blocks(tuple(x.shape), spec)
        local = tuple(s.stop - s.start for s in blocks[0])
        out = torch.empty((self.num_ranks,) + local, dtype=x.dtype,
                          device=self.device)
        for r, sl in enumerate(blocks):
            out[r].copy_(x[sl])
        return out

    def unlayout(self, t: torch.Tensor, spec: "P") -> torch.Tensor:
        """Stacked ``(R, *local)`` -> the global tensor ``spec`` describes;
        over the axes ``spec`` does not name, member 0's block is taken."""
        named = {a for e in spec for a in names_of(e)}
        free = tuple(a for a in self.names if a not in named)
        shape = list(t.shape[1:])
        for d, e in enumerate(spec):
            shape[d] *= self.size(names_of(e))
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        for r, sl in enumerate(self._blocks(tuple(shape), spec)):
            if all(self.coord(r, a) == 0 for a in free):
                out[sl] = t[r]
        return out

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


class P(tuple):
    """A partition spec: one entry per dim — ``None`` (not split), a mesh
    axis name, or a tuple of names (split over their linearized index,
    row-major in the order given).  Trailing dims may be left out."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _spec_map(fn, tree, spec):
    """``fn(leaf, P)`` over ``tree``; ``spec`` is a ``P`` (applied to every
    leaf below it) or a dict / tuple / list of specs matching ``tree``."""
    if isinstance(spec, P):
        if isinstance(tree, dict):
            return {k: _spec_map(fn, v, spec) for k, v in tree.items()}
        return fn(tree, spec)
    if isinstance(spec, dict):
        return {k: _spec_map(fn, tree[k], spec[k]) for k in spec}
    if isinstance(spec, (tuple, list)):
        if len(spec) != len(tree):
            raise ValueError(f"{len(spec)} specs for {len(tree)} values")
        return type(tree)(_spec_map(fn, t, s) for t, s in zip(tree, spec))
    raise TypeError(f"not a partition spec: {spec!r}")


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

    @classmethod
    def from_label(cls, label: str, device: Union[str, torch.device] = "cuda"
                   ) -> "VirtualCluster":
        """The cluster a ``label`` names, for one slow axis: ``2x4`` (axes
        ``pod`` / ``data``), ``2x(2x2)`` (the fast tier factored over
        ``dp`` / ``tp``, the production layout) or the full
        ``2x(2x2)-pod.dp.tp`` with the axis names."""
        m = re.fullmatch(r"(\d+)x(?:(\d+)|\((\d+(?:x\d+)+)\))(?:-([\w.]+))?",
                         label.strip())
        if not m:
            raise ValueError(f"bad topology label {label!r} (PODSxCHIPS, "
                             "PODSx(DPxTP) or ...-pod.dp.tp)")
        pods = int(m.group(1))
        fshape = (int(m.group(2)),) if m.group(2) else tuple(
            int(x) for x in m.group(3).split("x"))
        if m.group(4):
            names = tuple(m.group(4).split("."))
            slow, fast = (names[:1], names[1:]) if pods > 1 else ((), names)
        elif len(fshape) == 1:
            slow, fast = ("pod",), ("data",)
        elif len(fshape) == 2:
            slow, fast = ("pod",), ("dp", "tp")
        else:
            raise ValueError(f"label {label!r}: name the axes of a fast tier "
                             f"factored {len(fshape)} ways")
        if len(fast) != len(fshape) or len(slow) > 1:
            raise ValueError(f"label {label!r}: axis names do not match the "
                             f"shape")
        return cls(pods=pods, chips=math.prod(fshape),
                   fast_axis=fast if len(fast) > 1 else fast[0],
                   slow_axis=slow[0] if slow else "pod",
                   fast_shape=fshape, device=device)

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

    def layout(self, tree, specs):
        """A tree of global tensors -> stacked ``(R, *local)`` tensors under
        a matching tree of ``P`` specs."""
        mesh = self.mesh
        return _spec_map(mesh.layout, tree, specs)

    def unlayout(self, tree, specs):
        """Inverse of ``layout`` (member 0 over unnamed axes)."""
        mesh = self.mesh
        return _spec_map(mesh.unlayout, tree, specs)

    def smap(self, body, in_specs, out_specs):
        """The reference's ``shard_map`` over this cluster's mesh: the
        returned function lays its global arguments out under
        ``in_specs``, runs ``body`` on the stacked tensors with the mesh
        bound, and puts the outputs back together under ``out_specs``."""
        def mapped(*args):
            stacked = self.layout(tuple(args), tuple(in_specs))
            with self.bind():
                out = body(*stacked)
            return self.unlayout(out, out_specs)
        return mapped

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
