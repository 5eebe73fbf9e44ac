"""Mesh topology: axis roles of the two-tier cluster.

The paper's two-tier cluster (shared-memory node / network) maps onto named
mesh axes:

* fast tier ("node")  -> intra-pod axes (``data``, ``model``)
* slow tier (network) -> cross-pod axis (``pod``)

``MeshTopology`` is a lightweight description with no tensor state, so the
plan algebra in ``plans.py`` can be tested without touching a device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Axis names/sizes plus the fast/slow tier split.

    ``axis_sizes`` is ordered as the mesh is ordered.  Axes listed in
    ``slow_axes`` cross the network between nodes; all others are the
    node's shared memory.
    """

    axis_sizes: Mapping[str, int]
    slow_axes: Sequence[str] = (POD_AXIS,)

    def __post_init__(self):
        for ax, sz in self.axis_sizes.items():
            if sz < 1:
                raise ValueError(f"axis {ax!r} has non-positive size {sz}")

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes.values())

    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    @property
    def num_pods(self) -> int:
        return math.prod(self.axis_sizes[a] for a in self.slow_axes
                         if a in self.axis_sizes) or 1

    @property
    def chips_per_pod(self) -> int:
        return self.num_devices // self.num_pods

    @property
    def fast_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axis_sizes if a not in self.slow_axes)

    @property
    def has_pod_axis(self) -> bool:
        return any(a in self.axis_sizes for a in self.slow_axes)

    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.axis_sizes)


def single_pod(data: int = 16, model: int = 16) -> MeshTopology:
    return MeshTopology({DATA_AXIS: data, MODEL_AXIS: model})


def multi_pod(pods: int = 2, data: int = 16, model: int = 16) -> MeshTopology:
    return MeshTopology({POD_AXIS: pods, DATA_AXIS: data, MODEL_AXIS: model})
