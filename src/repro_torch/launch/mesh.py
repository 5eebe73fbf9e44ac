"""Production meshes over the stacked cluster.

A ``MeshTopology`` maps onto a stacked ``VirtualCluster``
(``make_mesh_from_topo``): the slow axes are the bridge tier,
``("data", "model")`` the node factored as (store, tp), the layout
``runtime.steps.cluster_ctx`` gives a factored fast tier.  Functions only:
a cluster is a description, and nothing is allocated until a state is
laid out on it, so ``make_production_mesh``'s 256 / 512 ranks cost
nothing to build.
"""

from __future__ import annotations

import math

from repro_torch.comm import Communicator
from repro_torch.core.topology import MeshTopology, multi_pod, single_pod
from repro_torch.substrate import VirtualCluster


def communicator_for_topo(topo: MeshTopology) -> Communicator:
    """The production two-tier communicator of a topology: fast tier = the
    node's axes, slow tier = the pod axes.  Pair with
    ``make_mesh_from_topo`` so mesh and communicator agree on the tier
    split."""
    return Communicator.from_topology(topo)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh: ``(data 16, model 16)``, or ``(pod 2, data 16,
    model 16)``, as a stacked cluster on ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_from_topo(MeshTopology(dict(zip(axes, shape))),
                               device=device)


def make_mesh_from_topo(topo: MeshTopology, device="cuda"):
    """The stacked cluster of ``topo`` on ``device``: its slow axis
    (``pod``) the bridge tier, its fast axes the node in the topology's
    order.  A slow axis of size 1 leaves a single node (no bridge)."""
    slow = tuple(a for a in topo.slow_axes if a in topo.axis_sizes)
    fast = topo.fast_axes
    if len(slow) > 1:
        raise ValueError(f"one slow (bridge) axis at most, got {slow}")
    if not fast:
        raise ValueError(f"{dict(topo.axis_sizes)} has no fast (node) axis")
    fshape = tuple(topo.size(a) for a in fast)
    return VirtualCluster(
        pods=topo.num_pods, chips=math.prod(fshape),
        fast_axis=fast if len(fast) > 1 else fast[0],
        slow_axis=slow[0] if slow else "pod", fast_shape=fshape,
        device=device)


def topo_for(*, multi_pod_flag: bool) -> MeshTopology:
    return multi_pod() if multi_pod_flag else single_pod()


def small_topo(pods: int = 2, data: int = 2, model: int = 2) -> MeshTopology:
    """Test-scale topology (8 ranks by default)."""
    if pods > 1:
        return MeshTopology({"pod": pods, "data": data, "model": model})
    return MeshTopology({"data": data, "model": model})
