"""Communicator: the two-tier communicator as a first-class object.

The paper's setup is ``MPI_Comm_split_type(COMM_TYPE_SHARED)``: the world
communicator splits into a *node* communicator (ranks sharing memory — the
fast tier) and a *bridge* communicator (one leader per node — the slow
tier).  ``Communicator`` carries exactly that structure over the stacked
cluster's mesh axes:

* ``fast_axis`` — intra-pod tier; one name or a tuple;
* ``slow_axis`` — cross-pod tier, ``None`` on a single node;
* static ``pods``/``chips`` counts when known (rank maps, plan algebra);
* collective methods that dispatch through the scheme registry.

``scheme="auto"`` (the default) resolves per call through
``repro_torch.comm.tuning``.  Schemes differ in result CLASS (replicated
tensor vs ``SharedWindow``), so call sites that can consume only one class
pass ``result="replicated"`` / ``result="shared"`` — a constraint on the
pick, never a scheme name.  ``allgatherv`` always returns raw
``(blocks, counts)``.

All methods take stacked ``(R, ...)`` tensors and run inside
``VirtualCluster.run`` / ``VirtualCluster.bind``, which bind the axis names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch.comm import primitives as p
from repro_torch.comm import registry
from repro_torch.comm.window import SharedWindow
from repro_torch.core.plans import NodeMap
from repro_torch.substrate import collectives as coll

Axis = Union[str, Sequence[str]]


def _norm(ax: Optional[Axis]):
    if ax is None:
        return None
    if isinstance(ax, (tuple, list)):
        ax = tuple(ax)
        if not ax:
            return None
        return ax if len(ax) > 1 else ax[0]
    return ax


@dataclasses.dataclass(frozen=True)
class Communicator:
    """Two-tier communicator over mesh axis names, with optional static
    ``pods``/``chips`` counts (``from_cluster``/``from_topology`` fill
    them in)."""

    fast_axis: Axis
    slow_axis: Optional[Axis] = None
    pods: Optional[int] = None
    chips: Optional[int] = None

    def __post_init__(self):
        fast = _norm(self.fast_axis)
        if fast is None:
            raise ValueError("Communicator needs a fast_axis (the node tier)")
        object.__setattr__(self, "fast_axis", fast)
        object.__setattr__(self, "slow_axis", _norm(self.slow_axis))

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_cluster(cls, vc) -> "Communicator":
        """From a ``VirtualCluster`` (its ``slow`` is already ``None`` for
        single-node shapes)."""
        return cls(fast_axis=vc.fast, slow_axis=vc.slow, pods=vc.pods,
                   chips=vc.chips)

    @classmethod
    def from_topology(cls, topo) -> "Communicator":
        """From a ``MeshTopology``: fast tier = every non-slow axis, slow
        tier = the pod axes present."""
        slow = tuple(a for a in topo.slow_axes if a in topo.axis_sizes)
        return cls(fast_axis=topo.fast_axes, slow_axis=slow or None,
                   pods=topo.num_pods, chips=topo.chips_per_pod)

    # -- structure -----------------------------------------------------------
    @property
    def axes(self) -> tuple[str, ...]:
        """Every mesh axis this communicator spans, slow tier first."""
        return p._world(self.fast_axis, self.slow_axis)

    @property
    def num_nodes(self) -> Optional[int]:
        return self.pods

    @property
    def ranks_per_node(self) -> Optional[int]:
        return self.chips

    @property
    def num_ranks(self) -> Optional[int]:
        if self.pods is None or self.chips is None:
            return None
        return self.pods * self.chips

    @property
    def signature(self) -> Optional[str]:
        if self.pods is None or self.chips is None:
            return None
        from repro_torch.comm import tuning
        return tuning.signature_for(self)

    @property
    def node_map(self) -> NodeMap:
        """SMP rank->node assignment (``core.plans`` algebra)."""
        if self.pods is None or self.chips is None:
            raise ValueError("node_map needs static pods/chips counts")
        return NodeMap.smp(self.pods, self.chips)

    def split_type_shared(self) -> "Communicator":
        """The node communicator of ``MPI_Comm_split_type(COMM_TYPE_SHARED)``:
        same fast tier, no bridge."""
        return Communicator(fast_axis=self.fast_axis, slow_axis=None,
                            pods=1, chips=self.chips)

    def bridge(self) -> "Communicator":
        """The leaders' bridge communicator: the slow tier as a flat
        single-tier communicator (multi-leader: every chip joins its own
        shard's bridge exchange)."""
        if self.slow_axis is None:
            raise ValueError("single-node communicator has no bridge tier")
        return Communicator(fast_axis=self.slow_axis, slow_axis=None,
                            pods=1, chips=self.pods)

    # -- indices over the rank axis -------------------------------------------
    def rank(self) -> torch.Tensor:
        """(R,) flat SMP rank, (pod, chip) row-major — the broadcast root
        numbering."""
        return p.axis_index(self.axes)

    def local_rank(self) -> torch.Tensor:
        return p.axis_index(self.fast_axis)

    def node_rank(self) -> torch.Tensor:
        if self.slow_axis is None:
            return torch.zeros_like(self.local_rank())
        return p.axis_index(self.slow_axis)

    # -- dispatch ------------------------------------------------------------
    def _auto_elems(self, family: str, x: torch.Tensor) -> int:
        """Per-rank payload elems (alltoall: per PAIR — the local buffer
        holds one chunk per rank)."""
        n = x[0].numel()
        if family == "alltoall" and self.num_ranks:
            n = max(1, n // self.num_ranks)
        return n

    def _resolve(self, family: str, scheme: str, x: torch.Tensor,
                 opts: dict, result: Optional[str]) -> tuple[str, dict]:
        """Turn ``scheme="auto"`` into a concrete registry entry (plus its
        modeled tunables; explicit caller opts win).  A concrete scheme
        passes through, still checked against ``result``."""
        if scheme != "auto":
            sch = registry.get_scheme(scheme)
            if result is not None and sch.result_class != result:
                raise ValueError(
                    f"scheme {scheme!r} is {sch.result_class}-class but "
                    f"the call requires result={result!r}")
            return scheme, opts
        from repro_torch.comm import tuning
        res = tuning.resolve_for(self, family,
                                 elems=self._auto_elems(family, x),
                                 elem_bytes=x.element_size(),
                                 result_class=result)
        return res.scheme, {**res.opts, **opts}

    def _call(self, family: str, scheme: str, *args, **kw):
        sch = registry.get_scheme(scheme)
        return sch, sch.op(family)(*args, fast=self.fast_axis,
                                   slow=self.slow_axis, **kw)

    def _wrap(self, sch, out, axis: int):
        if sch.result_class == "shared":
            return SharedWindow(self, out, axis=axis, epoch=1)
        return out

    def allgather(self, x, *, scheme: str = "auto", axis: int = 0,
                  result: Optional[str] = None, **opts):
        """Gather every rank's contribution.  Replicated schemes return the
        full rank-ordered buffer per rank; ``shared`` returns the node's
        ``SharedWindow`` (chip *i* holds shard *i*, (local, pod) order)."""
        scheme, opts = self._resolve("allgather", scheme, x, opts, result)
        sch, out = self._call("allgather", scheme, x, axis=axis, **opts)
        return self._wrap(sch, out, axis)

    def allgatherv(self, x_padded, valid, *, scheme: str = "auto",
                   axis: int = 0, result: Optional[str] = None, **opts):
        """Irregular allgather (padded blocks + valid counts); returns raw
        ``(blocks, counts)`` for every scheme (the two result classes still
        differ in block layout)."""
        scheme, opts = self._resolve("allgatherv", scheme, x_padded, opts,
                                     result)
        _, out = self._call("allgatherv", scheme, x_padded, valid, axis=axis,
                            **opts)
        return out

    def broadcast(self, x, *, root: int = 0, scheme: str = "auto",
                  axis: int = 0, result: Optional[str] = None, **opts):
        """Broadcast from the flat SMP rank ``root`` (pod, chip row-major).
        ``shared`` returns the node's ``SharedWindow`` of the message."""
        scheme, opts = self._resolve("broadcast", scheme, x, opts, result)
        sch, out = self._call("broadcast", scheme, x, root=root, axis=axis,
                              **opts)
        return self._wrap(sch, out, axis)

    def allreduce(self, x, *, scheme: str = "auto", axis: int = 0,
                  result: Optional[str] = None, **opts):
        """Global sum: the full sum per rank, or once per node as a
        ``SharedWindow`` (``shared``)."""
        scheme, opts = self._resolve("psum", scheme, x, opts, result)
        sch, out = self._call("psum", scheme, x, axis=axis, **opts)
        return self._wrap(sch, out, axis)

    def reduce_scatter(self, x, *, scheme: str = "auto", axis: int = 0,
                       result: Optional[str] = None, **opts):
        """Sum + scatter: ``naive``/``pipelined`` give every rank its flat
        1/R slice; ``shared`` the node's window shards (1/c each)."""
        scheme, opts = self._resolve("reduce_scatter", scheme, x, opts,
                                     result)
        sch, out = self._call("reduce_scatter", scheme, x, axis=axis, **opts)
        return self._wrap(sch, out, axis)

    def alltoall(self, x, *, scheme: str = "auto", axis: int = 0,
                 result: Optional[str] = None, **opts):
        """Personalized exchange: chunk *s* of the local buffer goes to rank
        *s*.  ``hier`` routes node superchunks over the bridge once."""
        scheme, opts = self._resolve("alltoall", scheme, x, opts, result)
        _, out = self._call("alltoall", scheme, x, axis=axis, **opts)
        return out

    # -- fused collective-matmul (compute overlap) ----------------------------
    def ag_matmul(self, x, w_shard, *, n_chunks: int = 2,
                  use_kernel: bool = False):
        """``x @ read(window)`` fused: the node-tier gather of the
        contraction-sharded weight streams behind the panel matmuls."""
        from repro_torch.comm import pipeline
        return pipeline.ag_matmul(x, w_shard, fast_axis=self.fast_axis,
                                  n_chunks=n_chunks, use_kernel=use_kernel)

    def ag_matmul_rows(self, a_shard, b, *, n_chunks: int = 2,
                       use_kernel: bool = False):
        """``read(window) @ b`` fused, window sharded along OUTPUT rows
        (the SUMMA A-panel)."""
        from repro_torch.comm import pipeline
        return pipeline.ag_matmul_rows(a_shard, b, fast_axis=self.fast_axis,
                                       n_chunks=n_chunks,
                                       use_kernel=use_kernel)

    def matmul_rs(self, x, w, *, axis: int = 0, n_chunks: int = 2,
                  use_kernel: bool = False):
        """``reduce_scatter(x @ w)`` over the fast tier, fused."""
        from repro_torch.comm import pipeline
        return pipeline.matmul_rs(x, w, axis_name=self.fast_axis,
                                  scatter_dim=axis, n_chunks=n_chunks,
                                  use_kernel=use_kernel)

    # -- windows & sync -------------------------------------------------------
    def window(self, shard, *, axis: int = 0, epoch: int = 0) -> SharedWindow:
        """Wrap an existing node-sharded buffer as a ``SharedWindow``."""
        return SharedWindow(self, shard, axis=axis, epoch=epoch)

    def barrier(self, token):
        """Heavy-weight world barrier over both tiers."""
        from repro_torch.core import sync
        return sync.barrier(token, self.axes)

    def bridge_psum(self, x):
        """The multi-leader bridge: psum over the slow tier only (identity
        on a single node)."""
        if self.slow_axis is None:
            return x
        return coll.psum(x, p._axes(self.slow_axis))
