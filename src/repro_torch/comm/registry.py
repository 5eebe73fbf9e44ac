"""Collective scheme registry: every scheme is ONE self-describing entry.

A ``CollectiveScheme`` bundles what the rest of the port needs to know about
one collective strategy:

* ``ops``          — the implementation per family (``primitives`` /
                     ``pipeline`` functions behind a uniform keyword
                     signature);
* ``result_class`` — ``"replicated"`` (a private full result per rank) or
                     ``"shared"`` (ONE copy per node, sharded over the fast
                     tier — the paper's MPI-3 shared window);
* ``traffic``      — the closed-form ``core.plans`` traffic model;
* ``links``        — expected per-rank link bytes of the scheme's known
                     collective sequence (ring model — what
                     ``analysis.traffic`` prices the substrate's record with);
* ``result_node``  — expected resident result bytes on one node;
* ``tiling`` / ``candidates`` — the sizes and tunables a cell admits;
* ``predicted_time`` — the cold-start input of ``scheme="auto"``.

``Communicator`` methods dispatch through ``get_scheme``: registering a
scheme is the only step needed to make it callable and checked.
"""

from __future__ import annotations

from types import MappingProxyType
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.comm import pipeline as pipe
from repro_torch.comm import primitives as p
from repro_torch.core.plans import (CollectiveTraffic, allgather_traffic,
                                    allgatherv_traffic, allreduce_traffic,
                                    alltoall_traffic, best_chunk_count,
                                    broadcast_traffic, collective_time_model,
                                    pipelined_time_model,
                                    reduce_scatter_traffic)

CNT_BYTES = 4  # int32 valid-count payload of the irregular allgatherv


# ---------------------------------------------------------------------------
# Ring-model per-rank link costs
# ---------------------------------------------------------------------------

def _ag(out_bytes: float, n: int) -> float:
    return out_bytes * (n - 1) / n if n > 1 else 0.0


def _rs(out_bytes: float, n: int) -> float:
    return out_bytes * (n - 1) if n > 1 else 0.0


def _ar(msg_bytes: float, n: int) -> float:
    return 2.0 * msg_bytes * (n - 1) / n if n > 1 else 0.0


def _a2a(buf_bytes: float, n: int) -> float:
    return buf_bytes * (n - 1) / n if n > 1 else 0.0


class CollectiveScheme:
    """One registered collective strategy.  Subclass + ``register_scheme``
    is the complete recipe for adding a scheme."""

    name: str = ""
    result_class: str = "replicated"        # "replicated" | "shared"
    ops: Mapping[str, Callable] = MappingProxyType({})

    # -- dispatch ------------------------------------------------------------
    def supports(self, family: str) -> bool:
        return family in self.ops

    def op(self, family: str) -> Callable:
        if family not in self.ops:
            have = [s.name for s in schemes_for(family)]
            raise NotImplementedError(
                f"scheme {self.name!r} does not implement {family!r}; "
                f"schemes supporting it: {have or 'none registered'}")
        return self.ops[family]

    # -- plans.py traffic model ----------------------------------------------
    @property
    def _plans_scheme(self) -> str:
        # plans.py spells the two result classes "naive" (replicated) and
        # "hier" (one shared copy per node).
        return "naive" if self.result_class == "replicated" else "hier"

    # All-to-all results are rank-private, so the naive/hier distinction
    # there is wire-schedule only (flat vs node-aware).
    _alltoall_plans_scheme = "naive"

    def traffic(self, family: str, *, pods: int, chips: int, elems: int,
                elem_bytes: int = 4,
                populations: Optional[Sequence[int]] = None
                ) -> CollectiveTraffic:
        m = elems * elem_bytes
        kw = dict(num_nodes=pods, ranks_per_node=chips)
        if family == "allgather":
            return allgather_traffic(scheme=self._plans_scheme,
                                     bytes_per_rank=m, **kw)
        if family == "allgatherv":
            return allgatherv_traffic(scheme=self._plans_scheme,
                                      populations=populations,
                                      bytes_per_rank=m)
        if family == "broadcast":
            return broadcast_traffic(scheme=self._plans_scheme, msg_bytes=m,
                                     **kw)
        if family == "psum":
            return allreduce_traffic(scheme=self._plans_scheme, msg_bytes=m,
                                     **kw)
        if family == "reduce_scatter":
            return reduce_scatter_traffic(scheme=self._plans_scheme,
                                          msg_bytes=m, **kw)
        if family == "alltoall":
            return alltoall_traffic(scheme=self._alltoall_plans_scheme,
                                    bytes_per_pair=m, **kw)
        raise ValueError(f"no traffic model for family {family!r}")

    # -- expected collective sequence (overridden per scheme) ----------------
    def links(self, family: str, *, pods: int, chips: int,
              fast_shape: tuple[int, ...], elems: int, elem_bytes: int = 4
              ) -> tuple[float, float]:
        """Expected (fast, slow) per-rank link bytes of this scheme's
        collective sequence for one config."""
        raise NotImplementedError

    def result_node(self, family: str, *, pods: int, chips: int, elems: int,
                    elem_bytes: int = 4) -> int:
        """Expected resident result bytes on ONE node: replicated schemes
        keep ranks_per_node copies, shared one."""
        R, m = pods * chips, elems * elem_bytes
        if family == "allgather":
            n = R * m
            return chips * n if self.result_class == "replicated" else n
        if family in ("broadcast", "psum"):
            return chips * m if self.result_class == "replicated" else m
        if family == "reduce_scatter":
            # the flat scheme keeps its 1/R slice per rank (m/num_nodes per
            # node); the shared window keeps the node's full m
            return m // pods if self.result_class == "replicated" else m
        if family == "alltoall":
            return chips * R * m          # rank-private in every scheme
        if family == "allgatherv":
            per_rank = m + CNT_BYTES      # padded block + its int32 count
            blocks = R if self.result_class == "replicated" else pods
            return chips * blocks * per_rank
        raise ValueError(f"unknown family {family!r}")

    # -- tunables ------------------------------------------------------------
    def candidates(self, family: str, *, pods: int, chips: int, elems: int
                   ) -> tuple[dict, ...]:
        """Tunable-kwarg grid for one config; EMPTY when the scheme cannot
        run the (family, topology, size) cell at all."""
        if not self.supports(family):
            return ()
        if elems % self.tiling(family, pods=pods, chips=chips):
            return ()
        return ({},)

    def tiling(self, family: str, *, pods: int, chips: int) -> int:
        """Divisor ``elems`` must tile by for this scheme (1 = any)."""
        return 1

    # -- model-predicted latency (cold-start for scheme="auto") --------------
    def predicted_time(self, family: str, *, pods: int, chips: int,
                       elems: int, elem_bytes: int = 4,
                       populations: Optional[Sequence[int]] = None
                       ) -> Optional[tuple[float, dict]]:
        """Closed-form latency of one config plus the tunables it assumes;
        ``None`` when the scheme cannot run the cell."""
        if not self.candidates(family, pods=pods, chips=chips, elems=elems):
            return None
        if family == "allgatherv" and populations is None:
            populations = (chips,) * pods    # regular cold-start assumption
        tr = self.traffic(family, pods=pods, chips=chips, elems=elems,
                          elem_bytes=elem_bytes, populations=populations)
        return collective_time_model(tr, num_nodes=pods,
                                     ranks_per_node=chips), {}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, CollectiveScheme] = {}


def register_scheme(scheme: CollectiveScheme) -> CollectiveScheme:
    if not scheme.name:
        raise ValueError("scheme needs a name")
    _REGISTRY[scheme.name] = scheme
    return scheme


def get_scheme(name: str) -> CollectiveScheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown collective scheme {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def scheme_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def schemes_for(family: str) -> tuple[CollectiveScheme, ...]:
    return tuple(s for s in _REGISTRY.values() if s.supports(family))


# ---------------------------------------------------------------------------
# The schemes of the paper's comparison
# ---------------------------------------------------------------------------

class NaiveScheme(CollectiveScheme):
    """Pure-MPI analogue: one flat phase, private full result per rank."""

    name = "naive"
    result_class = "replicated"
    ops = MappingProxyType({
        "allgather": lambda x, *, fast, slow, axis=0, **_:
            p.naive_all_gather(x, fast_axis=fast, slow_axis=slow, axis=axis),
        "broadcast": lambda x, *, fast, slow, root=0, axis=0, **_:
            p.naive_broadcast(x, root=root, fast_axis=fast, slow_axis=slow),
        "psum": lambda x, *, fast, slow, axis=0, **_:
            p.naive_psum(x, fast_axis=fast, slow_axis=slow),
        "reduce_scatter": lambda x, *, fast, slow, axis=0, **_:
            p.naive_reduce_scatter(x, fast_axis=fast, slow_axis=slow,
                                   axis=axis),
        "alltoall": lambda x, *, fast, slow, axis=0, **_:
            p.naive_all_to_all(x, fast_axis=fast, slow_axis=slow, axis=axis),
        "allgatherv": lambda x, valid, *, fast, slow, axis=0, **_:
            (p.naive_all_gather(x, fast_axis=fast, slow_axis=slow, axis=axis),
             p.naive_all_gather(valid, fast_axis=fast, slow_axis=slow,
                                axis=axis)),
    })

    def tiling(self, family, *, pods, chips):
        return pods * chips if family == "reduce_scatter" else 1

    def links(self, family, *, pods, chips, fast_shape, elems,
              elem_bytes=4):
        Pn, c = pods, chips
        R, m = Pn * c, elems * elem_bytes
        n = R if Pn > 1 else c
        if family == "allgather":
            link = _ag(R * m, n)
        elif family in ("broadcast", "psum"):
            link = _ar(m, n)
        elif family == "reduce_scatter":
            link = _rs(m / n, n)
        elif family == "alltoall":
            link = _a2a(R * m, n)
        elif family == "allgatherv":
            link = _ag(R * m, n) + _ag(R * CNT_BYTES, n)
        else:
            raise ValueError(f"unknown family {family!r}")
        # the flat group spans pods whenever there is more than one
        return (0.0, link) if Pn > 1 else (link, 0.0)


class HierScheme(CollectiveScheme):
    """Two-phase (intra-pod, then bridge) schedule; result still fully
    replicated — isolates the latency effect of the hierarchical schedule."""

    name = "hier"
    result_class = "replicated"
    _alltoall_plans_scheme = "hier"     # node-aware wire schedule
    ops = MappingProxyType({
        "allgather": lambda x, *, fast, slow, axis=0, **_:
            p.hier_all_gather(x, fast_axis=fast, slow_axis=slow, axis=axis),
        "broadcast": lambda x, *, fast, slow, root=0, axis=0, **_:
            p.hier_broadcast(x, root=root, fast_axis=fast, slow_axis=slow),
        "psum": lambda x, *, fast, slow, axis=0, **_:
            p.hier_psum(x, fast_axis=fast, slow_axis=slow, axis=axis),
        "alltoall": lambda x, *, fast, slow, axis=0, **_:
            p.hier_all_to_all(x, fast_axis=fast, slow_axis=slow, axis=axis),
    })

    def tiling(self, family, *, pods, chips):
        return chips if family == "psum" else 1   # intra-pod psum_scatter

    def links(self, family, *, pods, chips, fast_shape, elems,
              elem_bytes=4):
        Pn, c = pods, chips
        R, m = Pn * c, elems * elem_bytes
        if family == "allgather":
            return _ag(c * m, c), _ag(R * m, Pn)
        if family == "broadcast":
            return _ar(m, c), _ar(m, Pn)
        if family == "psum":
            return _rs(m / c, c) + _ag(m, c), _ar(m / c, Pn)
        if family == "alltoall":
            buf = R * m
            fast = buf * sum((n - 1) / n for n in fast_shape if n > 1)
            return fast, _a2a(buf, Pn)
        raise ValueError(f"unknown family {family!r}")


class SharedScheme(CollectiveScheme):
    """The paper's memory-optimal scheme: ONE result copy per node, sharded
    over the fast tier (the MPI-3 shared window)."""

    name = "shared"
    result_class = "shared"
    ops = MappingProxyType({
        "allgather": lambda x, *, fast, slow, axis=0, **_:
            p.shared_all_gather(x, fast_axis=fast, slow_axis=slow, axis=axis),
        "broadcast": lambda x, *, fast, slow, root=0, axis=0, **_:
            p.shared_broadcast(x, root=root, fast_axis=fast, slow_axis=slow,
                               axis=axis),
        "psum": lambda x, *, fast, slow, axis=0, **_:
            p.shared_psum_scatter(x, fast_axis=fast, slow_axis=slow,
                                  axis=axis),
        "reduce_scatter": lambda x, *, fast, slow, axis=0, **_:
            p.shared_psum_scatter(x, fast_axis=fast, slow_axis=slow,
                                  axis=axis),
        "allgatherv": lambda x, valid, *, fast, slow, axis=0, **_:
            p.shared_all_gather_v(x, valid, slow_axis=slow, axis=axis),
    })

    def tiling(self, family, *, pods, chips):
        if family in ("broadcast", "psum", "reduce_scatter"):
            return chips                  # window shards: 1/c of the message
        return 1

    def links(self, family, *, pods, chips, fast_shape, elems,
              elem_bytes=4):
        Pn, c = pods, chips
        m = elems * elem_bytes
        if family == "allgather":
            return 0.0, _ag(Pn * m, Pn)
        if family in ("broadcast", "psum", "reduce_scatter"):
            return _rs(m / c, c), _ar(m / c, Pn)
        if family == "allgatherv":
            return 0.0, _ag(Pn * m, Pn) + _ag(Pn * CNT_BYTES, Pn)
        raise ValueError(f"unknown family {family!r}")


class PipelinedScheme(HierScheme):
    """Chunked two-phase schedule (``repro_torch.comm.pipeline``): the
    message is split into ``n_chunks`` segments staged through
    double-buffered window epochs.  Results equal ``hier`` (``reduce_scatter``:
    the flat ``naive`` slices within rounding) and the total link bytes are
    exactly the unchunked closed forms, for every ``n_chunks``."""

    name = "pipelined"
    result_class = "replicated"
    n_chunk_candidates = (1, 2, 4, 8)
    ops = MappingProxyType({
        "allgather": lambda x, *, fast, slow, axis=0, n_chunks=2, **_:
            pipe.pipelined_all_gather(x, fast_axis=fast, slow_axis=slow,
                                      axis=axis, n_chunks=n_chunks),
        "broadcast": lambda x, *, fast, slow, root=0, axis=0, n_chunks=2,
                            **_:
            pipe.pipelined_broadcast(x, root=root, fast_axis=fast,
                                     slow_axis=slow, axis=axis,
                                     n_chunks=n_chunks),
        "psum": lambda x, *, fast, slow, axis=0, n_chunks=2, **_:
            pipe.pipelined_psum(x, fast_axis=fast, slow_axis=slow,
                                axis=axis, n_chunks=n_chunks),
        "reduce_scatter": lambda x, *, fast, slow, axis=0, n_chunks=2, **_:
            pipe.pipelined_reduce_scatter(x, fast_axis=fast, slow_axis=slow,
                                          axis=axis, n_chunks=n_chunks),
    })

    def tiling(self, family, *, pods, chips):
        if family == "psum":
            return chips                  # per-chunk intra-pod psum_scatter
        if family == "reduce_scatter":
            return pods * chips           # per-chunk flat 1/R slices
        return 1

    def candidates(self, family, *, pods, chips, elems):
        if not self.supports(family):
            return ()
        need = self.tiling(family, pods=pods, chips=chips)
        return tuple({"n_chunks": nc} for nc in self.n_chunk_candidates
                     if elems % (nc * need) == 0)

    def links(self, family, *, pods, chips, fast_shape, elems,
              elem_bytes=4):
        if family == "reduce_scatter":
            # bridge RS over pods, then intra-pod RS of the pod slice
            Pn, c = pods, chips
            m = elems * elem_bytes
            if Pn > 1:
                return _rs(m / (Pn * c), c), _rs(m / Pn, Pn)
            return _rs(m / c, c), 0.0
        return super().links(family, pods=pods, chips=chips,
                             fast_shape=fast_shape, elems=elems,
                             elem_bytes=elem_bytes)

    def predicted_time(self, family, *, pods, chips, elems, elem_bytes=4,
                       populations=None):
        """Overlap-aware prediction: ``best_chunk_count`` over the cell's
        valid ``n_chunks``, priced by ``pipelined_time_model``.  The
        per-chunk alpha makes one chunk strictly pricier than ``hier``."""
        cands = self.candidates(family, pods=pods, chips=chips, elems=elems)
        if not cands:
            return None
        tr = self.traffic(family, pods=pods, chips=chips, elems=elems,
                          elem_bytes=elem_bytes, populations=populations)
        ncs = tuple(c["n_chunks"] for c in cands)
        alpha = 1e-6
        nc = best_chunk_count(tr, num_nodes=pods, ranks_per_node=chips,
                              candidates=ncs, alpha=alpha)
        t = pipelined_time_model(tr, n_chunks=nc, num_nodes=pods,
                                 ranks_per_node=chips, alpha=alpha)
        return t, {"n_chunks": nc}


NAIVE = register_scheme(NaiveScheme())
HIER = register_scheme(HierScheme())
SHARED = register_scheme(SharedScheme())
PIPELINED = register_scheme(PipelinedScheme())
