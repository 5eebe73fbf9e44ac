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
* ``predicted_time`` — the cold-start input of ``scheme="auto"``;
* ``precision``    — ``"exact"``, or ``"lossy"`` for the quantized wire
                     formats (``q8_hier``, ``qbf16_hier``, ``q4_shared``),
                     which declare their error model (``error_bound_rel``,
                     ``error_check``) and are reached only under
                     ``precision="lossy"``.

``Communicator`` methods dispatch through ``get_scheme``: registering a
scheme is the only step needed to make it callable and checked.
"""

from __future__ import annotations

from types import MappingProxyType
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.comm import pipeline as pipe
from repro_torch.comm import primitives as p
from repro_torch.comm import quantize as qz
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
    precision: str = "exact"                # "exact" | "lossy"
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
              fast_shape: tuple[int, ...], elems: int, elem_bytes: int = 4,
              opts: Optional[dict] = None, dtype: str = "float32"
              ) -> tuple[float, float]:
        """Expected (fast, slow) per-rank link bytes of this scheme's
        collective sequence for one config.  ``opts`` is the candidate's
        tunable dict (a quantized scheme's block size changes its scales
        bytes); ``dtype`` is the logical payload dtype.  Exact schemes
        ignore both."""
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

    def min_payload_dims(self, family: str) -> int:
        """Dims a rank's payload needs: 1, as the scheme splits or joins it
        along ``axis``; 0 for one that also takes a per-rank scalar."""
        return 1

    def bucketable(self, family: str) -> bool:
        """True when packing several same-axes / same-dtype operands into
        one flat buffer and running this scheme once over it equals running
        it once per operand — the contract the step-graph optimizer's
        bucketing pass rewrites under.  Holds for a replicated exact
        ``psum``; a shared result is a window over the *packed* layout, and
        packing moves a lossy scheme's block boundaries."""
        return family == "psum" and self.result_class == "replicated" \
            and self.supports(family) and self.precision == "exact"

    # -- error model (lossy schemes only) ------------------------------------
    def error_bound_rel(self, family: str, *, pods: int) -> float:
        """Worst-case quantization error relative to the payload's per-block
        amax — what a per-call ``tol=`` is compared against.  Exact: 0."""
        return 0.0

    def error_check(self, family: str, *, inputs, output, pods: int,
                    chips: int, elems: int, dtype: str = "float32",
                    opts: Optional[dict] = None
                    ) -> Optional[tuple[float, float]]:
        """Host-side error model of one run: given the global input arrays
        and the global output, ``(bound, measured_abs_err)``; ``None`` for
        an exact scheme or an unmodeled family."""
        return None

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

    def min_payload_dims(self, family):
        return 0 if family == "psum" else 1     # the flat sum takes a scalar

    def tiling(self, family, *, pods, chips):
        return pods * chips if family == "reduce_scatter" else 1

    def links(self, family, *, pods, chips, fast_shape, elems,
              elem_bytes=4, opts=None, dtype="float32"):
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
              elem_bytes=4, opts=None, dtype="float32"):
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
              elem_bytes=4, opts=None, dtype="float32"):
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
              elem_bytes=4, opts=None, dtype="float32"):
        if family == "reduce_scatter":
            # bridge RS over pods, then intra-pod RS of the pod slice
            Pn, c = pods, chips
            m = elems * elem_bytes
            if Pn > 1:
                return _rs(m / (Pn * c), c), _rs(m / Pn, Pn)
            return _rs(m / c, c), 0.0
        return super().links(family, pods=pods, chips=chips,
                             fast_shape=fast_shape, elems=elems,
                             elem_bytes=elem_bytes, dtype=dtype)

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


# ---------------------------------------------------------------------------
# Quantized wire-format schemes (lossy precision class)
# ---------------------------------------------------------------------------

def _qblocks(n: int, block: int) -> tuple[int, int]:
    """(n_blocks, padded_elems) of ``comm.quantize``'s block layout for an
    ``n``-element payload — the wire carries the padded count."""
    beff = max(1, min(int(block), int(n)))
    nb = -(-int(n) // beff)
    return nb, nb * beff


def _np32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


class _QuantizedScheme(CollectiveScheme):
    """Shared scaffolding of the lossy wire-format schemes.

    Subclasses set ``WIRE`` (bytes per element crossing the bridge, per
    family), ``QREL`` (worst-case quantization error relative to the
    payload's per-block amax, per bridge contribution) and ``SCALE_BYTES``
    (0 for scale-free formats).  The traffic model prices the compressed
    bridge; the fast tier stays the parent scheme's full-precision bytes.
    ``candidates`` gate on ``pods >= 2``: a single pod has no bridge to
    compress, so the tuner is never offered the cell (the single-tier
    bodies still run — the static lossy fallback uses them).
    """

    precision = "lossy"
    block_candidates = (64, 256)
    WIRE: Mapping[str, float] = MappingProxyType({})
    QREL: Mapping[str, float] = MappingProxyType({})
    SCALE_BYTES = 4.0                  # f32 scales travel with the data

    def _payload(self, family: str, *, chips: int, elems: int) -> int:
        """Elems of the flattened payload the bridge codec sees."""
        if family == "psum":
            return max(1, elems // chips)      # post psum_scatter shard
        return chips * elems                   # gathered node region

    def candidates(self, family, *, pods, chips, elems):
        if not self.supports(family) or pods < 2:
            return ()
        if elems % self.tiling(family, pods=pods, chips=chips):
            return ()
        payload = self._payload(family, chips=chips, elems=elems)
        return tuple({"block": b} for b in self.block_candidates
                     if payload % b == 0)

    def traffic(self, family, *, pods, chips, elems, elem_bytes=4,
                populations=None):
        tr = super().traffic(family, pods=pods, chips=chips, elems=elems,
                             elem_bytes=elem_bytes, populations=populations)
        if pods <= 1 or family not in self.WIRE:
            return tr
        factor = (self._wire(family, pods=pods)
                  + self.SCALE_BYTES / qz.DEFAULT_BLOCK) / elem_bytes
        return CollectiveTraffic(
            slow_bytes=tr.slow_bytes * factor,
            fast_bytes=tr.fast_bytes,
            result_bytes_per_node=tr.result_bytes_per_node)

    def _wire(self, family: str, *, pods: int) -> float:
        """Bridge bytes per payload element (a hook for schedules whose
        wire format depends on the bridge's rank count)."""
        return self.WIRE[family]

    def error_bound_rel(self, family, *, pods):
        q = self.QREL[family]
        return pods * q if family == "psum" else q

    def error_check(self, family, *, inputs, output, pods, chips, elems,
                    dtype="float32", opts=None):
        if family not in self.QREL:
            return None
        eps = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -24
        if family == "psum":
            x = _np32(inputs[0])               # global (R, elems)
            exact = x.sum(axis=0)
            partials = x.reshape(pods, chips, -1).sum(axis=1)
            amax = float(np.max(np.abs(partials)))
            bound = self.QREL["psum"] * pods * amax \
                + 2.0 * (pods + chips) * eps * amax + 1e-12
            measured = float(np.max(np.abs(_np32(output) - exact)))
            return bound, measured
        if family == "allgather":
            x = _np32(inputs[0])               # global rank-major buffer
            amax = float(np.max(np.abs(x)))
            bound = self.QREL["allgather"] * amax + 2.0 * eps * amax + 1e-12
            exact = self._allgather_reference(x, pods=pods, chips=chips,
                                              elems=elems)
            measured = float(np.max(np.abs(_np32(output) - exact)))
            return bound, measured
        return None

    def _allgather_reference(self, x, *, pods, chips, elems):
        """Exact expected output layout: replicated hier order (== the
        rank-major input) unless a subclass overrides."""
        return x


class Q8HierScheme(_QuantizedScheme):
    """Hier schedule with an int8 bridge: intra-pod stages full precision,
    per-block symmetric int8 on the wire.  psum picks its bridge schedule
    by rank count — <= 3 pods fuse codes + LOCAL scales into ONE tiled u8
    gather summed locally in f32; wider bridges share block scales with one
    ``pmax`` and sum codes exactly in int16.  allgather ships local scales
    with the codes and restores the caller's own pod region exactly."""

    name = "q8_hier"
    result_class = "replicated"
    WIRE = MappingProxyType({"psum": 2.0, "allgather": 1.0})
    QREL = MappingProxyType({"psum": 1 / 254, "allgather": 1 / 254})
    ops = MappingProxyType({
        "psum": lambda x, *, fast, slow, axis=0, block=qz.DEFAULT_BLOCK,
                       err=None, **_:
            qz.q8_hier_psum(x, fast_axis=fast, slow_axis=slow, axis=axis,
                            block=block, err=err),
        "allgather": lambda x, *, fast, slow, axis=0,
                            block=qz.DEFAULT_BLOCK, **_:
            qz.q8_hier_all_gather(x, fast_axis=fast, slow_axis=slow,
                                  axis=axis, block=block),
    })

    def tiling(self, family, *, pods, chips):
        return chips if family == "psum" else 1   # intra-pod psum_scatter

    def _wire(self, family, *, pods):
        if family == "psum" and 2 <= pods <= 3:
            # fused u8 gather bridge: (p-1) B/elem where the parent ring
            # all-reduce moves 2(p-1)/p f32 elems -> p/2 x the u8 wire
            return 1.0 * pods / 2.0
        return self.WIRE[family]

    def links(self, family, *, pods, chips, fast_shape, elems,
              elem_bytes=4, opts=None, dtype="float32"):
        Pn, c = pods, chips
        m = elems * elem_bytes
        block = (opts or {}).get("block", qz.DEFAULT_BLOCK)
        if family == "psum":
            if Pn == 1:
                nb, padded = _qblocks(elems, block)
                if c <= 3:
                    # single-tier small world: one fused u8 code+scale gather
                    return _ag(c * (padded + 4.0 * nb), c), 0.0
                return _ar(2.0 * padded, c) + _ar(4.0 * nb, c), 0.0
            nb, padded = _qblocks(elems // c, block)
            fast = _rs(m / c, c) + _ag(m, c)
            if Pn <= 3:
                # fused u8 gather: codes + local f32 block scales, one op
                return fast, _ag(Pn * (padded + 4.0 * nb), Pn)
            # int16 wire sum + the f32 block-scales pmax exchange
            return fast, _ar(2.0 * padded, Pn) + _ar(4.0 * nb, Pn)
        if family == "allgather":
            fast = _ag(c * m, c)
            if Pn == 1:
                return fast, 0.0
            nb, padded = _qblocks(c * elems, block)
            # int8 codes + f32 scales, both gathered across the bridge
            return fast, _ag(Pn * 1.0 * padded, Pn) + _ag(Pn * 4.0 * nb, Pn)
        raise ValueError(f"unknown family {family!r}")


class QBf16HierScheme(_QuantizedScheme):
    """Hier schedule with a bf16 bridge: scale-free truncation, halving the
    f32 wire with no scales exchange.  The wire is a bitcast ``u16`` gather
    summed locally in f32.  Exact on bf16 payloads."""

    name = "qbf16_hier"
    result_class = "replicated"
    WIRE = MappingProxyType({"psum": 2.0, "allgather": 2.0})
    QREL = MappingProxyType({"psum": 2.0 ** -8, "allgather": 2.0 ** -8})
    SCALE_BYTES = 0.0
    ops = MappingProxyType({
        "psum": lambda x, *, fast, slow, axis=0, err=None, **_:
            qz.qbf16_hier_psum(x, fast_axis=fast, slow_axis=slow, axis=axis,
                               err=err),
        "allgather": lambda x, *, fast, slow, axis=0, **_:
            qz.qbf16_hier_all_gather(x, fast_axis=fast, slow_axis=slow,
                                     axis=axis),
    })

    def tiling(self, family, *, pods, chips):
        return chips if family == "psum" else 1

    def candidates(self, family, *, pods, chips, elems):
        # no block tunable: one candidate when the cell tiles multi-pod
        if not self.supports(family) or pods < 2:
            return ()
        if elems % self.tiling(family, pods=pods, chips=chips):
            return ()
        return ({},)

    def traffic(self, family, *, pods, chips, elems, elem_bytes=4,
                populations=None):
        tr = CollectiveScheme.traffic(self, family, pods=pods, chips=chips,
                                      elems=elems, elem_bytes=elem_bytes,
                                      populations=populations)
        if pods <= 1:
            return tr
        # psum crosses the bridge as a gather of all pods' bf16 partials
        # (summed locally): pods x the 2-byte payload
        factor = (float(pods) if family == "psum" else 2.0) / elem_bytes
        return CollectiveTraffic(
            slow_bytes=tr.slow_bytes * factor,
            fast_bytes=tr.fast_bytes,
            result_bytes_per_node=tr.result_bytes_per_node)

    def links(self, family, *, pods, chips, fast_shape, elems,
              elem_bytes=4, opts=None, dtype="float32"):
        Pn, c = pods, chips
        R, m = Pn * c, elems * elem_bytes
        if family == "psum":
            if Pn == 1:
                # single tier: the whole reduction is the u16-gather bridge
                return _ag(c * 2.0 * elems, c), 0.0
            fast = _rs(m / c, c) + _ag(m, c)
            # untiled u16 gather of every pod's shard, summed locally
            return fast, _ag(Pn * 2.0 * elems / c, Pn)
        if family == "allgather":
            fast = _ag(c * m, c)
            if Pn == 1:
                return fast, 0.0
            return fast, _ag(R * elems * 2.0, Pn)
        raise ValueError(f"unknown family {family!r}")


class Q4SharedScheme(_QuantizedScheme):
    """Shared-window allgather with a packed-int4 bridge (two nibbles per
    byte + per-block f32 scales): the weight-window format.  The result
    stays ONE copy per pod sharded over the fast tier (C1 untouched); only
    the bridge exchange is compressed."""

    name = "q4_shared"
    result_class = "shared"
    WIRE = MappingProxyType({"allgather": 0.5})
    QREL = MappingProxyType({"allgather": 1 / 14})
    ops = MappingProxyType({
        "allgather": lambda x, *, fast, slow, axis=0,
                            block=qz.DEFAULT_BLOCK, **_:
            qz.q4_shared_all_gather(x, fast_axis=fast, slow_axis=slow,
                                    axis=axis, block=block),
    })

    def _payload(self, family, *, chips, elems):
        return elems                       # per-rank shard, pre-gather

    def links(self, family, *, pods, chips, fast_shape, elems,
              elem_bytes=4, opts=None, dtype="float32"):
        if family != "allgather":
            raise ValueError(f"unknown family {family!r}")
        Pn = pods
        if Pn == 1:
            return 0.0, 0.0                # identity: already in the window
        block = (opts or {}).get("block", qz.DEFAULT_BLOCK)
        nb, padded = _qblocks(elems, block)
        return 0.0, _ag(Pn * 0.5 * padded, Pn) + _ag(Pn * 4.0 * nb, Pn)

    def _allgather_reference(self, x, *, pods, chips, elems):
        # shared layout: rank (p, i)'s window shard is chip i's
        # contribution from EVERY pod, pod-major (identical across p)
        cols = x.reshape(pods, chips, elems)
        shard = [np.concatenate([cols[q, i] for q in range(pods)])
                 for i in range(chips)]
        return np.concatenate([shard[i]
                               for _ in range(pods)
                               for i in range(chips)])


NAIVE = register_scheme(NaiveScheme())
HIER = register_scheme(HierScheme())
SHARED = register_scheme(SharedScheme())
PIPELINED = register_scheme(PipelinedScheme())
Q8_HIER = register_scheme(Q8HierScheme())
QBF16_HIER = register_scheme(QBf16HierScheme())
Q4_SHARED = register_scheme(Q4SharedScheme())
