"""Step-graph collective optimizer: record a step's collectives, rewrite
the schedule, then apply it.

The paper's win is treating ONE collective as a node-granular schedule.
Applied one level up, a *step's worth* of collectives is also a schedule
worth optimizing: a train step issues dozens of small messages (per-leaf
gradient psums, scalar loss / count / norm reductions) that never reach the
sizes where the tuning table has measured winners, and each pays a fixed
dispatch cost.

Lifecycle (record -> rewrite -> apply):

1. **record** — ``Communicator.record()`` returns a ``GraphRecorder``; call
   sites record their collectives (``rec.allreduce(x, axes=...)``,
   ``rec.gather(window, key=...)``) and get ``Deferred`` refs back.
   Recording builds a ``CollectiveGraph`` of ``CollectiveNode``s.
2. **rewrite** — ``optimize()`` runs three registry-driven passes:

   * **bucketing** — bucketable same-(axes, dtype, scheme) allreduces are
     packed into flat buffers; the bucket size comes from
     ``core.plans.best_bucket_bytes`` over the tuning table's measured psum
     cells for this topology.  The codec (``pack_leaves`` /
     ``unpack_leaves``) is ravel + concat + zero-pad + slice + reshape —
     no arithmetic, and the substrate adds a group's members in a fixed
     order for every shape, so bucketed sums equal per-leaf sums bit for
     bit.  A partition part of one message is issued as a single (a
     bucket of one would be the eager issue plus two copies);
   * **dedup** — repeated gathers of the same window within one epoch
     collapse to one issue; (key, axes, epoch) is the identity;
   * **sink/reorder** — every surviving issue happens up front (gathers
     first, in first-record order).

3. **apply** — ``Communicator.apply_schedule()`` (via
   ``GraphRecorder.run()``) issues the whole schedule on one side stream
   and resolves it behind ONE CUDA event (on the CPU, eagerly), returning
   a ``ScheduleResult`` that resolves ``Deferred`` refs.

``Schedule.report()`` is a JSON-able before/after account of the rewrite
with its own schema version; ``python -m repro_torch.bench.gates schedule``
validates it with the standard library only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import pathlib
from typing import Any, Hashable, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from repro_torch.comm import registry
from repro_torch.comm.handle import AsyncCollectiveHandle, side_stream
from repro_torch.core.plans import (BUCKET_BYTES_CANDIDATES,
                                    best_bucket_bytes, greedy_buckets)

SCHEMA_VERSION = "repro_torch.stepgraph/v1"


# ---------------------------------------------------------------------------
# The graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveNode:
    """One recorded collective call (or an identity placeholder)."""

    nid: int
    family: str                     # "allreduce" | "gather" | "identity"
    key: Hashable                   # operand identity (leaf path, window id)
    axes: tuple[str, ...]           # mesh axes the collective spans
    dtype: str
    shape: tuple[int, ...]
    elems: int
    nbytes: int
    pos: int                        # program position (record order)
    scheme: str = "naive"           # pinned registry scheme ("auto" allowed)
    result: Optional[str] = None    # result-class constraint for dispatch
    bucketable: bool = False
    epoch: int = 0                  # gather only: the window's issue epoch
    node: bool = False              # gather only: read as node buffers


class CollectiveGraph:
    """Append-only record of a step's collective calls."""

    def __init__(self):
        self._nodes: list[CollectiveNode] = []

    def add(self, *, family: str, key: Hashable, axes: Sequence[str],
            dtype: str, shape: Sequence[int], elem_bytes: int,
            scheme: str = "naive", result: Optional[str] = None,
            bucketable: bool = False, epoch: int = 0,
            node: bool = False) -> int:
        nid = len(self._nodes)
        elems = int(math.prod(shape)) if shape else 1
        self._nodes.append(CollectiveNode(
            nid=nid, family=family, key=key, axes=tuple(axes),
            dtype=str(dtype), shape=tuple(int(d) for d in shape),
            elems=elems, nbytes=elems * elem_bytes, pos=nid,
            scheme=scheme, result=result, bucketable=bucketable,
            epoch=epoch, node=node))
        return nid

    @property
    def nodes(self) -> tuple[CollectiveNode, ...]:
        return tuple(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)


# ---------------------------------------------------------------------------
# Pack/unpack codec (bit-identical leaf-for-leaf)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Layout of one packed bucket buffer: per-leaf shapes in pack order,
    plus the zero-padding appended to reach the scheme's tiling multiple.
    Leaves are per-rank stacked ``(R, *shape)``; ``shapes`` are the local
    shapes."""

    shapes: tuple[tuple[int, ...], ...]
    dtype: str
    pad_elems: int

    @property
    def leaf_elems(self) -> tuple[int, ...]:
        return tuple(int(math.prod(s)) if s else 1 for s in self.shapes)

    @property
    def total_elems(self) -> int:
        return sum(self.leaf_elems) + self.pad_elems


def pack_leaves(leaves: Sequence[torch.Tensor], *, pad_to: int = 1
                ) -> tuple[torch.Tensor, PackSpec]:
    """Ravel + concatenate each rank's ``leaves`` into one flat buffer
    ``(R, total)``, zero-padded up to a multiple of ``pad_to`` elements.
    Pure data movement: an elementwise reduction of the concatenation IS the
    concatenation of the reductions."""
    if not leaves:
        raise ValueError("cannot pack an empty bucket")
    dtypes = {x.dtype for x in leaves}
    if len(dtypes) > 1:
        raise ValueError(f"mixed dtypes in one bucket: "
                         f"{sorted(str(d) for d in dtypes)}")
    R = leaves[0].shape[0]
    flat = [x.reshape(R, -1) for x in leaves]
    total = sum(f.shape[1] for f in flat)
    pad = (-total) % max(1, pad_to)
    if pad:
        flat.append(torch.zeros((R, pad), dtype=leaves[0].dtype,
                                device=leaves[0].device))
    buf = torch.cat(flat, dim=1) if len(flat) > 1 else flat[0]
    spec = PackSpec(shapes=tuple(tuple(x.shape[1:]) for x in leaves),
                    dtype=str(leaves[0].dtype).removeprefix("torch."),
                    pad_elems=pad)
    return buf, spec


def unpack_leaves(buf: torch.Tensor, spec: PackSpec) -> list[torch.Tensor]:
    """Slice + reshape the packed ``(R, total)`` buffer back into its
    leaves (padding is dropped).  Exact inverse of ``pack_leaves``."""
    if buf.dim() != 2 or buf.shape[1] != spec.total_elems:
        raise ValueError(f"buffer shape {tuple(buf.shape)} does not match "
                         f"spec (R, {spec.total_elems})")
    out, off = [], 0
    R = buf.shape[0]
    for shape, n in zip(spec.shapes, spec.leaf_elems):
        out.append(buf[:, off:off + n].reshape((R,) + shape))
        off += n
    return out


# ---------------------------------------------------------------------------
# The optimized schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bucket:
    """One packed reduction: members share (axes, dtype, scheme)."""

    axes: tuple[str, ...]
    dtype: str
    scheme: str
    nids: tuple[int, ...]           # member nodes, pack order == pos order
    pad_to: int                     # element tiling of the packed buffer
    target_bytes: int               # the partitioner's target for this group

    def elems(self, graph: CollectiveGraph) -> int:
        n = sum(graph.nodes[i].elems for i in self.nids)
        return n + ((-n) % max(1, self.pad_to))

    def nbytes(self, graph: CollectiveGraph) -> int:
        per = graph.nodes[self.nids[0]].nbytes // \
            max(1, graph.nodes[self.nids[0]].elems)
        return self.elems(graph) * per


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The rewritten schedule: what to issue, in what order."""

    graph: CollectiveGraph
    buckets: tuple[Bucket, ...]
    singles: tuple[int, ...]              # unbucketed allreduce nids
    gather_primary: dict                  # gather nid -> issuing nid
    order: tuple[tuple[str, int], ...]    # ("bucket", idx) | ("single"|
    #                                       "gather", nid), issue order

    def report(self) -> dict:
        """JSON-able before/after account of the rewrite."""
        nodes = self.graph.nodes
        ar_nodes = [n for n in nodes if n.family == "allreduce"]
        g_nodes = [n for n in nodes if n.family == "gather"]
        bucket_rows = []
        for b in self.buckets:
            raw = sum(nodes[i].nbytes for i in b.nids)
            bucket_rows.append({
                "axes": list(b.axes), "dtype": b.dtype, "scheme": b.scheme,
                "count": len(b.nids), "bytes": raw,
                "padded_bytes": b.nbytes(self.graph),
                "target_bytes": b.target_bytes})
        after_msgs = len(self.buckets) + len(self.singles)
        return {
            "schema": SCHEMA_VERSION,
            "nodes": len(nodes),
            "allreduce": {
                "before_messages": len(ar_nodes),
                "after_messages": after_msgs,
                "before_bytes": sum(n.nbytes for n in ar_nodes),
                "after_bytes": sum(r["padded_bytes"] for r in bucket_rows)
                + sum(nodes[i].nbytes for i in self.singles),
            },
            "gather": {
                "before_issues": len(g_nodes),
                "after_issues": len(set(self.gather_primary.values())),
            },
            "buckets": bucket_rows,
            "singles": len(self.singles),
            "order": [[kind, int(idx)] for kind, idx in self.order],
        }


def bucket_target_candidates(table, *, pods: Optional[int],
                             chips: Optional[int], n_fast_axes: int = 1,
                             dtype: str = "float32") -> tuple[int, ...]:
    """Bucket-size candidates for ``best_bucket_bytes``: the tuning table's
    MEASURED psum cell sizes for this topology signature, falling back to
    the static ``core.plans.BUCKET_BYTES_CANDIDATES`` grid when nothing was
    measured (no table, unknown topology, or no static counts)."""
    if table is None or not pods or not chips:
        return BUCKET_BYTES_CANDIDATES
    from repro_torch.comm.tuning import topo_signature
    sig = topo_signature(pods, chips, n_fast_axes)
    measured = sorted({e.nbytes for e in table.entries
                       if e.family == "psum" and e.topo == sig
                       and e.source == "measured"})
    return tuple(measured) or BUCKET_BYTES_CANDIDATES


def optimize(graph: CollectiveGraph, *, pods: Optional[int] = None,
             chips: Optional[int] = None, n_fast_axes: int = 1,
             table=None, target_bytes: Optional[int] = None) -> Schedule:
    """Rewrite the recorded graph: bucket, dedup, sink/reorder.

    Pure Python on static metadata.  An explicit ``target_bytes`` pins the
    bucket size; otherwise ``core.plans.best_bucket_bytes`` picks it per
    (axes, dtype, scheme) group from the tuning table's measured
    candidates.
    """
    nodes = graph.nodes
    # -- pass 1: bucketing ---------------------------------------------------
    groups: dict[tuple, list[CollectiveNode]] = {}
    singles: list[int] = []
    for n in nodes:
        if n.family != "allreduce":
            continue
        if (n.bucketable and n.scheme != "auto"
                and registry.get_scheme(n.scheme).bucketable("psum")):
            groups.setdefault((n.axes, n.dtype, n.scheme), []).append(n)
        else:
            singles.append(n.nid)
    buckets: list[Bucket] = []
    for (axes, dtype, scheme), members in groups.items():
        members.sort(key=lambda n: n.pos)
        if len(members) == 1:
            singles.append(members[0].nid)
            continue
        sch = registry.get_scheme(scheme)
        pad_to = sch.tiling("psum", pods=pods or 1, chips=chips or 1)
        elem_bytes = members[0].nbytes // max(1, members[0].elems)
        sizes = [n.nbytes for n in members]
        tgt = target_bytes
        if tgt is None:
            cands = bucket_target_candidates(
                table, pods=pods, chips=chips, n_fast_axes=n_fast_axes,
                dtype=dtype)
            tgt = best_bucket_bytes(
                sizes, num_nodes=pods or 1, ranks_per_node=chips or 1,
                scheme=sch._plans_scheme, pad_to=pad_to * elem_bytes,
                candidates=cands)
        for part in greedy_buckets(sizes, tgt):
            if len(part) == 1:          # a message at or above the target
                singles.append(members[part[0]].nid)
                continue
            buckets.append(Bucket(
                axes=axes, dtype=dtype, scheme=scheme,
                nids=tuple(members[i].nid for i in part),
                pad_to=pad_to, target_bytes=tgt))
    # -- pass 2: gather dedup ------------------------------------------------
    gather_primary: dict[int, int] = {}
    first_issue: dict[tuple, int] = {}
    for n in nodes:
        if n.family != "gather":
            continue
        ident = (n.key, n.axes, n.epoch)
        gather_primary[n.nid] = first_issue.setdefault(ident, n.nid)
    # -- pass 3: sink/reorder (issue early, in first-record order) ----------
    order: list[tuple[str, int]] = []
    order += [("gather", nid) for nid in sorted(set(gather_primary.values()),
                                                key=lambda i: nodes[i].pos)]
    order += [("bucket", i) for i, _ in sorted(
        enumerate(buckets), key=lambda ib: nodes[ib[1].nids[0]].pos)]
    order += [("single", nid) for nid in sorted(
        singles, key=lambda i: nodes[i].pos)]
    return Schedule(graph=graph, buckets=tuple(buckets),
                    singles=tuple(sorted(singles)),
                    gather_primary=gather_primary, order=tuple(order))


# ---------------------------------------------------------------------------
# Apply (the executor)
# ---------------------------------------------------------------------------

def _split_tier(axes: Sequence[str], slow_names: Sequence[str]
                ) -> tuple[tuple[str, ...], Optional[tuple[str, ...]]]:
    """Split a node's axes into the issuing communicator's (fast, slow)
    tiers, slow-first ordering preserved."""
    slow = tuple(a for a in axes if a in slow_names)
    fast = tuple(a for a in axes if a not in slow_names)
    if not fast:
        return slow, None           # bridge-only: flat single-tier comm
    return fast, slow or None


def _issue_comm(comm, axes: tuple[str, ...]):
    """The communicator that issues one node: the recording communicator
    itself when the axes match (keeps static counts, so ``scheme="auto"``
    resolves exactly as an un-recorded call would), else a fresh two-tier
    split of the node's own axes."""
    from repro_torch.comm import primitives as p
    from repro_torch.comm.communicator import Communicator
    if axes == comm.axes:
        return comm
    fast, slow = _split_tier(axes, p._axes(comm.slow_axis)
                             if comm.slow_axis else ())
    return Communicator(fast_axis=fast, slow_axis=slow)


def _device_of(values: dict) -> torch.device:
    for v in values.values():
        t = v if isinstance(v, torch.Tensor) else getattr(v, "shard", None)
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def apply_schedule(comm, schedule: Schedule, values: dict) -> dict:
    """Execute the rewritten schedule.

    ``values`` maps nid -> recorded operand (stacked tensors for allreduce
    nodes, ``SharedWindow``s for gathers).  On the card every issue runs up
    front, in schedule order, on ONE side stream that starts after the
    current stream's queued work; one event recorded after the last issue
    is the only thing the current stream waits on (the one-event-per-
    bucket idiom, for the whole schedule).  On the CPU the issues run
    eagerly.  Returns nid -> resolved value.
    """
    nodes = schedule.graph.nodes
    out: dict[int, Any] = {}
    for n in nodes:                       # identity nodes resolve directly
        if n.family == "identity":
            out[n.nid] = values[n.nid]

    side = side_stream(_device_of(values))
    issued: list[tuple[str, Any, Any]] = []   # (kind, meta, raw result)
    with (torch.cuda.stream(side) if side is not None
          else contextlib.nullcontext()):
        for kind, idx in schedule.order:
            if kind == "bucket":
                b = schedule.buckets[idx]
                buf, spec = pack_leaves([values[i] for i in b.nids],
                                        pad_to=b.pad_to)
                red = _issue_comm(comm, b.axes).allreduce(
                    buf, scheme=b.scheme, result="replicated")
                issued.append(("bucket", (b, spec), red))
            elif kind == "single":
                n = nodes[idx]
                red = _issue_comm(comm, n.axes).allreduce(
                    values[idx], scheme=n.scheme, result=n.result)
                issued.append(("single", idx, red))
            else:                         # gather (already deduped)
                handle = AsyncCollectiveHandle.issue(
                    "allgather", values[idx], stream=side, event=False,
                    node=nodes[idx].node)
                issued.append(("gather", idx, handle))
        event = side.record_event() if side is not None else None

    if side is not None:
        current = torch.cuda.current_stream(side.device)
        current.wait_event(event)
        for v in values.values():         # operands read on the side stream
            t = v if isinstance(v, torch.Tensor) else v.shard
            t.record_stream(side)
    resolved_gathers: dict[int, Any] = {}
    for kind, meta, raw in issued:
        if kind == "gather":
            resolved_gathers[meta] = dataclasses.replace(
                raw, event=event).resolve()
            continue
        arr = raw.shard if hasattr(raw, "shard") else raw
        if side is not None:
            arr.record_stream(current)
        if kind == "bucket":
            b, spec = meta
            for nid, leaf in zip(b.nids, unpack_leaves(raw, spec)):
                out[nid] = leaf
        else:
            out[meta] = raw
    for nid, primary in schedule.gather_primary.items():
        out[nid] = resolved_gathers[primary]
    return out


# ---------------------------------------------------------------------------
# Recorder (the Communicator.record() entry point)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Deferred:
    """A ref to a recorded collective's (future) result.  Opaque: hold it,
    hand it back to the ``ScheduleResult``."""

    nid: int


class ScheduleResult:
    """Resolved schedule: maps ``Deferred`` refs back to values."""

    def __init__(self, values: dict, schedule: Schedule):
        self._values = values
        self.schedule = schedule

    def __getitem__(self, ref: Deferred):
        return self._values[ref.nid]

    def resolve(self, tree):
        """Replace every ``Deferred`` leaf in ``tree`` with its value."""
        is_ref = lambda x: isinstance(x, Deferred)  # noqa: E731
        return pytree.tree_map(lambda x: self._values[x.nid] if is_ref(x)
                               else x, tree, is_leaf=is_ref)

    def report(self) -> dict:
        return self.schedule.report()


class GraphRecorder:
    """Records a step's collectives against one base communicator.

    ``allreduce``/``gather`` return ``Deferred`` refs; ``run()`` optimizes
    and applies the schedule, returning a ``ScheduleResult``.
    """

    def __init__(self, comm, *, table=None):
        self.comm = comm
        self.graph = CollectiveGraph()
        self._values: dict[int, Any] = {}
        self._table = table

    def allreduce(self, x: torch.Tensor, *, axes: Sequence[str],
                  scheme: str = "naive", result: Optional[str] = None,
                  bucketable: Optional[bool] = None,
                  key: Hashable = None) -> Deferred:
        """Record one allreduce of the stacked ``x`` over ``axes`` (slow
        axes first).  Empty ``axes`` records an identity (the leaf needs no
        reduction but keeps its slot).  ``bucketable`` defaults to True
        exactly when the pinned scheme's packed reduction is elementwise
        (``registry`` ``bucketable``) — an ``"auto"`` pick is resolved per
        message size, so it never buckets unless the caller opts in."""
        from repro_torch.comm.tuning import dtype_name
        axes = tuple(axes)
        shape, eb = tuple(x.shape[1:]), x.element_size()
        if not axes:
            nid = self.graph.add(family="identity", key=key, axes=(),
                                 dtype=dtype_name(x.dtype), shape=shape,
                                 elem_bytes=eb)
            self._values[nid] = x
            return Deferred(nid)
        if bucketable is None:
            bucketable = (scheme != "auto"
                          and registry.get_scheme(scheme).bucketable("psum"))
        nid = self.graph.add(family="allreduce", key=key, axes=axes,
                             dtype=dtype_name(x.dtype), shape=shape,
                             elem_bytes=eb, scheme=scheme, result=result,
                             bucketable=bucketable)
        self._values[nid] = x
        return Deferred(nid)

    def gather(self, window, *, key: Hashable, node: bool = False
               ) -> Deferred:
        """Record a gather (read) of a ``SharedWindow``.  ``key`` is the
        window's stable identity: repeated gathers of the same key in the
        same epoch dedup to one issue; a fence bumps the epoch and keeps
        both.  ``node=True`` resolves to the node buffers
        (``SharedWindow.read_node``: one per window behind its ``lead``
        dims) instead of every rank's copy.  The node records one rank's
        shard shape."""
        from repro_torch.comm import primitives as p
        from repro_torch.comm.tuning import dtype_name
        shard = window.shard
        nid = self.graph.add(
            family="gather", key=key,
            axes=tuple(p._axes(window.comm.fast_axis)),
            dtype=dtype_name(shard.dtype),
            shape=tuple(shard.shape[window.lead + 1:]),
            elem_bytes=shard.element_size(), epoch=window.epoch, node=node)
        self._values[nid] = window
        return Deferred(nid)

    def run(self, *, target_bytes: Optional[int] = None) -> ScheduleResult:
        """Optimize the recorded graph and apply it."""
        from repro_torch.comm import primitives as p
        from repro_torch.comm import tuning
        table = self._table if self._table is not None \
            else tuning.active_table()
        schedule = optimize(
            self.graph, pods=self.comm.pods, chips=self.comm.chips,
            n_fast_axes=len(p._axes(self.comm.fast_axis)), table=table,
            target_bytes=target_bytes)
        values = apply_schedule(self.comm, schedule, self._values)
        return ScheduleResult(values, schedule)


# ---- the schedule artifact --------------------------------------------------
#: where ``python -m repro_torch.comm.stepgraph`` writes by default (never the
#: reference's root ``SCHEDULE_stepgraph.json``)
ARTIFACT = pathlib.Path(__file__).resolve().parents[1] / "artifacts" \
    / "SCHEDULE_stepgraph_h100.json"


def schedule_reports(matrix=None, configs=None) -> list[dict]:
    """One schedule ``report()`` per (model config, topology): run the
    ``step_time`` bench body (``runtime.steps.make_step_bench``) once with
    the ``stepgraph`` opt and collect what the optimizer did to its
    recorded graph under the active tuning table.  The schedule depends on
    the graph and the table, not on the device, so the default matrix is
    stacked on the CPU (reduced configs: a fraction of a second each)."""
    from repro_torch.bench.step_time import STEP_CONFIGS
    from repro_torch.configs import get_config
    from repro_torch.runtime.steps import make_step_bench
    from repro_torch.substrate.cluster import default_matrix

    rows = []
    for vc in (matrix if matrix is not None
               else default_matrix(device="cpu")):
        for cfg_name in (configs or STEP_CONFIGS):
            cfg = get_config(cfg_name).reduced()
            sink: list[dict] = []
            body, _, _, make_args, elems = make_step_bench(
                cfg, vc, opts=("stepgraph",), unroll=cfg.n_units,
                schedule_sink=sink)
            with vc.bind():
                body(*make_args())
            rows.append({"config": cfg_name, "topology": vc.label,
                         "pods": vc.pods, "chips": vc.chips,
                         "elems": elems, **sink[-1]})
    return rows


def _main(argv=None) -> int:
    """Emit the port's schedule artifact — the record of the optimizer's
    rewrite of the ``step_time`` step over the standard topology matrix,
    under the active tuning table (the committed
    ``artifacts/TUNING_h100.json`` unless ``REPRO_TORCH_TUNING_TABLE``
    names another), checked by ``bench.gates``:

        python -m repro_torch.comm.stepgraph [--out PATH]
    """
    import argparse
    import json

    from repro_torch.comm import tuning

    ap = argparse.ArgumentParser(prog="python -m repro_torch.comm.stepgraph")
    ap.add_argument("--out", default=str(ARTIFACT))
    args = ap.parse_args(argv)
    reports = schedule_reports()
    table = tuning.default_table_path()
    doc = {
        "schema": SCHEMA_VERSION,
        "generated_by": "python -m repro_torch.comm.stepgraph",
        "torch_version": torch.__version__,
        "tuning_table": table.name if table.exists() else None,
        "reports": reports,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    n_topo = len({r["topology"] for r in reports})
    print(f"repro_torch.comm.stepgraph: wrote {args.out} "
          f"({len(reports)} schedules over {n_topo} topologies)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
