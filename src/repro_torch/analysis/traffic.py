"""Traffic and memory evidence for the collectives (paper claims C1/C2).

The reference reads the collectives out of compiled HLO and prices each with
a ring model.  The port has no HLO: its substrate records every collective
it runs (``substrate.collectives.recording``), and this module prices that
record with the same ring formulas and holds it against each registry
entry's ``links()`` closed form.

C1 (one result copy per node) is measured, not modeled: the bytes a
collective's result holds on the device — the allocator's live bytes on
the card (``device_bytes``), the result's storage on the CPU — per node,
for the naive and
the shared scheme, must stand in the registry's ratio (``ranks_per_node``
for the full-result families).

``check_matrix`` runs every family under every registered exact scheme on
one cluster and raises on any mismatch of values, link bytes or resident
bytes.  ``check_lossy`` holds the quantized wire formats to their own
contract: link bytes priced by ``links(..., opts=)``, error within the
scheme's ``error_check`` bound, each rank's own pod region exact, and the
resident result bytes of ``result_node()``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.comm import Communicator, SharedWindow, registry
from repro_torch.substrate.collectives import CollectiveRecord, recording

#: Per-rank link bytes of one collective of ``group`` ranks whose per-rank
#: output is ``out`` bytes (the reference's ring model).
RING: dict[str, Callable[[float, int], float]] = {
    "all-gather": lambda out, n: out * (n - 1) / n,
    "reduce-scatter": lambda out, n: out * (n - 1),
    "all-reduce": lambda out, n: 2.0 * out * (n - 1) / n,
    "all-to-all": lambda out, n: out * (n - 1) / n,
    "collective-permute": lambda out, n: float(out),
}

FAMILIES = ("allgather", "allgatherv", "broadcast", "psum", "reduce_scatter",
            "alltoall")
#: Families whose results C1 compares (full results, or the window's share).
C1_FAMILIES = ("allgather", "broadcast", "psum", "reduce_scatter")


class EvidenceError(AssertionError):
    """A recorded or measured quantity disagrees with its closed form."""


def link_bytes(records: Iterable[CollectiveRecord]) -> tuple[float, float]:
    """Per-rank (fast, slow) link bytes of a traffic record."""
    fast = slow = 0.0
    for r in records:
        link = RING[r.op](r.out_bytes, r.group)
        if r.tier == "slow":
            slow += link
        else:
            fast += link
    return fast, slow


def _tensors(out) -> list[torch.Tensor]:
    if isinstance(out, SharedWindow):
        return [out.shard]
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _tensors(o)]


def device_bytes(device: torch.device) -> int:
    """The bytes live tensors hold on the card, as the caching allocator
    reports them (``requested_bytes``: each tensor's own size).
    ``memory_allocated`` counts allocator blocks instead, and a block less
    than 1 MiB larger than a request is handed out, and counted, whole, so
    its count depends on what the allocator cached before."""
    return torch.cuda.memory_stats(device)["requested_bytes.all.current"]


def resident_bytes(make: Callable[[], object], device: torch.device
                   ) -> tuple[int, object]:
    """Device bytes held by the result of ``make()`` (which creates its own
    inputs, so that only what the result keeps is counted), and the result."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        before = device_bytes(device)
        out = make()
        torch.cuda.synchronize(device)
        return device_bytes(device) - before, out
    out = make()
    seen, total = set(), 0
    for t in _tensors(out):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total, out


# ---------------------------------------------------------------------------
# The per-cluster matrix check
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CaseEvidence:
    """One (family, scheme) run on one cluster."""

    topology: str
    family: str
    scheme: str
    opts: dict
    fast_bytes: float           # recorded, priced
    slow_bytes: float
    fast_expected: float        # registry links()
    slow_expected: float
    node_bytes: Optional[float]     # measured resident result bytes per node
    node_expected: Optional[float]  # registry result_node()


def family_inputs(vc, family: str, elems: int, seed: int = 0) -> tuple:
    """Stacked inputs of one family: ``elems`` f32 per rank (per PAIR for
    alltoall), plus int32 valid counts for allgatherv."""
    R = vc.num_devices
    g = torch.Generator(device=vc.device).manual_seed(seed)
    n = R * elems if family == "alltoall" else elems
    x = torch.randn((R, n), generator=g, device=vc.device)
    if family == "allgatherv":
        valid = torch.randint(1, elems + 1, (R, 1), generator=g,
                              device=vc.device, dtype=torch.int32)
        return x, valid
    return (x,)


def _full(family: str, out, comm: Communicator):
    """Every scheme's result as the full value each rank can use, in rank
    order — what the schemes must agree on."""
    R = comm.num_ranks
    if family == "allgatherv":
        blocks, counts = out
        if blocks.dim() == 2:            # flat: already rank-major
            return blocks, counts
        # the node's window over each result, read in SMP rank order
        b, c = (SharedWindow(comm, x, epoch=1).read_rank_order()
                for x in (blocks, counts))
        return b.reshape(R, -1), c.reshape(R, -1)
    if isinstance(out, SharedWindow):
        return out.read_rank_order() if family == "allgather" \
            else out.read()
    if family == "reduce_scatter":       # flat 1/R slices, rank-major
        return out.reshape(1, -1).expand(R, -1)
    return out


def _agree(family: str, got, want, what: str) -> None:
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        if family in ("psum", "reduce_scatter"):   # reduction order differs
            if not torch.allclose(g, w, rtol=1e-5, atol=1e-5):
                err = (g - w).abs().max().item()
                raise EvidenceError(f"{what}: sums disagree (max |err| "
                                    f"{err:.3g} > rtol=atol=1e-5)")
        elif not torch.equal(g, w):
            raise EvidenceError(f"{what}: values differ from naive "
                                "(gathers/broadcasts/all-to-all are exact)")


def _case_opts(sch, family: str, vc, elems: int, n_chunks: int
               ) -> Optional[dict]:
    cands = sch.candidates(family, pods=vc.pods, chips=vc.chips, elems=elems)
    if not cands:
        return None
    return next((dict(c) for c in cands if c.get("n_chunks") == n_chunks),
                dict(cands[0]))


def check_matrix(vc, *, elems: int, seed: int = 0, n_chunks: int = 2
                 ) -> list[CaseEvidence]:
    """Run every family under every registered scheme on ``vc``: values
    must agree across schemes, the recorded traffic must price to each
    scheme's ``links()``, and resident result bytes per node must match
    ``result_node()`` (hence the naive/shared C1 ratio).  Raises
    ``EvidenceError`` on the first disagreement."""
    comm = Communicator.from_cluster(vc)
    R = vc.num_devices
    rows = []
    with vc.bind():
        for family in FAMILIES:
            inputs = family_inputs(vc, family, elems, seed)
            kw = {"root": R - 1} if family == "broadcast" else {}
            method = getattr(comm, "allreduce" if family == "psum"
                             else family)
            want = None
            for sch in registry.schemes_for(family):
                if sch.precision != "exact":
                    continue             # check_lossy holds these
                opts = _case_opts(sch, family, vc, elems, n_chunks)
                if opts is None:
                    continue             # the scheme cannot tile this cell
                what = f"{vc.label}/{family}/{sch.name}{opts or ''}"

                def make():
                    fresh = [t.clone() for t in inputs]
                    return method(*fresh, scheme=sch.name, **kw, **opts)

                with recording() as rec:
                    held, out = resident_bytes(make, vc.device)
                fast, slow = link_bytes(rec)
                exp = sch.links(family, pods=vc.pods, chips=vc.chips,
                                fast_shape=vc.fast_shape, elems=elems)
                if not (np.isclose(fast, exp[0], rtol=1e-9)
                        and np.isclose(slow, exp[1], rtol=1e-9)):
                    raise EvidenceError(
                        f"{what}: recorded link bytes (fast {fast}, slow "
                        f"{slow}) != links() {exp}")
                node = node_exp = None
                if family in C1_FAMILIES:
                    node = held / vc.pods
                    node_exp = sch.result_node(family, pods=vc.pods,
                                               chips=vc.chips, elems=elems)
                    if node != node_exp:
                        raise EvidenceError(
                            f"{what}: resident result bytes per node {node} "
                            f"!= result_node() {node_exp}")
                full = _full(family, out, comm)
                if want is None:
                    want = full
                else:
                    _agree(family, full, want, what)
                rows.append(CaseEvidence(vc.label, family, sch.name, opts,
                                         fast, slow, exp[0], exp[1], node,
                                         node_exp))
    return rows


def c1_ratios(rows: Iterable[CaseEvidence]) -> dict[tuple[str, str], float]:
    """Measured naive/shared resident-bytes ratio per (topology, family)."""
    by = {(r.topology, r.family, r.scheme): r.node_bytes for r in rows
          if r.node_bytes is not None}
    return {(t, f): by[(t, f, "naive")] / by[(t, f, "shared")]
            for (t, f, s) in by if s == "naive" and (t, f, "shared") in by}


# ---------------------------------------------------------------------------
# The lossy wire formats
# ---------------------------------------------------------------------------

#: The exact scheme each lossy wire format compresses the bridge of.
LOSSY_PARENT = {"q8_hier": "hier", "qbf16_hier": "hier",
                "q4_shared": "shared"}


@dataclasses.dataclass(frozen=True)
class LossyEvidence:
    """One lossy (family, scheme, opts) run on one cluster, beside its exact
    parent's bridge bytes."""

    topology: str
    family: str
    scheme: str
    opts: dict
    parent: str
    fast_bytes: float           # recorded, priced
    slow_bytes: float
    parent_slow: float          # the exact parent's links() slow bytes
    error: float                # max |err| against the exact result
    bound: float                # error_check() bound
    own_region_exact: Optional[bool]    # allgather: own pod region exact
    node_bytes: float           # measured resident result bytes per node


def _own_pod_region(out: torch.Tensor, pods: int, chips: int
                    ) -> torch.Tensor:
    """(R, pods * region) gather output -> (pods, chips, region): each
    rank's own pod region."""
    o = out.reshape(pods, chips, pods, -1)
    idx = torch.arange(pods, device=out.device)
    return o[idx, :, idx]


def check_lossy(vc, *, elems: int, seed: int = 0) -> list[LossyEvidence]:
    """Run every lossy (family, scheme) under ``precision="lossy"`` on
    ``vc``, once per tunable candidate (on one pod, where no candidate is
    offered, once with the single-tier body the static fallback runs).
    Each run's recorded traffic must price to ``links(..., opts=)``, its
    error against the exact result must stay within ``error_check``, each
    rank's own pod region of a gather must equal the exact gather bit for
    bit, and its resident bytes per node must be ``result_node()`` (for
    ``q4_shared``: one copy per node).  Raises ``EvidenceError`` on the
    first miss."""
    comm = Communicator.from_cluster(vc)
    R, P, c = vc.num_devices, vc.pods, vc.chips
    rows = []
    with vc.bind():
        for family in ("psum", "allgather"):
            (x,) = family_inputs(vc, family, elems, seed)
            method = comm.allreduce if family == "psum" else comm.allgather
            flat = x if family == "psum" else x.reshape(-1)
            for sch in registry.schemes_for(family):
                if sch.precision != "lossy":
                    continue
                cands = sch.candidates(family, pods=P, chips=c, elems=elems)
                if not cands and P == 1:
                    cands = ({},)
                for opts in map(dict, cands):
                    what = f"{vc.label}/{family}/{sch.name}{opts or ''}"

                    def make():
                        return method(x.clone(), scheme=sch.name,
                                      precision="lossy", **opts)

                    with recording() as rec:
                        held, out = resident_bytes(make, vc.device)
                    fast, slow = link_bytes(rec)
                    exp = sch.links(family, pods=P, chips=c,
                                    fast_shape=vc.fast_shape, elems=elems,
                                    opts=opts, dtype="float32")
                    if not (np.isclose(fast, exp[0], rtol=1e-9)
                            and np.isclose(slow, exp[1], rtol=1e-9)):
                        raise EvidenceError(
                            f"{what}: recorded link bytes (fast {fast}, slow "
                            f"{slow}) != links() {exp}")
                    node = held / P
                    node_exp = sch.result_node(family, pods=P, chips=c,
                                               elems=elems)
                    if node != node_exp:
                        raise EvidenceError(
                            f"{what}: resident result bytes per node {node} "
                            f"!= result_node() {node_exp}")
                    got = out.shard if isinstance(out, SharedWindow) else out
                    # one pod: the whole reduction is the bridge, so every
                    # rank's contribution is quantized
                    pods_e, chips_e = (P, c) if family == "allgather" \
                        or P > 1 else (R, 1)
                    bound, err = sch.error_check(
                        family, inputs=(flat.cpu().numpy(),),
                        output=got.cpu().numpy().reshape(
                            (-1,) if isinstance(out, SharedWindow)
                            else (R, -1)),
                        pods=pods_e, chips=chips_e, elems=elems)
                    if not err <= bound:
                        raise EvidenceError(f"{what}: error {err} > bound "
                                            f"{bound}")
                    own = None
                    if family == "allgather":
                        ref = method(x.clone(), scheme=LOSSY_PARENT[sch.name])
                        ref = ref.shard if isinstance(ref, SharedWindow) \
                            else ref
                        own = torch.equal(_own_pod_region(got, P, c),
                                          _own_pod_region(ref, P, c))
                        if not own:
                            raise EvidenceError(f"{what}: the own pod region "
                                                "differs from the exact "
                                                "gather")
                    parent = registry.get_scheme(LOSSY_PARENT[sch.name])
                    parent_slow = parent.links(
                        family, pods=P, chips=c, fast_shape=vc.fast_shape,
                        elems=elems)[1]
                    rows.append(LossyEvidence(
                        vc.label, family, sch.name, opts, parent.name, fast,
                        slow, parent_slow, err, bound, own, node))
    return rows
