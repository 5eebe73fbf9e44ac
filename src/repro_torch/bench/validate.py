"""Traffic-model cross-checks: the substrate's record vs the scheme registry.

The reference parses compiled HLO; the port's substrate records every
collective it runs (``substrate.collectives.recording``).  Three layers run
for every measured config; ANY mismatch fails the bench run
(``BenchValidationError``):

1. **Lowering check** (``link/fast``, ``link/slow``) — the per-rank link
   bytes of the recorded collectives, priced by the ring model
   (``analysis.traffic.link_bytes``), must equal the scheme's closed form
   for the sequence it runs (``CollectiveScheme.links``).  An extra or
   missing collective, or a wrong group, shows up here.
2. **Resident bytes** (``result/node``, ``model/result-node``) — the bytes
   the result holds on the device (``analysis.traffic.resident_bytes``:
   the allocator's live bytes on the card), per node, must
   equal ``result_node()`` and the case's plans traffic model for the
   families whose results C1 compares
   (``analysis.traffic.C1_FAMILIES``; allgatherv's int32 counts sit below
   the allocator's 512-byte granule, alltoall's result is rank-private).
   Lossy schemes add ``error/bound``: the measured error within the
   scheme's declared ceiling.
3. **C1, the paper's memory claim** (``C1/*``) — within every (family,
   topology, size) group holding both result classes, the measured
   replicated/shared resident ratio equals the registry's closed-form
   ratio (ranks_per_node for full results), and every replicated-class
   scheme holds the same resident bytes.

Nothing here matches scheme *names*: expectations come from the registry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.analysis import traffic as T
from repro_torch.bench.suites import BenchCase, CaseResult
from repro_torch.comm import SharedWindow, registry
from repro_torch.substrate.collectives import recording


class BenchValidationError(AssertionError):
    """The recorded traffic disagrees with the model (or C1 broke)."""


@dataclasses.dataclass
class Check:
    name: str
    expected: float
    measured: float
    note: str = ""
    # link-byte expectations are exact under the ring model; tolerance only
    # absorbs float accumulation and int truncation in plans.
    tol: float = 2.0
    # one-sided checks assert measured <= expected (+tol): error bounds are
    # ceilings, not equalities.
    one_sided: bool = False

    @property
    def ok(self) -> bool:
        slack = max(self.tol, 1e-9 * abs(self.expected))
        if self.one_sided:
            return self.measured <= self.expected + slack
        return abs(self.measured - self.expected) <= slack

    def to_dict(self) -> dict:
        d = {"name": self.name, "expected": self.expected,
             "measured": self.measured, "ok": self.ok, "note": self.note}
        if self.one_sided:
            d["one_sided"] = True
        return d


# ---------------------------------------------------------------------------
# Registry-supplied expectations
# ---------------------------------------------------------------------------

def expected_links(case: BenchCase, opts: Optional[dict] = None
                   ) -> tuple[float, float]:
    """Expected (fast, slow) per-rank link bytes of the case's sequence."""
    vc = case.cluster
    return registry.get_scheme(case.scheme).links(
        case.family, pods=vc.pods, chips=vc.chips, fast_shape=vc.fast_shape,
        elems=case.elems, elem_bytes=case.elem_bytes, opts=opts,
        dtype=case.dtype)


def expected_result_node(case: BenchCase) -> int:
    """Expected resident result bytes on ONE node."""
    vc = case.cluster
    return registry.get_scheme(case.scheme).result_node(
        case.family, pods=vc.pods, chips=vc.chips, elems=case.elems,
        elem_bytes=case.elem_bytes)


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _error_check(sch, case: BenchCase, args: tuple, out, opts):
    """The lossy scheme's host-side error model on this run (the layout
    ``analysis.traffic.check_lossy`` hands it)."""
    if case.family not in ("psum", "allgather"):
        return None
    vc = case.cluster
    x = args[0].float().cpu().numpy()
    shared = isinstance(out, SharedWindow)
    got = (out.shard if shared else out).float().cpu().numpy()
    return sch.error_check(
        case.family,
        inputs=(x if case.family == "psum" else x.reshape(-1),),
        output=got.reshape((-1,) if shared else (vc.num_devices, -1)),
        pods=vc.pods, chips=vc.chips, elems=case.elems, dtype=case.dtype,
        opts=opts)


def inspect_case(case: BenchCase, body, args: tuple,
                 opts: Optional[dict] = None) -> tuple[dict, list[Check]]:
    """Run ``body`` once on fresh copies of ``args`` — the case's one
    warm-up — under the substrate's recording; return (measurements,
    per-case checks)."""
    vc = case.cluster

    def make():
        fresh = [a.clone() for a in args]
        with vc.bind():
            return body(*fresh)

    with recording() as rec:
        held, out = T.resident_bytes(make, vc.device)
    fast, slow = T.link_bytes(rec)
    by_op: dict[str, float] = {}
    for r in rec:
        by_op[r.op] = by_op.get(r.op, 0.0) + T.RING[r.op](r.out_bytes,
                                                          r.group)
    R = vc.num_devices
    meas = {
        "fast_link_bytes_per_chip": fast,
        "slow_link_bytes_per_chip": slow,
        "fast_link_bytes_total": fast * R,
        "slow_link_bytes_total": slow * R,
        "by_op": by_op,
        "collectives": len(rec),
        "result_bytes_per_node": held / vc.pods,
    }
    exp_fast, exp_slow = expected_links(case, opts)
    checks = [
        Check("link/fast", exp_fast, fast,
              "per-rank intra-pod link bytes (ring model) of the recorded "
              "collectives"),
        Check("link/slow", exp_slow, slow,
              "per-rank bridge link bytes (ring model) of the recorded "
              "collectives"),
    ]
    if case.family in T.C1_FAMILIES:
        checks.append(Check(
            "result/node", expected_result_node(case), held / vc.pods,
            "resident result bytes per node, measured on the device"))
        checks.append(Check(
            "model/result-node", case.traffic.result_bytes_per_node,
            held / vc.pods, "resident result bytes per node == the plans "
            "model's result_bytes_per_node"))
    sch = registry.get_scheme(case.scheme)
    err = _error_check(sch, case, args, out, opts)
    if err is not None:
        bound, measured_err = err
        checks.append(Check(
            "error/bound", bound, measured_err,
            "max abs quantization error vs the exact host-side reference; "
            "the scheme's declared error model is a ceiling",
            tol=0.0, one_sided=True))
    return meas, checks


def timed_link_checks(case: BenchCase, links: Sequence[tuple],
                      inner: int = 1, opts: Optional[dict] = None
                      ) -> list[Check]:
    """The traffic record of every eagerly timed rep (``links``: its priced
    (fast, slow) bytes, over ``inner`` calls) against the case's expected
    links: the rep farthest from each is the measured value.  A captured
    case replays a graph and records nothing (no checks)."""
    if not links:
        return []
    exp = expected_links(case, opts)
    out = []
    for k, tier in enumerate(("fast", "slow")):
        got = [ln[k] / inner for ln in links]
        worst = max(got, key=lambda x: abs(x - exp[k]))
        out.append(Check(
            f"link/{tier}/timed", exp[k], worst,
            f"per-rank {tier} link bytes of each of the {len(links)} timed "
            "reps' own records (the one farthest from the expectation)"))
    return out


# ---------------------------------------------------------------------------
# Tuning-table winner cross-check
# ---------------------------------------------------------------------------

def tuning_table_checks(table, report: dict, *,
                        rel_tol: float = 1.0) -> list[Check]:
    """Every MEASURED tuning-table entry's winner must have the best median
    in the bench run being checked (within ``rel_tol``x: 1.0 when the
    table was folded from this very report, wider for the staleness gate
    against a fresh run).  Cells only one side measured are skipped; ZERO
    overlapping cells is a failing check."""
    from repro_torch.comm.tuning import TuningTable, bench_cells

    if isinstance(table, dict):
        table = TuningTable.from_dict(table)
    cells = bench_cells(report)
    checks: list[Check] = []
    overlap = 0
    for entry in table.entries:
        if entry.source != "measured":
            continue
        key = (entry.family, entry.topo, entry.dtype, entry.nbytes)
        cell = cells.get(key)
        if cell is None:
            continue
        overlap += 1
        name = f"tuning/{entry.family}/{entry.topo}/b{entry.nbytes}"
        best_med = min(med for med, _ in cell["schemes"].values())
        winner = cell["schemes"].get(entry.best.scheme)
        if winner is None:
            checks.append(Check(
                name, best_med, -1.0,
                f"table winner {entry.best.scheme!r} was not timed in this "
                "run — regenerate the table from a sweep that covers it",
                tol=0.0))
            continue
        checks.append(Check(
            name, best_med, winner[0],
            f"table winner {entry.best.scheme!r} vs the run's best median "
            f"(band {rel_tol}x)",
            tol=max(best_med * (rel_tol - 1.0), 0.0)))
    if not overlap:
        checks.append(Check(
            "tuning/overlap", 1.0, 0.0,
            "no (family, topology, dtype, size) cell appears in both the "
            "tuning table and the bench report — nothing was cross-checked",
            tol=0.0))
    return checks


# ---------------------------------------------------------------------------
# Cross-scheme (C1) checks + failure aggregation
# ---------------------------------------------------------------------------

def cross_scheme_checks(results: Sequence[CaseResult]) -> list[Check]:
    """Paper C1 as a measured invariant: within every (family, topology,
    size, dtype) group of a C1 family holding both result classes, the
    replicated/shared resident-result ratio equals the registry's
    closed-form ratio (ranks_per_node for full results; 1/num_nodes for
    ``reduce_scatter``, whose flat scheme keeps only its node's share).
    Every replicated-class scheme must also hold identical resident
    bytes."""
    by_key: dict[tuple, dict] = {}
    for r in results:
        if r.case.family not in T.C1_FAMILIES:
            continue
        k = (r.case.family, r.case.topology, r.case.elems, r.case.dtype)
        by_key.setdefault(k, {})[r.case.scheme] = r
    checks = []
    for (fam, topo, elems, dtype), group in sorted(by_key.items()):
        reps = [s for s in registry.scheme_names()
                if s in group
                and registry.get_scheme(s).result_class == "replicated"]
        shared = [s for s in registry.scheme_names()
                  if s in group
                  and registry.get_scheme(s).result_class == "shared"]
        if not reps or not shared:
            continue
        base, sh = reps[0], shared[0]
        vc = group[base].case.cluster
        c = vc.chips
        eb = group[base].case.elem_bytes
        exp_rep = registry.get_scheme(base).result_node(
            fam, pods=vc.pods, chips=c, elems=elems, elem_bytes=eb)
        exp_sh = registry.get_scheme(sh).result_node(
            fam, pods=vc.pods, chips=c, elems=elems, elem_bytes=eb)
        expected = exp_rep / exp_sh
        rep_b = group[base].record["result_bytes_per_node"]
        shared_b = group[sh].record["result_bytes_per_node"]
        what = "ranks_per_node" if expected == c \
            else "the registry closed-form ratio"
        tag = f"C1/{fam}/{topo}/e{elems}" if dtype == "float32" \
            else f"C1/{fam}/{topo}/e{elems}/{dtype}"
        checks.append(Check(
            tag, expected, rep_b / shared_b,
            f"{base}/{sh} resident-result ratio == {what} "
            f"({base} {rep_b} B, {sh} {shared_b} B per node)",
            tol=1e-9))
        for other in reps[1:]:
            other_b = group[other].record["result_bytes_per_node"]
            checks.append(Check(
                f"{tag}/{other}-replicates", rep_b, other_b,
                f"the {other} schedule is replication-class: same resident "
                f"bytes as {base}", tol=0.0))
    return checks


def raise_on_failure(results: Sequence[CaseResult],
                     cross: Sequence[Check]) -> None:
    lines = []
    for r in results:
        for ch in r.checks:
            if not ch.ok:
                lines.append(f"  {r.case.name} :: {ch.name}: expected "
                             f"{ch.expected}, measured {ch.measured} "
                             f"({ch.note})")
    for ch in cross:
        if not ch.ok:
            lines.append(f"  {ch.name}: expected {ch.expected}, measured "
                         f"{ch.measured} ({ch.note})")
    if lines:
        raise BenchValidationError(
            "traffic-model cross-check FAILED for "
            f"{len(lines)} check(s):\n" + "\n".join(lines))
