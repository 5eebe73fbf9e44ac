"""Matrix-driven collective benchmark suites.

Every case is one (family, scheme, topology, message size, dtype) cell:

* families — ``allgather``, ``broadcast``, ``psum``, ``reduce_scatter``,
  ``allgatherv`` (irregularly populated nodes, paper Figs 4/10) and
  ``alltoall``; ``step_time`` is the whole-train-step family
  (``bench.step_time``, self-sized per cluster, timed eagerly);
  ``serving`` the decode-step family (``bench.serving``, the same);
* schemes  — whatever the ``repro_torch.comm`` registry declares for the
  family, dispatched through a ``Communicator``; a scheme whose tunable grid
  is empty for a cell (its tiling divisor does not divide ``elems`` on that
  topology) is skipped and logged, never raised;
* tunables — a scheme's ``candidates()`` grid (``pipelined``'s
  ``n_chunks``, the quantized schemes' ``block``) is autotuned per cell:
  every candidate is warmed up, cross-checked and timed, and the best median
  is the case's number;
* topologies — ``substrate.default_matrix()``: 1x8, 2x4, 4x2, 8x1 and the
  tuple-axis ``pod x (dp, tp)`` mesh, every rank stacked on one device.

The one eager warm-up of each (case, candidate) is also its inspection: the
substrate records its collectives and the device reports the bytes its
result holds (``validate.inspect_case``).  Then the body is captured in a
CUDA graph and the replays of every entry of a (family, topology, size,
dtype) group are timed round-robin (``runner``).  Inputs are made on the
device before timing.
"""

from __future__ import annotations

import dataclasses
import random
import re
import time
import warnings
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.traffic import link_bytes
from repro_torch.bench import runner
from repro_torch.comm import Communicator, registry
from repro_torch.core.plans import CollectiveTraffic
from repro_torch.substrate import VirtualCluster, default_matrix
from repro_torch.substrate.collectives import recording

ELEM_DTYPE = "float32"  # recorded per case: the tuning table keys by dtype

#: Families swept at extra dtypes: the gradient-reduction and weight-window
#: payloads whose wire format the quantized schemes compress.
DTYPE_SWEPT = ("allgather", "psum")
DTYPES = (ELEM_DTYPE, "bfloat16")

FAMILIES = ("allgather", "broadcast", "psum", "reduce_scatter",
            "allgatherv", "alltoall", "step_time", "serving")
#: Families that size themselves per cluster (the reference's train-step
#: and decode-step families).
SELF_SIZED = ("step_time", "serving")
COLLECTIVE_FAMILIES = tuple(f for f in FAMILIES if f not in SELF_SIZED)
# QUICK_ELEMS must stay a subset of FULL_ELEMS: the regression gate compares
# a quick sweep against a full-sweep baseline over shared cells only.  Up to
# 65536 the reference's sizes (1-256 KiB per rank in f32); 2^20 and 2^22
# (4 and 16 MiB per rank) are the card's width.
FULL_ELEMS = (256, 1024, 4096, 65536, 1 << 20, 1 << 22)
QUICK_ELEMS = (1024, 1 << 20)
assert set(QUICK_ELEMS) <= set(FULL_ELEMS)


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}: not a torch dtype name "
                         "(try float32, bfloat16)")
    return dt


def _dtype_bytes(name: str) -> int:
    return torch.empty((), dtype=_dtype(name)).element_size()


def slug(s: str) -> str:
    """CSV-safe case name."""
    return re.sub(r"[^a-z0-9]+", "_", s.lower()).strip("_")


@dataclasses.dataclass
class BenchCase:
    """One measurable config: a body over stacked ``(R, ...)`` inputs bound
    to a cluster + the registry-supplied traffic model it must agree with.

    ``tunable_grid`` holds the scheme's autotune candidates for this cell
    (``({},)`` = untunable); ``body_with(opts)`` builds the body for one
    candidate."""

    family: str
    scheme: str                      # a repro_torch.comm registry entry name
    cluster: VirtualCluster
    elems: int                       # per-rank / message / per-pair elems
    make_args: Callable[[], tuple]
    traffic: CollectiveTraffic       # scheme.traffic(...) for this config
    body_with: Callable[[dict], Callable]
    tunable_grid: tuple = ({},)
    populations: Optional[tuple] = None      # allgatherv only
    dtype: str = ELEM_DTYPE
    #: why the case is timed eagerly instead of captured (a whole train
    #: step); empty: captured in a CUDA graph on the card
    eager: str = ""

    @property
    def topology(self) -> str:
        return self.cluster.label

    @property
    def elem_bytes(self) -> int:
        return _dtype_bytes(self.dtype)

    @property
    def name(self) -> str:
        base = f"{self.family}/{self.scheme}/{self.topology}/e{self.elems}"
        return base if self.dtype == ELEM_DTYPE else f"{base}/{self.dtype}"

    @property
    def csv_name(self) -> str:
        base = f"{self.family}_{self.scheme}_{self.topology}_{self.elems}"
        if self.dtype != ELEM_DTYPE:
            base = f"{base}_{self.dtype}"
        return slug(base)


def bound_call(vc: VirtualCluster, body: Callable, args: tuple
               ) -> Callable[[], object]:
    """``body(*args)`` as a no-argument call with the cluster's mesh
    bound (what the timer captures and replays)."""
    def call():
        with vc.bind():
            return body(*args)
    return call


def _ranked(vc: VirtualCluster, num: int, dtype: str) -> torch.Tensor:
    """Ranked payload in the case dtype (built in f32, cast once)."""
    return torch.arange(num, dtype=torch.float32,
                        device=vc.device).to(_dtype(dtype))


def _scaled(vc: VirtualCluster, elems: int, dtype: str) -> torch.Tensor:
    """(R, elems) ranked payload scaled into [0, 1), so a reduction stays
    well inside f32 range."""
    R = vc.num_devices
    x = torch.arange(R * elems, dtype=torch.float32, device=vc.device)
    return (x.reshape(R, elems) / (R * elems)).to(_dtype(dtype))


# ---------------------------------------------------------------------------
# Family builders (one BenchCase per registered scheme)
# ---------------------------------------------------------------------------

def _swept(schs, schemes):
    """Registry entries filtered to an explicit scheme subset (None = all)."""
    if schemes is None:
        return schs
    return tuple(s for s in schs if s.name in schemes)


class BenchCoverageWarning(UserWarning):
    """A (family, scheme, topology, size) cell was dropped from the sweep
    (size does not tile for the scheme) — coverage, not correctness."""


def _grid_or_skip(sch, family: str, vc: VirtualCluster, elems: int,
                  on_skip) -> tuple:
    """The scheme's tunable grid for one cell; empty = skip and log."""
    grid = sch.candidates(family, pods=vc.pods, chips=vc.chips, elems=elems)
    if not grid:
        need = sch.tiling(family, pods=vc.pods, chips=vc.chips)
        msg = (f"skip {family}/{sch.name}/{vc.label}/e{elems}: "
               f"elems={elems} does not tile by {need} "
               f"(scheme tiling divisor on this topology)")
        if on_skip is not None:
            on_skip(msg)
        else:
            warnings.warn(msg, BenchCoverageWarning, stacklevel=3)
    return grid


def _traffic(sch, family: str, vc, elems: int, dtype: str, **kw):
    return sch.traffic(family, pods=vc.pods, chips=vc.chips, elems=elems,
                       elem_bytes=_dtype_bytes(dtype), **kw)


def _family_cases(family: str, method: str, vc: VirtualCluster, elems: int,
                  make_args, on_skip, schemes, dtype: str,
                  populations: Optional[tuple] = None, **call_kw):
    """One case per registered scheme of ``family`` that tiles the cell;
    the body calls ``Communicator.<method>`` with the scheme named (a lossy
    scheme opting in with its own precision)."""
    comm = Communicator.from_cluster(vc)
    for sch in _swept(registry.schemes_for(family), schemes):
        grid = _grid_or_skip(sch, family, vc, elems, on_skip)
        if not grid:
            continue

        def body_with(opts, s=sch.name, p=sch.precision):
            fn = getattr(comm, method)
            return lambda *v: fn(*v, scheme=s, precision=p, **call_kw,
                                 **opts)

        kw = {} if populations is None else {"populations": populations}
        yield BenchCase(family, sch.name, vc, elems, make_args=make_args,
                        traffic=_traffic(sch, family, vc, elems, dtype, **kw),
                        body_with=body_with, tunable_grid=grid,
                        populations=populations, dtype=dtype)


def allgather_cases(vc, elems, on_skip=None, schemes=None,
                    dtype=ELEM_DTYPE):
    R = vc.num_devices
    return _family_cases(
        "allgather", "allgather", vc, elems,
        lambda: (_ranked(vc, R * elems, dtype).reshape(R, elems),),
        on_skip, schemes, dtype)


def broadcast_cases(vc, elems, on_skip=None, schemes=None,
                    dtype=ELEM_DTYPE):
    R = vc.num_devices
    # a non-zero, non-leader root: the flat-root API
    return _family_cases(
        "broadcast", "broadcast", vc, elems,
        lambda: (_ranked(vc, R * elems, dtype).reshape(R, elems),),
        on_skip, schemes, dtype, root=R // 2)


def psum_cases(vc, elems, on_skip=None, schemes=None, dtype=ELEM_DTYPE):
    return _family_cases("psum", "allreduce", vc, elems,
                         lambda: (_scaled(vc, elems, dtype),),
                         on_skip, schemes, dtype)


def reduce_scatter_cases(vc, elems, on_skip=None, schemes=None,
                         dtype=ELEM_DTYPE):
    """Every rank contributes a full ``elems`` buffer; the global sum is
    scattered (flat 1/R slices, or the node's window shards)."""
    return _family_cases("reduce_scatter", "reduce_scatter", vc, elems,
                         lambda: (_scaled(vc, elems, dtype),),
                         on_skip, schemes, dtype)


def alltoall_cases(vc, elems, on_skip=None, schemes=None, dtype=ELEM_DTYPE):
    """Personalized exchange: every rank holds R rank-ordered chunks of
    ``elems`` each; chunk *s* goes to rank *s*."""
    R = vc.num_devices
    return _family_cases(
        "alltoall", "alltoall", vc, elems,
        lambda: (_ranked(vc, R * R * elems, dtype).reshape(R, R * elems),),
        on_skip, schemes, dtype)


def bench_populations(pods: int, chips: int) -> tuple[int, ...]:
    """Deterministic irregular node populations: node k holds
    ``chips - (k % chips)`` ranks (always >= 1, node 0 always full)."""
    return tuple(chips - (k % chips) for k in range(pods))


def allgatherv_cases(vc, max_elems, populations=None, on_skip=None,
                     schemes=None, dtype=ELEM_DTYPE):
    R = vc.num_devices
    pops = tuple(populations) if populations is not None \
        else bench_populations(vc.pods, vc.chips)

    def args():
        data = np.arange(R * max_elems,
                         dtype=np.float32).reshape(R, max_elems)
        valid = np.zeros((R, 1), np.int32)
        for pd in range(vc.pods):
            for i in range(vc.chips):
                r = pd * vc.chips + i
                valid[r, 0] = max_elems if i < pops[pd] else 0
                if i >= pops[pd]:
                    data[r] = 0.0
        return (torch.as_tensor(data, device=vc.device).to(_dtype(dtype)),
                torch.as_tensor(valid, device=vc.device))

    return _family_cases("allgatherv", "allgatherv", vc, max_elems, args,
                         on_skip, schemes, dtype, populations=pops)


def step_time_cases(vc, elems=None, on_skip=None, schemes=None):
    """Bridge to ``bench.step_time``: whole-train-step cases, self-sized
    per cluster (``elems`` unused)."""
    from repro_torch.bench import step_time as st
    return st.step_time_cases(vc, on_skip=on_skip, schemes=schemes)


def serving_cases(vc, elems=None, on_skip=None, schemes=None):
    """Bridge to ``bench.serving``: continuous-batching decode-step cases,
    self-sized per cluster (``elems`` unused)."""
    from repro_torch.bench import serving as sv
    return sv.serving_cases(vc, on_skip=on_skip, schemes=schemes)


_FAMILY_BUILDERS = {
    "allgather": allgather_cases,
    "broadcast": broadcast_cases,
    "psum": psum_cases,
    "reduce_scatter": reduce_scatter_cases,
    "allgatherv": allgatherv_cases,
    "alltoall": alltoall_cases,
    "step_time": step_time_cases,
    "serving": serving_cases,
}


def build_cases(*, clusters: Optional[Sequence[VirtualCluster]] = None,
                families: Sequence[str] = COLLECTIVE_FAMILIES,
                elems: Sequence[int] = FULL_ELEMS,
                max_devices: int = 8,
                schemes: Optional[Sequence[str]] = None,
                dtypes: Sequence[str] = (ELEM_DTYPE,),
                device="cuda", on_skip=None) -> list[BenchCase]:
    """The sweep: topology matrix x families x message sizes (x dtypes).

    ``schemes`` filters to a subset of registry entries; ``on_skip``
    receives one message per (family, scheme, topology, size) cell whose
    size does not tile for that scheme.  ``dtypes`` widens the sweep beyond
    float32 for the ``DTYPE_SWEPT`` families only.
    """
    if clusters is None:
        clusters = default_matrix(max_devices, device=device)
    unknown = set(families) - set(_FAMILY_BUILDERS)
    if unknown:
        raise ValueError(f"unknown families {sorted(unknown)}; "
                         f"pick from {list(_FAMILY_BUILDERS)}")
    for dt in dtypes:
        _dtype(dt)
    if "step_time" in families:
        from repro_torch.bench import step_time  # noqa: F401  registers
        # its schemes before the scheme-name validation below
    if "serving" in families:
        from repro_torch.bench import serving  # noqa: F401  registers
        # sync / recorded before the scheme-name validation below
    if schemes is not None:
        if "auto" in schemes:
            raise ValueError(
                "'auto' is the tuning-table dispatch mode, not a registry "
                "entry — the sweep measures the concrete schemes auto "
                "chooses between (emit the table from the sweep instead: "
                "python -m repro_torch.bench --emit-tuning-table)")
        unknown_s = set(schemes) - set(registry.scheme_names())
        if unknown_s:
            raise ValueError(f"unknown schemes {sorted(unknown_s)}; "
                             f"registered: {list(registry.scheme_names())}")
    cases: list[BenchCase] = []
    per_size = tuple(f for f in families if f not in SELF_SIZED)
    for vc in clusters:
        for dt in dict.fromkeys(dtypes):   # de-duped, order-preserving
            fams = per_size if dt == ELEM_DTYPE else \
                tuple(f for f in per_size if f in DTYPE_SWEPT)
            for e in elems:
                for fam in fams:
                    cases.extend(_FAMILY_BUILDERS[fam](
                        vc, e, on_skip=on_skip, schemes=schemes, dtype=dt))
        for fam in SELF_SIZED:
            if fam in families:
                cases.extend(_FAMILY_BUILDERS[fam](vc, on_skip=on_skip,
                                                   schemes=schemes))
    return cases


# ---------------------------------------------------------------------------
# Suite execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CaseResult:
    case: BenchCase
    timing: runner.TimingResult
    record: dict                 # recorded link / resident bytes (validate)
    checks: list                 # per-case validate.Check list
    autotune: Optional[dict] = None   # tunable sweep record (best wins)


def _cand_tag(cand: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(cand.items()))


class _Entry(NamedTuple):
    """One warmed-up, captured (case, tunable-candidate) of a timing cell."""
    case: BenchCase
    cand: dict
    call: runner.Captured
    record: dict
    checks: list
    inner: int


@dataclasses.dataclass
class SuiteResult:
    cases: list[CaseResult]
    cross_checks: list           # cross-scheme C1 validate.Check list


def run_suite(cases: Sequence[BenchCase], *, reps: int = 30,
              min_rep_s: float = 0.0, validate: bool = True,
              log=None) -> SuiteResult:
    """Warm up, cross-check and measure every case.

    A case with a tunable grid is autotuned: EVERY candidate is warmed up,
    cross-checked (the closed forms are tunable-invariant) and timed with
    the same reps; the best median is the case's number and the full sweep
    lands in ``CaseResult.autotune``.

    Timing is **interleaved per cell**: all (case, candidate) entries of one
    (family, topology, size, dtype) group are timed round-robin — rep *r*
    of every entry before rep *r+1* of any — with the within-round order
    shuffled per round under a fixed seed, so the comparisons the sweep
    exists for share one drift profile.  (The reference also pools the
    samples of entries whose compiled programs are identical; the port has
    no program text to compare, so every entry keeps its own samples.)

    Per-case and cross-scheme (C1) validation failures are raised together
    as ``validate.BenchValidationError`` after the whole sweep ran.
    """
    from repro_torch.bench import validate as V

    groups: dict[tuple, list[BenchCase]] = {}
    for case in cases:
        groups.setdefault(
            (case.family, case.topology, case.elems, case.dtype),
            []).append(case)

    results_by_id: dict[int, CaseResult] = {}
    done = 0
    for group in groups.values():
        # phase 1 — warm up (and inspect) every (case, candidate), then
        # capture it
        entries: list[_Entry] = []
        try:
            for case in group:
                for cand in tuple(case.tunable_grid) or ({},):
                    body, args = case.body_with(dict(cand)), \
                        case.make_args()
                    t0 = time.perf_counter()
                    record, checks = V.inspect_case(case, body, args,
                                                    opts=cand)
                    warm_s = time.perf_counter() - t0
                    call = bound_call(case.cluster, body, args)
                    entries.append(_Entry(
                        case=case, cand=cand,
                        call=runner.Captured(
                            call, case.cluster.device,
                            capture=not case.eager, note=case.eager),
                        record=record, checks=checks,
                        inner=runner.calibrate_inner(warm_s, min_rep_s)))
            # phase 2 — interleaved round-robin timing over the cell
            rng = random.Random(0x5EED)
            samples: list[list[float]] = [[] for _ in entries]
            order = list(range(len(entries)))
            timed_links: list[list] = [[] for _ in entries]
            for _ in range(reps):
                rng.shuffle(order)
                for i in order:
                    e = entries[i]
                    if e.call.graph is not None or not validate:
                        samples[i].append(runner.timed_call(
                            e.call, e.case.cluster.device, inner=e.inner))
                        continue
                    # an eager rep re-runs the body: its own traffic record
                    # is held to the case's expectation too
                    with recording() as rec:
                        samples[i].append(runner.timed_call(
                            e.call, e.case.cluster.device, inner=e.inner))
                    timed_links[i].append(link_bytes(rec))
        finally:
            for e in entries:
                e.call.release()
        # phase 3 — aggregate per case: best candidate wins
        for case in group:
            tuned = [(e.cand, runner.summarize(
                samples[i], inner=e.inner, mode=e.call.mode,
                clock=e.call.clock, note=e.call.note), e.record, e.checks)
                for i, e in enumerate(entries) if e.case is case]
            best = min(tuned, key=lambda t: t[1].median_us)
            checks = list(best[3])
            for i, e in enumerate(entries):
                if e.case is case and e.cand is best[0]:
                    checks.extend(V.timed_link_checks(case, timed_links[i],
                                                      e.inner, e.cand))
            for cand, _, _, cand_checks in tuned:
                if cand is best[0]:
                    continue
                # non-best candidates contribute only their FAILURES
                checks.extend(
                    dataclasses.replace(ch,
                                        name=f"{ch.name}@{_cand_tag(cand)}")
                    for ch in cand_checks if not ch.ok)
            autotune = None
            if len(tuned) > 1 or tuned[0][0]:
                autotune = {
                    "param_grid": [dict(c) for c, _, _, _ in tuned],
                    "results": [{**dict(c), "median_us": t.median_us}
                                for c, t, _, _ in tuned],
                    "best": dict(best[0]),
                }
            results_by_id[id(case)] = CaseResult(
                case, best[1], best[2], checks if validate else [],
                autotune)
            done += 1
            if log:
                tag = f" [{_cand_tag(best[0])}]" if best[0] else ""
                mode = f" (eager: {best[1].note})" if best[1].note else ""
                log(f"[{done}/{len(cases)}] {case.name}{tag}: "
                    f"{best[1].median_us:.1f}us (iqr "
                    f"{best[1].iqr_us:.1f}, {len(tuned)} candidate(s))"
                    f"{mode}")
        del entries
    results = [results_by_id[id(c)] for c in cases]
    cross = V.cross_scheme_checks(results) if validate else []
    if validate:
        V.raise_on_failure(results, cross)
    return SuiteResult(results, cross)
