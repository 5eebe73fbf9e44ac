"""Tuning-table-driven scheme selection: the ``scheme="auto"`` backend.

The paper's central measurement (Figs 7-10) is that the best collective
algorithm depends on topology and message size.  ``repro_torch.comm.tuning``
turns that observation into the dispatch rule:

* ``TuningTable``  — a schema-versioned, persisted table of per-cell scheme
  rankings, keyed by (op family x topology signature x dtype x size
  bucket).  Measured entries are folded out of a ``repro_torch.bench``
  report (``python -m repro_torch.bench --emit-tuning-table``); the port's
  default is ``artifacts/TUNING_h100.json``, measured on one H100 with
  every rank of a topology stacked on that card, so its winners rank
  device copies, not NVLink links.  Every entry carries a ``source`` tag
  (``measured`` | ``modeled``) and the full per-scheme ranking, so a
  result-class-constrained lookup falls through to the best *allowed*
  scheme.
* ``resolve()``    — the dispatch rule ``Communicator`` consults when
  ``scheme="auto"``:

  1. **measured** — nearest-size-bucket table entry for the communicator's
     topology signature; the ranking is walked best-first, skipping schemes
     the caller's ``result`` / ``precision`` constraint or the cell's tiling
     rules out;
  2. **modeled**  — no usable entry: every registry scheme prices the cell
     with its ``predicted_time`` closed form (``core.plans``; ``pipelined``
     folds in ``best_chunk_count``) and the cheapest allowed scheme wins;
  3. **fallback** — no static ``pods``/``chips`` counts (nothing to key or
     model on): the per-family defaults of ``FALLBACK`` apply
     (``LOSSY_FALLBACK`` first under ``precision="lossy"``).

``precision`` mirrors ``result_class`` on the exact/lossy axis:
``"exact"`` (the default) never returns a quantized scheme, ``"lossy"``
admits them, capped by ``tol`` (a relative error bound).  Resolution is
pure Python on static shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import pathlib
from typing import Iterable, Mapping, Optional, Sequence

from repro_torch.comm import registry
from repro_torch.core.plans import nearest_bucket, size_bucket

SCHEMA_VERSION = "repro_torch.tuning/v1"

#: What every table folded from a bench report says about its winners.
MEASURED_ON = ("every rank of a topology stacked on one card: the winners "
               "rank device copies on that card, not NVLink links")

#: Per-family defaults when nothing can be measured or modeled (no static
#: pods/chips counts): ``shared`` for the window families, ``hier`` for
#: alltoall, ``prefetch`` / ``sync`` for the ``step_time`` / ``serving``
#: bench families; ``naive`` under a ``replicated`` constraint.
FALLBACK = {
    None: {"allgather": "shared", "broadcast": "shared", "psum": "shared",
           "reduce_scatter": "shared", "allgatherv": "shared",
           "alltoall": "hier", "step_time": "prefetch",
           "serving": "sync"},
    "shared": {"allgather": "shared", "broadcast": "shared",
               "psum": "shared", "reduce_scatter": "shared",
               "allgatherv": "shared"},
    "replicated": {"allgather": "naive", "broadcast": "naive",
                   "psum": "naive", "reduce_scatter": "naive",
                   "allgatherv": "naive", "alltoall": "hier",
                   "step_time": "prefetch", "serving": "sync"},
}


def topo_signature(pods: int, chips: int, n_fast_axes: int = 1) -> str:
    """Stable topology key: ``{pods}x{chips}`` plus ``-f{n}`` when the fast
    tier spans several named mesh axes."""
    sig = f"{pods}x{chips}"
    if n_fast_axes > 1:
        sig += f"-f{n_fast_axes}"
    return sig


def dtype_name(dtype) -> str:
    """A torch dtype as the table spells it (``float32``, ``bfloat16``)."""
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Table entries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Choice:
    """One ranked (scheme, tunable-opts) alternative of a cell."""

    scheme: str
    opts: Mapping = dataclasses.field(default_factory=dict)
    median_us: Optional[float] = None

    def to_dict(self) -> dict:
        out = {"scheme": self.scheme, "opts": dict(self.opts)}
        if self.median_us is not None:
            out["median_us"] = self.median_us
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Choice":
        return cls(scheme=d["scheme"], opts=dict(d.get("opts") or {}),
                   median_us=d.get("median_us"))


@dataclasses.dataclass(frozen=True)
class TuningEntry:
    """One (family, topology, dtype, size) cell: the full scheme ranking.

    ``nbytes`` is the per-rank payload (message bytes for broadcast/psum,
    per-rank contribution for allgather, per-pair bytes for alltoall) — the
    same normalization ``repro_torch.bench`` keys its sweep by."""

    family: str
    topo: str                       # topo_signature(...)
    dtype: str
    nbytes: int
    source: str                     # "measured" | "modeled"
    ranking: tuple[Choice, ...]     # best first
    label: str = ""                 # human topology label, e.g. "2x4"

    def __post_init__(self):
        if self.source not in ("measured", "modeled"):
            raise ValueError(f"bad source {self.source!r}")
        if not self.ranking:
            raise ValueError(f"{self.family}/{self.topo}: empty ranking")

    @property
    def bucket(self) -> int:
        return size_bucket(self.nbytes)

    @property
    def best(self) -> Choice:
        return self.ranking[0]

    def to_dict(self) -> dict:
        return {"family": self.family, "topo": self.topo,
                "dtype": self.dtype, "nbytes": self.nbytes,
                "bucket": self.bucket, "source": self.source,
                "label": self.label,
                "ranking": [c.to_dict() for c in self.ranking]}

    @classmethod
    def from_dict(cls, d: dict) -> "TuningEntry":
        return cls(family=d["family"], topo=d["topo"], dtype=d["dtype"],
                   nbytes=int(d["nbytes"]), source=d["source"],
                   label=d.get("label", ""),
                   ranking=tuple(Choice.from_dict(c)
                                 for c in d["ranking"]))


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuningTable:
    """Persisted scheme-selection table (``artifacts/TUNING_h100.json``)."""

    entries: tuple[TuningEntry, ...] = ()
    meta: Mapping = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.entries)

    # -- lookup --------------------------------------------------------------
    def lookup(self, family: str, topo: str, dtype: str, nbytes: int
               ) -> Optional[TuningEntry]:
        """Nearest-size-bucket entry for one (family, topology) cell.

        Exact-dtype entries are preferred; with none recorded the search
        widens to every dtype.  Among candidates the geometrically-nearest
        bucket wins, ties toward the smaller size
        (``core.plans.nearest_bucket``)."""
        cands = [e for e in self.entries
                 if e.family == family and e.topo == topo]
        if not cands:
            return None
        exact = [e for e in cands if e.dtype == dtype]
        cands = exact or cands
        best_bucket = nearest_bucket(nbytes, [e.bucket for e in cands])
        matches = [e for e in cands if e.bucket == best_bucket]
        return min(matches, key=lambda e: e.nbytes)

    def signatures(self) -> tuple[str, ...]:
        return tuple(sorted({e.topo for e in self.entries}))

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": SCHEMA_VERSION,
                "meta": dict(self.meta),
                "entries": [e.to_dict() for e in sorted(
                    self.entries,
                    key=lambda e: (e.family, e.topo, e.dtype, e.nbytes))]}

    @classmethod
    def from_dict(cls, d: dict) -> "TuningTable":
        schema = d.get("schema")
        if schema != SCHEMA_VERSION:
            raise ValueError(
                f"not a {SCHEMA_VERSION} table (schema={schema!r})")
        return cls(entries=tuple(TuningEntry.from_dict(e)
                                 for e in d.get("entries", [])),
                   meta=dict(d.get("meta") or {}))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
            f.write("\n")

    @classmethod
    def load(cls, path) -> "TuningTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- folding a bench report into measured entries ------------------------
    @classmethod
    def from_bench_report(cls, report: dict, *,
                          source_name: str = "") -> "TuningTable":
        """Fold a ``repro_torch.bench`` report's per-cell medians +
        ``autotune`` winners into measured entries: one entry per (family,
        topology signature, dtype, elems) cell, ranking every scheme the
        sweep timed there by its (autotuned-best) median.  The header
        carries the card the report was taken on."""
        entries = []
        for (family, sig, dtype, nbytes), cell in sorted(
                bench_cells(report).items()):
            ranking = tuple(sorted(
                (Choice(scheme=s, opts=dict(opts), median_us=med)
                 for s, (med, opts) in cell["schemes"].items()),
                key=lambda c: (c.median_us, c.scheme)))
            entries.append(TuningEntry(
                family=family, topo=sig, dtype=dtype, nbytes=nbytes,
                source="measured", ranking=ranking, label=cell["label"]))
        meta = {"generated_by":
                "python -m repro_torch.bench --emit-tuning-table",
                "generated_from": source_name or report.get("generated_by",
                                                            ""),
                "bench_schema": report.get("schema"),
                "backend": report.get("backend"),
                "device": report.get("device"),
                "nvidia_smi": report.get("nvidia_smi"),
                "torch_version": report.get("torch_version"),
                "cuda_version": report.get("cuda_version"),
                "measured_on": MEASURED_ON,
                "sweep": report.get("sweep")}
        return cls(entries=tuple(entries), meta=meta)


def bench_cells(report: dict) -> dict[tuple, dict]:
    """A bench report regrouped into tuning cells: ``(family, topology
    signature, dtype, nbytes) -> {"label", "schemes": {scheme: (median_us,
    best_opts)}}``.  The shared keying of ``from_bench_report`` and the
    ``repro_torch.bench.validate`` winner cross-check."""
    schema = str(report.get("schema", ""))
    if not schema.startswith("repro_torch.bench/"):
        raise ValueError(f"not a repro_torch.bench report "
                         f"(schema={schema!r})")
    cells: dict[tuple, dict] = {}
    for case in report.get("cases", []):
        sig = topo_signature(case["pods"], case["chips"], case["fast_axes"])
        key = (case["family"], sig, case["dtype"],
               int(case["bytes_per_rank"]))
        opts = (case["autotune"] or {}).get("best", {}) \
            if case.get("autotune") else {}
        cell = cells.setdefault(key, {"label": case["topology"],
                                      "schemes": {}})
        cell["schemes"][case["scheme"]] = (
            float(case["timing"]["median_us"]), dict(opts))
    return cells


# ---------------------------------------------------------------------------
# The active table (process-wide; tests swap it with ``use_table``)
# ---------------------------------------------------------------------------

_ENV_VAR = "REPRO_TORCH_TUNING_TABLE"
_DEFAULT_PATH = pathlib.Path(__file__).resolve().parents[1] \
    / "artifacts" / "TUNING_h100.json"
_active: Optional[TuningTable] = None
_default_cache: Optional[TuningTable] = None


def default_table_path() -> pathlib.Path:
    """The committed H100 table, overridable via
    ``REPRO_TORCH_TUNING_TABLE``."""
    env = os.environ.get(_ENV_VAR)
    return pathlib.Path(env) if env else _DEFAULT_PATH


def default_table() -> TuningTable:
    """The committed table (cached); an EMPTY table when the file does not
    exist — every auto dispatch then takes the modeled path."""
    global _default_cache
    if _default_cache is None:
        path = default_table_path()
        _default_cache = TuningTable.load(path) if path.exists() \
            else TuningTable()
    return _default_cache


def active_table() -> TuningTable:
    return _active if _active is not None else default_table()


@contextlib.contextmanager
def use_table(table: Optional[TuningTable]):
    """Swap the process-wide active table (``None`` = empty: force the
    modeled path)."""
    global _active
    prev = _active
    _active = table if table is not None else TuningTable()
    try:
        yield
    finally:
        _active = prev


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Resolution:
    """The outcome of one ``scheme="auto"`` dispatch decision."""

    scheme: str
    opts: dict
    source: str                    # "measured" | "modeled" | "fallback"
    entry: Optional[TuningEntry] = None


def _usable(sch, family: str, result_class: Optional[str], pods: int,
            chips: int, elems: int, precision: str = "exact",
            tol: Optional[float] = None, payload_dims: int = 1):
    """The scheme's valid tunable grid for this cell, or ``None`` when the
    caller's result-class / precision constraint, the cell's tiling or a
    payload of fewer dims than the scheme splits (``payload_dims``, the
    dims of one rank's payload) rules it out.  ``precision="exact"``
    filters lossy schemes out entirely; ``"lossy"`` admits them unless
    their ``error_bound_rel`` exceeds ``tol``."""
    if result_class is not None and sch.result_class != result_class:
        return None
    if payload_dims < sch.min_payload_dims(family):
        return None
    if sch.precision == "lossy":
        if precision != "lossy":
            return None
        if tol is not None and pods \
                and sch.error_bound_rel(family, pods=pods) > tol:
            return None
    cands = sch.candidates(family, pods=pods, chips=chips, elems=elems)
    return cands or None


def best_scheme_predicted(family: str, *, pods: int, chips: int, elems: int,
                          elem_bytes: int = 4,
                          result_class: Optional[str] = None,
                          precision: str = "exact",
                          tol: Optional[float] = None,
                          populations: Optional[Sequence[int]] = None,
                          payload_dims: int = 1
                          ) -> Optional[tuple[str, dict, float]]:
    """Model-predicted (scheme, opts, time) for one cell; ties go to the
    first registered scheme."""
    best = None
    for sch in registry.schemes_for(family):
        if _usable(sch, family, result_class, pods, chips, elems,
                   precision, tol, payload_dims) is None:
            continue
        pred = sch.predicted_time(family, pods=pods, chips=chips,
                                  elems=elems, elem_bytes=elem_bytes,
                                  populations=populations)
        if pred is None:
            continue
        t, opts = pred
        if best is None or t < best[2]:
            best = (sch.name, dict(opts), t)
    return best


#: Static-fallback overrides under ``precision="lossy"``: a communicator
#: with no pods/chips counts is all bridge (the gradient-bridge path), so
#: lossy opt-in means "compress that bridge" — the q8 wire format, run
#: single-tier.  Other families keep the exact fallback (lossy *admits*
#: quantized schemes, it never requires one).
LOSSY_FALLBACK = {"psum": "q8_hier", "allgather": "q8_hier"}


def resolve(family: str, *, pods: Optional[int], chips: Optional[int],
            elems: int, elem_bytes: int = 4, dtype: str = "float32",
            n_fast_axes: int = 1, result_class: Optional[str] = None,
            precision: str = "exact", tol: Optional[float] = None,
            table: Optional[TuningTable] = None,
            payload_dims: int = 1) -> Resolution:
    """Resolve one ``scheme="auto"`` dispatch (measured -> modeled ->
    fallback).  ``result_class`` constrains the pick to one result class;
    ``precision`` / ``tol`` to exact schemes or admitted lossy ones;
    ``payload_dims`` (the dims of one rank's payload) to the schemes that
    can take it, so a per-rank scalar skips the measured split schemes."""
    if result_class not in (None, "replicated", "shared"):
        raise ValueError(f"bad result constraint {result_class!r}")
    if precision not in ("exact", "lossy"):
        raise ValueError(f"bad precision constraint {precision!r} "
                         "(pick 'exact' or 'lossy')")
    table = table if table is not None else active_table()
    if pods and chips:
        entry = table.lookup(family, topo_signature(pods, chips,
                                                    n_fast_axes),
                             dtype, elems * elem_bytes)
        if entry is not None:
            for choice in entry.ranking:
                try:
                    sch = registry.get_scheme(choice.scheme)
                except KeyError:
                    continue           # table from a build with more schemes
                cands = _usable(sch, family, result_class, pods, chips,
                                elems, precision, tol, payload_dims)
                if cands is None:
                    continue
                opts = dict(choice.opts)
                if opts and opts not in [dict(c) for c in cands]:
                    # recorded tunables do not tile THIS size: re-predict
                    # them from the closed form instead of mis-lowering
                    pred = sch.predicted_time(family, pods=pods,
                                              chips=chips, elems=elems,
                                              elem_bytes=elem_bytes)
                    opts = dict(pred[1]) if pred else dict(cands[0])
                return Resolution(sch.name, opts, entry.source, entry)
        best = best_scheme_predicted(family, pods=pods, chips=chips,
                                     elems=elems, elem_bytes=elem_bytes,
                                     result_class=result_class,
                                     precision=precision, tol=tol,
                                     payload_dims=payload_dims)
        if best is not None:
            return Resolution(best[0], best[1], "modeled")
        raise ValueError(
            f"no registered scheme can run {family} with elems={elems} on "
            f"a {pods}x{chips} topology"
            + (f" under result={result_class!r}" if result_class else "")
            + " — every candidate grid is empty (tiling)")
    name = None
    if precision == "lossy":
        cand = LOSSY_FALLBACK.get(family)
        if cand is not None and result_class in (
                None, registry.get_scheme(cand).result_class):
            name = cand
    if name is None:
        try:
            name = FALLBACK[result_class][family]
        except KeyError:
            raise ValueError(
                f"scheme='auto' cannot resolve {family} under "
                f"result={result_class!r} without static pods/chips counts"
            ) from None
    return Resolution(name, {}, "fallback")


def resolve_for(comm, family: str, *, elems: int, elem_bytes: int = 4,
                dtype: str = "float32", result_class: Optional[str] = None,
                precision: str = "exact", tol: Optional[float] = None,
                table: Optional[TuningTable] = None,
                payload_dims: int = 1) -> Resolution:
    """``resolve`` keyed by a ``Communicator``'s static structure."""
    from repro_torch.comm import primitives as p
    return resolve(family, pods=comm.pods, chips=comm.chips, elems=elems,
                   elem_bytes=elem_bytes, dtype=dtype,
                   n_fast_axes=len(p._axes(comm.fast_axis)),
                   result_class=result_class, precision=precision, tol=tol,
                   table=table, payload_dims=payload_dims)


# ---------------------------------------------------------------------------
# Signature re-resolution (the elastic-rebuild surface)
# ---------------------------------------------------------------------------

logger = logging.getLogger("repro_torch.comm.tuning")


def signature_for(comm) -> str:
    """The topology signature of a ``Communicator`` — the key that changes
    when an elastic rebuild shrinks or grows the cluster."""
    from repro_torch.comm import primitives as p
    if comm.pods is None or comm.chips is None:
        raise ValueError("topology signature needs static pods/chips counts "
                         "— build the communicator via from_cluster/"
                         "from_topology")
    return topo_signature(comm.pods, comm.chips,
                          len(p._axes(comm.fast_axis)))


@dataclasses.dataclass(frozen=True)
class RetuneReport:
    """What ``scheme="auto"`` now resolves to on a (possibly new) topology
    signature: one row per (family, elems) the caller is about to
    dispatch.  After a shrink onto a signature the bench never swept,
    every row is ``modeled`` — the designed degradation, not an error."""

    signature: str
    rows: tuple[tuple[str, int, Resolution], ...]   # (family, elems, res)

    @property
    def sources(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for _, _, res in self.rows:
            out[res.source] = out.get(res.source, 0) + 1
        return out

    def scheme_for(self, family: str) -> Optional[str]:
        for fam, _, res in self.rows:
            if fam == family:
                return res.scheme
        return None


def retune_for(comm, families: Sequence[str], elems_list: Sequence[int], *,
               elem_bytes: int = 4, dtype: str = "float32",
               result_class: Optional[str] = None,
               table: Optional[TuningTable] = None) -> RetuneReport:
    """Re-resolve ``scheme="auto"`` for a rebuilt communicator and log every
    decision, so the measured -> modeled fallback for an unseen signature
    is visible instead of silently changing schedules."""
    sig = signature_for(comm)
    known = (table if table is not None else active_table()).signatures()
    if sig not in known:
        logger.info("retune %s: signature not in tuning table %s — "
                    "expect modeled (closed-form) resolutions", sig,
                    list(known))
    rows = []
    for family in families:
        for elems in elems_list:
            res = resolve_for(comm, family, elems=elems,
                              elem_bytes=elem_bytes, dtype=dtype,
                              result_class=result_class, table=table)
            logger.info("retune %s: %s elems=%d -> scheme=%s (%s)",
                        sig, family, elems, res.scheme, res.source)
            rows.append((family, int(elems), res))
    return RetuneReport(signature=sig, rows=tuple(rows))


def modeled_entries(families: Iterable[str], *, pods: int, chips: int,
                    elems_list: Sequence[int], elem_bytes: int = 4,
                    dtype: str = "float32", n_fast_axes: int = 1
                    ) -> tuple[TuningEntry, ...]:
    """Cold-start table rows for an unmeasured topology: one ``modeled``
    entry per (family, size), ranking every runnable scheme by its
    ``predicted_time``."""
    out = []
    sig = topo_signature(pods, chips, n_fast_axes)
    for family in families:
        for elems in elems_list:
            ranked = []
            for sch in registry.schemes_for(family):
                pred = sch.predicted_time(family, pods=pods, chips=chips,
                                          elems=elems,
                                          elem_bytes=elem_bytes)
                if pred is None:
                    continue
                t, opts = pred
                ranked.append((t, Choice(sch.name, dict(opts))))
            if ranked:
                ranked.sort(key=lambda tc: (tc[0], tc[1].scheme))
                out.append(TuningEntry(
                    family=family, topo=sig, dtype=dtype,
                    nbytes=elems * elem_bytes, source="modeled",
                    ranking=tuple(c for _, c in ranked),
                    label=f"{pods}x{chips}"))
    return tuple(out)
