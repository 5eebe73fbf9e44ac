"""Standard-library gates over the port's bench reports, tuning tables and
step-graph schedule reports.

    python -m repro_torch.bench.gates regression BASELINE FRESH [--tol 3.0]
    python -m repro_torch.bench.gates tuning TABLE --schema-only
    python -m repro_torch.bench.gates tuning TABLE --bench FRESH [--tol 3.0]
    python -m repro_torch.bench.gates schedule SCHEDULE.json

They import nothing beyond ``json`` / ``argparse`` (the package ``__init__``
files import nothing either), so they run where torch is not installed.

* **regression** — fresh medians against a baseline report, normalized
  within each run: every case's median over its (family, topology, elems,
  dtype) group's reference-scheme median (``naive`` where present) from the
  SAME file; a case regresses when ``fresh_norm > base_norm * tol``.  A
  machine-factor pass covers the reference scheme itself (raw fresh/base
  ratio against the median raw ratio, at ``2 * tol``), a p99 pass gates
  ``timing.p99_us`` the same way at ``2 * tol``, and an error-bound pass
  holds every fresh ``error/bound`` check (a fresh report with quantized
  cases but no such check fails).  Zero overlapping cells is a failure.
* **tuning** — ``--schema-only``: the table's structure (schema, required
  fields, rankings sorted by median, known ``source`` tags, positive
  sizes).  ``--bench``: staleness — every measured cell present in both the
  table and a fresh report must have its table winner within ``tol``x of
  the fresh run's best median; zero overlap fails.
* **schedule** — byte conservation, message-count reduction, buckets of at
  least two members, issue order covering exactly the rewritten schedule
  with gathers first, and at least one multi-pod schedule that reduced the
  message count.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

BENCH_SCHEMA_PREFIX = "repro_torch.bench/"
TUNING_SCHEMA = "repro_torch.tuning/v1"
SCHEDULE_SCHEMA = "repro_torch.stepgraph/v1"


# ---------------------------------------------------------------------------
# regression
# ---------------------------------------------------------------------------

def _cells(report: dict, stat: str = "median_us") -> dict[tuple, float]:
    """(family, scheme, topology, elems, dtype) -> ``timing[stat]``."""
    out = {}
    for case in report.get("cases", []):
        key = (case["family"], case["scheme"], case["topology"],
               case["elems"], case.get("dtype", "float32"))
        val = case["timing"].get(stat)
        if val is not None and float(val) > 0:
            out[key] = float(val)
    return out


def _group_reference(cells: dict[tuple, float]) -> dict[tuple, str]:
    """(family, topology, elems, dtype) -> reference scheme (``naive``
    where present, else the lexicographic first)."""
    groups: dict[tuple, list[str]] = {}
    for (fam, sch, topo, elems, dt) in cells:
        groups.setdefault((fam, topo, elems, dt), []).append(sch)
    return {g: ("naive" if "naive" in ss else sorted(ss)[0])
            for g, ss in groups.items()}


def compare(base: dict, fresh: dict, tol: float
            ) -> tuple[list[str], list[str]]:
    """Returns (table_rows, failures)."""
    bc, fc = _cells(base), _cells(fresh)
    common = sorted(set(bc) & set(fc))
    if not common:
        return [], ["no overlapping (family, scheme, topology, elems, "
                    "dtype) cells between baseline and fresh report"]
    refs = _group_reference({k: bc[k] for k in common})
    rows, failures = [], []

    def ref_key(key):
        fam, _, topo, elems, dt = key
        return (fam, refs[(fam, topo, elems, dt)], topo, elems, dt)

    def name(key):
        fam, sch, topo, elems, dt = key
        return f"{fam}/{sch}/{topo}/e{elems}/{dt}"

    for key in common:
        base_ref, fresh_ref = bc.get(ref_key(key)), fc.get(ref_key(key))
        if not base_ref or not fresh_ref:
            continue
        base_norm, fresh_norm = bc[key] / base_ref, fc[key] / fresh_ref
        ok = fresh_norm <= base_norm * tol
        rows.append(f"  {name(key)}: base {base_norm:.2f}x fresh "
                    f"{fresh_norm:.2f}x {ref_key(key)[1]} "
                    f"{'ok' if ok else 'REGRESSED'}")
        if not ok:
            failures.append(f"{name(key)}: {fresh_norm:.2f}x "
                            f"{ref_key(key)[1]} vs baseline "
                            f"{base_norm:.2f}x (tol {tol}x)")
    # machine-factor pass over the reference cells (normalized value 1.0 by
    # construction: the normalized pass's blind spot)
    raw_tol = 2.0 * tol
    factor = statistics.median(fc[k] / bc[k] for k in common)
    rows.append(f"  machine speed factor (median raw fresh/base): "
                f"{factor:.2f}x")
    for key in common:
        if key != ref_key(key):
            continue
        raw = fc[key] / bc[key]
        if raw > factor * raw_tol:
            failures.append(
                f"{name(key)}: reference-scheme raw {raw:.2f}x vs machine "
                f"factor {factor:.2f}x (raw tol {raw_tol}x)")
    # p99 pass over cells both files carry it
    p99_tol = 2.0 * tol
    bp, fp = _cells(base, "p99_us"), _cells(fresh, "p99_us")
    compared = 0
    for key in sorted(set(bp) & set(fp) & set(common)):
        base_ref, fresh_ref = bp.get(ref_key(key)), fp.get(ref_key(key))
        if not base_ref or not fresh_ref:
            continue
        compared += 1
        base_norm, fresh_norm = bp[key] / base_ref, fp[key] / fresh_ref
        if fresh_norm > base_norm * p99_tol:
            failures.append(f"{name(key)}: p99 {fresh_norm:.2f}x vs "
                            f"baseline {base_norm:.2f}x (p99 tol "
                            f"{p99_tol}x)")
    rows.append(f"  p99 pass: {compared} cells gated at {p99_tol}x"
                if compared else "  p99 pass: skipped (no p99_us)")
    return rows, failures


def error_bound_pass(fresh: dict) -> tuple[list[str], list[str]]:
    """Every fresh ``error/bound`` check must hold; quantized cases
    (``q``-prefixed schemes) without any such check fail."""
    failures = []
    n_bound = quantized = 0
    for case in fresh.get("cases", []):
        if str(case.get("scheme", "")).startswith("q"):
            quantized += 1
        for ch in case.get("checks", []):
            if ch.get("name") != "error/bound":
                continue
            n_bound += 1
            if not ch.get("ok", False):
                failures.append(
                    f"{case['name']}: measured quantization error "
                    f"{ch.get('measured')} exceeds declared bound "
                    f"{ch.get('expected')}")
    if quantized and not n_bound:
        failures.append(f"fresh report has {quantized} quantized cases but "
                        "no error/bound checks")
    rows = [f"  error-bound pass: {n_bound} checks over {quantized} "
            "quantized cases"]
    return rows, failures


# ---------------------------------------------------------------------------
# tuning
# ---------------------------------------------------------------------------

ENTRY_FIELDS = ("family", "topo", "dtype", "nbytes", "source", "ranking")


def schema_errors(table: dict) -> list[str]:
    if table.get("schema") != TUNING_SCHEMA:
        return [f"schema is {table.get('schema')!r}, want {TUNING_SCHEMA!r}"]
    entries = table.get("entries")
    if not isinstance(entries, list) or not entries:
        return ["table has no entries"]
    errs: list[str] = []
    seen: set[tuple] = set()
    for i, e in enumerate(entries):
        missing = [f for f in ENTRY_FIELDS if f not in e]
        if missing:
            errs.append(f"entries[{i}]: missing fields {missing}")
            continue
        tag = f"{e['family']}/{e['topo']}/{e['dtype']}/b{e['nbytes']}"
        key = (e["family"], e["topo"], e["dtype"], e["nbytes"])
        if key in seen:
            errs.append(f"{tag}: duplicate cell")
        seen.add(key)
        if e["source"] not in ("measured", "modeled"):
            errs.append(f"{tag}: bad source {e['source']!r}")
        if not isinstance(e["nbytes"], int) or e["nbytes"] <= 0:
            errs.append(f"{tag}: bad nbytes {e['nbytes']!r}")
        ranking = e["ranking"]
        if not isinstance(ranking, list) or not ranking:
            errs.append(f"{tag}: empty ranking")
            continue
        for c in ranking:
            if "scheme" not in c or not isinstance(c.get("opts", {}), dict):
                errs.append(f"{tag}: malformed choice {c!r}")
        if e["source"] == "measured":
            meds = [c.get("median_us") for c in ranking]
            if any(m is None for m in meds):
                errs.append(f"{tag}: measured entry without medians")
            elif meds != sorted(meds):
                errs.append(f"{tag}: ranking not sorted by median")
    return errs


def _signature(case: dict) -> str:
    # mirrors repro_torch.comm.tuning.topo_signature (import-free by design)
    sig = f"{case['pods']}x{case['chips']}"
    if case["fast_axes"] > 1:
        sig += f"-f{case['fast_axes']}"
    return sig


def staleness_failures(table: dict, bench: dict, tol: float
                       ) -> tuple[list[str], list[str]]:
    """(report_rows, failures) of the winner-vs-fresh-best comparison."""
    cells: dict[tuple, dict[str, float]] = {}
    for case in bench.get("cases", []):
        key = (case["family"], _signature(case), case["dtype"],
               int(case["bytes_per_rank"]))
        cells.setdefault(key, {})[case["scheme"]] = \
            float(case["timing"]["median_us"])
    rows, failures = [], []
    compared = 0
    for e in table.get("entries", []):
        if e.get("source") != "measured":
            continue
        cell = cells.get((e["family"], e["topo"], e["dtype"],
                          int(e["nbytes"])))
        if not cell:
            continue
        compared += 1
        winner = e["ranking"][0]["scheme"]
        name = f"{e['family']}/{e['topo']}/{e['dtype']}/b{e['nbytes']}"
        if winner not in cell:
            failures.append(f"{name}: table winner {winner!r} not in the "
                            "fresh sweep — regenerate the table")
            continue
        best = min(cell.values())
        ratio = cell[winner] / best if best > 0 else 1.0
        ok = ratio <= tol
        rows.append(f"  {name}: winner {winner} {ratio:.2f}x fresh best "
                    f"{'ok' if ok else 'STALE'}")
        if not ok:
            failures.append(
                f"{name}: committed winner {winner!r} is {ratio:.2f}x the "
                f"fresh best ({min(cell, key=cell.get)!r}) — tol {tol}x")
    if not compared:
        failures.append("no overlapping (family, topology, dtype, size) "
                        "cells between the table and the fresh report")
    return rows, failures


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

REPORT_KEYS = {"schema", "nodes", "allreduce", "gather", "buckets",
               "singles", "order", "config", "topology", "pods", "chips",
               "elems"}
BUCKET_KEYS = {"axes", "dtype", "scheme", "count", "bytes", "padded_bytes",
               "target_bytes"}
ORDER_KINDS = {"bucket", "single", "gather"}


def check_report(r: dict, where: str) -> list[str]:
    """The failures of one schedule report (empty when it passes)."""
    bad: list[str] = []

    def fail(msg: str) -> None:
        bad.append(f"{where}: {msg}")

    missing = REPORT_KEYS - set(r)
    if missing:
        fail(f"missing keys {sorted(missing)}")
        return bad
    if r["schema"] != SCHEDULE_SCHEMA:
        fail(f"schema {r['schema']!r} != {SCHEDULE_SCHEMA!r}")
    ar, ga = r["allreduce"], r["gather"]
    if ar["after_bytes"] != ar["before_bytes"]:
        fail(f"bucketing changed payload bytes: {ar['before_bytes']} -> "
             f"{ar['after_bytes']} (must conserve)")
    if ar["after_messages"] > ar["before_messages"]:
        fail(f"rewrite INCREASED allreduce messages: "
             f"{ar['before_messages']} -> {ar['after_messages']}")
    if ga["after_issues"] > ga["before_issues"]:
        fail(f"dedup INCREASED gather issues: "
             f"{ga['before_issues']} -> {ga['after_issues']}")
    for i, b in enumerate(r["buckets"]):
        miss = BUCKET_KEYS - set(b)
        if miss:
            fail(f"bucket[{i}] missing keys {sorted(miss)}")
            continue
        if b["count"] < 2:
            fail(f"bucket[{i}] has {b['count']} member(s); buckets pack "
                 ">= 2 operands, singletons stay eager")
        if b["padded_bytes"] < b["bytes"]:
            fail(f"bucket[{i}] padded_bytes {b['padded_bytes']} < payload "
                 f"{b['bytes']}")
    n_bucketed = sum(b["count"] for b in r["buckets"])
    if n_bucketed + r["singles"] != ar["before_messages"]:
        fail(f"accounting: {n_bucketed} bucketed + {r['singles']} single "
             f"!= {ar['before_messages']} recorded allreduces")
    if len(r["buckets"]) + r["singles"] != ar["after_messages"]:
        fail(f"accounting: {len(r['buckets'])} buckets + {r['singles']} "
             f"singles != {ar['after_messages']} issued messages")
    kinds = [k for k, _ in r["order"]]
    if not set(kinds) <= ORDER_KINDS:
        fail(f"unknown order kinds {sorted(set(kinds) - ORDER_KINDS)}")
    if kinds.count("bucket") != len(r["buckets"]):
        fail(f"order has {kinds.count('bucket')} bucket issues for "
             f"{len(r['buckets'])} buckets")
    if kinds.count("single") != r["singles"]:
        fail(f"order has {kinds.count('single')} single issues for "
             f"{r['singles']} singles")
    if kinds.count("gather") != ga["after_issues"]:
        fail(f"order has {kinds.count('gather')} gather issues for "
             f"{ga['after_issues']} deduped gathers")
    if "gather" in kinds and kinds.index("gather") != 0:
        first_red = min(i for i, k in enumerate(kinds) if k != "gather")
        if any(k == "gather" for k in kinds[first_red:]):
            fail("gather issued after a reduction: the sink pass "
                 "front-loads all gather issues")
    return bad


def schedule_failures(doc: dict) -> list[str]:
    """The failures of a schedule document ``{"schema", "reports": [..]}``."""
    bad: list[str] = []
    if doc.get("schema") != SCHEDULE_SCHEMA:
        bad.append(f"top-level schema {doc.get('schema')!r} != "
                   f"{SCHEDULE_SCHEMA!r}")
    reports = doc.get("reports", [])
    if not reports:
        bad.append("no reports")
    for r in reports:
        bad.extend(check_report(r, f"{r.get('config')}@{r.get('topology')}"))
    multi = [r for r in reports if r.get("pods", 1) > 1]
    if multi and not any(r["allreduce"]["after_messages"]
                         < r["allreduce"]["before_messages"] for r in multi):
        bad.append("no multi-pod schedule shows a message-count reduction")
    return bad


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _is_bench(rep: dict) -> bool:
    return str(rep.get("schema", "")).startswith(BENCH_SCHEMA_PREFIX)


def _finish(what: str, rows: list[str], failures: list[str]) -> int:
    for r in rows:
        print(r)
    if failures:
        print(f"{what} FAILED:", file=sys.stderr)
        for f_ in failures:
            print(f"  {f_}", file=sys.stderr)
        return 1
    print(f"{what} OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.gates")
    sub = ap.add_subparsers(dest="gate", required=True)
    reg = sub.add_parser("regression", help="fresh medians vs a baseline")
    reg.add_argument("baseline")
    reg.add_argument("fresh")
    reg.add_argument("--tol", type=float, default=3.0)
    tun = sub.add_parser("tuning", help="table schema and staleness")
    tun.add_argument("table")
    tun.add_argument("--schema-only", action="store_true")
    tun.add_argument("--bench", default=None)
    tun.add_argument("--tol", type=float, default=3.0)
    sch = sub.add_parser("schedule", help="step-graph schedule reports")
    sch.add_argument("path")
    args = ap.parse_args(argv)

    if args.gate == "regression":
        base, fresh = _load(args.baseline), _load(args.fresh)
        for rep, name in ((base, args.baseline), (fresh, args.fresh)):
            if not _is_bench(rep):
                print(f"bench-regression: {name} is not a repro_torch.bench "
                      f"report (schema={rep.get('schema')!r})",
                      file=sys.stderr)
                return 1
        rows, failures = compare(base, fresh, args.tol)
        eb_rows, eb_failures = error_bound_pass(fresh)
        print(f"bench-regression: {len(rows)} rows (tol {args.tol}x, "
              "normalized within-run):")
        return _finish("bench-regression", rows + eb_rows,
                       failures + eb_failures)
    if args.gate == "tuning":
        table = _load(args.table)
        errs = schema_errors(table)
        if errs:
            return _finish(f"tuning-table check ({args.table})", [], errs)
        n = len(table["entries"])
        measured = sum(1 for e in table["entries"]
                       if e["source"] == "measured")
        print(f"tuning-table schema OK: {n} entries ({measured} measured) "
              f"in {args.table}")
        if args.schema_only:
            return 0
        if not args.bench:
            print("tuning-table check: pass --schema-only or --bench FRESH",
                  file=sys.stderr)
            return 2
        bench = _load(args.bench)
        if not _is_bench(bench):
            print(f"tuning-table check: {args.bench} is not a repro_torch."
                  f"bench report (schema={bench.get('schema')!r})",
                  file=sys.stderr)
            return 1
        rows, failures = staleness_failures(table, bench, args.tol)
        print(f"tuning-table staleness: {len(rows)} compared cells "
              f"(tol {args.tol}x):")
        return _finish("tuning-table staleness", rows, failures)
    doc = _load(args.path)
    bad = schedule_failures(doc)
    if not bad:
        reports = doc["reports"]
        before = sum(r["allreduce"]["before_messages"] for r in reports)
        after = sum(r["allreduce"]["after_messages"] for r in reports)
        print(f"schedule-report: {len(reports)} schedules, allreduce "
              f"messages {before} -> {after}")
    return _finish("schedule-report check", [], bad)


if __name__ == "__main__":
    raise SystemExit(main())
