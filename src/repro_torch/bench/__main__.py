"""CLI: ``python -m repro_torch.bench [--quick] [--reps N] [--out PATH]``.

Runs the matrix-driven collective sweep on one device (``--device``,
default ``cuda``; every rank of a topology stacked on it), cross-checks
every measured config against the registry's closed forms (any mismatch
exits non-zero) and writes the schema-versioned JSON report.  ``--csv``
also prints the ``name,us_per_call,derived`` rows.

``--emit-tuning-table`` instead FOLDS an existing report (``--bench``) into
the table ``scheme="auto"`` dispatches through (``--table-out``) — no
re-measurement.  The fold is self-checked: every emitted winner must hold
the best median of the very report it came from
(``validate.tuning_table_checks``).

Regenerating the committed H100 artifacts (on the card):

    python -m repro_torch.bench --summaries-only \\
        --out src/repro_torch/artifacts/BENCH_collectives_h100.json
    python -m repro_torch.bench --emit-tuning-table \\
        --bench src/repro_torch/artifacts/BENCH_collectives_h100.json \\
        --table-out src/repro_torch/artifacts/TUNING_h100.json
"""

from __future__ import annotations

import argparse
import json
import sys

_ARTIFACT_BENCH = "src/repro_torch/artifacts/BENCH_collectives_h100.json"


def emit_tuning_table(bench_path: str, table_out: str, log=print) -> int:
    from repro_torch.bench.validate import tuning_table_checks
    from repro_torch.comm.tuning import TuningTable

    with open(bench_path) as f:
        rep = json.load(f)
    table = TuningTable.from_bench_report(rep, source_name=bench_path)
    bad = [ch for ch in tuning_table_checks(table, rep) if not ch.ok]
    if bad:
        print(f"repro_torch.bench: tuning-table fold FAILED {len(bad)} "
              "winner cross-check(s) against its own report:",
              file=sys.stderr)
        for ch in bad:
            print(f"  {ch.name}: expected {ch.expected}, measured "
                  f"{ch.measured} ({ch.note})", file=sys.stderr)
        return 1
    table.save(table_out)
    measured = sum(1 for e in table.entries if e.source == "measured")
    log(f"repro_torch.bench: wrote {table_out} ({measured} measured "
        f"entries over {len(table.signatures())} topology signatures, "
        f"folded from {bench_path})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench",
        description="matrix-driven collective benchmarks with "
                    "traffic-model cross-checks")
    ap.add_argument("--quick", action="store_true",
                    help="reduced sweep: two message sizes, 5 reps")
    ap.add_argument("--out", default="BENCH_torch_fresh.json",
                    help="JSON report path (default %(default)s)")
    ap.add_argument("--csv", action="store_true",
                    help="also print name,us_per_call,derived rows")
    ap.add_argument("--device", default="cuda",
                    help="the device every rank is stacked on "
                         "(default %(default)s)")
    ap.add_argument("--max-devices", type=int, default=8,
                    help="cap the topology matrix (default %(default)s)")
    ap.add_argument("--topologies", default=None,
                    help="comma list of matrix labels (e.g. 2x4,1x8)")
    ap.add_argument("--families", default=None,
                    help="comma list: allgather,broadcast,psum,"
                         "reduce_scatter,allgatherv,alltoall")
    ap.add_argument("--schemes", default=None,
                    help="comma list of registry scheme names")
    ap.add_argument("--elems", default=None,
                    help="comma list of message sizes in elems, overriding "
                         "the quick/full defaults")
    ap.add_argument("--dtypes", default="float32,bfloat16",
                    help="comma list of payload dtypes; non-float32 "
                         "entries sweep only allgather and psum "
                         "(default %(default)s)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed reps per case (default 30, quick 5)")
    ap.add_argument("--min-rep-s", type=float, default=0.0,
                    help="calibrate an inner loop so every timed rep lasts "
                         "at least this many seconds")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the traffic-model cross-checks")
    ap.add_argument("--summaries-only", action="store_true",
                    help="write passing checks without their notes and the "
                         "autotune winner without its grid (the committed "
                         "artifact's form)")
    ap.add_argument("--emit-tuning-table", action="store_true",
                    help="fold an existing report (--bench) into the "
                         "scheme='auto' tuning table (--table-out) and "
                         "exit — runs no sweep")
    ap.add_argument("--bench", default=_ARTIFACT_BENCH,
                    help="input report for --emit-tuning-table "
                         "(default %(default)s)")
    ap.add_argument("--table-out", default="TUNING_torch_fresh.json",
                    help="tuning-table path for --emit-tuning-table "
                         "(default %(default)s)")
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr)

    if args.emit_tuning_table:
        return emit_tuning_table(args.bench, args.table_out, log=log)

    import torch

    from repro_torch.bench import report, suites
    from repro_torch.bench.validate import BenchValidationError
    from repro_torch.substrate import default_matrix

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("repro_torch.bench: no CUDA device (pass --device cpu)")
        return 1
    families = tuple(args.families.split(",")) if args.families \
        else suites.COLLECTIVE_FAMILIES
    schemes = tuple(args.schemes.split(",")) if args.schemes else None
    if args.elems:
        elems = tuple(int(e) for e in args.elems.split(","))
    else:
        elems = suites.QUICK_ELEMS if args.quick else suites.FULL_ELEMS
    reps = args.reps if args.reps is not None else (5 if args.quick else 30)
    if reps < 1:
        ap.error(f"--reps must be >= 1, got {reps}")
    dtypes = tuple(args.dtypes.split(","))
    clusters = default_matrix(args.max_devices, device=device)
    if args.topologies:
        want = args.topologies.split(",")
        unknown = set(want) - {vc.label for vc in clusters}
        if unknown:
            ap.error(f"unknown topologies {sorted(unknown)}; the matrix "
                     f"has {[vc.label for vc in clusters]}")
        clusters = tuple(vc for vc in clusters if vc.label in want)

    cases = suites.build_cases(
        clusters=clusters, families=families, elems=elems, schemes=schemes,
        dtypes=dtypes, on_skip=lambda msg: log(f"repro_torch.bench: {msg}"))
    log(f"repro_torch.bench: {len(cases)} cases over "
        f"{len({c.topology for c in cases})} topologies x {elems} elems x "
        f"dtypes {dtypes} (reps={reps}) on {device}")
    try:
        suite = suites.run_suite(cases, reps=reps, min_rep_s=args.min_rep_s,
                                 validate=not args.no_validate, log=log)
    except BenchValidationError as e:
        log(f"repro_torch.bench: {e}")
        return 1

    rep = report.to_report(suite, quick=args.quick, reps=reps,
                           families=families, elems=elems, dtypes=dtypes,
                           device=device,
                           summaries_only=args.summaries_only)
    report.write_report(rep, args.out)
    if args.csv:
        for row in report.csv_rows(suite):
            print(row)
    ok = rep["validation"]["ok"]
    eager = sum(1 for c in rep["cases"] if c["timing"]["mode"] == "eager")
    log(f"repro_torch.bench: wrote {args.out} ({len(rep['cases'])} cases, "
        f"validation {'OK' if ok else 'FAILED'}, "
        f"{rep['validation']['num_checks']} checks; timed eagerly: "
        f"{eager})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
