"""Schema-versioned benchmark report + the ``name,us_per_call,derived`` CSV
rows.

Structure (``repro_torch.bench/v1``):

* top level — ``schema``, the environment (``backend``, the card's name
  and its ``nvidia-smi`` name / power limit, the torch and CUDA versions),
  the sweep parameters and the topology-matrix labels;
* ``cases[]`` — one record per measured config: identity (family, scheme,
  topology, pods, chips, elems, dtype), ``timing`` (median / mean / min /
  max / iqr / p50 / p99 us, reps, inner, ``mode``: ``graph`` for CUDA-graph
  replays or ``eager``, ``clock``), ``traffic`` (the plans model),
  ``record`` (the substrate's link bytes and the measured resident bytes),
  the per-case ``checks`` and, in a ``serving`` case only, ``serving``
  (the load model's tokens/s and per-token p50 / p99 at the median);
* ``cross_checks[]`` — the C1 resident-memory invariants across schemes;
* ``validation`` — the verdict (``ok: true`` in a written file: a mismatch
  raises before the report is written).

``summaries_only`` drops the notes of passing checks and the autotune
grids (each candidate's median stays), keeping every number a table or a
gate reads.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from typing import Optional, Sequence

import torch

from repro_torch.bench import SCHEMA_VERSION
from repro_torch.bench.suites import CaseResult, SuiteResult


def case_record(r: CaseResult) -> dict:
    c = r.case
    rec = {
        "name": c.name,
        "csv_name": c.csv_name,
        "family": c.family,
        "scheme": c.scheme,
        "topology": c.topology,
        "pods": c.cluster.pods,
        "chips": c.cluster.chips,
        "elems": c.elems,
        "bytes_per_rank": c.elems * c.elem_bytes,
        "dtype": c.dtype,
        "fast_axes": len(c.cluster.fast_names),
        "populations": list(c.populations) if c.populations else None,
        "timing": r.timing.to_dict(),
        "traffic": dataclasses.asdict(c.traffic),
        "record": r.record,
        "checks": [ch.to_dict() for ch in r.checks],
        "autotune": r.autotune,
        "ok": all(ch.ok for ch in r.checks),
    }
    if c.family == "serving":
        # the open-loop Poisson load model priced by the measured step
        # median: tokens/s and p50 / p99 per-token latency per topology
        from repro_torch.bench.serving import serving_metrics
        rec["serving"] = serving_metrics(r.timing.median_us)
    return rec


def copies_per_node(r: CaseResult) -> int:
    """How many copies of the FULL result a node holds (naive: one per
    rank; shared: one — paper C1)."""
    c = r.case
    eb = c.elem_bytes
    if c.family in ("allgather", "alltoall"):
        full = c.cluster.num_devices * c.elems * eb
    elif c.family == "allgatherv":
        full = sum(c.populations) * c.elems * eb
    elif c.family == "reduce_scatter":
        full = c.elems * eb // c.cluster.pods
    else:                       # broadcast / psum: the message itself
        full = c.elems * eb
    return c.traffic.result_bytes_per_node // full


def csv_rows(suite: SuiteResult) -> list[str]:
    """``name,us_per_call,derived`` rows."""
    rows = []
    for r in suite.cases:
        t = r.case.traffic
        derived = (f"slow_bytes={t.slow_bytes};fast_bytes={t.fast_bytes};"
                   f"result_bytes_per_node={t.result_bytes_per_node};"
                   f"copies_per_node={copies_per_node(r)}")
        rows.append(f"{r.case.csv_name},{r.timing.median_us:.1f},{derived}")
    return rows


def nvidia_smi() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (``None`` where there is no ``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def environment(device: torch.device) -> dict:
    """The header fields every report and table carries."""
    cuda = device.type == "cuda"
    return {
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "nvidia_smi": nvidia_smi() if cuda else None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": sys.version.split()[0],
    }


def to_report(suite: SuiteResult, *, quick: bool, reps: int,
              families: Sequence[str], elems: Sequence[int],
              dtypes: Sequence[str], device: torch.device,
              summaries_only: bool = False) -> dict:
    matrix = sorted({r.case.topology for r in suite.cases})
    n_checks = sum(len(r.checks) for r in suite.cases) + \
        len(suite.cross_checks)
    cases = [case_record(r) for r in suite.cases]
    if summaries_only:
        for rec in cases:
            for ch in rec["checks"]:
                if ch["ok"]:
                    del ch["note"]
            if rec["autotune"]:
                del rec["autotune"]["param_grid"]
    return {
        "schema": SCHEMA_VERSION,
        "generated_by": "python -m repro_torch.bench",
        **environment(device),
        "measured_on": "every rank of a topology stacked on one device: "
                       "the times rank device copies, not links",
        "sweep": {"quick": quick, "reps": reps,
                  "families": list(families), "elems": list(elems),
                  "dtypes": list(dtypes)},
        "matrix": matrix,
        "cases": cases,
        "cross_checks": [ch.to_dict() for ch in suite.cross_checks],
        "validation": {
            "ok": all(ch.ok for r in suite.cases for ch in r.checks)
                  and all(ch.ok for ch in suite.cross_checks),
            "num_checks": n_checks,
            "invariants": {
                "C1": "naive/shared resident-result bytes per node ratio "
                      "== ranks_per_node (measured on the device)",
                "links": "recorded link bytes (ring model) == the "
                         "scheme's links() closed form",
            },
        },
    }


def write_report(report: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=False)
        f.write("\n")
