"""The port's collective bench (``repro_torch.bench``) against the JAX
reference's (``repro.bench``), on the CPU.

Covered: the timer (one warm-up, calibration, bad reps refused), the sweep
building the reference's cases (names, traffic models, tunable grids,
skips) for the six collective families, validation failing on a wrong
traffic model and on a wrong lowering, the report schema, autotune picking
the best candidate, the standard-library gates on synthetic reports, and
``python -m repro_torch.bench --quick`` on one topology.  The card runs
the sweep in ``chip_smoke.py`` phase 10, where bodies are captured in CUDA
graphs.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.bench import suites as jsuites
from repro_torch.bench import SCHEMA_VERSION, gates, report, runner, suites
from repro_torch.bench.validate import BenchValidationError
from repro_torch.comm import stepgraph
from repro_torch.substrate import VirtualCluster

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
VC22 = VirtualCluster(pods=2, chips=2, device="cpu")


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def test_timer_one_warmup_then_reps():
    calls = []
    res = runner.timeit(lambda: calls.append(1), CPU, reps=4)
    assert len(calls) == 5                      # one warm-up + 4 reps
    assert res.reps == 4 and res.inner == 1
    assert res.min_us <= res.median_us <= res.max_us
    assert res.p50_us <= res.p99_us and res.iqr_us >= 0.0
    assert (res.mode, res.clock) == ("eager", "host")
    calls.clear()
    runner.timeit(lambda: calls.append(1), CPU, reps=3, warmup=False)
    assert len(calls) == 3


def test_timer_calibrates_and_rejects_bad_reps():
    assert runner.timeit(lambda: None, CPU, reps=2, min_rep_s=1e-3).inner > 1
    assert runner.timeit(lambda: None, CPU, reps=3, warmup=False,
                         min_rep_s=1e-3).inner > 1
    with pytest.raises(ValueError):
        runner.timeit(lambda: None, CPU, reps=0)
    assert runner.calibrate_inner(1.0, 0.0) == 1
    assert runner.calibrate_inner(1e-6, 1e-3, max_inner=8) == 8


# ---------------------------------------------------------------------------
# The sweep builds the reference's cases
# ---------------------------------------------------------------------------

def _case_rows(cases, traffic=True):
    return [(c.name, c.csv_name, c.family, c.scheme, c.topology, c.elems,
             c.dtype, tuple(dict(g) for g in c.tunable_grid),
             tuple(c.populations or ()),
             dataclasses.astuple(c.traffic) if traffic
             else c.traffic.result_bytes_per_node)
            for c in cases]


@pytest.mark.parametrize("dtypes", [("float32",), ("float32", "bfloat16")])
def test_cases_match_reference_build_cases(dtypes):
    """Same names, schemes, tunable grids, populations and traffic models
    (bf16 at the logical width: the reference prices its CPU backend's f32
    wire, the card moves bf16), and the same skipped cells."""
    skips, jskips = [], []
    cases = suites.build_cases(elems=(256, 1024), dtypes=dtypes,
                               device="cpu", on_skip=skips.append)
    jcases = jsuites.build_cases(families=suites.COLLECTIVE_FAMILIES,
                                 elems=(256, 1024), dtypes=dtypes,
                                 on_skip=jskips.append)
    exact = dtypes == ("float32",)
    assert _case_rows(cases, exact) == _case_rows(jcases, exact)
    assert skips == jskips
    assert len(cases) > 100


def test_unported_families_name_their_items():
    # every family is ported: serving builds its two schemes' cases (held
    # to the reference in tests/test_torch_serving_bench.py)
    cases = suites.build_cases(clusters=(VC22,), families=("serving",))
    assert sorted(c.scheme for c in cases) == ["recorded", "sync"]
    assert {c.family for c in cases} == {"serving"}
    with pytest.raises(ValueError, match="auto"):
        suites.build_cases(clusters=(VC22,), schemes=("auto",))
    with pytest.raises(ValueError, match="unknown schemes"):
        suites.build_cases(clusters=(VC22,), schemes=("warp",))


# ---------------------------------------------------------------------------
# Suite + report schema
# ---------------------------------------------------------------------------

_TOP_KEYS = {"schema", "generated_by", "backend", "device", "device_count",
             "nvidia_smi", "torch_version", "cuda_version", "python_version",
             "measured_on", "sweep", "matrix", "cases", "cross_checks",
             "validation"}
_CASE_KEYS = {"name", "csv_name", "family", "scheme", "topology", "pods",
              "chips", "elems", "bytes_per_rank", "dtype", "fast_axes",
              "populations", "timing", "traffic", "record", "checks",
              "autotune", "ok"}
_TIMING_KEYS = {"median_us", "mean_us", "min_us", "max_us", "iqr_us",
                "p50_us", "p99_us", "reps", "inner", "mode", "clock", "note"}
_RECORD_KEYS = {"fast_link_bytes_per_chip", "slow_link_bytes_per_chip",
                "fast_link_bytes_total", "slow_link_bytes_total", "by_op",
                "collectives", "result_bytes_per_node"}


@pytest.fixture(scope="module")
def small_suite():
    cases = suites.build_cases(clusters=(VC22,),
                               families=("allgather", "allgatherv"),
                               elems=(64,))
    return suites.run_suite(cases, reps=2)


def test_report_schema(small_suite):
    rep = report.to_report(small_suite, quick=True, reps=2,
                           families=("allgather", "allgatherv"),
                           elems=(64,), dtypes=("float32",), device=CPU)
    assert rep["schema"] == SCHEMA_VERSION and set(rep) == _TOP_KEYS
    assert (rep["backend"], rep["device"], rep["nvidia_smi"]) == \
        ("cpu", "cpu", None)
    assert rep["matrix"] == ["2x2"]
    assert len(rep["cases"]) == 9       # 4 exact + 3 lossy + 2 allgatherv
    for case in rep["cases"]:
        assert set(case) == _CASE_KEYS
        assert set(case["timing"]) == _TIMING_KEYS
        assert set(case["record"]) == _RECORD_KEYS
        assert case["ok"] is True and case["checks"]
    names = {ch["name"] for c in rep["cases"] for ch in c["checks"]}
    assert {"link/fast", "link/slow", "result/node", "model/result-node",
            "error/bound"} <= names
    assert rep["validation"]["ok"] is True
    assert [ch["name"] for ch in rep["cross_checks"]] == [
        "C1/allgather/2x2/e64"] + [
        f"C1/allgather/2x2/e64/{s}-replicates"
        for s in ("hier", "pipelined", "q8_hier", "qbf16_hier")]
    slim = report.to_report(small_suite, quick=True, reps=2,
                            families=("allgather",), elems=(64,),
                            dtypes=("float32",), device=CPU,
                            summaries_only=True)
    assert all("note" not in ch for c in slim["cases"]
               for ch in c["checks"])
    json.dumps(rep)
    rows = report.csv_rows(small_suite)
    by_name = {r.split(",")[0]: r for r in rows}
    assert by_name["allgather_naive_2x2_64"].endswith("copies_per_node=2")
    assert by_name["allgather_shared_2x2_64"].endswith("copies_per_node=1")


# ---------------------------------------------------------------------------
# Validation teeth: a mismatch fails the run
# ---------------------------------------------------------------------------

def _allgather(scheme):
    return next(c for c in suites.allgather_cases(VC22, 64)
                if c.scheme == scheme)


def test_validation_catches_a_wrong_traffic_model():
    shared = _allgather("shared")
    bad = dataclasses.replace(shared, traffic=dataclasses.replace(
        shared.traffic,
        result_bytes_per_node=shared.traffic.result_bytes_per_node + 4096))
    with pytest.raises(BenchValidationError, match="model/result-node"):
        suites.run_suite([bad], reps=1)


def test_validation_catches_a_wrong_lowering():
    """A case labelled 'shared' running the naive flat gather trips the
    link check and the measured C1 ratio."""
    naive, shared = _allgather("naive"), _allgather("shared")
    impostor = dataclasses.replace(naive, scheme="shared",
                                   traffic=shared.traffic)
    with pytest.raises(BenchValidationError) as e:
        suites.run_suite([naive, impostor], reps=1)
    assert "link/slow" in str(e.value) and "C1/allgather" in str(e.value)
    suite = suites.run_suite([naive, impostor], reps=1, validate=False)
    assert all(r.checks == [] for r in suite.cases) and \
        suite.cross_checks == []


def test_autotune_picks_the_best_candidate():
    (case,) = [c for c in suites.allgather_cases(VC22, 64)
               if c.scheme == "pipelined"]
    assert case.tunable_grid == ({"n_chunks": 1}, {"n_chunks": 2},
                                 {"n_chunks": 4}, {"n_chunks": 8})
    res = suites.run_suite([case], reps=2).cases[0]
    at = res.autotune
    assert [r["n_chunks"] for r in at["results"]] == [1, 2, 4, 8]
    assert res.timing.median_us == min(r["median_us"]
                                       for r in at["results"])
    assert at["best"] in at["param_grid"]
    naive = suites.run_suite([_allgather("naive")], reps=1).cases[0]
    assert naive.autotune is None


def test_indivisible_cells_skip_and_log():
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    skips = []
    cases = suites.build_cases(clusters=(vc,), elems=(6,),
                               on_skip=skips.append)
    built = {(c.family, c.scheme) for c in cases}
    assert ("psum", "shared") not in built and \
        ("allgather", "naive") in built
    assert any("psum/shared" in m for m in skips)
    suite = suites.run_suite(cases, reps=1)
    assert all(ch.ok for r in suite.cases for ch in r.checks)


# ---------------------------------------------------------------------------
# Gates on synthetic reports
# ---------------------------------------------------------------------------

def _fake(medians, p99=None, checks=None):
    return {"schema": SCHEMA_VERSION, "cases": [
        {"name": f"{f}/{s}/{t}/e{e}", "family": f, "scheme": s,
         "topology": t, "elems": e, "dtype": "float32",
         "timing": {"median_us": us,
                    **({"p99_us": p99[(f, s, t, e)]} if p99 else {})},
         "checks": (checks or {}).get(s, [])}
        for (f, s, t, e), us in medians.items()]}


N, P = ("allgather", "naive", "2x4", 1024), \
    ("allgather", "pipelined", "2x4", 1024)


@pytest.mark.parametrize("fresh,tol,ok", [
    ({N: 200.0, P: 160.0}, 3.0, True),       # uniformly slower machine
    ({N: 100.0, P: 320.0}, 3.0, False),      # pipelined 4x its group
    ({N: 100.0, P: 320.0}, 10.0, True),
])
def test_regression_gate_normalizes_within_run(fresh, tol, ok):
    _, failures = gates.compare(_fake({N: 100.0, P: 80.0}), _fake(fresh),
                                tol)
    assert (not failures) is ok


def test_regression_gate_reference_scheme_overlap_and_p99():
    base = {N: 100.0, P: 80.0, ("psum", "naive", "2x4", 1024): 50.0,
            ("psum", "hier", "2x4", 1024): 40.0}
    fresh = dict(base)
    fresh[N] = 100.0 * 8                     # only the reference moved
    _, failures = gates.compare(_fake(base), _fake(fresh), 3.0)
    assert any("reference-scheme" in f for f in failures)
    _, failures = gates.compare(
        _fake({N: 1.0}), _fake({("psum", "naive", "1x8", 256): 1.0}), 3.0)
    assert failures and "no overlapping" in failures[0]
    b = _fake({N: 100.0, P: 80.0}, p99={N: 120.0, P: 100.0})
    f = _fake({N: 100.0, P: 80.0}, p99={N: 120.0, P: 900.0})
    _, failures = gates.compare(b, f, 3.0)
    assert any("p99" in x for x in failures)


def test_error_bound_gate():
    ok = {"name": "error/bound", "ok": True, "expected": 1, "measured": 0}
    bad = dict(ok, ok=False, measured=2)
    q = ("psum", "q8_hier", "2x4", 1024)
    assert gates.error_bound_pass(_fake({q: 1.0},
                                        checks={"q8_hier": [ok]}))[1] == []
    assert gates.error_bound_pass(_fake({q: 1.0},
                                        checks={"q8_hier": [bad]}))[1]
    assert gates.error_bound_pass(_fake({q: 1.0}))[1]   # check missing


def test_tuning_gates_and_cli(tmp_path):
    from repro_torch.comm import tuning
    cases = []
    for s, us in (("naive", 40.0), ("shared", 10.0)):
        cases.append({"family": "allgather", "scheme": s, "topology": "2x4",
                      "pods": 2, "chips": 4, "fast_axes": 1,
                      "dtype": "float32", "elems": 64, "bytes_per_rank": 256,
                      "timing": {"median_us": us}, "autotune": None})
    rep = {"schema": SCHEMA_VERSION, "cases": cases}
    table = tuning.TuningTable.from_bench_report(rep).to_dict()
    assert gates.schema_errors(table) == []
    assert gates.staleness_failures(table, rep, 3.0)[1] == []
    slow = json.loads(json.dumps(rep))
    slow["cases"][1]["timing"]["median_us"] = 400.0
    assert gates.staleness_failures(table, slow, 3.0)[1]
    assert gates.staleness_failures(table, {"cases": []}, 3.0)[1]
    unsorted = json.loads(json.dumps(table))
    unsorted["entries"][0]["ranking"].reverse()
    assert any("sorted" in e for e in gates.schema_errors(unsorted))
    assert gates.schema_errors(dict(table, schema="repro.tuning/v1"))
    (tmp_path / "t.json").write_text(json.dumps(table))
    (tmp_path / "b.json").write_text(json.dumps(rep))
    assert gates.main(["tuning", str(tmp_path / "t.json"),
                       "--schema-only"]) == 0
    assert gates.main(["tuning", str(tmp_path / "t.json"), "--bench",
                       str(tmp_path / "b.json")]) == 0


def test_schedule_gate():
    g = stepgraph.CollectiveGraph()
    for i in range(4):
        g.add(family="allreduce", key=i, axes=("pod", "data"),
              dtype="float32", shape=(8,), elem_bytes=4, bucketable=True)
    r = dict(stepgraph.optimize(g, pods=2, chips=4).report(), config="t",
             topology="2x4", pods=2, chips=4, elems=32)
    doc = {"schema": stepgraph.SCHEMA_VERSION, "reports": [r]}
    assert gates.schedule_failures(doc) == []
    bad = json.loads(json.dumps(r))
    bad["allreduce"]["after_bytes"] += 4
    bad["buckets"][0]["count"] = 1
    errs = gates.check_report(bad, "bad")
    assert any("conserve" in e for e in errs) and \
        any("member" in e for e in errs)
    assert gates.schedule_failures({"schema": "x", "reports": []})


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_quick_cli_on_one_topology_and_emit(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "B.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", "--quick", "--reps", "1",
         "--device", "cpu", "--topologies", "2x4", "--elems", "1024",
         "--out", str(out)], capture_output=True, text=True, env=env,
        timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "validation OK" in run.stderr
    rep = json.loads(out.read_text())
    assert rep["matrix"] == ["2x4"] and rep["sweep"]["quick"] is True
    assert {c["family"] for c in rep["cases"]} == \
        set(suites.COLLECTIVE_FAMILIES)
    assert {c["dtype"] for c in rep["cases"]} == {"float32", "bfloat16"}
    table = tmp_path / "T.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", "--emit-tuning-table",
         "--bench", str(out), "--table-out", str(table)],
        capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    assert gates.main(["tuning", str(table), "--bench", str(out)]) == 0
    assert gates.main(["regression", str(out), str(out)]) == 0
