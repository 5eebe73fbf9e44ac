"""The port's tuning table and ``scheme="auto"`` resolution against the JAX
reference's (``repro.comm.tuning``).

The same table goes into both packages: the reference's committed
``TUNING_default.json`` (its schema string mapped to the port's, read here
only, through ``TuningTable.from_dict``), or one folded from the same
synthetic bench report.  Both must resolve every (family, topology, size,
result class, precision) to the same (scheme, opts, source).  The cases of
``tests/test_tuning.py`` that need no bench run are ported beside it.
"""

import copy
import json
import pathlib

import pytest
import torch

from repro.comm import Communicator as JComm
from repro.comm import tuning as jtuning
from repro.substrate import default_matrix as jmatrix
from repro_torch.analysis import traffic
from repro_torch.bench import SCHEMA_VERSION as BENCH_SCHEMA
from repro_torch.bench import gates
from repro_torch.bench.validate import tuning_table_checks
from repro_torch.comm import Communicator, registry, tuning
from repro_torch.core.plans import nearest_bucket, size_bucket
from repro_torch.substrate import default_matrix

ROOT = pathlib.Path(__file__).resolve().parent.parent
MATRIX = default_matrix(device="cpu")
PAIRS = {t.label: (j, t) for j, t in zip(jmatrix(), MATRIX)}
REFERENCE_TABLE = ROOT / "TUNING_default.json"


def _reference_table_dict() -> dict:
    with open(REFERENCE_TABLE) as f:
        d = json.load(f)
    d["schema"] = tuning.SCHEMA_VERSION
    return d


# ---------------------------------------------------------------------------
# Synthetic bench reports (schema-shaped, controlled medians)
# ---------------------------------------------------------------------------

def _case(family, scheme, vc, elems, median, opts=None, dtype="float32"):
    return {"family": family, "scheme": scheme, "topology": vc.label,
            "pods": vc.pods, "chips": vc.chips,
            "fast_axes": len(vc.fast_names), "dtype": dtype,
            "elems": elems, "bytes_per_rank": elems * 4,
            "timing": {"median_us": median},
            "autotune": ({"best": dict(opts), "results": []}
                         if opts else None)}


def _report(cases, schema=BENCH_SCHEMA):
    return {"schema": schema, "generated_by": "test", "sweep": {},
            "backend": "cpu", "cases": cases}


WINNERS = {"1x8": ("naive", {}), "2x4": ("shared", {}),
           "4x2": ("hier", {}), "8x1": ("pipelined", {"n_chunks": 2}),
           "2x(2x2)-pod.dp.tp": ("shared", {})}


def _matrix_report(elems=64, schema=BENCH_SCHEMA):
    cases = []
    for vc in MATRIX:
        win, opts = WINNERS[vc.label]
        medians = {"naive": 40.0, "hier": 30.0, "shared": 20.0,
                   "pipelined": 25.0}
        medians[win] = 10.0
        for scheme, med in medians.items():
            cases.append(_case("allgather", scheme, vc, elems, med,
                               opts if scheme == "pipelined" else None))
    return _report(cases, schema)


def _both(cases):
    """The same synthetic report folded by both packages."""
    port = tuning.TuningTable.from_bench_report(_report(cases))
    ref = jtuning.TuningTable.from_bench_report(
        _report(copy.deepcopy(cases), schema="repro.bench/v1"))
    return port, ref


def _same(got, want):
    assert (got.scheme, got.opts, got.source) == \
        (want.scheme, want.opts, want.source)


# ---------------------------------------------------------------------------
# Parity over the reference's committed table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", list(PAIRS))
def test_resolution_matches_reference_on_its_table(label):
    """Every family x size x result class x precision resolves to the
    reference's (scheme, opts, source) given the reference's table."""
    _, vc = PAIRS[label]
    port = tuning.TuningTable.from_dict(_reference_table_dict())
    ref = jtuning.TuningTable.load(REFERENCE_TABLE)
    assert len(port) == len(ref) and port.signatures() == ref.signatures()
    n_fast = len(vc.fast_names)
    seen = set()
    for family in traffic.FAMILIES:
        for elems in (1, 64, 1024, 4096, 65536, 1 << 20):
            for dtype, eb in (("float32", 4), ("bfloat16", 2)):
                for result in (None, "replicated", "shared"):
                    for precision, tol in (("exact", None),
                                           ("lossy", None),
                                           ("lossy", 1e-3)):
                        kw = dict(pods=vc.pods, chips=vc.chips, elems=elems,
                                  elem_bytes=eb, dtype=dtype,
                                  n_fast_axes=n_fast, result_class=result,
                                  precision=precision, tol=tol)
                        try:
                            want = jtuning.resolve(family, table=ref, **kw)
                        except ValueError:
                            with pytest.raises(ValueError):
                                tuning.resolve(family, table=port, **kw)
                            continue
                        got = tuning.resolve(family, table=port, **kw)
                        _same(got, want)
                        seen.add(got.source)
    assert "measured" in seen


def test_fallback_without_static_counts_matches_reference():
    for family in traffic.FAMILIES:
        for result in (None, "replicated", "shared"):
            for precision in ("exact", "lossy"):
                kw = dict(pods=None, chips=None, elems=64,
                          result_class=result, precision=precision)
                try:
                    want = jtuning.resolve(family, **kw)
                except ValueError:
                    with pytest.raises(ValueError):
                        tuning.resolve(family, **kw)
                    continue
                _same(tuning.resolve(family, **kw), want)


def test_schema_is_the_ports_own():
    with open(REFERENCE_TABLE) as f:
        raw = json.load(f)
    with pytest.raises(ValueError, match="repro_torch.tuning/v1"):
        tuning.TuningTable.from_dict(raw)
    with pytest.raises(ValueError, match="repro_torch.bench"):
        tuning.bench_cells(_matrix_report(schema="repro.bench/v1"))


# ---------------------------------------------------------------------------
# Pure helpers
# ---------------------------------------------------------------------------

def test_size_bucket_nearest_bucket_and_signature():
    assert [size_bucket(n) for n in (4096, 4095, 6000, 1, 0)] == \
        [12, 12, 13, 0, 0]
    assert nearest_bucket(2 ** 13, [12, 14]) == 12
    assert nearest_bucket(10 ** 9, [12, 18]) == 18
    assert tuning.topo_signature(2, 4) == "2x4"
    assert tuning.topo_signature(2, 4, n_fast_axes=2) == "2x4-f2"
    for vc in MATRIX:
        comm = Communicator.from_cluster(vc)
        assert tuning.signature_for(comm) == jtuning.topo_signature(
            vc.pods, vc.chips, len(vc.fast_names))
    assert tuning.dtype_name(torch.bfloat16) == "bfloat16"


# ---------------------------------------------------------------------------
# Round trip: fold -> save -> load -> dispatch picks the recorded winner
# ---------------------------------------------------------------------------

def test_fold_save_load_dispatch_round_trip_matches_reference(tmp_path):
    table = tuning.TuningTable.from_bench_report(_matrix_report(),
                                                 source_name="synthetic")
    path = tmp_path / "T.json"
    table.save(path)
    loaded = tuning.TuningTable.load(path)
    assert loaded == table and loaded.meta["generated_from"] == "synthetic"
    assert loaded.meta["measured_on"] == tuning.MEASURED_ON
    ref = jtuning.TuningTable.from_bench_report(
        _matrix_report(schema="repro.bench/v1"))
    for jvc, vc in PAIRS.values():
        res = tuning.resolve_for(Communicator.from_cluster(vc), "allgather",
                                 elems=64, table=loaded)
        assert (res.scheme, res.opts) == WINNERS[vc.label]
        assert res.source == "measured" and res.entry.label == vc.label
        _same(res, jtuning.resolve("allgather", pods=jvc.pods,
                                   chips=jvc.chips, elems=64,
                                   n_fast_axes=len(jvc.fast_names),
                                   table=ref))
    assert loaded.to_dict()["entries"] == [
        e for e in ref.to_dict()["entries"]]


def test_dispatch_through_communicator_uses_the_table():
    _, vc = PAIRS["2x4"]
    comm = Communicator.from_cluster(vc)
    x = vc.stack(vc.rank_major_input(m=2, extra=2))
    with vc.bind():
        with tuning.use_table(tuning.TuningTable.from_bench_report(
                _matrix_report(elems=4))):
            got = comm.allgather(x)                   # 2x4 winner: shared
            assert torch.equal(got.shard,
                               comm.allgather(x, scheme="shared").shard)
        flip = _matrix_report(elems=4)
        for case in flip["cases"]:
            if case["topology"] == "2x4":
                case["timing"]["median_us"] = \
                    5.0 if case["scheme"] == "naive" else 50.0
        with tuning.use_table(tuning.TuningTable.from_bench_report(flip)):
            full = comm.allgather(x)                  # naive: replicated
            assert torch.equal(full, comm.allgather(x, scheme="naive"))


def test_nearest_bucket_interpolation_matches_reference():
    _, vc = PAIRS["2x4"]
    cases = [_case("allgather", "naive", vc, 1024, 10.0),
             _case("allgather", "shared", vc, 1024, 20.0),
             _case("allgather", "naive", vc, 65536, 90.0),
             _case("allgather", "shared", vc, 65536, 30.0)]
    port, ref = _both(cases)
    for elems in (16, 1024, 4000, 2 ** 13, 50000, 65536, 10 ** 6):
        got = tuning.resolve("allgather", pods=2, chips=4, elems=elems,
                             table=port)
        want = jtuning.resolve("allgather", pods=2, chips=4, elems=elems,
                               table=ref)
        _same(got, want)
        assert got.entry.nbytes == want.entry.nbytes
    assert tuning.resolve("allgather", pods=2, chips=4, elems=2 ** 13,
                          table=port).entry.nbytes == 4096


def test_modeled_cold_start_and_empty_table():
    table = tuning.TuningTable.from_bench_report(_matrix_report())
    res = tuning.resolve("allgather", pods=3, chips=2, elems=64, table=table)
    assert res.source == "modeled" and res.entry is None
    assert registry.get_scheme(res.scheme).candidates(
        "allgather", pods=3, chips=2, elems=64)
    with tuning.use_table(None):
        assert tuning.resolve("psum", pods=2, chips=4,
                              elems=1024).source == "modeled"


# ---------------------------------------------------------------------------
# Constraints walk the ranking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["result", "tiling", "opts", "exact",
                                  "lossy"])
def test_constraints_walk_the_ranking_as_the_reference(what):
    _, vc = PAIRS["2x4"]
    if what == "result":
        port = tuning.TuningTable.from_bench_report(_matrix_report())
        ref = jtuning.TuningTable.from_bench_report(
            _matrix_report(schema="repro.bench/v1"))
        calls = [("allgather", dict(elems=64, result_class="replicated"))]
    else:
        cases = {
            "tiling": [_case("psum", "shared", vc, 1024, 10.0),
                       _case("psum", "naive", vc, 1024, 40.0)],
            "opts": [_case("allgather", "pipelined", vc, 1024, 10.0,
                           {"n_chunks": 8}),
                     _case("allgather", "naive", vc, 1024, 40.0)],
            "exact": [_case("psum", "q8_hier", vc, 1024, 1.0),
                      _case("psum", "hier", vc, 1024, 30.0),
                      _case("psum", "naive", vc, 1024, 40.0)],
            "lossy": [_case("psum", "q8_hier", vc, 1024, 1.0),
                      _case("psum", "hier", vc, 1024, 30.0)],
        }[what]
        port, ref = _both(cases)
        calls = {
            "tiling": [("psum", dict(elems=1))],
            "opts": [("allgather", dict(elems=12))],
            "exact": [("psum", dict(elems=1024))],
            "lossy": [("psum", dict(elems=1024, precision="lossy")),
                      ("psum", dict(elems=1024, precision="lossy",
                                    tol=1e-4)),
                      ("psum", dict(elems=1024, precision="lossy",
                                    tol=0.5))],
        }[what]
    for family, kw in calls:
        got = tuning.resolve(family, pods=2, chips=4, table=port, **kw)
        want = jtuning.resolve(family, pods=2, chips=4, table=ref, **kw)
        _same(got, want)
        assert got.source == "measured"


def test_exact_never_resolves_quantized_on_the_committed_table():
    tables = [tuning.TuningTable(), tuning.default_table()]
    for tbl in tables:
        for vc in MATRIX:
            for family in ("psum", "allgather"):
                for elems in (64, 1024, 65536, 1 << 20):
                    res = tuning.resolve(
                        family, pods=vc.pods, chips=vc.chips, elems=elems,
                        n_fast_axes=len(vc.fast_names), table=tbl)
                    assert registry.get_scheme(res.scheme).precision == \
                        "exact", (vc.label, family, elems, res.scheme)


# ---------------------------------------------------------------------------
# Retune / modeled entries / the committed H100 table
# ---------------------------------------------------------------------------

def test_retune_and_modeled_entries_match_reference():
    _, vc = PAIRS["2x4"]
    comm = Communicator.from_cluster(vc)
    port = tuning.TuningTable.from_dict(_reference_table_dict())
    ref = jtuning.TuningTable.load(REFERENCE_TABLE)
    fams, sizes = ("allgather", "psum", "alltoall"), (64, 1024, 65536)
    rep = tuning.retune_for(comm, fams, sizes, table=port)
    jcomm = JComm.from_cluster(PAIRS["2x4"][0])
    jrep = jtuning.retune_for(jcomm, fams, sizes, table=ref)
    assert rep.signature == jrep.signature and rep.sources == jrep.sources
    for (f, e, r), (jf, je, jr) in zip(rep.rows, jrep.rows):
        assert (f, e) == (jf, je)
        _same(r, jr)
    assert rep.scheme_for("psum") == jrep.scheme_for("psum")
    for pods, chips in ((3, 2), (2, 4)):
        got = tuning.modeled_entries(fams, pods=pods, chips=chips,
                                     elems_list=sizes)
        want = jtuning.modeled_entries(fams, pods=pods, chips=chips,
                                       elems_list=sizes)
        assert [e.to_dict() for e in got] == [e.to_dict() for e in want]


def test_committed_h100_table_passes_its_gates():
    """The committed table carries the card it was measured on, says its
    winners rank device copies, passes the schema gate, and resolves every
    matrix topology from measurement."""
    path = tuning.default_table_path()
    with open(path) as f:
        doc = json.load(f)
    assert gates.schema_errors(doc) == []
    meta = doc["meta"]
    assert meta["backend"] == "cuda" and "H100" in meta["nvidia_smi"]
    assert meta["measured_on"] == tuning.MEASURED_ON
    for vc in MATRIX:
        comm = Communicator.from_cluster(vc)
        for family in traffic.FAMILIES:
            assert tuning.resolve_for(comm, family,
                                      elems=1 << 20).source == "measured"


def test_winner_cross_check_fails_on_a_disagreeing_table():
    rep = _matrix_report()
    table = tuning.TuningTable.from_bench_report(rep)
    assert all(ch.ok for ch in tuning_table_checks(table, rep))
    bad = copy.deepcopy(rep)
    for case in bad["cases"]:
        if case["topology"] == "1x8" and case["scheme"] == "hier":
            case["timing"]["median_us"] = 1.0
    checks = tuning_table_checks(table, bad)
    assert [ch.name for ch in checks if not ch.ok] == \
        ["tuning/allgather/1x8/b256"]
    assert not any(ch.ok for ch in tuning_table_checks(
        table, _report([])))              # zero overlap fails
