"""BENCHMARK.json against the benchmark's contract, and the lookup by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ROOT = harness.ROOT
MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


def test_names_units_and_entry_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and _line(w["why"])
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_cells_are_one_chip_and_each_config_used():
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for name in CELLS:
        cell = harness.find_cell(MANIFEST, name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_target_reported_by_every_cell_of_the_metric(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert metric["moves"] in e2e
    target = e2e[metric["moves"]]
    cells = metric.get("workloads", CELLS)
    assert cells and set(cells) <= set(CELLS)
    for c in cells:
        assert c in target.get("workloads", CELLS)
    layers = {m["layer"] for m in MANIFEST["per_layer"]
              if m["name"].split(".")[0] == metric["name"].split(".")[0]}
    assert metric["layer"] in layers


@pytest.mark.parametrize("cell", CELLS)
def test_lookup_by_name_finds_the_cells_files(cell):
    got = harness.find_cell(MANIFEST, cell)
    w = {x["name"]: x for x in MANIFEST["workloads"]}[cell]
    cfg = {c["name"]: c for c in MANIFEST["configs"]}[w["config"]]
    assert got.config == json.loads((ROOT / cfg["file"]).read_text())
    assert got.config["name"] == w["config"]
    assert got.traffic == json.loads(
        (harness.HERE / "traffic" / f"{w['traffic']}.json").read_text())
    assert harness.driver_for(got.config).setup
    for m in got.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert {m["name"] for m in got.end_to_end} >= {"setup_s", "peak_mem_gib"}


def test_lookup_of_an_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.find_cell(MANIFEST, "no.such.cell")


def test_every_limit_of_a_cell_is_stated():
    want = {"summa": {"rel_err"},
            "train": {"loss_gap", "grad1_gap", "update_gap"}}
    for name in CELLS:
        cell = harness.find_cell(MANIFEST, name)
        lim = cell.config["limits"]
        assert set(lim) == want[cell.config["driver"]]
        assert all(0 < v < 1 for v in lim.values())


def test_every_configuration_states_the_datasheet_peaks():
    from portbench.work import DATASHEET
    for c in MANIFEST["configs"]:
        peak = json.loads((ROOT / c["file"]).read_text())["peak"]
        assert peak["flops_per_s"] == DATASHEET["tf32"]
        assert peak["bytes_per_s"] == DATASHEET["hbm_bytes_per_s"]
        assert peak["source"]
