"""One run of one cell: set-up, a measured window, the readings, the check.

Everything is found by name.  ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the configuration's file names its driver
(``portbench/drivers/<driver>.py``); the traffic mix is
``portbench/traffic/<traffic>.json``; each per-layer metric is read by
``portbench/metrics/<metric>.py``.  A later cell or metric is files and
manifest entries, never an edit here.

The window is a closed loop: the driver's unit of work (a multiply, a
training step) is issued once the one before it has finished on the card
(a synchronise), until ``seconds`` have passed on the host clock; every
unit counts, over the whole time.  Set-up (building, warming every shape
the window uses, the check steps) ends before the window opens, and the
peak memory is the window's own.  The reference runs after the window,
once the program's state is freed.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from portbench import trace as tracing
from portbench.check import Check

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent
GIB = float(2 ** 30)


@dataclasses.dataclass
class Cell:
    """A cell as the manifest gives it, with its files loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(manifest: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and the
    metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    return Cell(name, w["chips"], config, traffic, e2e, per_layer)


def driver_for(config: dict):
    return importlib.import_module(f"portbench.drivers.{config['driver']}")


def metric_reader(name: str) -> Callable:
    """``read`` of ``portbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Window:
    units: int
    seconds: float


def closed_loop(step: Callable[[], None], seconds: float,
                sync: Callable[[], None],
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run ``step`` and wait for it (``sync``), back to back, until
    ``seconds`` have passed; all the units over all the time."""
    t0 = clock()
    units = 0
    while True:
        step()
        sync()
        units += 1
        if clock() - t0 >= seconds:
            return Window(units, clock() - t0)


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader may read."""

    config: dict
    traffic: dict
    window: Window
    counters: dict          # the program's counters over the window
    stats: dict             # the driver's set-up numbers
    trace: Optional[tracing.Trace]


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def power_limit_w(index: int) -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it (None where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
        return float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float
             ) -> tuple[dict, list[Check]]:
    """Set up, measure, read, check.  Returns the result's fields and the
    checks; ``t_start`` is the host time the run began (set-up counts from
    it)."""
    driver = driver_for(cell.config)
    on_card = device.type == "cuda"
    sync = _sync(device)
    sess = driver.setup(cell.config, cell.traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = sess.counters()
    with tracing.capture(trace and on_card) as traced:
        window = closed_loop(sess.step, seconds, sync)
    after = sess.counters()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    e2e = sess.end_to_end(window)
    counters = {k: after[k] - before[k] for k in after}
    sess.release()
    t_check = time.perf_counter()
    checks = sess.check()
    log(f"set-up {setup_s:.3f} s; window {window.units} units in "
        f"{window.seconds:.3f} s; check {time.perf_counter() - t_check:.3f} "
        f"s; {time.perf_counter() - t_start:.3f} s so far")

    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else device.type),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if on_card:
        device_info["power_limit_w"] = power_limit_w(
            device.index if device.index is not None else 0)
    values = {"setup_s": setup_s, "peak_mem_gib": peak / GIB, **e2e}
    out: dict = {}
    if trace:
        tr = traced.get("trace")
        readings = Readings(cell.config, cell.traffic, window, counters,
                            sess.stats, tr)
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            log(f"{len(tr.device)} device activities traced")
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = window.seconds
            out["breakdown"] = {"device_ops": tr.top_ops(10),
                                "idle_gaps": tr.idle_gaps(10)}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    ok = all(c.ok for c in checks)
    out.update({"correct": ok, "attempted": window.units,
                "failed": 0 if ok else sess.failed_units(checks),
                "metrics": metrics, "device": device_info})
    return out, checks
