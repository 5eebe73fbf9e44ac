"""The readers of the program's spans (``portbench/metrics/_spans.py`` and
the metrics that use it) on a synthetic trace and synthetic span totals:
each gives the hand-worked value, counts the idle inside the program's
spans and not between units, and gives None without a trace or without
the program's spans."""

from __future__ import annotations

import sys

import pytest

from portbench import harness
from portbench.trace import Trace

SPAN_METRICS = {
    "summa.a_panel_ms": ("summa::a_panel", "multiplies"),
    "summa.b_panel_ms": ("summa::b_panel", "multiplies"),
    "summa.accumulate_ms": ("summa::accumulate", "multiplies"),
    "summa.blocks_ms": ("summa::blocks", "multiplies"),
    "train.model_ms": ("train::forward_backward", "steps"),
    "train.bridge_ms": ("train::bridge", "steps"),
    "train.optimizer_ms": ("train::optimizer", "steps"),
}
IDLE_METRICS = {"summa.host_idle_ms": ("summa::", "multiplies"),
                "train.host_idle_ms": ("train::", "steps")}
ALL = sorted(SPAN_METRICS) + sorted(IDLE_METRICS)


def _readings(trace, unit: str, units: int = 4) -> harness.Readings:
    return harness.Readings(config={}, traffic={},
                            window=harness.Window(units, 1.0),
                            counters={unit: units}, stats={}, trace=trace)


def _trace(prefix: str) -> Trace:
    """Two units, each a host span ``<prefix>unit`` (0-100 us, 200-300 us)
    with an inner span: a device gap of 10 us inside each unit's span
    (20-30, 220-230), one of 5 us inside an inner span (250-255), and one
    of 100 us between the units (100-200), which no program span covers
    (only the benchmark's loop)."""
    device = [("k", 0.0, 20.0), ("k", 30.0, 100.0), ("k", 200.0, 220.0),
              ("k", 230.0, 250.0), ("k", 255.0, 300.0)]
    host = [(f"{prefix}unit", 0.0, 100.0), (f"{prefix}unit", 200.0, 300.0),
            (f"{prefix}inner", 240.0, 260.0), ("aten::copy_", 20.0, 30.0),
            ("bench::loop", 0.0, 300.0), ("cudaDeviceSynchronize", 100.0,
                                          200.0)]
    return Trace(device, host)


@pytest.fixture
def totals(monkeypatch):
    """The program's span totals, set by the test."""
    from repro_torch.core import spans
    box: dict = {}
    monkeypatch.setattr(spans, "totals", lambda: dict(box))
    return box


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_is_the_span_ms_over_the_units(name, totals):
    span, unit = SPAN_METRICS[name]
    totals[span] = {"calls": 8, "ms": 30.0}
    totals["other::span"] = {"calls": 1, "ms": 1000.0}
    r = _readings(Trace([("k", 0.0, 1.0)], []), unit, units=4)
    assert harness.metric_reader(name)(r) == pytest.approx(7.5)
    del totals[span]
    assert harness.metric_reader(name)(r) is None


@pytest.mark.parametrize("name", sorted(IDLE_METRICS))
def test_host_idle_counts_gaps_inside_program_spans_only(name):
    prefix, unit = IDLE_METRICS[name]
    r = _readings(_trace(prefix), unit, units=2)
    # 10 + 10 + 5 us inside the spans, the 100 us between units left out:
    # 25 us over 2 units
    assert harness.metric_reader(name)(r) == pytest.approx(0.0125)
    # the same trace from a program without the spans
    other = "summa::" if prefix == "train::" else "train::"
    assert harness.metric_reader(name)(
        _readings(_trace(other), unit, units=2)) is None


@pytest.mark.parametrize("name", ALL)
def test_reader_gives_none_without_a_trace(name, totals):
    unit = {**SPAN_METRICS, **IDLE_METRICS}[name][1]
    totals["summa::a_panel"] = totals["train::bridge"] = {"calls": 1,
                                                          "ms": 1.0}
    assert harness.metric_reader(name)(_readings(None, unit)) is None
    r = _readings(Trace([], []), unit, units=0)
    assert harness.metric_reader(name)(r) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_gives_none_without_the_programs_spans(name, totals,
                                                      monkeypatch):
    """A checkout whose program has no ``core.spans`` module."""
    import repro_torch.core
    span, unit = SPAN_METRICS[name]
    totals[span] = {"calls": 1, "ms": 1.0}
    r = _readings(Trace([("k", 0.0, 1.0)], []), unit)
    assert harness.metric_reader(name)(r) is not None
    monkeypatch.delattr(repro_torch.core, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert harness.metric_reader(name)(r) is None
