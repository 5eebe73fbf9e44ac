"""The window's arithmetic (all the work over all the time) and the
trace's reduction."""

from __future__ import annotations

import pytest

from portbench.harness import closed_loop
from portbench.trace import Trace, busy_us


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def test_closed_loop_waits_for_each_unit_and_counts_all_the_time():
    clock = FakeClock()
    synced = []

    def step():
        clock.t += 0.1            # the host issues a unit in 0.1 s

    def sync():
        synced.append(clock.t)
        clock.t += 0.2            # the card finishes it 0.2 s later

    w = closed_loop(step, 1.0, sync, clock=clock)
    # a unit takes 0.3 s; the loop stops after the unit that ends at or
    # past 1.0 s: 0.3, 0.6, 0.9, 1.2 -> 4 units over 1.2 s
    assert w.units == 4 == len(synced)
    assert w.seconds == pytest.approx(1.2)


def test_closed_loop_runs_at_least_one_unit():
    clock = FakeClock()

    def step():
        clock.t += 5.0

    w = closed_loop(step, 1.0, lambda: None, clock=clock)
    assert (w.units, w.seconds) == (1, 5.0)


def test_busy_is_the_union_of_intervals():
    assert busy_us([(0, 10), (5, 15), (20, 30), (30, 31)]) == 26
    assert busy_us([]) == 0


def test_trace_sums_counts_and_names_gaps():
    dev = [("k_a<float>", 0.0, 10.0), ("Memcpy DtoD", 10.0, 12.0),
           ("k_b<float>", 20.0, 50.0), ("k_a<float>", 51.0, 61.0)]
    host = [("step", 0.0, 70.0), ("aten::copy_", 12.0, 19.0),
            ("cudaLaunchKernel", 50.0, 50.9)]
    tr = Trace(dev, host)
    assert tr.busy_s == pytest.approx(52e-6)
    assert tr.kernel_s(("k_a<",)) == pytest.approx(20e-6)
    assert tr.top_ops(2) == [["k_b<float>", pytest.approx(30e-6)],
                             ["k_a<float>", pytest.approx(20e-6)]]
    # gaps 12..20 (8 us, under aten::copy_) and 50..51 (1 us, under
    # cudaLaunchKernel, the innermost host op spanning its middle)
    assert tr.idle_gaps(5) == [["aten::copy_", pytest.approx(8e-6)],
                               ["cudaLaunchKernel", pytest.approx(1e-6)]]
