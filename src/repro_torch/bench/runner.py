"""Microbenchmark timer: one warm-up, CUDA-graph replays, CUDA events.

On the card a collective body is a few dozen eager launches; timed eagerly,
small messages would measure the host's launch rate.  So each (case,
candidate) body is captured once in a ``torch.cuda.CUDAGraph`` (after its
one eager warm-up) and the replays are timed with CUDA events.  A body that
cannot be captured (a host sync, a host-to-device copy) is timed eagerly
with the same events, and its ``TimingResult.mode`` says ``"eager"``.  On
the CPU there are no graphs and no events: bodies run eagerly under the
host clock.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
import warnings
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class TimingResult:
    """Median-of-reps timing with dispersion, all in microseconds."""

    median_us: float
    mean_us: float
    min_us: float
    max_us: float
    iqr_us: float       # p75 - p25 over the reps: the dispersion estimate
    reps: int
    inner: int          # calls per timed rep (calibrated; 1 unless tiny)
    p50_us: float = 0.0
    p99_us: float = 0.0
    mode: str = "eager"         # "graph" (CUDA-graph replays) | "eager"
    clock: str = "host"         # "cuda_events" | "host"
    note: str = ""              # why a card body was timed eagerly

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _percentile(sorted_us: list, q: float) -> float:
    """Nearest-rank percentile of an ascending sample list."""
    n = len(sorted_us)
    return sorted_us[min(n - 1, max(0, math.ceil(q * n) - 1))]


def calibrate_inner(warm_s: float, min_rep_s: float,
                    max_inner: int = 64) -> int:
    """Inner-loop count so one timed rep lasts at least ``min_rep_s``,
    given a ``warm_s``-second calibration call (1 = no batching)."""
    if min_rep_s <= 0.0 or warm_s >= min_rep_s:
        return 1
    return min(max_inner, max(1, math.ceil(min_rep_s / max(warm_s, 1e-9))))


def summarize(times_us, inner: int = 1, **how) -> TimingResult:
    """Aggregate raw per-rep microsecond samples into a ``TimingResult``
    (``how``: the ``mode`` / ``clock`` / ``note`` fields)."""
    times_us = list(times_us)
    if not times_us:
        raise ValueError("no samples")
    if len(times_us) >= 2:
        q1, _, q3 = statistics.quantiles(times_us, n=4)
        iqr = q3 - q1
    else:
        iqr = 0.0
    ordered = sorted(times_us)
    return TimingResult(
        median_us=statistics.median(times_us),
        mean_us=statistics.fmean(times_us),
        min_us=ordered[0], max_us=ordered[-1],
        iqr_us=iqr, reps=len(times_us), inner=inner,
        p50_us=_percentile(ordered, 0.50),
        p99_us=_percentile(ordered, 0.99), **how)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_call(fn: Callable[[], object], device: torch.device, *,
               inner: int = 1) -> float:
    """One timed rep (``inner`` back-to-back calls) in microseconds per
    call: CUDA events on the card, the host clock (the calls are eager and
    synchronous) on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / inner
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    return (time.perf_counter() - t0) / inner * 1e6


class Captured:
    """A body made ready to time: captured in a CUDA graph when the device
    allows it and the caller does not pass ``capture=False`` (with its
    reason as ``note``), else called eagerly.  ``mode`` / ``note`` say
    which."""

    def __init__(self, body: Callable[[], object], device: torch.device,
                 *, capture: bool = True, note: str = ""):
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.mode, self.note = "eager", ""
        self._body = body
        if device.type != "cuda":
            return
        if not capture:           # the caller's reason goes in the note
            self.note = note
            return
        graph = torch.cuda.CUDAGraph()
        try:
            with warnings.catch_warnings():
                # a body with no device work (the one-node shared gather:
                # the window IS the input) captures an empty graph; its
                # replay times the timer's floor
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                with torch.cuda.graph(graph):
                    body()
        except RuntimeError as e:          # capture refused by the body
            torch.cuda.synchronize(device)
            self.note = f"not capturable: {str(e).splitlines()[0][:200]}"
            return
        self.graph, self.mode = graph, "graph"

    @property
    def clock(self) -> str:
        return "cuda_events" if self.device.type == "cuda" else "host"

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
        else:
            self._body()

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def timeit(fn: Callable[[], object], device: torch.device, *,
           reps: int = 30, min_rep_s: float = 0.0, max_inner: int = 64,
           warmup: bool = True) -> TimingResult:
    """Time ``fn()``: one warm-up call, then (on the card) the body
    captured, then ``reps`` timed reps.

    Calibration: the warm-up is also timed; if it ran faster than
    ``min_rep_s``, each rep calls ``fn`` ``inner`` times (capped at
    ``max_inner``).  ``warmup=False`` is for callers that already ran
    ``fn`` once — THAT was the warm-up; calibration then uses the first
    timed rep, which stays in the measured set.
    """
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    inner = 1
    if warmup:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        inner = calibrate_inner(time.perf_counter() - t0, min_rep_s,
                                max_inner)
    call = Captured(fn, device)
    times_us = []
    try:
        for i in range(reps):
            dt_us = timed_call(call, device, inner=inner)
            times_us.append(dt_us)
            if not warmup and i == 0:
                inner = calibrate_inner(dt_us * 1e-6, min_rep_s, max_inner)
    finally:
        call.release()
    return summarize(times_us, inner=inner, mode=call.mode,
                     clock=call.clock, note=call.note)
