"""The device trace of a measured window, and its reduction.

``capture()`` wraps the window in ``torch.profiler`` (host and device
activity).  ``Trace`` keeps each device activity (kernel, copy, set) and
each host operation as (name, start, end) in microseconds and reduces them:
the busy time is the union of the device intervals (``busy_us``, the same
union as the port's ``analysis/profile.py``), kernel time is summed by name
pattern, the longest idle gaps are named by the innermost host operation
that spans them.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Iterable, Iterator, Optional

Span = tuple[str, float, float]


def _merged(intervals: Iterable[tuple[float, float]]
            ) -> list[tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(intervals: Iterable[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    return sum(e - s for s, e in _merged(intervals))


class Trace:
    """Device activities and host operations of one traced window."""

    def __init__(self, device: list[Span], host: list[Span]):
        self.device = device
        self.host = host

    @property
    def busy_s(self) -> float:
        return busy_us((s, e) for _, s, e in self.device) / 1e6

    def kernel_s(self, patterns: Iterable[str]) -> float:
        """Device seconds of the activities whose name holds a pattern."""
        pats = tuple(patterns)
        return sum(e - s for name, s, e in self.device
                   if any(p in name for p in pats)) / 1e6

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device activities that took the most time in all,
        by name, with their seconds."""
        by: dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            by[name] += (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest gaps between device activities, each named by
        the innermost host operation that spans its middle (``"none"``
        where none does), with their seconds."""
        busy = _merged((s, e) for _, s, e in self.device)
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(busy, busy[1:]) if b[0] > a[1]),
                      reverse=True)[:k]
        host = sorted(self.host, key=lambda sp: sp[1])
        starts = [sp[1] for sp in host]
        out = []
        for length, s, e in gaps:
            mid = (s + e) / 2
            best: Optional[Span] = None
            for sp in host[:bisect.bisect_right(starts, mid)]:
                if sp[2] >= mid and (best is None
                                     or sp[2] - sp[1] < best[2] - best[1]):
                    best = sp
            out.append([best[0] if best else "none", length / 1e6])
        return out


def _spans(prof) -> tuple[list[Span], list[Span]]:
    from torch.autograd import DeviceType
    device: list[Span] = []
    host: list[Span] = []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            device.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    return device, host


@contextlib.contextmanager
def capture(enabled: bool) -> Iterator[dict]:
    """Profile the body when ``enabled``; the yielded dict gets ``trace``
    (a ``Trace``) once the body has ended."""
    out: dict = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        yield out
    out["trace"] = Trace(*_spans(prof))
