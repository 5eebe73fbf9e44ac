"""What the program's own spans give a per-layer metric.

The port marks its phases with ``repro_torch.core.spans.span``: a host
range in the trace (a CPU event named after the span) and, while a profiler
records, a pair of CUDA events on the current stream.  A ``--trace 1``
window is exactly such a recording, so ``span_ms_per_unit`` reads the
device time a span took over the window, and ``idle_ms_per_unit`` the
device idle time that falls inside the host spans.  A program without the
spans (an older checkout) gives ``None`` from both.
"""

from __future__ import annotations

import bisect
from typing import Optional

from portbench.trace import _merged


def span_ms_per_unit(r, name: str, unit: str) -> Optional[float]:
    """Device ms between the entry and exit events of every ``name`` span
    of the window, over the window's ``r.counters[unit]``; None where the
    program has no such span."""
    if r.trace is None or not r.counters.get(unit):
        return None
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    got = spans.totals().get(name)
    return got["ms"] / r.counters[unit] if got else None


def idle_ms_per_unit(r, prefix: str, unit: str) -> Optional[float]:
    """Device idle ms in the gaps between the trace's device activities
    whose middle lies inside a host event named ``prefix...``, over the
    window's ``r.counters[unit]``; None where the trace has no such host
    event."""
    if r.trace is None or not r.counters.get(unit):
        return None
    spans = _merged((s, e) for name, s, e in r.trace.host
                    if name.startswith(prefix))
    if not spans:
        return None
    starts = [s for s, _ in spans]
    busy = _merged((s, e) for _, s, e in r.trace.device)
    idle_us = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and spans[i][1] >= mid:
            idle_us += b - a
    return idle_us / 1e3 / r.counters[unit]
