"""Named spans of the port's phases: host ranges for ``torch.profiler`` and
device times on the card.

    with span("summa::a_panel"):
        ...

With no profiler recording a span costs one branch.  While one records
(``torch.profiler.profile`` or ``torch.autograd.profiler.profile``):

* **host**: the span opens a function-scope profiler range
  (``torch._C._profiler._RecordFunctionFast``).  It is a CPU event on the
  profiler's clock whose children are the ops inside it, so a reader of
  ``prof.events()`` gets its device time through ``device_time_total``.
  Unlike ``torch.profiler.record_function`` (a user-scope range) it puts no
  ``gpu_user_annotation`` event on the device timeline, so a span never
  counts as device activity and never hides an idle gap there;
* **device**: where CUDA is initialised (and the current stream is not
  capturing a graph), a pair of timing events is recorded on the current
  stream at entry and at exit.

``totals()`` resolves the recorded pairs into, per name, the calls and the
device milliseconds between each pair's events; ``reset()`` drops them.
"""

from __future__ import annotations

import torch

_recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

#: (name, start event, end event) recorded and not yet resolved
_pending: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
#: name -> [calls, device ms] of the resolved pairs
_done: dict[str, list] = {}


def _event():
    """A timing event recorded on the current stream, or None where there
    is no card to time (CUDA not initialised, or a graph being captured)."""
    if not torch.cuda.is_initialized() or \
            torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class span:
    """A context manager marking one phase of the program as ``name``."""

    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _recording():
            self._range = _Range(self.name)
            self._range.__enter__()
            self._start = _event()
        return self

    def __exit__(self, *exc) -> bool:
        rng = self._range
        if rng is None:
            return False
        self._range = None
        if self._start is not None:
            end = _event()
            if end is not None:
                _pending.append((self.name, self._start, end))
        rng.__exit__(*exc)
        return False


def totals() -> dict[str, dict]:
    """Per span name, ``{"calls": n, "ms": device ms}`` over every pair
    recorded since the last ``reset()`` (waits for the pending ones)."""
    for name, start, end in _pending:
        end.synchronize()
        acc = _done.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += start.elapsed_time(end)
    _pending.clear()
    return {name: {"calls": c, "ms": ms} for name, (c, ms) in _done.items()}


def reset() -> None:
    """Drop every recorded pair."""
    _pending.clear()
    _done.clear()
