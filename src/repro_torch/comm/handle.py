"""AsyncCollectiveHandle: issue-early / resolve-late collectives.

The shared-window synchronization epochs are what make *asynchronous*
collectives safe: a gather may be issued in one epoch and its result
consumed much later, as long as no store re-opens the window in between.
On the card this is the CUDA-event idiom, with the window's epoch as the
guard:

* ``issue`` — the current stream's work is handed to a side stream
  (``side.wait_stream(current)``), the shared-window read runs there, and a
  ``torch.cuda.Event`` is recorded after it; the window's epoch is kept;
* ``resolve`` — if the window was stored to or fenced past the issue epoch
  in the meantime, the handle is *torn* and ``resolve`` raises
  ``WindowEpochError``; otherwise the current stream waits on the event and
  the value is marked as used there (``record_stream``), so the caching
  allocator cannot hand its memory out before the current stream reads it.

Work the caller enqueues between ``issue`` and ``resolve`` runs on the
current stream beside the side stream's read — the double-buffer overlap of
``repro_torch.comm.pipeline``, spanning arbitrary user code.  On the CPU
there are no streams: ``issue`` reads eagerly and ``resolve`` returns the
value.  Gradients flow through the value as through the eager gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.comm.window import SharedWindow, WindowEpochError


#: One side stream per card, made at first use and kept: the caching
#: allocator keeps a pool per stream, so a fresh stream per issue would
#: allocate every result anew (the communication-stream design of NCCL's
#: process groups).
_SIDE: dict[int, torch.cuda.Stream] = {}


def side_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    """The card's side stream, ordered after the current stream's queued
    work (``None`` on the CPU)."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    side = _SIDE.get(index)
    if side is None:
        side = _SIDE[index] = torch.cuda.Stream(device=index)
    side.wait_stream(torch.cuda.current_stream(index))
    return side


@dataclasses.dataclass(frozen=True)
class AsyncCollectiveHandle:
    """An in-flight collective: the issuing window, the value being
    materialized, the event recorded after it and the epoch that guards the
    resolve."""

    family: str
    window: SharedWindow
    value: torch.Tensor
    event: Optional[torch.cuda.Event]
    issue_epoch: int

    @classmethod
    def issue(cls, family: str, window: SharedWindow, *,
              stream: Optional[torch.cuda.Stream] = None,
              event: bool = True, node: bool = False
              ) -> "AsyncCollectiveHandle":
        """Start the collective: read the (clean) window on a side stream
        (``stream``, or the card's) and record an event after it.  Raises
        ``WindowEpochError`` if the window is dirty — an async gather may
        not overlap an open store epoch.  ``event=False`` leaves the event
        to the caller (``stepgraph.apply_schedule`` records one for the
        whole schedule).  ``node=True`` reads a one-node window as one
        buffer (``SharedWindow.read_node``)."""
        window._check_clean()
        shard = window.shard
        read = window.read_node if node else window.read
        side = stream if stream is not None else side_stream(shard.device)
        if side is None:
            return cls(family=family, window=window, value=read(),
                       event=None, issue_epoch=window.epoch)
        with torch.cuda.stream(side):
            value = read()
            ev = side.record_event() if event else None
        shard.record_stream(side)
        return cls(family=family, window=window, value=value, event=ev,
                   issue_epoch=window.epoch)

    @property
    def done(self) -> bool:
        """Event query (``MPI_Test`` / ``cudaEventQuery`` on the epoch): the
        handle is resolvable iff the window is still clean in the issue
        epoch."""
        return (not self.window.dirty) and \
            self.window.epoch == self.issue_epoch

    def resolve(self) -> torch.Tensor:
        """Event wait: the gathered buffer, ordered after the issue.  A
        dirty window or an epoch bump since issue means the buffer may have
        been torn by a concurrent store — raise instead of returning stale
        bytes."""
        if not self.done:
            raise WindowEpochError(
                f"resolve of a torn {self.family} handle: the window was "
                f"stored to or fenced past epoch {self.issue_epoch} "
                f"(now epoch {self.window.epoch}, "
                f"dirty={self.window.dirty}) — re-issue after the fence")
        if self.value.device.type == "cuda":
            current = torch.cuda.current_stream(self.value.device)
            if self.event is not None:
                current.wait_event(self.event)
            self.value.record_stream(current)
        return self.value
