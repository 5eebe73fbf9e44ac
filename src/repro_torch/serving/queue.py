"""Request queue + admission control for the continuous-batching engine.

Requests enter FIFO through :meth:`RequestQueue.submit`, which applies
admission control (pending-depth backpressure, prompt-length limits) and
assigns request ids.  The scheduler drains the queue with
:meth:`RequestQueue.take_group`, which returns a *length-bucketed* group:
the head-of-line request picks the prefill bucket and a bounded lookahead
window is scanned for same-bucket requests, so one prefill trace serves
many prompt lengths without unbounded head-of-line reordering.

Bucketing modes:

* ``"pow2"``  — prompts are right-padded to the next power of two.  Safe
  for pure global-attention models: padded KV positions are never
  attendable before the decode loop has overwritten them (the causal
  ``gidx <= pos`` mask plus write-before-read induction).
* ``"exact"`` — requests are grouped by exact prefill length.  Required
  for models with recurrent or sliding-window blocks, where padded
  prefill steps would corrupt carried state / evict real window entries.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np


class AdmissionError(RuntimeError):
    """The queue refused a request (backpressure or a hard limit)."""


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` is a (T0,) int32 token vector."""

    rid: int
    prompt: np.ndarray
    max_new: int
    arrival: float = 0.0


def bucket_len(n: int, mode: str = "pow2") -> int:
    """Prefill bucket for an ``n``-token prefill (``n = T0 - 1``)."""
    if mode == "exact" or n == 0:
        return n
    if mode == "pow2":
        return 1 << max(0, int(n - 1).bit_length())
    raise ValueError(f"unknown bucket mode: {mode!r}")


class RequestQueue:
    """Bounded FIFO with length-bucketed group draining."""

    def __init__(self, *, max_pending: int = 1024,
                 max_prompt_len: Optional[int] = None,
                 lookahead: int = 32):
        self.max_pending = max_pending
        self.max_prompt_len = max_prompt_len
        self.lookahead = lookahead
        self._q: deque[Request] = deque()
        self._next_rid = 0

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, prompt, max_new: int, *, arrival: float = 0.0) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise AdmissionError("prompt must be a non-empty 1-D int32 array")
        if self.max_prompt_len is not None \
                and prompt.size > self.max_prompt_len:
            raise AdmissionError(
                f"prompt of {prompt.size} tokens exceeds the admission "
                f"limit of {self.max_prompt_len}")
        if max_new < 1:
            raise AdmissionError("max_new must be >= 1")
        if len(self._q) >= self.max_pending:
            raise AdmissionError(
                f"queue full ({self.max_pending} pending) — backpressure")
        rid = self._next_rid
        self._next_rid += 1
        self._q.append(Request(rid=rid, prompt=prompt, max_new=max_new,
                               arrival=arrival))
        return rid

    def take_group(self, n: int, *, bucket: str = "pow2") -> list[Request]:
        """Pop up to ``n`` requests sharing the head-of-line request's
        prefill bucket, scanning at most ``lookahead`` queued requests."""
        if n < 1 or not self._q:
            return []
        head_bucket = bucket_len(self._q[0].prompt.size - 1, bucket)
        picked: list[Request] = []
        kept: list[Request] = []
        scanned = 0
        while self._q and scanned < self.lookahead and len(picked) < n:
            req = self._q.popleft()
            scanned += 1
            if bucket_len(req.prompt.size - 1, bucket) == head_bucket:
                picked.append(req)
            else:
                kept.append(req)
        for req in reversed(kept):
            self._q.appendleft(req)
        return picked
