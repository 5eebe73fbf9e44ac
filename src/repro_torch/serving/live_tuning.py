"""Session-local ``TuningTable`` overlay fed by live collective latencies.

The committed ``artifacts/TUNING_h100.json`` comes from a sweep on one
card; a serving session sees *real* traffic — different message sizes,
different contention — and its scheme winners can drift from the sweep's.
:class:`LiveTuner` closes that loop without touching the committed table:

* every observed collective latency updates a decaying (EWMA) per-cell
  estimator, keyed exactly like the table — ``(family, topology signature,
  dtype, size bucket, scheme)``;
* :meth:`LiveTuner.overlay` folds the estimates over a base table into a
  fresh in-memory ``TuningTable``: cells with live data get re-ranked by
  the live medians (base medians fill schemes not yet observed), cells
  without keep the base ranking, and cells the base never measured are
  synthesized from live data alone;
* the overlay is installed session-locally via ``tuning.use_table`` (or
  passed to ``Communicator.record(table=...)``), so ``scheme="auto"`` —
  and the step-graph optimizer's bucket sizing — track real traffic while
  the committed artifact stays untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.comm import tuning
from repro_torch.comm.tuning import Choice, TuningEntry, TuningTable
from repro_torch.core.plans import size_bucket


@dataclasses.dataclass
class _Cell:
    """Live estimates for one (family, topo, dtype, bucket) cell."""

    us: dict          # scheme -> EWMA latency (microseconds)
    count: dict       # scheme -> observation count
    nbytes: int       # representative per-rank payload
    label: str = ""


class LiveTuner:
    """Decaying per-collective latency estimator + table overlay.

    ``alpha`` is the EWMA weight of a new observation; ``min_count`` is how
    many observations a (cell, scheme) needs before its estimate is
    trusted into the overlay — a single outlier must not flip a winner.
    """

    def __init__(self, base: Optional[TuningTable] = None, *,
                 alpha: float = 0.25, min_count: int = 1):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self._base = base
        self.alpha = alpha
        self.min_count = min_count
        self._cells: dict[tuple, _Cell] = {}

    @property
    def base(self) -> TuningTable:
        return self._base if self._base is not None else tuning.default_table()

    # -- feeding -------------------------------------------------------------
    def observe(self, family: str, *, pods: int, chips: int, nbytes: int,
                scheme: str, us: float, dtype: str = "float32",
                n_fast_axes: int = 1, label: str = "") -> None:
        """Record one live latency sample for a collective call."""
        if us <= 0:
            raise ValueError("latency must be positive")
        topo = tuning.topo_signature(pods, chips, n_fast_axes)
        key = (family, topo, dtype, size_bucket(int(nbytes)))
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _Cell(us={}, count={},
                                            nbytes=int(nbytes), label=label)
        prev = cell.us.get(scheme)
        cell.us[scheme] = us if prev is None \
            else (1 - self.alpha) * prev + self.alpha * us
        cell.count[scheme] = cell.count.get(scheme, 0) + 1
        if label:
            cell.label = label

    def observe_comm(self, comm, family: str, *, nbytes: int, scheme: str,
                     us: float, dtype: str = "float32") -> None:
        """``observe`` keyed by a ``Communicator``'s static topology."""
        if comm.pods is None or comm.chips is None:
            raise ValueError("live tuning needs a Communicator with static "
                             "pods/chips counts")
        fast = comm.fast_axis
        n_fast = len(fast) if isinstance(fast, tuple) else 1
        self.observe(family, pods=comm.pods, chips=comm.chips, nbytes=nbytes,
                     scheme=scheme, us=us, dtype=dtype, n_fast_axes=n_fast)

    def estimate(self, family: str, topo: str, dtype: str, nbytes: int,
                 scheme: str) -> Optional[float]:
        cell = self._cells.get((family, topo, dtype, size_bucket(int(nbytes))))
        if cell is None or cell.count.get(scheme, 0) < self.min_count:
            return None
        return cell.us[scheme]

    # -- the overlay ---------------------------------------------------------
    def overlay(self) -> TuningTable:
        """The base table with live estimates folded in (in-memory only)."""
        base = self.base
        live_left = dict(self._cells)
        entries = []
        for e in base.entries:
            key = (e.family, e.topo, e.dtype, e.bucket)
            cell = live_left.pop(key, None)
            if cell is None:
                entries.append(e)
                continue
            medians = {c.scheme: (c.median_us, dict(c.opts))
                       for c in e.ranking}
            for scheme, us in cell.us.items():
                if cell.count.get(scheme, 0) < self.min_count:
                    continue
                _, opts = medians.get(scheme, (None, {}))
                medians[scheme] = (us, opts)
            ranking = tuple(sorted(
                (Choice(scheme=s, opts=opts, median_us=us)
                 for s, (us, opts) in medians.items() if us is not None),
                key=lambda c: (c.median_us, c.scheme)))
            entries.append(dataclasses.replace(
                e, ranking=ranking or e.ranking,
                label=e.label or cell.label))
        # cells the base never measured: synthesize from live data alone
        for (family, topo, dtype, _), cell in sorted(live_left.items()):
            ranking = tuple(sorted(
                (Choice(scheme=s, median_us=us)
                 for s, us in cell.us.items()
                 if cell.count.get(s, 0) >= self.min_count),
                key=lambda c: (c.median_us, c.scheme)))
            if not ranking:
                continue
            entries.append(TuningEntry(
                family=family, topo=topo, dtype=dtype, nbytes=cell.nbytes,
                source="measured", ranking=ranking,
                label=cell.label or "live"))
        meta = dict(base.meta)
        meta["live_overlay"] = {
            "cells": len(self._cells), "alpha": self.alpha,
            "min_count": self.min_count}
        return TuningTable(entries=tuple(entries), meta=meta)

    def use(self):
        """``with tuner.use():`` — install the overlay session-locally."""
        return tuning.use_table(self.overlay())
