"""Fault tolerance and elasticity: restart manager, straggler watchdog,
elastic topology rebuild.

The reference's ``repro/runtime/fault_tolerance.py``.  The decision logic
is all here; a real fleet adds only transport (heartbeats, a coordinator).
Checkpoint/restart runs for real (``checkpoint.checkpointer``), the
straggler EWMA policy is driven with recorded or synthetic step times, and
``elastic_topology`` rebuilds a ``core.topology.MeshTopology`` from the
surviving chips.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer


# ---------------------------------------------------------------------------
# Straggler detection (per-host step-time EWMA vs fleet median)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerPolicy:
    """Flags hosts whose EWMA step time exceeds ``threshold`` x the fleet
    median for ``patience`` consecutive steps.  On a synchronous fleet one
    slow host gates every step, so the mitigation is replacement or
    eviction + elastic shrink — both surfaced as actions for the
    launcher."""
    alpha: float = 0.2
    threshold: float = 1.5
    patience: int = 5

    def __post_init__(self):
        self.ewma: dict[int, float] = {}
        self.strikes: dict[int, int] = {}
        self.evicted: set[int] = set()

    def observe(self, step_times: dict[int, float]) -> list[int]:
        """``step_times``: host id -> seconds for this step.  Returns the
        hosts to evict, each at most once: an evicted host's EWMA and
        strikes are dropped so it neither inflates the fleet median nor is
        flagged again."""
        for h, t in step_times.items():
            if h in self.evicted:
                continue
            prev = self.ewma.get(h, t)
            self.ewma[h] = (1 - self.alpha) * prev + self.alpha * t
        if not self.ewma:
            return []
        med = float(np.median(list(self.ewma.values())))
        evict = []
        for h, e in self.ewma.items():
            if e > self.threshold * med:
                self.strikes[h] = self.strikes.get(h, 0) + 1
                if self.strikes[h] >= self.patience:
                    evict.append(h)
            else:
                self.strikes[h] = 0
        for h in evict:
            self.evicted.add(h)
            self.ewma.pop(h, None)
            self.strikes.pop(h, None)
        return evict


# ---------------------------------------------------------------------------
# Elastic topology: rebuild the mesh from surviving resources
# ---------------------------------------------------------------------------

def elastic_topology(n_chips: int, *, model: Optional[int] = None,
                     prev=None):
    """Largest (pod, data, model) topology that fits ``n_chips``: model is
    fixed (the TP degree is a model property), pods shrink first, then
    data.

    The model degree comes from ``prev`` (the topology before the failure),
    so a run keeps its TP degree through every shrink; ``model=``
    overrides, and with neither the production default of 16 applies.
    Survivors that do not factor into whole model groups are an ERROR
    naming the stranded chips.  Returns a ``MeshTopology``; raises if fewer
    than one model group survives."""
    from repro_torch.core.topology import MeshTopology
    if model is None:
        if prev is not None and "model" in prev.axis_sizes:
            model = prev.size("model")
        else:
            model = 16
    if n_chips < model:
        raise ValueError(f"need >= {model} chips, have {n_chips}")
    stranded = n_chips % model
    if stranded:
        raise ValueError(
            f"{stranded} stranded chip(s): {n_chips} survivors do not "
            f"factor into model={model} groups ({n_chips // model} whole "
            f"groups + {stranded} extra) — evict down to "
            f"{n_chips - stranded} chips or re-pool {model - stranded} "
            "spares")
    data = n_chips // model
    pods = 1
    # prefer 256-chip pods (16 data x 16 model), extras become pods
    if data >= 32 and data % 16 == 0:
        pods, data = data // 16, 16
    if pods > 1:
        return MeshTopology({"pod": pods, "data": data, "model": model})
    return MeshTopology({"data": data, "model": model})


# ---------------------------------------------------------------------------
# Restart manager
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RestartManager:
    """Drives the save/restore cycle: periodic async saves, resume from the
    newest intact checkpoint after a crash, re-laid out on a changed
    cluster.  ``logical`` maps the live state to the logical one the
    checkpoint holds, as fresh host tensors (``TrainStepBundle.host_state``
    for a laid-out state); by default the state is saved as it is."""
    ckpt: Checkpointer
    save_every: int = 100
    logical: Optional[Callable] = None

    def maybe_save(self, step: int, state) -> None:
        if step % self.save_every == 0 and step > 0:
            self.save(step, state)

    def save(self, step: int, state, *, blocking: bool = False) -> None:
        if self.logical is None:
            self.ckpt.save(step, state, blocking=blocking)
        else:        # the logical state is a fresh host copy already
            self.ckpt.save(step, self.logical(state), blocking=blocking,
                           copy=False)

    def resume_or_init(self, init_fn: Callable[[], object], *, like,
                       layout: Optional[Callable] = None):
        """``(state, start_step)``: the newest intact checkpoint laid out
        by ``layout``, or ``init_fn()`` when there is none.  ``like`` is
        the logical state's template (shapes and dtypes: ``meta``-device
        tensors, e.g. ``TrainStepBundle.abstract_state()``), so nothing is
        initialized just to read shapes."""
        step = self.ckpt.latest_step()
        if step is None:
            return init_fn(), 0
        # pin the step we validated: a concurrent save landing between
        # latest_step() and restore() must not switch the checkpoint
        return self.ckpt.restore(like, step=step, layout=layout)
