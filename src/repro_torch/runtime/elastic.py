"""ElasticRuntime: fault injection, communicator rebuild, checkpointed
recovery — the kill -> rebuild -> re-tune -> resume path, end to end.

The reference's ``repro/runtime/elastic.py`` over the port's stacked
cluster.  The paper's two-tier design makes failure NODE-granular: one
shared copy per node plus a bridge tier means losing a host removes exactly
one bridge participant and one shared window.  This runtime exploits that:

1. **Fault injection** — a ``FaultPlan`` scripts deterministic failures
   keyed by step (pod loss, host slowdown feeding the straggler watchdog,
   torn checkpoints).  A new failure kind is ONE ``@register_event``
   registration.
2. **Communicator rebuild** — on pod loss the cluster shrinks
   (``VirtualCluster.without_pod``: the slow tier loses one extent) and the
   world communicator is rebuilt with ``Communicator.from_cluster``.
3. **Re-tune** — the new topology signature re-resolves ``scheme="auto"``
   against the tuning table (``comm.tuning.retune_for``): measured entries
   where the bench swept the surviving shape, modeled closed forms where it
   did not — logged into the recovery record.
4. **Re-record** — the step is rebuilt with ``make_cluster_train_step``
   (``opts=("stepgraph",)`` by default), so the collective schedule is
   recorded and optimized afresh for the surviving topology on its next
   run.
5. **Resume** — the logical state restores from ``checkpoint/`` laid out
   on the surviving cluster (``bundle.layout_state``), torn newest steps
   discarded with a warning, saves of the aborted timeline invalidated
   (``Checkpointer.discard_after``).

The continued loss trajectory is bit-identical to a run that STARTED on
the shrunk topology at the restored step (``reference_run``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import warnings
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.comm import Communicator, tuning
from repro_torch.core import tree as T
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.runtime.fault_tolerance import (RestartManager,
                                                 StragglerPolicy)
from repro_torch.runtime.steps import make_cluster_train_step

logger = logging.getLogger("repro_torch.runtime.elastic")


# ---------------------------------------------------------------------------
# Fault events: the injection grammar
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted failure.  ``kind`` selects the registered handler;
    ``step`` is the train step it fires at (before the step executes: a pod
    lost "mid-step" aborts that step's work).  The remaining fields are the
    kind's parameters."""

    kind: str
    step: int
    pod: int = -1          # pod_loss: which node dies (-1 = last)
    host: int = -1         # host_slowdown: which host drags
    factor: float = 4.0    # host_slowdown: step-time multiplier
    duration: int = 8      # host_slowdown: steps the slowdown lasts

    @classmethod
    def pod_loss(cls, step: int, pod: int = -1) -> "FaultEvent":
        return cls(kind="pod_loss", step=step, pod=pod)

    @classmethod
    def host_slowdown(cls, step: int, host: int, *, factor: float = 4.0,
                      duration: int = 8) -> "FaultEvent":
        return cls(kind="host_slowdown", step=step, host=host,
                   factor=factor, duration=duration)

    @classmethod
    def torn_checkpoint(cls, step: int) -> "FaultEvent":
        return cls(kind="torn_checkpoint", step=step)


#: kind -> handler(runtime, event).  A handler either mutates runtime
#: bookkeeping (slowdowns, disk corruption) or raises ``PodLost`` to enter
#: the recovery path.  Registering here is ALL a new failure kind needs.
EVENT_HANDLERS: dict[str, Callable] = {}


def register_event(kind: str):
    def deco(fn):
        EVENT_HANDLERS[kind] = fn
        return fn
    return deco


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic failure script: events fire when the loop reaches
    their step, each exactly once (a recovery replays the steps between
    the restored checkpoint and the failure without re-firing them)."""

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            if ev.kind not in EVENT_HANDLERS:
                raise ValueError(
                    f"unknown fault kind {ev.kind!r}: registered kinds are "
                    f"{sorted(EVENT_HANDLERS)}")
            if ev.step < 0:
                raise ValueError(f"event step must be >= 0, got {ev.step}")

    def pending(self, step: int, fired: set) -> list[tuple[int, FaultEvent]]:
        return [(i, ev) for i, ev in enumerate(self.events)
                if ev.step == step and i not in fired]


class PodLost(Exception):
    """Control-flow signal: a node died (scripted or straggler-evicted);
    unwind to the recovery path."""

    def __init__(self, pod: int, cause: str):
        super().__init__(f"pod {pod} lost ({cause})")
        self.pod = pod
        self.cause = cause


@register_event("pod_loss")
def _on_pod_loss(rt: "ElasticRuntime", ev: FaultEvent) -> None:
    raise PodLost(ev.pod, "pod_loss")


@register_event("host_slowdown")
def _on_host_slowdown(rt: "ElasticRuntime", ev: FaultEvent) -> None:
    rt._slowdowns.append(ev)
    logger.info("step %d: host %d slows %.1fx for %d steps", ev.step,
                ev.host, ev.factor, ev.duration)


@register_event("torn_checkpoint")
def _on_torn_checkpoint(rt: "ElasticRuntime", ev: FaultEvent) -> None:
    rt._tear_newest_checkpoint()


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecoveryRecord:
    """One completed kill -> rebuild -> re-tune -> resume cycle."""

    trigger_step: int                 # step whose execution was aborted
    cause: str                        # "pod_loss" | "straggler"
    lost_pod: int
    old_label: str
    new_label: str
    old_signature: str
    new_signature: str
    restored_step: int                # checkpoint the run resumed from
    torn_discarded: tuple[int, ...]   # torn steps skipped by the restore
    stale_dropped: tuple[int, ...]    # aborted-timeline saves invalidated
    retune: tuning.RetuneReport       # scheme="auto" on the new signature


@dataclasses.dataclass
class ElasticReport:
    """What the supervised run did.  ``losses`` maps step -> loss; steps
    replayed after a recovery overwrite their pre-failure entries, so the
    map holds the SURVIVING trajectory.  ``state`` is laid out on the final
    cluster; ``layouts`` lists ``(cluster label, device bytes of params, m
    and v)`` for every state laid out during the run."""

    losses: dict
    recoveries: tuple
    start_step: int
    final_step: int
    cluster_label: str
    signature: str
    state: object = None
    layouts: tuple = ()

    def loss_trajectory(self, from_step: int = 0) -> list[float]:
        return [self.losses[s] for s in sorted(self.losses)
                if s >= from_step]


def _group_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size()
               for g in ("params", "m", "v") for t in T.leaves(state[g]))


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

class ElasticRuntime:
    """Owns the live ``VirtualCluster`` + ``Communicator`` + active tuning
    resolution and drives supervised training through scripted faults.

    The step comes from ``runtime.steps.make_cluster_train_step``
    (``opts=("stepgraph",)`` by default); the state stays laid out on the
    cluster and is donated to ``bundle.step``.  One host == one pod here —
    node-granular failure, per the paper's layout."""

    RETUNE_FAMILIES = ("psum", "allgather")

    def __init__(self, cfg, cluster, *, ckpt_dir: str,
                 plan: Optional[FaultPlan] = None, mode: str = "hier",
                 opts=("stepgraph",), global_batch: int = 8, seq: int = 16,
                 lr: float = 1e-3, save_every: int = 2, keep: int = 10,
                 seed: int = 0, data_seed: int = 1234, unroll: int = 1,
                 straggler_factory: Optional[Callable[[], StragglerPolicy]]
                 = None):
        self.cfg = cfg
        self.mode = mode
        self.opts = tuple(opts)
        self.global_batch = global_batch
        self.seq = seq
        self.lr = lr
        self.seed = seed
        self.data_seed = data_seed
        self.unroll = unroll
        self.ckpt = Checkpointer(ckpt_dir, keep=keep)
        self.mgr = RestartManager(
            self.ckpt, save_every=save_every,
            logical=lambda s: self.bundle.host_state(s))
        self.plan = plan if plan is not None else FaultPlan()
        self._fired: set[int] = set()
        self._slowdowns: list[FaultEvent] = []
        self._straggler_factory = straggler_factory or StragglerPolicy
        self.recoveries: list[RecoveryRecord] = []
        self.layouts: list[tuple[str, int]] = []
        self._build(cluster)

    # -- build / rebuild -----------------------------------------------------
    def _build(self, vc) -> None:
        """(Re)build every topology-dependent piece for ``vc``: the world
        communicator (``from_cluster``), the step (its schedule recorded
        afresh), the straggler watchdog (host ids renumber with the
        survivors, so the policy starts a fresh epoch), and the
        ``scheme="auto"`` re-resolution report for the new signature."""
        self.cluster = vc
        self.comm = Communicator.from_cluster(vc)
        self.bundle = make_cluster_train_step(
            self.cfg, vc, mode=self.mode, lr=self.lr, unroll=self.unroll,
            global_batch=self.global_batch, opts=self.opts)
        self.step_fn = self.bundle.step
        self.straggler = self._straggler_factory()
        self._slowdowns = []
        shapes = T.leaves(self.bundle.abstract_state()["params"])
        sizes = sorted({int(np.prod(t.shape)) or 1 for t in shapes})
        elems = tuple(dict.fromkeys((1, sizes[0], sizes[-1])))
        self.retuned = tuning.retune_for(self.comm, self.RETUNE_FAMILIES,
                                         elems)

    # -- checkpoint plumbing -------------------------------------------------
    def _data_cfg(self) -> DataConfig:
        return DataConfig(vocab=self.cfg.vocab, seq_len=self.seq,
                          global_batch=self.global_batch,
                          seed=self.data_seed)

    def _restore(self, *, max_step: Optional[int] = None):
        """(state, start_step, torn_discarded): the newest intact
        checkpoint at step <= ``max_step`` laid out on the CURRENT cluster,
        or a fresh init when none exists."""
        if self.ckpt.latest_step() is None and max_step is None:
            state = self.bundle.init_layout_state(self.seed)
            self.layouts.append((self.cluster.label, _group_bytes(state)))
            return state, 0, ()
        with warnings.catch_warnings(record=True) as wlog:
            warnings.simplefilter("always")
            state, start = self.ckpt.restore(
                self.bundle.abstract_state(), step=max_step,
                layout=self.bundle.layout_state)
        discarded = []
        for w in wlog:
            m = re.search(r"checkpoint step (\d+) is torn", str(w.message))
            if m:
                discarded.append(int(m.group(1)))
                logger.warning("%s", w.message)
        self.layouts.append((self.cluster.label, _group_bytes(state)))
        return state, start, tuple(discarded)

    def _tear_newest_checkpoint(self) -> None:
        """Fault injection: corrupt the newest committed step on disk (a
        truncated shard file).  The next restore must discard it with a
        warning and fall back to the previous intact step."""
        self.ckpt.wait()
        step = self.ckpt.latest_step()
        if step is None:
            return
        path = os.path.join(self.ckpt.root, f"step_{step:08d}",
                            "shard_0.npz")
        with open(path, "wb") as f:
            f.write(b"torn")
        logger.warning("fault injection: tore checkpoint step %d (%s)",
                       step, path)

    # -- failure detection ---------------------------------------------------
    def _heartbeat(self, step: int) -> dict[int, float]:
        """Synthetic per-host step times (base 1.0) with the active
        scripted slowdowns applied."""
        times = {}
        for h in range(self.cluster.pods):
            f = 1.0
            for ev in self._slowdowns:
                if ev.host == h and ev.step <= step < ev.step + ev.duration:
                    f = max(f, ev.factor)
            times[h] = f
        return times

    # -- recovery ------------------------------------------------------------
    def _recover(self, failure: PodLost, *, at_step: int):
        """The full recovery path.  Returns (state, resume_step, stream)."""
        self.ckpt.wait()   # land (or surface) the in-flight save first
        old_label = self.cluster.label
        old_sig = self.comm.signature
        survivor = self.cluster.without_pod(failure.pod)
        logger.warning("step %d: %s — rebuilding %s -> %s", at_step,
                       failure, old_label, survivor.label)
        self._build(survivor)
        state, start, torn = self._restore()
        stale = self.ckpt.discard_after(start)
        self.recoveries.append(RecoveryRecord(
            trigger_step=at_step, cause=failure.cause, lost_pod=failure.pod,
            old_label=old_label, new_label=survivor.label,
            old_signature=old_sig, new_signature=self.comm.signature,
            restored_step=start, torn_discarded=torn,
            stale_dropped=tuple(stale), retune=self.retuned))
        logger.warning(
            "recovered: signature %s -> %s, resumed step %d, retune "
            "sources %s", old_sig, self.comm.signature, start,
            self.retuned.sources)
        stream = SyntheticLM(self._data_cfg(), start_step=start)
        return state, start, stream

    # -- the supervised loop -------------------------------------------------
    def run(self, steps: int, *, from_step: Optional[int] = None,
            save: bool = True) -> ElasticReport:
        """Train to ``steps``, surviving the fault plan.

        ``from_step`` pins the starting checkpoint (a reference run
        starting mid-trajectory); ``save=False`` leaves the checkpoint
        directory as it is (a reference run must not overwrite the run
        under test)."""
        state, start, _ = self._restore(max_step=from_step)
        stream = SyntheticLM(self._data_cfg(), start_step=start)
        losses: dict[int, float] = {}
        step = start
        while step < steps:
            try:
                for idx, ev in self.plan.pending(step, self._fired):
                    self._fired.add(idx)
                    EVENT_HANDLERS[ev.kind](self, ev)
                evicted = self.straggler.observe(self._heartbeat(step))
                if evicted:
                    raise PodLost(evicted[0], "straggler")
                batch = self.bundle.layout_batch(stream.next_batch())
                state, metrics = self.step_fn(state, batch)
                losses[step] = float(metrics["loss"][0])
                step += 1
                if save:
                    self.mgr.maybe_save(step, state)
            except PodLost as failure:
                state = None           # the lost cluster's layout
                state, step, stream = self._recover(failure, at_step=step)
        if save:
            self.mgr.save(steps, state, blocking=True)
        return ElasticReport(losses=losses,
                             recoveries=tuple(self.recoveries),
                             start_step=start, final_step=steps,
                             cluster_label=self.cluster.label,
                             signature=self.comm.signature, state=state,
                             layouts=tuple(self.layouts))


def reference_run(cfg, cluster, *, ckpt_dir: str, from_step: int,
                  steps: int, **kw) -> ElasticReport:
    """The bit-identity oracle: a fresh run that STARTS on ``cluster`` (the
    post-failure topology) at ``from_step``, restoring the same pinned
    checkpoint and training forward with no faults and no saves.  A
    recovered ``ElasticRuntime`` run must match its loss trajectory
    bit for bit from ``from_step`` on."""
    rt = ElasticRuntime(cfg, cluster, ckpt_dir=ckpt_dir, **kw)
    return rt.run(steps, from_step=from_step, save=False)
