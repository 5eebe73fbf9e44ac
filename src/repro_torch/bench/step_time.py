"""End-to-end ``step_time`` bench family: whole train steps, not medians of
one collective.

The reference's ``repro/bench/step_time.py`` on the port's substrate.  The
single-collective families measure each schedule in isolation; what the
prefetch and the step graph buy only shows in a full forward / backward
step.  This family times that, over the model-zoo configs, through the same
machinery as every other family: its schemes are registry entries, its
cases carry traffic expectations that ``bench.validate`` cross-checks
against each timed run's traffic record, and its cells land in the bench
report.

* ``eager``     — the window reads issued inside each unit at use time and
  again by the remat recompute in the backward;
* ``prefetch``  — the same step with the ``prefetch`` opt: unit *k+1*'s
  reads issued as ``AsyncCollectiveHandle``s on the side stream while unit
  *k* computes, outside the remat region (read once per step);
* ``stepgraph`` — the same step with the ``stepgraph`` opt: the scalar
  stats and per-leaf gradient reductions recorded into one
  ``CollectiveGraph`` and issued as the bucketed schedule.

**The link inventory.**  A step's collective content is whatever the model
runs, so there is no closed form in ``(pods, chips, elems)``; each scheme
carries a per-config inventory recorded when the case is built.  The
reference reads it off the step's jaxpr; the port, which has no jaxpr,
reads it off the substrate's own traffic record
(``substrate.collectives.recording``) over one untimed step
(``link_inventory``), priced with the ring model
(``analysis.traffic.link_bytes``).  A window read is recorded as the
all-gather it stands for on a node, its gradient as the reduce-scatter
(``SharedWindow.read_node``), and a model run once per memory domain
records its first domain's collectives as each rank's.  ``bench.validate``
then holds every timed run's own record to that inventory — a second run,
so a schedule that changes between runs (a lost prefetch, an extra read, a
wrong group) fails the ``link/fast`` / ``link/slow`` checks — and the
parity tests hold the inventory to the reference's ``link_inventory`` on
2x4, byte for byte.

**Timing.**  A whole step (autograd, the remat recompute, the side stream)
is not a CUDA-graph capture target, so the cases time eager steps with
CUDA events (``BenchCase.eager``: ``runner.Captured(..., capture=False)``);
the report's ``timing.mode`` says ``eager``, and every timed rep's own
traffic record is held to the inventory too.

Case sizing: ``elems`` is the model's global parameter element count, so
quick and full sweeps land on the same cells.
"""

from __future__ import annotations

from types import MappingProxyType
from typing import Optional

from repro_torch.analysis.traffic import link_bytes
from repro_torch.bench.suites import BenchCase, _swept
from repro_torch.comm import registry
from repro_torch.comm.registry import CollectiveScheme, register_scheme
from repro_torch.configs import get_config
from repro_torch.core.plans import CollectiveTraffic, collective_time_model
from repro_torch.substrate.collectives import CollectiveRecord, recording

#: model-zoo configs timed by the family (reduced shapes: the bench measures
#: schedules, not model quality).  Both are plain dense, untied-embedding
#: entries, as in the reference.
STEP_CONFIGS = ("starcoder2-7b", "mistral-nemo-12b")

#: why the family is timed eagerly (``TimingResult.note``)
EAGER_NOTE = ("a whole train step (autograd, remat recompute, side-stream "
              "reads) is timed eagerly with CUDA events, not captured")


# ---------------------------------------------------------------------------
# The link inventory (the expected side of the per-run cross-check)
# ---------------------------------------------------------------------------

def link_entries(body, args: tuple, vc) -> list[CollectiveRecord]:
    """The traffic record of one run of ``body(*args)`` (stacked inputs)
    under the cluster's mesh: one ``CollectiveRecord`` per message a rank
    sends — counting records counts messages, as the step-graph tests
    do."""
    with recording() as rec, vc.bind():
        body(*args)
    return list(rec)


def link_inventory(body, args: tuple, vc) -> tuple[float, float]:
    """Per-rank (fast, slow) link bytes of one run of ``body(*args)``:
    ``link_entries`` priced with the ring model — AG ``out*(n-1)/n``, RS
    ``out*(n-1)``, AR ``2*out*(n-1)/n``, A2A ``out*(n-1)/n``, permute
    ``out`` — a group naming a slow axis charged to the bridge tier."""
    return link_bytes(link_entries(body, args, vc))


# ---------------------------------------------------------------------------
# The step schemes
# ---------------------------------------------------------------------------

def _no_dispatch(*_a, **_k):
    raise NotImplementedError(
        "step_time schemes are whole-train-step bench entries; they have no "
        "Communicator dispatch body — build cases via "
        "repro_torch.bench.step_time.step_time_cases")


class StepTimeScheme(CollectiveScheme):
    """Base of the ``step_time`` schemes: a registry entry whose expected
    traffic is a recorded per-config inventory instead of a closed form.

    ``step_time_cases`` records each built case's inventory here;
    ``links()`` replays it for ``validate.expected_links``, ``traffic`` /
    ``predicted_time`` express it in ``core.plans`` terms."""

    result_class = "replicated"
    FAMILY = "step_time"
    ops = MappingProxyType({"step_time": _no_dispatch})
    opts: tuple = ()            # ParallelCtx opts that select this schedule
    N_OUT = 3                   # loss, gnorm, checksum: replicated f32

    def __init__(self):
        # (pods, chips, fast_shape, elems) -> (fast, slow) per-rank bytes
        self._inventory: dict = {}

    def record(self, *, pods: int, chips: int, fast_shape, elems: int,
               fast: float, slow: float) -> None:
        self._inventory[(pods, chips, tuple(fast_shape), elems)] = \
            (fast, slow)

    def _lookup(self, pods: int, chips: int, elems: int
                ) -> Optional[tuple[float, float]]:
        for (p, c, _fs, e), v in self._inventory.items():
            if (p, c, e) == (pods, chips, elems):
                return v
        return None

    def links(self, family, *, pods, chips, fast_shape, elems, elem_bytes=4,
              opts=None, dtype="float32"):
        inv = self._inventory.get((pods, chips, tuple(fast_shape), elems))
        if inv is None:
            raise ValueError(
                f"{self.name!r} has no recorded link inventory for "
                f"{pods}x{chips} (fast {fast_shape}) at {elems} elems — "
                f"{self.FAMILY} expectations are recorded per case by the "
                "family's case builder, not closed forms")
        return inv

    def result_node(self, family, *, pods, chips, elems, elem_bytes=4):
        # replicated scalars: every rank holds each f32 output once
        return self.N_OUT * 4 * chips

    def traffic_for(self, *, pods: int, chips: int, fast_shape, elems: int
                    ) -> CollectiveTraffic:
        fast, slow = self.links(self.FAMILY, pods=pods, chips=chips,
                                fast_shape=fast_shape, elems=elems)
        R = pods * chips
        return CollectiveTraffic(
            slow_bytes=slow * R, fast_bytes=fast * R,
            result_bytes_per_node=self.result_node(
                self.FAMILY, pods=pods, chips=chips, elems=elems))

    def traffic(self, family, *, pods, chips, elems, elem_bytes=4,
                populations=None):
        if family != self.FAMILY:
            return super().traffic(family, pods=pods, chips=chips,
                                   elems=elems, elem_bytes=elem_bytes,
                                   populations=populations)
        inv = self._lookup(pods, chips, elems)
        if inv is None:
            raise ValueError(f"{self.name!r}: no recorded inventory for "
                             f"{pods}x{chips}/e{elems}")
        R = pods * chips
        return CollectiveTraffic(
            slow_bytes=inv[1] * R, fast_bytes=inv[0] * R,
            result_bytes_per_node=self.result_node(
                family, pods=pods, chips=chips, elems=elems))

    def predicted_time(self, family, *, pods, chips, elems, elem_bytes=4,
                       populations=None):
        if self._lookup(pods, chips, elems) is None:
            return None         # unrecorded config: cannot rank off-table
        tr = self.traffic(family, pods=pods, chips=chips, elems=elems)
        return collective_time_model(tr, num_nodes=pods,
                                     ranks_per_node=chips), {}


class StepEagerScheme(StepTimeScheme):
    """Issue-at-use baseline: window reads inside each unit at use time,
    read again by the remat recompute in the backward."""

    name = "eager"
    opts = ()


class StepPrefetchScheme(StepTimeScheme):
    """The async-prefetch step: unit *k+1*'s reads in flight
    (``AsyncCollectiveHandle`` on the side stream) while unit *k*
    computes, double-buffered (in-flight budget 2), kept for the
    backward."""

    name = "prefetch"
    opts = ("prefetch",)


class StepStepgraphScheme(StepTimeScheme):
    """The step-graph-optimized step: scalar stats + per-leaf gradient
    reductions recorded into one ``CollectiveGraph`` and issued as the
    rewritten schedule — fewer, larger bridge messages; outputs
    bit-identical to ``eager``."""

    name = "stepgraph"
    opts = ("stepgraph",)


EAGER = register_scheme(StepEagerScheme())
PREFETCH = register_scheme(StepPrefetchScheme())
STEPGRAPH = register_scheme(StepStepgraphScheme())


# ---------------------------------------------------------------------------
# Case builder
# ---------------------------------------------------------------------------

def step_time_cases(vc, on_skip=None, schemes=None):
    """One case per (model config, step scheme) on this cluster.

    Builds the flattened-state train-step body (``runtime.steps.
    make_step_bench``), records its link inventory on the scheme from one
    untimed step, and yields a ``BenchCase`` whose timed runs the validate
    layer holds to it."""
    from repro_torch.runtime.steps import make_step_bench

    for cfg_name in STEP_CONFIGS:
        cfg = get_config(cfg_name).reduced()
        for sch in _swept(registry.schemes_for("step_time"), schemes):
            body, _in, _out, make_args, elems = make_step_bench(
                cfg, vc, opts=sch.opts, unroll=cfg.n_units)
            fast_b, slow_b = link_inventory(body, make_args(), vc)
            sch.record(pods=vc.pods, chips=vc.chips,
                       fast_shape=vc.fast_shape, elems=elems,
                       fast=fast_b, slow=slow_b)
            yield BenchCase(
                "step_time", sch.name, vc, elems, make_args=make_args,
                traffic=sch.traffic_for(pods=vc.pods, chips=vc.chips,
                                        fast_shape=vc.fast_shape,
                                        elems=elems),
                body_with=lambda _opts, b=body: b, eager=EAGER_NOTE)
