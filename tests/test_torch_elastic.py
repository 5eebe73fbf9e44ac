"""The port's elastic runtime held to the reference's.

``repro_torch.runtime.elastic`` against ``tests/test_elastic.py``'s
contract on the reduced ``qwen3-0.6b`` (2 layers, d 64, 4 heads), 2x4
only: the ``FaultPlan`` grammar and the one-registration extension; a pod
lost at step 3 with saves every 2 steps — one recovery 2x4 -> 1x4 restored
at step 2, the modeled retune logged, losses for steps 0-5 — whose
trajectory from step 2 is bit-identical (``==`` on the floats) to
``reference_run`` started on 1x4 at step 2; the same plan against the
reference's ``train_elastic`` from the same initial state (the reference's
``init_state(0)``, written by the reference's checkpointer at step 0 and
restored by the port), losses within rtol 2e-4 and every recovery-record
field equal; a torn newest checkpoint during recovery; and a straggler
eviction.
"""

import logging

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.runtime.elastic import FaultEvent as JFaultEvent
from repro.runtime.elastic import FaultPlan as JFaultPlan
from repro.runtime.steps import make_cluster_train_step as jmake
from repro.runtime.train_loop import train_elastic as jtrain_elastic
from repro.substrate import VirtualCluster as JVC
from repro_torch.configs import get_config
from repro_torch.runtime.elastic import (EVENT_HANDLERS, ElasticRuntime,
                                         FaultEvent, FaultPlan,
                                         register_event, reference_run)
from repro_torch.runtime.fault_tolerance import StragglerPolicy
from repro_torch.runtime.train_loop import train_elastic
from repro_torch.substrate import VirtualCluster

KW = dict(save_every=2, global_batch=8, seq=16)


def tiny_cfg():
    return get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64,
                                            n_heads=4)


def _vc():
    return VirtualCluster(pods=2, chips=4, device="cpu")


# ---------------------------------------------------------------------------
# FaultPlan grammar
# ---------------------------------------------------------------------------

def test_fault_plan_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan((FaultEvent(kind="asteroid", step=3),))


def test_fault_plan_rejects_negative_step():
    with pytest.raises(ValueError, match="step"):
        FaultPlan((FaultEvent.pod_loss(-1),))


def test_fault_plan_fires_each_event_once():
    plan = FaultPlan((FaultEvent.pod_loss(3), FaultEvent.torn_checkpoint(3),
                      FaultEvent.host_slowdown(5, 1, factor=2.0)))
    fired = set()
    first = plan.pending(3, fired)
    assert [ev.kind for _, ev in first] == ["pod_loss", "torn_checkpoint"]
    for idx, _ in first:
        fired.add(idx)
    assert plan.pending(3, fired) == []
    assert [ev.kind for _, ev in plan.pending(5, fired)] == \
        ["host_slowdown"]


def test_event_constructors_fill_kind_fields():
    ev = FaultEvent.host_slowdown(7, 2, factor=3.0, duration=4)
    assert (ev.kind, ev.step, ev.host, ev.factor, ev.duration) == \
        ("host_slowdown", 7, 2, 3.0, 4)
    assert FaultEvent.pod_loss(1, pod=0).pod == 0
    assert FaultEvent.torn_checkpoint(2).kind == "torn_checkpoint"


def test_new_failure_kind_is_one_registration():
    calls = []

    @register_event("power_blip")
    def _blip(rt, ev):
        calls.append(ev.step)

    try:
        plan = FaultPlan((FaultEvent(kind="power_blip", step=4),))
        fired = set()
        for idx, ev in plan.pending(4, fired):
            fired.add(idx)
            EVENT_HANDLERS[ev.kind](None, ev)
        assert calls == [4]
        assert plan.pending(4, fired) == []
    finally:
        EVENT_HANDLERS.pop("power_blip", None)


# ---------------------------------------------------------------------------
# One pod-loss recovery, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pod_loss(tmp_path_factory):
    """The port's run: a pod lost at step 3 on 2x4, 6 steps, saves every
    2, with the tuning log captured."""
    ckpt = str(tmp_path_factory.mktemp("elastic") / "ckpt")
    logs = []

    class _Keep(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    lg = logging.getLogger("repro_torch.comm.tuning")
    h, level = _Keep(level=logging.INFO), lg.level
    lg.addHandler(h)
    lg.setLevel(logging.INFO)
    try:
        rep = train_elastic(tiny_cfg(), _vc(), steps=6, ckpt_dir=ckpt,
                            plan=FaultPlan((FaultEvent.pod_loss(3, pod=1),)),
                            **KW)
    finally:
        lg.removeHandler(h)
        lg.setLevel(level)
    return rep, ckpt, "\n".join(logs)


def test_pod_loss_recovery_smoke(pod_loss):
    rep, _, log = pod_loss
    assert len(rep.recoveries) == 1
    rec = rep.recoveries[0]
    assert rec.cause == "pod_loss" and rec.lost_pod == 1
    assert (rec.old_signature, rec.new_signature) == ("2x4", "1x4")
    assert rec.restored_step == 2
    assert rec.retune.sources.get("modeled", 0) > 0
    assert "signature not in tuning table" in log
    assert sorted(rep.losses) == list(range(6))
    assert rep.cluster_label == "1x4" and rep.signature == "1x4"
    # the laid-out state holds one copy of the logical state per node
    (l0, b0), (l1, b1) = rep.layouts
    assert (l0, l1) == ("2x4", "1x4") and b0 == 2 * b1


def test_recovery_is_bit_identical_to_reference_run(pod_loss):
    rep, ckpt, _ = pod_loss
    rec = rep.recoveries[0]
    ref = reference_run(tiny_cfg(), _vc().without_pod(1), ckpt_dir=ckpt,
                        from_step=rec.restored_step, steps=6, **KW)
    assert ref.start_step == rec.restored_step == 2
    assert sorted(ref.losses) == [2, 3, 4, 5]
    for s in sorted(ref.losses):
        assert rep.losses[s] == ref.losses[s], \
            f"step {s}: {rep.losses[s]} != {ref.losses[s]}"


def test_pod_loss_matches_the_reference_train_elastic(tmp_path):
    """The same plan through both packages from the same initial state:
    the loss trajectories within rtol 2e-4 and the recovery records
    field for field."""
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced(n_layers=2, d_model=64,
                                                     n_heads=4)
    jvc = JVC(pods=2, chips=4)
    jb = jmake(jcfg, jvc, global_batch=8, lr=1e-3, opts=("stepgraph",))
    init = jax.device_get(jax.jit(lambda: jb.init_state(0))())
    port_dir = str(tmp_path / "port")
    JCheckpointer(port_dir).save(0, init, blocking=True)
    plan = ((3, 1),)
    rep = train_elastic(tiny_cfg(), _vc(), steps=6, ckpt_dir=port_dir,
                        plan=FaultPlan(tuple(FaultEvent.pod_loss(s, pod=p)
                                             for s, p in plan)), **KW)
    jrep = jtrain_elastic(jcfg, jvc, steps=6,
                          ckpt_dir=str(tmp_path / "reference"),
                          plan=JFaultPlan(tuple(JFaultEvent.pod_loss(s, pod=p)
                                                for s, p in plan)), **KW)
    assert sorted(rep.losses) == sorted(jrep.losses) == list(range(6))
    np.testing.assert_allclose(rep.loss_trajectory(),
                               jrep.loss_trajectory(), rtol=2e-4)
    (rec,), (jrec,) = rep.recoveries, jrep.recoveries
    for f in ("trigger_step", "cause", "lost_pod", "old_label", "new_label",
              "old_signature", "new_signature", "restored_step",
              "torn_discarded", "stale_dropped"):
        assert getattr(rec, f) == getattr(jrec, f), f
    assert rec.retune.signature == jrec.retune.signature
    assert [(f, e, r.scheme, r.source) for f, e, r in rec.retune.rows] == \
        [(f, e, r.scheme, r.source) for f, e, r in jrec.retune.rows]


def test_torn_checkpoint_falls_back_during_recovery(tmp_path):
    plan = FaultPlan((FaultEvent.torn_checkpoint(5),
                      FaultEvent.pod_loss(5, pod=0)))
    rt = ElasticRuntime(tiny_cfg(), _vc(), ckpt_dir=str(tmp_path / "ckpt"),
                        plan=plan, **KW)
    rep = rt.run(7)
    assert len(rep.recoveries) == 1
    rec = rep.recoveries[0]
    assert rec.torn_discarded == (4,)
    assert rec.restored_step == 2
    assert 4 in rec.stale_dropped
    assert sorted(rep.losses) == list(range(7))


def test_straggler_eviction_triggers_elastic_shrink(tmp_path):
    plan = FaultPlan((FaultEvent.host_slowdown(2, 1, factor=8.0,
                                               duration=10),))
    rt = ElasticRuntime(tiny_cfg(), _vc(), ckpt_dir=str(tmp_path / "ckpt"),
                        plan=plan, straggler_factory=lambda: StragglerPolicy(
                            patience=2), **KW)
    rep = rt.run(6)
    assert len(rep.recoveries) == 1
    rec = rep.recoveries[0]
    assert rec.cause == "straggler" and rec.lost_pod == 1
    assert (rec.old_signature, rec.new_signature) == ("2x4", "1x4")
    assert rec.retune.sources.get("modeled", 0) > 0
    assert sorted(rep.losses) == list(range(6))
    assert rep.cluster_label == "1x4"
