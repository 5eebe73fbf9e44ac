"""The port's step-graph optimizer and async handles against the JAX
reference (``repro.comm.stepgraph``, ``repro.comm.handle``).

Mirrors ``tests/test_stepgraph.py``, ``tests/test_stepgraph_props.py`` and
the first four tests of ``tests/test_async_prefetch.py``: the pack/unpack
codec bit-exact against the reference's, ``optimize()`` giving the
reference's schedule report on the same graph and table, the recorder and
``apply_schedule`` bit-identical to per-leaf eager sums (on the CPU here;
``chip_smoke.py`` phase 10 holds the card to the same), gather dedup only
within one epoch, async gathers equal to eager ones on every matrix
topology, the torn-handle rules and gradients through ``resolve``.

One deliberate difference: where the greedy partition leaves a single
message in a part (a message at or above the bucket target), the reference
issues a "bucket" of one and the port issues it as a single — its own
schedule gate forbids buckets of one.  ``_ported`` applies that rule to the
reference's schedule; every other field must match as it is.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.comm import Communicator as JComm
from repro.comm import stepgraph as jsg
from repro.comm import tuning as jtuning
from repro.substrate import default_matrix as jmatrix
from repro_torch.bench import gates
from repro_torch.comm import Communicator, WindowEpochError, stepgraph, tuning
from repro_torch.comm.handle import AsyncCollectiveHandle
from repro_torch.core.plans import greedy_buckets
from repro_torch.substrate import default_matrix
from repro_torch.substrate import collectives as coll

ROOT = pathlib.Path(__file__).resolve().parent.parent
PAIRS = {t.label: (j, t) for j, t in zip(jmatrix(), default_matrix(
    device="cpu"))}
LABELS = list(PAIRS)


def _tables():
    """The reference's committed table in both packages."""
    with open(ROOT / "TUNING_default.json") as f:
        d = json.load(f)
    ref = jtuning.TuningTable.from_dict(d)
    d["schema"] = tuning.SCHEMA_VERSION
    return tuning.TuningTable.from_dict(d), ref


# ---------------------------------------------------------------------------
# pack/unpack codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("pad_to", [1, 7])
def test_pack_unpack_bit_exact_against_reference(dtype, pad_to):
    rng = np.random.default_rng(3)
    R = 3
    shapes = [(3, 2), (), (5,), (1, 1, 4), (0, 2)]
    leaves = [(rng.normal(size=(R,) + s) * 100).astype(dtype)
              for s in shapes]
    buf, spec = stepgraph.pack_leaves([torch.from_numpy(x) for x in leaves],
                                      pad_to=pad_to)
    assert buf.shape == (R, spec.total_elems)
    for r in range(R):
        jbuf, jspec = jsg.pack_leaves([jnp.asarray(x[r]) for x in leaves],
                                      pad_to=pad_to)
        np.testing.assert_array_equal(buf[r].numpy(), np.asarray(jbuf))
        assert (spec.shapes, spec.pad_elems, spec.leaf_elems,
                spec.total_elems) == (jspec.shapes, jspec.pad_elems,
                                      jspec.leaf_elems, jspec.total_elems)
    flat = np.concatenate([x.reshape(R, -1) for x in leaves]
                          + [np.zeros((R, spec.pad_elems), dtype)], axis=1)
    np.testing.assert_array_equal(buf.numpy(), flat)   # program order
    for x, y in zip(leaves, stepgraph.unpack_leaves(buf, spec)):
        assert y.dtype == torch.from_numpy(x).dtype and y.shape == x.shape
        np.testing.assert_array_equal(y.numpy(), x)


def test_codec_polices_empty_mixed_and_misshapen():
    with pytest.raises(ValueError):
        stepgraph.pack_leaves([])
    with pytest.raises(ValueError, match="mixed"):
        stepgraph.pack_leaves([torch.zeros(2, 2),
                               torch.zeros(2, 2, dtype=torch.bfloat16)])
    buf, spec = stepgraph.pack_leaves([torch.zeros(2, 4)])
    with pytest.raises(ValueError):
        stepgraph.unpack_leaves(torch.zeros(2, spec.total_elems + 1), spec)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_buckets_is_an_ordered_partition(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(0, 1 << 20, size=40)]
    target = int(rng.integers(1, 1 << 18))
    buckets = greedy_buckets(sizes, target)
    assert [i for b in buckets for i in b] == list(range(len(sizes)))
    for b in buckets[:-1]:
        total = sum(sizes[i] for i in b)
        assert total >= target and total - sizes[b[-1]] < target


# ---------------------------------------------------------------------------
# optimize(): the same graph and table give the reference's schedule
# ---------------------------------------------------------------------------

def _graph_recipes():
    """Named graph builders: each takes a graph class and adds nodes."""
    def ar(g, *, axes=("pod", "data"), dtype="float32", shape=(8,),
           scheme="naive", bucketable=True, key=None):
        g.add(family="allreduce", key=key, axes=axes, dtype=dtype,
              shape=shape, elem_bytes=4, scheme=scheme,
              bucketable=bucketable)

    def gather(g, key, epoch, axes=("data",)):
        g.add(family="gather", key=key, axes=axes, dtype="float32",
              shape=(4,), elem_bytes=4, epoch=epoch)

    def groups(g):
        for i in range(5):
            ar(g, key=("a", i))
        ar(g, axes=("pod",), key="other-axes")
        ar(g, dtype="float64", key="other-dtype")

    def pinned(g):
        ar(g, bucketable=False, key="p0")
        ar(g, bucketable=False, key="p1")
        ar(g, scheme="auto", key="auto1")
        ar(g, scheme="auto", key="auto2")

    def dedup(g):
        for key, epoch in (("w0", 1), ("w0", 1), ("w0", 2), ("w1", 1)):
            gather(g, key, epoch)

    def order(g):
        ar(g, key=("a", 0))
        ar(g, key=("a", 1))
        gather(g, "w0", 1)

    def gradients(g):
        """A gradient record: large weights between norms and scalars —
        parts of one message appear at every target."""
        for i, shape in enumerate([(4, 64), (4, 64, 128), (4, 64, 256),
                                   (4, 32), (4, 32), (4, 64),
                                   (4, 64, 384), (4, 192, 64), (), (), ()]):
            ar(g, shape=shape, key=("g", i))
        gather(g, "w", 3)
        ar(g, axes=("pod",), shape=(16,), key="bridge-0")
        ar(g, axes=("pod",), shape=(1,), key="bridge-1")

    return {"groups": groups, "pinned": pinned, "dedup": dedup,
            "order": order, "gradients": gradients}


RECIPES = _graph_recipes()


def _ported(ref):
    """The reference's schedule with the port's rule applied: a bucket of
    one message is issued as a single."""
    nodes = ref.graph.nodes
    buckets = [b for b in ref.buckets if len(b.nids) > 1]
    singles = sorted(list(ref.singles)
                     + [b.nids[0] for b in ref.buckets if len(b.nids) == 1])
    order = [o for o in ref.order if o[0] == "gather"]
    order += [("bucket", i) for i, _ in sorted(
        enumerate(buckets), key=lambda ib: nodes[ib[1].nids[0]].pos)]
    order += [("single", nid) for nid in sorted(singles,
                                                key=lambda i: nodes[i].pos)]
    return jsg.Schedule(graph=ref.graph, buckets=tuple(buckets),
                        singles=tuple(singles),
                        gather_primary=ref.gather_primary,
                        order=tuple(order))


def _report(schedule) -> dict:
    """A reference schedule's report under the port's schema string."""
    return dict(schedule.report(), schema=stepgraph.SCHEMA_VERSION)


@pytest.mark.parametrize("table", ["none", "reference"])
@pytest.mark.parametrize("shape", [(2, 4, 1), (4, 2, 1), (2, 4, 2)],
                         ids=["2x4", "4x2", "2x4-f2"])
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_optimize_report_matches_reference(recipe, shape, table):
    pods, chips, n_fast = shape
    ptable, jtable = _tables() if table == "reference" else (None, None)
    g, jg = stepgraph.CollectiveGraph(), jsg.CollectiveGraph()
    RECIPES[recipe](g)
    RECIPES[recipe](jg)
    kw = dict(pods=pods, chips=chips, n_fast_axes=n_fast)
    got = stepgraph.optimize(g, table=ptable, **kw)
    ref = jsg.optimize(jg, table=jtable, **kw)
    want = _ported(ref)
    assert got.report() == _report(want)
    assert got.gather_primary == ref.gather_primary
    for b, jb in zip(got.buckets, want.buckets):
        assert dataclasses.astuple(b) == dataclasses.astuple(jb)
    if all(len(b.nids) > 1 for b in ref.buckets):
        assert got.report() == _report(ref)       # no difference to apply
    pinned = stepgraph.optimize(g, target_bytes=64, **kw)
    assert pinned.report() == _report(_ported(
        jsg.optimize(jg, target_bytes=64, **kw)))


def test_reference_issues_buckets_of_one_where_the_port_does_not():
    """The difference ``_ported`` applies is real: on the gradient record
    the reference's partition leaves single-message parts."""
    jg, g = jsg.CollectiveGraph(), stepgraph.CollectiveGraph()
    RECIPES["gradients"](jg)
    RECIPES["gradients"](g)
    ref = jsg.optimize(jg, pods=2, chips=4, target_bytes=1 << 14)
    got = stepgraph.optimize(g, pods=2, chips=4, target_bytes=1 << 14)
    assert any(len(b.nids) == 1 for b in ref.buckets)
    assert all(len(b.nids) > 1 for b in got.buckets)
    r = dict(got.report(), config="gradients", topology="2x4", pods=2,
             chips=4, elems=0)
    assert gates.schedule_failures({"schema": r["schema"],
                                    "reports": [r]}) == []
    jr = dict(ref.report(), config="gradients", topology="2x4", pods=2,
              chips=4, elems=0, schema=stepgraph.SCHEMA_VERSION)
    assert any("member" in e for e in gates.check_report(jr, "reference"))


# ---------------------------------------------------------------------------
# apply: the recorder against eager sums, and against the reference
# ---------------------------------------------------------------------------

SHAPES = [(3, 5), (7,), (), (2, 2, 3), (1,), (33,), (4, 100)]


def _leaves(vc, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(vc.num_devices,) + s).astype(np.float32)
            for s in SHAPES]


@pytest.mark.parametrize("label", LABELS)
def test_recorder_matches_eager_and_reference_psum(label):
    """``rec.run()`` returns exactly the port's eager psum of every leaf
    (bit for bit: the substrate adds members in a fixed order for every
    shape, so a packed bucket sums like its leaves), and the reference's
    ``lax.psum`` within the port's sum tolerance."""
    jvc, vc = PAIRS[label]
    comm = Communicator.from_cluster(vc)
    xs = _leaves(vc)
    with vc.bind():
        rec = comm.record()
        refs = [rec.allreduce(torch.from_numpy(x), axes=comm.axes, key=i)
                for i, x in enumerate(xs)]
        res = rec.run()
        got = [res[r] for r in refs]
        for g_, x in zip(got, xs):
            assert torch.equal(g_, coll.psum(torch.from_numpy(x),
                                             comm.axes))
    assert len(res.schedule.buckets) >= 1
    jcomm = JComm.from_cluster(jvc)
    for x, g_ in zip(xs, got):
        def body(v):
            return lax.psum(v, jcomm.axes)
        want = jax.jit(jvc.smap(body, (jvc.spec,), jvc.spec))(
            x.reshape((-1,) + x.shape[2:]) if x.ndim > 1 else x)
        np.testing.assert_allclose(
            g_.numpy().reshape(np.asarray(want).shape), np.asarray(want),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("label", ["2x4", "2x(2x2)-pod.dp.tp"])
def test_apply_schedule_bit_identical_to_eager(label):
    """Every kind of node at once: bucketed and pinned allreduces over the
    full axes and the bridge alone, an identity, and deduped gathers — each
    result equal to its eager counterpart."""
    _, vc = PAIRS[label]
    comm = Communicator.from_cluster(vc)
    xs = [torch.from_numpy(x) for x in _leaves(vc, seed=5)]
    with vc.bind():
        win = comm.allgather(xs[0], scheme="shared")
        rec = comm.record()
        full = [rec.allreduce(x, axes=comm.axes, key=i)
                for i, x in enumerate(xs)]
        bridge = [rec.allreduce(x, axes=("pod",), key=("b", i))
                  for i, x in enumerate(xs[:3])]
        pinned = rec.allreduce(xs[6], axes=comm.axes, scheme="hier",
                               bucketable=False, key="pinned")
        ident = rec.allreduce(xs[2], axes=(), key="identity")
        g1 = rec.gather(win, key="w")
        g2 = rec.gather(win, key="w")
        res = rec.run()
        for r, x in zip(full, xs):
            assert torch.equal(res[r], coll.psum(x, comm.axes))
        for r, x in zip(bridge, xs):
            assert torch.equal(res[r], coll.psum(x, "pod"))
        assert torch.equal(res[pinned], comm.allreduce(xs[6],
                                                       scheme="hier"))
        assert res[ident] is xs[2]
        assert torch.equal(res[g1], win.read()) and res[g2] is res[g1]
        out = res.resolve({"a": [full[0], ident], "b": (g1, 3)})
        assert out["a"][1] is xs[2] and out["b"][1] == 3
        assert torch.equal(out["a"][0], res[full[0]])
        again = comm.apply_schedule(res.schedule, rec._values)
        for r in full:
            assert torch.equal(again[r.nid], res[r])
    rep = res.report()
    assert rep["allreduce"]["after_messages"] < \
        rep["allreduce"]["before_messages"]
    assert rep["gather"] == {"before_issues": 2, "after_issues": 1}
    r = dict(rep, config="test", topology=label, pods=vc.pods,
             chips=vc.chips, elems=0)
    assert gates.check_report(r, label) == []


def test_gather_dedup_only_within_one_epoch():
    _, vc = PAIRS["2x4"]
    comm = Communicator.from_cluster(vc)
    x = torch.from_numpy(_leaves(vc)[0])
    with vc.bind():
        win = comm.allgather(x, scheme="shared")
        bumped = win.store(win.shard * 2).fence()
        rec = comm.record()
        a = rec.gather(win, key="w")
        b = rec.gather(win, key="w")
        c = rec.gather(bumped, key="w")
        res = rec.run()
        assert res[a] is res[b]
        assert torch.equal(res[c], bumped.read())
        assert not torch.equal(res[c], res[a])
    assert res.report()["gather"] == {"before_issues": 3, "after_issues": 2}


def test_schedule_reports_match_the_reference():
    """``schedule_reports`` traces the ``step_time`` step's recorded graph
    per (config, topology): under the same table (the reference's
    committed one, and none) every row equals the reference's but for the
    schema string — the step records the same graph and the optimizer
    rewrites it the same way (no reference part is a bucket of one here,
    so ROADMAP Queue 3's bucket-of-one rule does not bite)."""
    ptable, jtable = _tables()
    with tuning.use_table(ptable), jtuning.use_table(jtable):
        got = stepgraph.schedule_reports()
        want = jsg.schedule_reports()
    assert [(r["config"], r["topology"]) for r in got] == \
        [(r["config"], r["topology"]) for r in want]
    for g, w in zip(got, want):
        assert all(b["count"] > 1 for b in w["buckets"])
        assert g == dict(w, schema=stepgraph.SCHEMA_VERSION)


def test_committed_schedule_artifact_is_current_and_passes_the_checks():
    """The committed ``artifacts/SCHEDULE_stepgraph_h100.json`` is what
    ``python -m repro_torch.comm.stepgraph`` emits under the committed H100
    table (under no table at all the rows are the reference's too), and
    passes ``bench.gates`` and the reference's
    ``scripts/check_schedule_report.py`` (its report checks, with the
    schema string relabelled: the port's reports carry their own)."""
    import importlib.util
    doc = json.loads(stepgraph.ARTIFACT.read_text())
    assert doc["schema"] == stepgraph.SCHEMA_VERSION
    assert doc["tuning_table"] == "TUNING_h100.json"
    with tuning.use_table(tuning.TuningTable.load(
            stepgraph.ARTIFACT.parent / "TUNING_h100.json")):
        assert stepgraph.schedule_reports() == doc["reports"]
    with tuning.use_table(None), jtuning.use_table(None):
        got, want = stepgraph.schedule_reports(configs=("starcoder2-7b",)), \
            jsg.schedule_reports(configs=("starcoder2-7b",))
    assert got == [dict(w, schema=stepgraph.SCHEMA_VERSION) for w in want]
    assert gates.schedule_failures(doc) == []
    spec = importlib.util.spec_from_file_location(
        "check_schedule_report", ROOT / "scripts" / "check_schedule_report.py")
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    for r in doc["reports"]:
        assert check.check_report(dict(r, schema=check.SCHEMA),
                                  f"{r['config']}@{r['topology']}") == []
    assert any(r["allreduce"]["after_messages"]
               < r["allreduce"]["before_messages"]
               for r in doc["reports"] if r["pods"] > 1)


# ---------------------------------------------------------------------------
# AsyncCollectiveHandle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", LABELS)
def test_async_gather_matches_eager_and_reference(label):
    jvc, vc = PAIRS[label]
    comm, jcomm = Communicator.from_cluster(vc), JComm.from_cluster(jvc)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(vc.num_devices, 3)).astype(np.float32)
    with vc.bind():
        h = comm.allgather_async(torch.from_numpy(x)[:, None])
        assert h.family == "allgather" and h.done
        got = h.resolve()
        eager = comm.allgather(torch.from_numpy(x)[:, None],
                               scheme="shared").read()
    assert torch.equal(got, eager)

    def body(v):
        return jcomm.allgather_async(v).resolve()[None]

    want = np.asarray(jax.jit(jvc.smap(body, (jvc.spec,), jvc.spec))(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_resolve_after_store_or_fence_raises():
    _, vc = PAIRS["2x4"]
    comm = Communicator.from_cluster(vc)
    x = torch.zeros(vc.num_devices, 2)
    with vc.bind():
        h = comm.allgather_async(x)
        with pytest.raises(WindowEpochError, match="torn"):
            dataclasses.replace(h, window=h.window.store(x)).resolve()
        bumped = h.window.store(x).fence_local(h.event)
        torn = dataclasses.replace(h, window=bumped)
        assert not torn.done
        with pytest.raises(WindowEpochError, match="torn"):
            torn.resolve()
        dirty = comm.window(x, epoch=1).store(x)
        with pytest.raises(WindowEpochError, match="dirty"):
            AsyncCollectiveHandle.issue("allgather", dirty)


def test_gradient_through_resolve_equals_eager_gather():
    _, vc = PAIRS["2x4"]
    comm = Communicator.from_cluster(vc)
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.normal(size=(vc.num_devices, 4))
                          .astype(np.float32))
    R = vc.num_devices
    w = torch.from_numpy(rng.normal(size=(R, 4 * R)).astype(np.float32))
    grads = []
    with vc.bind():
        for run in ("async", "eager"):
            x = x0.clone().requires_grad_(True)
            full = comm.allgather_async(x).resolve() if run == "async" \
                else comm.allgather(x, scheme="shared").read()
            (full.reshape(w.shape) * w).sum().backward()
            grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])
    assert grads[0].abs().sum() > 0
