"""The port's collectives held against the JAX reference over the topology
matrix.

The same numpy inputs go through ``repro.substrate.VirtualCluster.run``
(conftest forces 8 host devices) and the port's stacked
``repro_torch.substrate.VirtualCluster.run`` on the CPU.  Gathers,
broadcasts and all-to-all must match bit for bit; sums match allclose
(rtol 1e-5: the reduction order differs).  Also covered: window epochs,
the registry closed forms, ``scheme="auto"``, the pipelined schemes, the
fused collective-matmuls, the sync primitives, the traffic record against
``links()`` and the measured C1.  The lossy wire formats run here under
``precision="lossy"`` (gathers bit for bit, sums allclose);
``tests/test_torch_quantized.py`` holds the rest of their contract.
"""

from dataclasses import astuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comm import Communicator as JComm
from repro.comm import registry as jregistry
from repro.comm import tuning as jtuning
from repro.core import sync as jsync
from repro.substrate import default_matrix as jmatrix
from repro_torch import convert
from repro_torch.analysis import traffic
from repro_torch.comm import Communicator, SharedWindow, WindowEpochError
from repro_torch.comm import pipeline, registry, tuning
from repro_torch.core import sync
from repro_torch.substrate import VirtualCluster, default_matrix
from repro_torch.substrate import collectives as coll

PAIRS = {t.label: (j, t) for j, t in zip(jmatrix(), default_matrix(
    device="cpu"))}
LABELS = list(PAIRS)
SUMS = ("psum", "reduce_scatter")
CASES = [(f, s.name) for f in traffic.FAMILIES
         for s in registry.schemes_for(f)]
LOSSY = {s.name for s in registry.schemes_for("psum")
         + registry.schemes_for("allgather") if s.precision == "lossy"}
EXACT_CASES = [(f, s) for f, s in CASES if s not in LOSSY]


def _jrun(jvc, body, *args, in_specs=None, out_specs=None):
    """The reference's ``VirtualCluster.run``, jitted (compiling the
    shard_map is faster than running it op by op)."""
    in_specs = (jvc.spec,) * len(args) if in_specs is None else in_specs
    out_specs = jvc.spec if out_specs is None else out_specs
    return jax.jit(jvc.smap(body, in_specs, out_specs))(*args)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _compare(family, got, want):
    for g, w in zip(got, want):
        if family in SUMS:
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(_np(g), _np(w))


def _family_call(comm, family, scheme, R, opts):
    """A body computing ``family`` under ``scheme``; a window comes back as
    its shard, so both packages return their raw rank-major layout."""
    method = getattr(comm, "allreduce" if family == "psum" else family)
    kw = {"root": R - 1} if family == "broadcast" else {}

    def body(*args):
        out = method(*args, scheme=scheme, **kw, **opts)
        if hasattr(out, "shard"):
            return out.shard
        return out
    return body


def _inputs(family, R, seed=0):
    rng = np.random.default_rng(seed)
    m = 2 * R if family == "alltoall" else 16
    x = rng.normal(size=(R * m, 3)).astype(np.float32)
    if family == "allgatherv":
        return x, rng.integers(1, m + 1, size=(R,)).astype(np.int32)
    return (x,)


@pytest.mark.parametrize("family,scheme", CASES,
                         ids=[f"{f}-{s}" for f, s in CASES])
@pytest.mark.parametrize("label", LABELS)
def test_primitive_matches_reference(label, family, scheme):
    jvc, tvc = PAIRS[label]
    R = tvc.num_devices
    opts = {"n_chunks": 2} if scheme == "pipelined" else \
        {"precision": "lossy"} if scheme in LOSSY else {}
    args = _inputs(family, R)
    out_specs = (jvc.spec, jvc.spec) if family == "allgatherv" else jvc.spec
    want = _jrun(jvc, _family_call(JComm.from_cluster(jvc), family, scheme, R,
                                opts),
                   *[jnp.asarray(a) for a in args], out_specs=out_specs)
    got = tvc.run(_family_call(Communicator.from_cluster(tvc), family,
                               scheme, R, opts), *args)
    if family != "allgatherv":
        want, got = (want,), (got,)
    _compare(family, got, want)


@pytest.mark.parametrize("label", LABELS)
def test_evidence_matrix_traffic_and_c1(label):
    """Every family x scheme: values agree across schemes, the recorded
    traffic prices to ``links()``, resident bytes match ``result_node()``,
    and the measured naive/shared ratio is ranks_per_node (C1)."""
    _, vc = PAIRS[label]
    rows = traffic.check_matrix(vc, elems=64)
    assert {(r.family, r.scheme) for r in rows} == set(EXACT_CASES)
    ratios = traffic.c1_ratios(rows)
    for fam in ("allgather", "broadcast", "psum"):
        assert ratios[(label, fam)] == vc.chips
    assert ratios[(label, "reduce_scatter")] == 1 / vc.pods


@pytest.mark.parametrize("family", ["allgather", "broadcast", "psum",
                                    "reduce_scatter"])
@pytest.mark.parametrize("label", LABELS)
def test_pipelined_every_chunking_equals_unchunked(label, family):
    """``pipelined`` with n_chunks=1 is ``hier`` (reduce_scatter: the flat
    ``naive`` slices), and every chunk count gives the same values."""
    _, vc = PAIRS[label]
    comm = Communicator.from_cluster(vc)
    R = vc.num_devices
    x = np.random.default_rng(0).normal(size=(R * 64, 3)).astype(np.float32)
    base = "naive" if family == "reduce_scatter" else "hier"
    want = vc.run(_family_call(comm, family, base, R, {}), x)
    for nc in (1, 2, 4):
        got = vc.run(_family_call(comm, family, "pipelined", R,
                                  {"n_chunks": nc}), x)
        if nc == 1 and family != "reduce_scatter":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# windows and sync
# ---------------------------------------------------------------------------

def test_window_dirty_read_raises_and_fence_closes_epochs():
    _, vc = PAIRS["2x4"]
    comm = Communicator.from_cluster(vc)
    x = vc.rank_major_input(m=4)

    def body(v):
        win = comm.allgather(v, scheme="shared")
        assert not win.dirty and win.epoch == 1
        dirty = win.store(win.shard * 2)
        with pytest.raises(WindowEpochError, match="fence"):
            dirty.read()
        fenced = dirty.fence()
        assert not fenced.dirty and fenced.epoch == 2
        local = dirty.fence_local(None)
        assert torch.equal(local.shard, fenced.shard)
        return fenced.read_rank_order()

    got = vc.run(body, x)
    want = vc.run(lambda v: comm.allgather(v, scheme="naive"), x)
    torch.testing.assert_close(got, 2 * want, rtol=0, atol=0)


def test_window_fence_is_value_preserving_for_nonfinite():
    _, vc = PAIRS["2x4"]
    comm = Communicator.from_cluster(vc)
    bad = np.full((vc.num_devices * 2,), np.nan, np.float32)
    bad[1::2] = np.inf
    out = vc.run(lambda v: comm.window(v, epoch=1).store(v).fence().shard,
                 bad)
    np.testing.assert_array_equal(out.numpy(), bad)


@pytest.mark.parametrize("label", ["2x4", "2x(2x2)-pod.dp.tp"])
def test_window_accumulate_matches_reference(label):
    jvc, tvc = PAIRS[label]
    x = np.random.default_rng(7).normal(size=(tvc.num_devices * 8, 2)) \
        .astype(np.float32)
    jc, tc = JComm.from_cluster(jvc), Communicator.from_cluster(tvc)
    want = _jrun(jvc, lambda v: jc.window(v).accumulate(v).fence().read(),
                   jnp.asarray(x))
    got = tvc.run(lambda v: tc.window(v).accumulate(v).fence().read(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("label", LABELS)
def test_window_converts_from_reference_shards(label):
    """A reference window's shards carried across with ``convert`` read
    back in rank order exactly as the reference reads them."""
    jvc, tvc = PAIRS[label]
    jc, tc = JComm.from_cluster(jvc), Communicator.from_cluster(tvc)
    x = np.random.default_rng(8).normal(size=(tvc.num_devices * 4, 2)) \
        .astype(np.float32)
    shards = np.asarray(_jrun(
        jvc, lambda v: jc.allgather(v, scheme="shared").shard,
        jnp.asarray(x)))
    want = np.asarray(_jrun(
        jvc, lambda v: jc.allgather(v, scheme="shared").read_rank_order(),
        jnp.asarray(x)))
    win = convert.window_from_shards(shards, tc, tvc, epoch=1)
    back, meta = convert.window_to_shards(win)
    np.testing.assert_array_equal(back, shards)
    assert meta == {"axis": 0, "epoch": 1, "dirty": False}
    with tvc.bind():
        got = win.read_rank_order()
    np.testing.assert_array_equal(convert.from_stacked(got), want)


@pytest.mark.parametrize("label", LABELS)
def test_sync_primitives_match_reference(label):
    jvc, tvc = PAIRS[label]
    tok = np.arange(1, tvc.num_devices + 1, dtype=np.float32)
    for jfn, tfn in (
            (lambda t: jsync.barrier(t, jvc.axis_names),
             lambda t: sync.barrier(t, tvc.axis_names)),
            (lambda t: jsync.flag_chain(t, jvc.axis_names),
             lambda t: sync.flag_chain(t, tvc.axis_names)),
            (lambda t: jsync.leader_flag(t, fast_axis=jvc.fast),
             lambda t: sync.leader_flag(t, fast_axis=tvc.fast))):
        want = _jrun(jvc, lambda t, f=jfn: f(t[0])[None], jnp.asarray(tok))
        got = tvc.run(lambda t, f=tfn: f(t[:, 0]), tok)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("label", LABELS)
def test_communicator_structure_and_rank_indices(label):
    jvc, tvc = PAIRS[label]
    jc, tc = JComm.from_cluster(jvc), Communicator.from_cluster(tvc)
    assert (tc.fast_axis, tc.slow_axis, tc.pods, tc.chips) == \
        (jc.fast_axis, jc.slow_axis, jc.pods, jc.chips)
    assert tc.signature == jc.signature
    assert tc.node_map == tc.node_map.smp(tvc.pods, tvc.chips)
    assert tc.split_type_shared().slow_axis is None
    if tvc.pods > 1:
        assert tc.bridge().chips == tvc.pods
    else:
        with pytest.raises(ValueError, match="bridge"):
            tc.bridge()
    dummy = np.zeros((tvc.num_devices,), np.float32)
    for name in ("rank", "local_rank", "node_rank"):
        want = _jrun(jvc, lambda t, n=name: getattr(jc, n)()[None]
                       .astype(jnp.int32), jnp.asarray(dummy))
        got = tvc.run(lambda t, n=name: getattr(tc, n)(), dummy)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_substrate_rejects_bad_shapes_and_unbound_axes():
    with pytest.raises(ValueError):
        VirtualCluster(pods=2, chips=4, slow_axis=None, device="cpu")
    with pytest.raises(ValueError):
        VirtualCluster(pods=2, chips=4, fast_axis=("a", "b"),
                       fast_shape=(3, 1), device="cpu")
    with pytest.raises(RuntimeError, match="outside"):
        coll.psum(torch.ones(8), "data")
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    assert vc.without_pod().slow is None and vc.with_pods(3).pods == 3
    with pytest.raises(ValueError):
        vc.run(lambda v: v, np.zeros((7,), np.float32))


# ---------------------------------------------------------------------------
# registry closed forms and scheme="auto"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", LABELS)
def test_registry_closed_forms_match_reference(label):
    _, vc = PAIRS[label]
    shape = dict(pods=vc.pods, chips=vc.chips)
    for family, name in CASES:
        t, j = registry.get_scheme(name), jregistry.get_scheme(name)
        assert (t.result_class, t.precision) == (j.result_class,
                                                 j.precision)
        assert t.tiling(family, **shape) == j.tiling(family, **shape)
        for elems in (1, 48, 1024, 1 << 20):
            kw = dict(shape, elems=elems)
            pops = (vc.chips,) * vc.pods if family == "allgatherv" else None
            assert astuple(t.traffic(family, **kw, populations=pops)) == \
                astuple(j.traffic(family, **kw, populations=pops))
            assert t.links(family, fast_shape=vc.fast_shape, **kw) == \
                j.links(family, fast_shape=vc.fast_shape, **kw)
            assert t.result_node(family, **kw) == j.result_node(family, **kw)
            assert t.candidates(family, **kw) == j.candidates(family, **kw)
            assert t.predicted_time(family, **kw) == \
                j.predicted_time(family, **kw)


@pytest.mark.parametrize("label", LABELS)
def test_auto_resolution_matches_reference_model(label):
    """With no measured table (``use_table(None)``) the port resolves
    ``auto`` by the closed forms; the reference's modeled pick (its measured
    table aside) must be the same scheme.  The measured path's parity is
    ``test_auto_resolution_matches_reference_measured`` and
    ``tests/test_torch_tuning.py``."""
    _, vc = PAIRS[label]
    comm = Communicator.from_cluster(vc)
    with tuning.use_table(None):
        _modeled_picks_match(comm, vc)
    bare = Communicator(fast_axis="data")
    for family, name in tuning.FALLBACK[None].items():
        assert tuning.resolve_for(bare, family, elems=8).scheme == name
        assert jtuning.resolve(family, pods=None, chips=None,
                               elems=8).scheme == name


def _modeled_picks_match(comm, vc):
    for family in traffic.FAMILIES:
        for elems in (64, 1 << 16):
            for result in (None, "replicated", "shared"):
                if result == "shared" and family == "alltoall":
                    continue
                got = tuning.resolve_for(comm, family, elems=elems,
                                         result_class=result)
                want = jtuning.best_scheme_predicted(
                    family, pods=vc.pods, chips=vc.chips, elems=elems,
                    result_class=result, precision="exact")
                assert (got.scheme, got.opts, got.source) == \
                    (want[0], want[1], "modeled")


@pytest.mark.parametrize("label", LABELS)
def test_auto_resolution_matches_reference_measured(label):
    """Given the same measured table (the reference's committed one, its
    schema string mapped), ``auto`` dispatches through both packages'
    ``Communicator`` to the same scheme and the same values."""
    import json
    import pathlib
    jvc, vc = PAIRS[label]
    with open(pathlib.Path(__file__).resolve().parent.parent
              / "TUNING_default.json") as f:
        d = json.load(f)
    jtable = jtuning.TuningTable.from_dict(d)
    table = tuning.TuningTable.from_dict(dict(d,
                                              schema=tuning.SCHEMA_VERSION))
    comm = Communicator.from_cluster(vc)
    for family in traffic.FAMILIES:
        for elems in (256, 1024, 1 << 16):
            got = tuning.resolve_for(comm, family, elems=elems, table=table)
            want = jtuning.resolve(family, pods=vc.pods, chips=vc.chips,
                                   elems=elems,
                                   n_fast_axes=len(vc.fast_names),
                                   table=jtable)
            assert (got.scheme, got.opts, got.source) == \
                (want.scheme, want.opts, "measured")
    x = np.random.default_rng(0).normal(
        size=(vc.num_devices * 2, 3)).astype(np.float32)
    with tuning.use_table(table), jtuning.use_table(jtable):
        got = vc.run(lambda v: _raw(comm.allgather(v)), torch.from_numpy(x))
        jcomm = JComm.from_cluster(jvc)
        want = _jrun(jvc, lambda v: _raw(jcomm.allgather(v)), x)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def _raw(out):
    return out.shard if hasattr(out, "shard") else out


def test_concrete_scheme_checked_against_result_constraint():
    _, vc = PAIRS["2x4"]
    comm = Communicator.from_cluster(vc)
    with vc.bind():
        x = torch.ones(8, 8)
        with pytest.raises(ValueError, match="result='replicated'"):
            comm.allgather(x, scheme="shared", result="replicated")
        with pytest.raises(KeyError, match="unknown collective scheme"):
            comm.allgather(x, scheme="smp")
        win = comm.allgather(x, result="shared")
        assert isinstance(win, SharedWindow)


# ---------------------------------------------------------------------------
# fused collective-matmul against the reference bodies
# ---------------------------------------------------------------------------

def _tile_rows(a, vc):
    """The reference's test layout: every pod holds the same row shards."""
    return np.tile(a.reshape(vc.chips, -1, a.shape[-1]),
                   (vc.pods, 1, 1)).reshape(-1, a.shape[-1])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("label", LABELS)
def test_ag_matmul_rows_matches_reference(label, use_kernel):
    jvc, tvc = PAIRS[label]
    rng = np.random.default_rng(1)
    rows, k, n_out = tvc.chips * 4, 3, 5
    a = rng.normal(size=(rows, k)).astype(np.float32)
    b = rng.normal(size=(k, n_out)).astype(np.float32)
    jnode = JComm.from_cluster(jvc).split_type_shared()
    tnode = Communicator.from_cluster(tvc).split_type_shared()
    want = _jrun(jvc, lambda a_sh: jnode.ag_matmul_rows(
        a_sh, jnp.asarray(b), n_chunks=2)[None], jnp.asarray(_tile_rows(
            a, tvc)), in_specs=(jvc.spec,), out_specs=jvc.spec)
    bs = torch.from_numpy(b).expand(tvc.num_devices, k, n_out)
    got = tvc.run(lambda a_sh: tnode.ag_matmul_rows(
        a_sh, bs, n_chunks=2, use_kernel=use_kernel), _tile_rows(a, tvc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        got.shape), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nc", [1, 2, 3])
@pytest.mark.parametrize("label", ["2x4", "2x(2x2)-pod.dp.tp"])
def test_ag_matmul_matches_reference(label, nc):
    jvc, tvc = PAIRS[label]
    rng = np.random.default_rng(0)
    K = tvc.chips * 6
    w = rng.normal(size=(K, 5)).astype(np.float32)
    x = rng.normal(size=(4, K)).astype(np.float32)
    jnode = JComm.from_cluster(jvc).split_type_shared()
    tnode = Communicator.from_cluster(tvc).split_type_shared()
    want = _jrun(jvc, lambda w_sh: jnode.ag_matmul(jnp.asarray(x), w_sh,
                                                n_chunks=nc)[None],
                   jnp.asarray(_tile_rows(w, tvc)), in_specs=(jvc.spec,),
                   out_specs=jvc.spec)
    xs = torch.from_numpy(x).expand(tvc.num_devices, *x.shape)
    got = tvc.run(lambda w_sh: tnode.ag_matmul(xs, w_sh, n_chunks=nc,
                                               use_kernel=True),
                  _tile_rows(w, tvc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        got.shape), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("label", ["2x4", "4x2", "2x(2x2)-pod.dp.tp"])
def test_matmul_rs_matches_reference(label):
    jvc, tvc = PAIRS[label]
    rng = np.random.default_rng(2)
    rows, k, n_out = tvc.chips * 4, 3, 5
    xs = rng.normal(size=(tvc.num_devices, rows, k)).astype(np.float32)
    w = rng.normal(size=(k, n_out)).astype(np.float32)
    jnode = JComm.from_cluster(jvc).split_type_shared()
    tnode = Communicator.from_cluster(tvc).split_type_shared()
    want = _jrun(jvc, lambda xi: jnode.matmul_rs(xi[0], jnp.asarray(w), axis=0,
                                              n_chunks=2),
                   jnp.asarray(xs), in_specs=(jvc.spec,),
                   out_specs=P(jvc.axis_names))
    ws = torch.from_numpy(w).expand(tvc.num_devices, k, n_out)
    got = tvc.run(lambda xi: tnode.matmul_rs(xi[:, 0], ws, axis=0,
                                             n_chunks=2, use_kernel=True),
                  xs.reshape(tvc.num_devices, rows, k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_strided_split_merge_roundtrip():
    x = torch.arange(2 * 24 * 3, dtype=torch.float32).reshape(2, 24, 3)
    for blocks, nc in ((4, 3), (2, 2), (1, 6)):
        parts = pipeline._split_strided(x, 0, nc, blocks)
        assert torch.equal(pipeline._merge_strided(parts, 0, blocks), x)
    with pytest.raises(ValueError):
        pipeline._split_blocked(x, 0, 5)
