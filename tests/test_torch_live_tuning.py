"""The port's live tuner (``repro_torch.serving.live_tuning``) against the
JAX reference's (``repro.serving.live_tuning``): the same observations over
the same base table give the same EWMA estimates and the same overlay, and
the overlay flips a winner through ``resolve_for`` without touching the
base table.  The scheduler feeding the tuner is in
``tests/test_torch_serving.py``.
"""

import copy

import pytest

from repro.comm import Communicator as JComm
from repro.comm import tuning as jtuning
from repro.serving.live_tuning import LiveTuner as JLiveTuner
from repro.substrate import VirtualCluster as JVirtualCluster
from repro_torch.comm import Communicator, tuning
from repro_torch.serving.live_tuning import LiveTuner
from repro_torch.substrate import VirtualCluster

VC2 = VirtualCluster(pods=2, chips=4, device="cpu")
JVC2 = JVirtualCluster(pods=2, chips=4)


def _base(pkg):
    """One measured cell: psum on 2x4, naive (100us) beats shared (120us)."""
    return pkg.TuningTable(entries=(pkg.TuningEntry(
        family="psum", topo="2x4", dtype="float32", nbytes=4096,
        source="measured",
        ranking=(pkg.Choice("naive", median_us=100.0),
                 pkg.Choice("shared", median_us=120.0)),
    ),), meta={})


#: (family, pods, chips, nbytes, scheme, us) observation streams
STREAMS = {
    "shift": [("psum", 2, 4, 4096, "naive", 500.0)] * 3,
    "outlier": [("psum", 2, 4, 4096, "naive", 500.0),
                ("psum", 2, 4, 4096, "shared", 90.0)],
    "synthesize": [("allgather", 4, 2, 1 << 20, "shared", 80.0),
                   ("allgather", 4, 2, 1 << 20, "naive", 300.0),
                   ("allgather", 4, 2, 1 << 20, "shared", 120.0),
                   ("serving", 1, 1, 3 << 20, "sync", 7000.0)],
    "mixed": [("psum", 2, 4, 4096 + 512 * i, "naive" if i % 2 else "hier",
               50.0 + 13.0 * i) for i in range(9)],
}


@pytest.mark.parametrize("alpha,min_count", [(0.25, 1), (0.5, 2), (1.0, 1)])
@pytest.mark.parametrize("stream", list(STREAMS))
def test_overlay_matches_reference(stream, alpha, min_count):
    port = LiveTuner(_base(tuning), alpha=alpha, min_count=min_count)
    ref = JLiveTuner(_base(jtuning), alpha=alpha, min_count=min_count)
    for fam, pods, chips, nbytes, scheme, us in STREAMS[stream]:
        for t in (port, ref):
            t.observe(fam, pods=pods, chips=chips, nbytes=nbytes,
                      scheme=scheme, us=us)
        key = (fam, tuning.topo_signature(pods, chips), "float32", nbytes,
               scheme)
        assert port.estimate(*key) == ref.estimate(*key)
    ov, jov = port.overlay(), ref.overlay()
    assert [e.to_dict() for e in ov.entries] == \
        [e.to_dict() for e in jov.entries]
    assert ov.meta == jov.meta
    jcomm = JComm.from_cluster(JVC2)
    comm = Communicator.from_cluster(VC2)
    for elems in (64, 1024, 4096):
        got = tuning.resolve_for(comm, "psum", elems=elems, table=ov)
        want = jtuning.resolve_for(jcomm, "psum", elems=elems, table=jov)
        assert (got.scheme, got.opts, got.source) == \
            (want.scheme, want.opts, want.source)


def test_latency_shift_flips_winner_without_touching_tables():
    base = _base(tuning)
    snapshot = copy.deepcopy(base)
    committed = copy.deepcopy(tuning.default_table())
    comm = Communicator.from_cluster(VC2)
    assert tuning.resolve_for(comm, "psum", elems=1024,
                              table=base).scheme == "naive"
    t = LiveTuner(base, min_count=2)
    for _ in range(2):
        t.observe("psum", pods=2, chips=4, nbytes=4096, scheme="naive",
                  us=500.0)
    after = tuning.resolve_for(comm, "psum", elems=1024, table=t.overlay())
    assert (after.scheme, after.source) == ("shared", "measured")
    assert base == snapshot and tuning.default_table() == committed
    with t.use():
        assert tuning.resolve_for(comm, "psum", elems=1024).scheme == \
            "shared"
    assert {c.scheme: c.median_us for c in t.overlay().entries[0].ranking} \
        == {"shared": 120.0, "naive": pytest.approx(500.0)}


def test_observe_validates_and_keys_by_communicator():
    t = LiveTuner(_base(tuning))
    with pytest.raises(ValueError):
        t.observe("psum", pods=2, chips=4, nbytes=4096, scheme="naive",
                  us=0.0)
    with pytest.raises(ValueError):
        LiveTuner(alpha=0.0)
    t.observe_comm(Communicator.from_cluster(VC2), "psum", nbytes=4096,
                   scheme="shared", us=50.0)
    assert t.estimate("psum", "2x4", "float32", 4096, "shared") == 50.0
    with pytest.raises(ValueError, match="static"):
        t.observe_comm(Communicator(fast_axis="x"), "psum", nbytes=4096,
                       scheme="shared", us=50.0)
