"""The port's closed forms (``repro_torch.core.plans``) against the
reference's ``repro.core.plans``.

The arguments are those ``tests/test_plans.py`` draws with hypothesis
(nodes 1..12, ranks per node 1..32, message 1..2^20 bytes, populations of
1..12 nodes with 1..32 ranks), taken here as a fixed seeded sample plus the
range corners, so the comparison runs without hypothesis.  The closed forms
are pure Python in both packages: results must be EQUAL.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import plans as jp
from repro_torch.core import plans as tp

_rng = np.random.default_rng(20)
SHAPES = [(1, 1, 1), (12, 32, 1 << 20), (1, 32, 4096), (12, 1, 7)] + [
    (int(_rng.integers(1, 13)), int(_rng.integers(1, 33)),
     int(_rng.integers(1, (1 << 20) + 1))) for _ in range(26)]
POPS = [[1], [32] * 12, [3, 1, 4]] + [
    [int(v) for v in _rng.integers(1, 33, size=_rng.integers(1, 13))]
    for _ in range(9)]


def _same(a, b):
    if dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    else:
        assert a == b


@pytest.mark.parametrize("P,c,m", SHAPES)
def test_closed_forms_match_reference(P, c, m):
    kw = dict(num_nodes=P, ranks_per_node=c)
    for scheme in ("naive", "hier"):
        for fn, arg in (("allgather_traffic", "bytes_per_rank"),
                        ("broadcast_traffic", "msg_bytes"),
                        ("allreduce_traffic", "msg_bytes"),
                        ("reduce_scatter_traffic", "msg_bytes"),
                        ("alltoall_traffic", "bytes_per_pair")):
            want = getattr(jp, fn)(scheme=scheme, **kw, **{arg: m})
            got = getattr(tp, fn)(scheme=scheme, **kw, **{arg: m})
            _same(got, want)
            assert tp.collective_time_model(got, **kw) == \
                jp.collective_time_model(want, **kw)
            for n in (1, 2, 4, 8):
                assert tp.pipelined_time_model(got, n_chunks=n, **kw,
                                               alpha=1e-6) == \
                    jp.pipelined_time_model(want, n_chunks=n, **kw,
                                            alpha=1e-6)
                assert tp.overlap_efficiency(got, n_chunks=n, **kw) == \
                    jp.overlap_efficiency(want, n_chunks=n, **kw)
            assert tp.best_chunk_count(got, candidates=(1, 2, 4, 8),
                                       alpha=1e-6, **kw) == \
                jp.best_chunk_count(want, candidates=(1, 2, 4, 8),
                                    alpha=1e-6, **kw)
    assert tp.size_bucket(m) == jp.size_bucket(m)
    assert tp.nearest_bucket(m, (3, 10, 16)) == jp.nearest_bucket(
        m, (3, 10, 16))
    _same(tp.NodeMap.smp(P, c), jp.NodeMap.smp(P, c))
    assert tp.NodeMap.smp(P, c).leaders() == jp.NodeMap.smp(P, c).leaders()
    gp_t = tp.GatherPlan(tp.NodeMap.smp(P, c), elem_per_rank=m % 4096 + 1)
    gp_j = jp.GatherPlan(jp.NodeMap.smp(P, c), elem_per_rank=m % 4096 + 1)
    gp_t.check()
    assert gp_t.counts() == gp_j.counts()
    assert gp_t.displs() == gp_j.displs()


@pytest.mark.parametrize("pops", POPS, ids=lambda p: "-".join(map(str, p)))
def test_irregular_forms_match_reference(pops):
    for m in (1, 4096, 1 << 16):
        for scheme in ("naive", "hier"):
            _same(tp.allgatherv_traffic(scheme=scheme, populations=pops,
                                        bytes_per_rank=m),
                  jp.allgatherv_traffic(scheme=scheme, populations=pops,
                                        bytes_per_rank=m))
        plan_t = tp.GatherPlan(tp.NodeMap.irregular(pops), elem_per_rank=m)
        plan_j = jp.GatherPlan(jp.NodeMap.irregular(pops), elem_per_rank=m)
        plan_t.check()
        assert plan_t.counts() == plan_j.counts()
        assert plan_t.displs() == plan_j.displs()
        assert plan_t.total_elems == plan_j.total_elems
    sizes = [p * 1000 for p in pops]
    kw = dict(num_nodes=len(pops), ranks_per_node=max(pops))
    assert tp.greedy_buckets(sizes, 4096) == jp.greedy_buckets(sizes, 4096)
    assert tp.bucket_time_model(sizes, 4096, **kw) == \
        jp.bucket_time_model(sizes, 4096, **kw)
    assert tp.best_bucket_bytes(sizes, **kw) == jp.best_bucket_bytes(sizes,
                                                                     **kw)
    assert tp.schedule_time(sizes, **kw) == jp.schedule_time(sizes, **kw)


def test_bad_arguments_raise_like_reference():
    for mod in (tp, jp):
        with pytest.raises(ValueError):
            mod.allgatherv_traffic(scheme="hier", populations=[],
                                   bytes_per_rank=1)
        with pytest.raises(ValueError, match="unknown scheme"):
            mod.reduce_scatter_traffic(scheme="quantum", num_nodes=2,
                                       ranks_per_node=2, msg_bytes=8)
        with pytest.raises(ValueError):
            mod.pipelined_time_model(
                mod.allgather_traffic(scheme="hier", num_nodes=2,
                                      ranks_per_node=2, bytes_per_rank=8),
                n_chunks=0, num_nodes=2, ranks_per_node=2)
