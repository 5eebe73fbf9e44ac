"""xLSTM serving on the factored cluster and the node store.

The reduced ``xlstm-1.3b`` in the ``serve_fsdp`` layout, through
``tests/test_torch_xlstm_serving.py``'s checks: on ``2x(2x2)`` (tp 2: each
tp rank 2 of the 4 heads and half the conv channels, the sLSTM's state
replicated and its prefill's batch split over the tp ranks) every rank's
logits and decode state against the reference's ``vc.run``;
``RecordedDecoder`` ``torch.equal`` to the sync decode with one node
gather per node-stored leaf, on 2x4 and ``2x(2x2)``; the weight C1 of
serving (naive / hier = the node's chips).
"""

import pytest
import torch

from test_torch_xlstm_serving import (_clusters, _port, _port_serve,
                                      _pspecs, check_serving)
from repro_torch.core import tree as T
from repro_torch.models.meta import store_dim
from repro_torch.serving.recorded import RecordedDecoder
from repro_torch.substrate import VirtualCluster


def test_cluster_serving_at_tp2_matches_reference():
    check_serving("2x(2x2)", "hier")


@pytest.mark.parametrize("label", ["2x4", "2x(2x2)"])
def test_recorded_decoder_is_bit_identical_and_gathers_every_node_leaf(
        label):
    _, vc = _clusters(label)
    m = _port(vc)
    params = m.init_params(0)
    lg, cache = _port_serve(m, vc, params)
    dec = RecordedDecoder(m)
    lg2, cache2 = _port_serve(m, vc, params, decode=dec)
    assert torch.equal(lg, lg2) and torch.isfinite(lg).all()
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(dict(cache)),
                                                 T.leaves(dict(cache2))))
    (sched,) = dec.schedules.values()
    gathers = [n for n in sched.graph.nodes if n.family == "gather"]
    n_store = sum(store_dim(mt) is not None for mt in T.leaves(m.serve_defs))
    assert len(gathers) == n_store and all(g.node for g in gathers)


def test_serving_weight_c1():
    """naive / hier weight bytes per node = the node's chips under
    serve_fsdp: every xLSTM leaf once per node in hier."""
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    params = _port(vc).init_params(0)
    total = sum(t.numel() * t.element_size() for t in T.leaves(params))
    held = {}
    for mode in ("hier", "naive"):
        lay = vc.layout(params, _pspecs(_port(vc, mode), True))
        held[mode] = sum(t.numel() * t.element_size()
                         for t in T.leaves(lay)) / vc.pods
    assert held["hier"] == total and held["naive"] / held["hier"] == 4.0
