"""MoE serving on the factored cluster and the node store, in the port.

The reduced ``granite-moe-3b-a800m`` (4 experts, top 2) in the
``serve_fsdp`` layout: on ``2x(2x2)`` (ep 2: each tp rank its 2 experts, the
T-sharded cache, split-K decode) the prefill logits against the
reference's and the decode against the port's tp-1 decode (held to the
reference in ``tests/test_torch_moe_serving.py``); ``RecordedDecoder``
torch.equal to the sync decode with one node gather per node-stored leaf
(the expert leaves, stored along their d_ff, too); the weight C1 of MoE
serving (naive / hier = the node's chips) and of the default layout (the
experts once per node, the rest per rank); ``materialize_params_on_mesh``
of the serve layout through the node tier.
"""

import numpy as np
import pytest
import torch

from test_torch_moe_serving import (F32_TOL, _cfgs, _clusters, _port,
                                    _port_serve, _pspecs, _ref_serve)
from repro_torch.analysis.traffic import link_bytes
from repro_torch.comm import Communicator, SharedWindow
from repro_torch.convert import params_from_reference
from repro_torch.core import tree as T
from repro_torch.models.meta import store_dim
from repro_torch.serving.engine import materialize_params_on_mesh
from repro_torch.serving.recorded import RecordedDecoder
from repro_torch.substrate import VirtualCluster
from repro_torch.substrate.collectives import recording


def test_cluster_serving_at_tp2_matches_reference_prefill_and_tp1():
    """2x(2x2): ep 2 (each tp rank its 2 experts), the T-sharded cache,
    split-K decode; capacity 8.0, every rank.  The reference's tp-2
    decode without ``serve_fsdp`` does not run (its cache write refuses
    the layout), so its prefill logits hold the port's and the port's
    decode is held to the port's tp-1 decode (held to the reference
    above); ``moe_block``'s serve path at tp 2 and 8 is held to the
    reference's in ``tests/test_torch_moe.py``."""
    cf = 8.0
    jp, want = _ref_serve("2x(2x2)", cf, 0)
    _, cfg = _cfgs(cf)
    _, vc = _clusters("2x(2x2)")
    m = _port(vc, cfg)
    assert m.ctx.tp == 2 and cfg.moe.ep_tp(2) == (2, 1)
    params = params_from_reference(jp, device="cpu")
    got, _, _, _ = _port_serve(m, vc, params)
    np.testing.assert_allclose(got.numpy()[:, 0], want[:, 0], **F32_TOL)
    # the tp-1 tree: ep 2 stores rank r's experts 2r, 2r + 1 at [r]
    p1 = dict(params, units=dict(params["units"]))
    p1["units"]["b0"] = dict(params["units"]["b0"], moe={
        k: (v.reshape((v.shape[0], 1, -1) + tuple(v.shape[3:]))
            if k in ("w_in", "w_out") else v)
        for k, v in params["units"]["b0"]["moe"].items()})
    vc1 = VirtualCluster(pods=2, chips=4, device="cpu")
    one, _, _, _ = _port_serve(_port(vc1, cfg), vc1, p1)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **F32_TOL)


@pytest.mark.parametrize("label", ["2x4", "2x(2x2)"])
def test_recorded_decoder_is_bit_identical_and_gathers_every_node_leaf(
        label):
    _, cfg = _cfgs(1.25)
    _, vc = _clusters(label)
    m = _port(vc, cfg)
    params = m.init_params(0)
    lg, cache, rec, _ = _port_serve(m, vc, params)
    dec = RecordedDecoder(m)
    lg2, cache2, rec2, _ = _port_serve(m, vc, params, decode=dec)
    assert torch.equal(lg, lg2) and torch.isfinite(lg).all()
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(dict(cache)),
                                                 T.leaves(dict(cache2))))
    (sched,) = dec.schedules.values()
    gathers = [n for n in sched.graph.nodes if n.family == "gather"]
    metas = T.leaves(m.serve_defs)
    n_store = sum(store_dim(mt) is not None for mt in metas)
    n_expert = sum(mt.data_dim is not None for mt in metas)
    assert len(gathers) == n_store and n_expert == 2 * len(cfg.pattern)
    assert all(g.node for g in gathers)


def test_moe_serving_weight_c1_and_materialize_on_mesh():
    """naive / hier weight bytes per node = the node's chips under
    serve_fsdp (the expert leaves stored once per node along their d_ff);
    the default layout stores the experts once per node and the rest per
    rank; the serve layout's windows read back exactly through the node
    tier."""
    _, cfg = _cfgs(1.25)
    vc = VirtualCluster(pods=2, chips=4, device="cpu")
    params = _port(vc, cfg).init_params(0)
    total = sum(t.numel() * t.element_size() for t in T.leaves(params))
    held = {}
    for mode, opts in (("hier", ("serve_fsdp",)), ("naive", ("serve_fsdp",)),
                       ("hier", ())):
        m = _port(vc, cfg, mode, opts)
        lay = vc.layout(params, _pspecs(m, True))
        held[mode, opts] = sum(t.numel() * t.element_size()
                               for t in T.leaves(lay)) / vc.pods
    assert held["naive", ("serve_fsdp",)] / held["hier", ("serve_fsdp",)] \
        == vc.chips
    assert held["hier", ("serve_fsdp",)] == total
    expert = sum(t.numel() * t.element_size() for k, t in
                 zip(sorted(params["units"]["b0"]["moe"]),
                     T.leaves(params["units"]["b0"]["moe"]))
                 if k in ("w_in", "w_out"))
    assert held["hier", ()] == vc.chips * (total - expert) + expert

    m = _port(vc, cfg)
    comm = Communicator.from_cluster(vc)
    lay = vc.layout(params, _pspecs(m, True))
    units = [k == "units" for k in sorted(lay) for _ in T.leaves(lay[k])]
    wins = []
    for t, mt, u in zip(T.leaves(lay), T.leaves(m.serve_defs), units):
        ax = store_dim(mt) + int(u)
        wins.append(SharedWindow(comm, t.movedim(0, ax).flatten(ax, ax + 1),
                                 axis=ax, epoch=1))
    with recording() as rec:
        got = materialize_params_on_mesh(T.unflatten(params, wins), vc)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(got),
                                                 T.leaves(params)))
    assert link_bytes(rec)[1] == 0


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_train_state_carries_across_with_5d_expert_leaves(name):
    """``convert``: the reference's ``init_state(0)`` of both MoE configs
    (reduced) on ``2x(2x2)`` — the expert leaves ``(U, tp, E_loc, d, 2,
    n_ff)`` — into the port's laid-out state and back, bit for bit."""
    import jax
    from repro import configs as jconfigs
    from repro.runtime.steps import make_cluster_train_step as jmake
    from repro_torch import configs
    from repro_torch.convert import (train_state_from_reference,
                                     train_state_to_reference)
    from repro_torch.runtime.steps import make_cluster_train_step
    jvc, vc = _clusters("2x(2x2)")
    jb = jmake(jconfigs.get_config(name).reduced(), jvc, global_batch=8)
    want = jax.device_get(jax.jit(lambda: jb.init_state(0))())
    cfg = configs.get_config(name).reduced()
    b = make_cluster_train_step(cfg, vc, global_batch=8)
    state = train_state_from_reference(want, vc, b.state_specs)
    w_in = want["params"]["units"]["b0"]["moe"]["w_in"]
    assert w_in.ndim == 6 and w_in.shape[1] == 2
    back = train_state_to_reference(state, vc, b.state_specs)
    for a, c in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(c))
