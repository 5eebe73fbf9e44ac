"""The port's MoE train step held against the JAX reference on 2x4 (tp 1:
ep 1, every expert on every rank; hier folds a node's 4 ranks' rows into
one batch and dispatches them per rank), hier and naive, at
``capacity_factor`` 8.0 and 1.25 (drops), 2 steps — the checks of
``tests/test_torch_moe_cluster.py``; then the training C1 on both
layouts."""

import numpy as np
import pytest

from test_torch_moe_cluster import cfgs, check_train_step, clusters
from repro_torch.core import tree as T
from repro_torch.runtime.steps import make_cluster_train_step


@pytest.mark.parametrize("mode", ["hier", "naive"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_train_step_matches_reference_2x4(mode, cf):
    check_train_step("2x4", mode, cf)


def test_moe_training_c1_is_the_store_size():
    """hier holds each tp shard of the state once per node, naive once per
    store rank: naive / hier = 4.0 on 2x4, 2.0 on 2x(2x2), every group."""
    _, cfg = cfgs(1.25)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(8, 17))
    for label, want in (("2x4", 4.0), ("2x(2x2)", 2.0)):
        _, vc = clusters(label)
        nbytes = {}
        for mode in ("hier", "naive"):
            b = make_cluster_train_step(cfg, vc, mode=mode, global_batch=8)
            state = b.init_layout_state(0)
            nbytes[mode] = {g: sum(t.numel() * t.element_size()
                                   for t in T.leaves(state[g]))
                            for g in ("params", "m", "v")}
            state, _ = b.step(state, b.layout_batch({"tokens": toks}))
            nbytes[mode]["grads"] = b.stats["grad_bytes"]
        for g in ("params", "m", "v", "grads"):
            assert nbytes["naive"][g] / nbytes["hier"][g] == want, (label, g)


def test_routes_record_and_replay_across_layouts():
    """``moe.routes``: hier's recorded routing, mapped to naive's call
    order (a node's members folded -> a domain per rank), equals naive's
    own on the CPU, and replayed into naive gives naive's step; a
    different routing replayed changes the step (the replay is used)."""
    import torch
    from repro_torch.models import moe
    _, cfg = cfgs(1.25)
    _, vc = clusters("2x4")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(8, 17))

    def step(mode, replay=None):
        b = make_cluster_train_step(cfg, vc, mode=mode, global_batch=8)
        state = b.init_layout_state(0)
        with moe.routes(replay) as rt:
            _, m = b.step(state, b.layout_batch({"tokens": toks}))
        return float(m["loss"][0]), rt["idx"], rt["margin"]

    _, hier, margins = step("hier")
    loss, own, _ = step("naive")
    n = len(hier) // vc.pods
    mapped = [hier[d * n + j][m:m + 1] for d in range(vc.pods)
              for m in range(vc.chips) for j in range(n)]
    assert len(mapped) == len(own) and all(
        torch.equal(a, b) for a, b in zip(mapped, own))
    assert min(float(x) for x in margins) >= 0
    again, _, _ = step("naive", mapped)
    assert again == loss
    other, _, _ = step("naive", [(i + 1) % cfg.moe.num_experts
                                 for i in mapped])
    assert other != loss
