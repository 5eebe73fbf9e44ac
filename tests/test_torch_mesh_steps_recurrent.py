"""The production-mesh train step held against the JAX reference: the
hybrid and xLSTM cases of the reference's ``tests/test_distributed.py``
(its ``compare()``: the port's ``make_train_step`` hier and naive against
the reference's single-device step; the hybrid in hier on ``(2, 2, 2)``
also against the reference's own step under ``PERF.md`` §2's rule).  The
xLSTM head-group case (tp 4 over 2 heads on ``(2, 1, 4)``) is held to the
single-device step only, leaf by leaf under the rule: the reference's own
head-group step is wrong there (ROADMAP Queue 3,
``tests/test_torch_xlstm_head_groups.py``).
"""

from repro_torch.analysis.state_rule import state_close

from test_torch_mesh_steps import compare


def test_recurrentgemma_hybrid():
    compare("recurrentgemma-9b", dict(n_layers=3, d_model=64, n_heads=4), 5,
            (2, 2, 2))


def test_xlstm_head_groups():
    # tp=4 > nh=2 -> 2 tp ranks a head (the group all-gather path) + sLSTM
    got, _, want = compare("xlstm-1.3b", dict(n_layers=8, d_model=64,
                                              n_heads=2), 4, (2, 1, 4),
                           dist=False)
    for mode in ("hier", "naive"):
        state_close(got[mode][0], want, 1, f"xlstm head groups {mode}")
