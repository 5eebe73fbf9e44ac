"""The production-mesh train step held against the JAX reference: the
context-parallel and MoE cases of the reference's
``tests/test_distributed.py`` (its ``compare()``: the port's
``make_train_step`` hier and naive against the reference's single-device
step; in hier on ``(2, 2, 2)`` the whole state also against the
reference's own step under ``PERF.md`` §2's rule).  Dense and the
frontends are ``tests/test_torch_mesh_steps.py``, the hybrid and xLSTM
cases ``tests/test_torch_mesh_steps_recurrent.py``.
"""

import dataclasses

from repro.configs.base import MoESpec as JMoESpec
from repro_torch.configs.base import MoESpec

from test_torch_mesh_steps import compare


def test_dense_cp_mode():
    # n_heads=3 % tp=2 != 0 -> context-parallel attention
    got, _, _ = compare("starcoder2-7b", dict(n_layers=2, d_model=48,
                                              n_heads=3, d_ff=64), 2,
                        (2, 2, 2))
    assert got["hier"][1].model.ctx.tp == 2


def test_moe_ep_tp():
    # E=4 over tp=2 -> ep=2; capacity widened so no token drops
    def wide(jcfg, cfg):
        return (dataclasses.replace(jcfg, moe=JMoESpec(
                    4, 2, 32, capacity_factor=8.0)),
                dataclasses.replace(cfg, moe=MoESpec(
                    4, 2, 32, capacity_factor=8.0)))
    compare("granite-moe-3b-a800m", dict(n_layers=2, d_model=64, n_heads=4),
            3, (2, 2, 2), cfg_fn=wide)
