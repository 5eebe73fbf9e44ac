"""The port's xLSTM train step on the factored cluster held against the JAX
reference.

``repro_torch.runtime.steps.make_cluster_train_step`` for the reduced
``xlstm-1.3b`` (one unit: 7 mLSTM + 1 sLSTM, d 64, 4 heads) on ``2x(2x2)``
(tp 2: each tp rank holds 2 heads, g = 1; the sLSTM's batch split over the
tp ranks) against the reference's ``make_cluster_train_step``, hier and
naive, 2 steps from the reference's ``init_state(0)`` carried across with
``convert``, the same numpy batches.  Loss rtol 2e-4, gnorm 5e-3, the
state under ``PERF.md`` §2's rule (``analysis.state_rule.state_close``).
The head-group layout (tp > n_heads) is
``tests/test_torch_xlstm_head_groups.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.runtime.steps import make_cluster_train_step as jmake
from repro.substrate import VirtualCluster as JVC
from repro_torch import configs
from repro_torch.analysis.state_rule import state_close
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.runtime.steps import make_cluster_train_step
from repro_torch.substrate import VirtualCluster

NAME = "xlstm-1.3b"


def _jvc(dp, tp):
    return JVC(pods=2, chips=dp * tp, fast_axis=("dp", "tp"),
               fast_shape=(dp, tp), slow_axis="pod")


def _check_metrics(m, jm):
    np.testing.assert_allclose(float(m["loss"][0]), float(jm["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(m["gnorm"][0]), float(jm["gnorm"]),
                               rtol=5e-3)


@pytest.mark.parametrize("mode", ["hier", "naive"])
def test_xlstm_train_step_matches_reference_2x2x2(mode):
    jcfg = jconfigs.get_config(NAME).reduced()
    cfg = configs.get_config(NAME).reduced()
    jvc, vc = _jvc(2, 2), VirtualCluster.from_label("2x(2x2)", device="cpu")
    jb = jmake(jcfg, jvc, mode=mode, global_batch=8)
    jstate = jax.device_get(jax.jit(lambda: jb.init_state(0))())
    bundle = make_cluster_train_step(cfg, vc, mode=mode, global_batch=8)
    assert bundle.model.ctx.tp == 2
    state = train_state_from_reference(jstate, vc, bundle.state_specs)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab, size=(8, 17)).astype(np.int32)
               for _ in range(2)]
    fn = jax.jit(jb.fn).lower(jstate, {"tokens": batches[0]}).compile()
    for toks in batches:
        state, m = bundle.step(state, bundle.layout_batch({"tokens": toks}))
        jstate, jm = fn(jstate, {"tokens": jnp.asarray(toks)})
        _check_metrics(m, jm)
        assert float(m["tokens"][0]) == float(jm["tokens"])
    back = train_state_to_reference(state, vc, bundle.state_specs)
    state_close(back, jax.device_get(jstate), len(batches), f"2x(2x2) {mode}")
