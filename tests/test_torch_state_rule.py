"""``repro_torch.analysis.state_rule.state_close``: PERF.md §2's rule for two
runs of the same AdamW steps, on small hand-made states.

The rule excuses a param that differs only where AdamW's update is
ill-conditioned (sqrt(v_hat) < 1e-6) and counts it; a NaN anywhere, on
either side, in m, v or the params, breaks it, excused element or not.
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis.state_rule import state_close


def _state(seed=0):
    rng = np.random.default_rng(seed)
    p = {"a": {"w": rng.standard_normal((4, 8)).astype(np.float32)},
         "b": rng.standard_normal(16).astype(np.float32)}
    m = {"a": {"w": 1e-3 * rng.standard_normal((4, 8)).astype(np.float32)},
         "b": np.zeros(16, np.float32)}              # an all-zero leaf
    v = {"a": {"w": 1e-6 * rng.random((4, 8)).astype(np.float32)},
         "b": 1e-6 * rng.random(16).astype(np.float32)}
    v["a"]["w"][1, 2] = 1e-20                        # ill-conditioned
    tree = {"params": p, "m": m, "v": v}
    return tree, _copy(tree)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(x) for k, x in tree.items()}
    return torch.from_numpy(tree.copy())


def test_equal_states_are_close_with_nothing_excused():
    want, got = _state()
    excused, total, worst = state_close(got, want, 1)
    assert (excused, total) == (0, 48)
    assert worst == {"m": 0.0, "v": 0.0}


def test_ill_conditioned_param_difference_is_excused_and_counted():
    want, got = _state()
    got["params"]["a"]["w"][1, 2] += 0.1
    excused, total, _ = state_close(got, want, 1)
    assert (excused, total) == (1, 48)


def test_well_conditioned_param_difference_raises():
    want, got = _state()
    got["params"]["a"]["w"][0, 0] += 0.1
    with pytest.raises(AssertionError, match="params a/w"):
        state_close(got, want, 1)


@pytest.mark.parametrize("where", [
    ("m", ("a", "w"), (0, 3)),
    ("m", ("b",), (5,)),                 # a NaN in an all-zero leaf
    ("v", ("b",), (2,)),
    ("params", ("a", "w"), (0, 0)),      # well conditioned
    ("params", ("a", "w"), (1, 2)),      # where a finite diff is excused
])
@pytest.mark.parametrize("side", ["got", "want"])
def test_a_nan_breaks_the_rule(where, side):
    grp, path, idx = where
    want, got = _state()
    leaf = (got if side == "got" else want)[grp]
    for k in path[:-1]:
        leaf = leaf[k]
    leaf[path[-1]][idx] = float("nan")
    with pytest.raises(AssertionError, match=f"{grp} {'/'.join(path)}"):
        state_close(got, want, 1)
