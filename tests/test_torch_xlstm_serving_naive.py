"""xLSTM serving in naive mode and through the scheduler, held against the
JAX reference.

The reduced ``xlstm-1.3b`` through ``tests/test_torch_xlstm_serving.py``'s
check on 2x4 in naive mode (every rank its own replica and decode
state); and the single-device scheduler's streams equal the reference
scheduler's and each request's solo run (exact-length buckets; a slot's
mLSTM / sLSTM state is reset by its admission).
"""

import jax
import numpy as np

from test_torch_xlstm_serving import NAME, check_serving
from repro.models import build_by_name as jbuild_by_name
from repro.serving.scheduler import generate as jgenerate
from repro_torch.convert import params_from_reference
from repro_torch.models import build_by_name
from repro_torch.serving.engine import greedy_generate
from repro_torch.serving.scheduler import _bucket_mode, generate


def test_cluster_serving_matches_reference_2x4_naive():
    check_serving("2x4", "naive")


def test_scheduler_matches_reference_and_solo_runs():
    """Exact-length buckets; the slots' mLSTM / sLSTM state is reset by
    each admission (a prompt of 5, one of 24, then a 5 refilling a slot):
    the streams equal the reference scheduler's and each request's solo
    greedy_generate run."""
    jm = jbuild_by_name(NAME, reduced=True)
    jp = jm.init_params(0)
    tm = build_by_name(NAME, reduced=True, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    assert _bucket_mode(tm.cfg) == "exact"
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (5, 24, 5)]
    want = jgenerate(jm, jp, prompts, max_new=4, slots=2, s_max=32)
    got = generate(tm, tp, prompts, max_new=4, slots=2, s_max=32)
    assert np.isfinite(got.logprobs).all()
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=1e-4,
                               atol=1e-4)
    for i, p in enumerate(prompts):
        solo = greedy_generate(tm, tp, p[None], max_new=4, s_max=32)
        np.testing.assert_array_equal(got.tokens[i:i + 1], solo.tokens)
