"""The hybrid ``recurrentgemma-9b`` served on the stacked cluster, held
against the JAX reference.

The reduced ``recurrentgemma-9b`` (``rglru, rglru, local``, window 16,
tied embeddings) through ``tests/test_torch_serving_cluster.py``'s checks
on the factored ``2x(2x2)``: an ``rglru`` block's decode state (``h``,
``conv``) stays sharded over tp along its channels, the local block's
ring cache is split along its slots, and both decode (from a zero cache
and from a random one) and prefill (its logits against the reference's
there, its cache against the reference's tp-1 prefill cache) agree with
the reference at ``F32_TOL``.
"""

import pytest

import test_torch_serving_cluster as base

ARCH = "recurrentgemma-9b"


@pytest.mark.parametrize("posv", list(base.POSV.values()),
                         ids=list(base.POSV))
def test_hybrid_decode_at_tp2_matches_reference(posv):
    base.check_decode("2x(2x2)", posv, ARCH)


def test_hybrid_prefill_at_tp2_matches_reference():
    base.check_prefill("2x(2x2)", ARCH)
