"""The port's roofline (``repro_torch.analysis.roofline``) held to the
reference's ``tests/test_roofline.py`` checks, rebuilt for the port.

The reference parses the collectives out of HLO lines; the port's substrate
records them (``CollectiveRecord``: op, tier, group, per-rank output
bytes).  The same three collectives — the variadic all-reduce across pods,
the iota reduce-scatter across pods and the intra-pod all-gather — are
built as records and priced by ``CollectiveBytes.from_records``; each
tier and byte count must equal the reference's parse of its HLO line.  The
terms' algebra and dominance use the H100 constants (NVIDIA's datasheet:
HBM3 3.35 TB/s, NVLink 4 450 GB/s a direction, 400 Gb/s NDR 50 GB/s).
"""

import numpy as np

from repro.analysis.roofline import parse_collectives
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.roofline import (CollectiveBytes, RooflineTerms,
                                           roofline)
from repro_torch.substrate.collectives import CollectiveRecord

VARIADIC = ("  %all-reduce.2 = (f32[9496,64]{1,0}, f32[28,192,64]{2,1,0}, "
            "/*index=5*/f32[64,9496]{1,0}) all-reduce(%a, %b, %c), "
            "channel_id=1, replica_groups={{0,256},{1,257}}, "
            "use_global_device_ids=true, to_apply=%add")
SIMPLE_AG = ("  %all_gather.1 = bf16[16,4096,1024]{2,1,0} "
             "all-gather(%x), channel_id=2, replica_groups="
             "{{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={1}")
IOTA_RS = ("  %reduce-scatter.5 = f32[8,64]{1,0} reduce-scatter(%y), "
           "channel_id=3, replica_groups=[256,2]<=[2,256]T(1,0), "
           "dimensions={0}")

VAR_BYTES = 4 * (9496 * 64 + 28 * 192 * 64 + 64 * 9496)
#: the same three collectives as the substrate records them: a pair of
#: ranks in two pods (slow), 16 ranks of one pod (fast)
RECORDS = [
    CollectiveRecord("all-reduce", "slow", 2, VAR_BYTES, 2),
    CollectiveRecord("all-gather", "fast", 16, 2 * 16 * 4096 * 1024, 15),
    CollectiveRecord("reduce-scatter", "slow", 2, 8 * 64 * 4, 1),
]


def test_records_price_as_the_reference_parses_the_hlo():
    cb = CollectiveBytes.from_records(RECORDS)
    want = parse_collectives("\n".join([VARIADIC, SIMPLE_AG, IOTA_RS]),
                             num_devices=512, pod_size=256)
    assert cb.by_op.keys() == want.by_op.keys()
    for k, v in want.by_op.items():
        np.testing.assert_allclose(cb.by_op[k], v)
    np.testing.assert_allclose((cb.fast, cb.slow), (want.fast, want.slow))


def test_cross_pod_classification():
    cb = CollectiveBytes.from_records(RECORDS)
    # the variadic AR crosses pods: 2 out (n-1)/n with n = 2 -> out bytes
    np.testing.assert_allclose(cb.by_op["all-reduce/slow"], VAR_BYTES)
    # the iota RS crosses pods too: out (n-1) = out
    np.testing.assert_allclose(cb.by_op["reduce-scatter/slow"], 8 * 64 * 4)
    assert cb.slow == cb.by_op["all-reduce/slow"] \
        + cb.by_op["reduce-scatter/slow"]
    # the AG is intra-pod (the model axis)
    ag = 2 * 16 * 4096 * 1024 * 15 / 16
    np.testing.assert_allclose(cb.by_op["all-gather"], ag)
    assert cb.fast == cb.by_op["all-gather"]


def test_collective_bytes_algebra():
    a = CollectiveBytes(fast=10.0, slow=2.0, by_op={"all-gather": 10.0})
    b = CollectiveBytes(fast=14.0, slow=4.0, by_op={"all-gather": 14.0,
                                                    "all-reduce/slow": 4.0})
    a.add(b, 2.0).add(CollectiveBytes.from_records(RECORDS[2:]), -1.0)
    np.testing.assert_allclose((a.fast, a.slow), (38.0, 10.0 - 8 * 64 * 4))
    assert a.by_op == {"all-gather": 38.0, "all-reduce/slow": 8.0,
                       "reduce-scatter/slow": -8 * 64 * 4}


def test_roofline_terms_and_dominance():
    coll = CollectiveBytes(fast=rl.NVLINK_BW, slow=rl.NDR_BW)
    t = roofline(flops_per_dev={"bf16": rl.PEAK["bf16"]},
                 bytes_per_dev=rl.HBM_BW, coll=coll, chips=256,
                 model_flops=rl.PEAK["bf16"] * 256 * 0.5)
    np.testing.assert_allclose((t.compute_s, t.memory_s, t.fast_coll_s,
                                t.slow_coll_s), 1.0)
    assert t.dominant == "collective"
    np.testing.assert_allclose(t.useful_flops_ratio, 0.5)
    np.testing.assert_allclose(t.roofline_fraction, 0.5)
    d = t.to_dict()
    assert d["dominant"] == "collective" and set(d) >= {
        "compute_s", "memory_s", "collective_s", "hlo_flops", "hlo_bytes",
        "model_flops", "useful_flops_ratio", "roofline_fraction"}


def test_the_compute_term_follows_the_route():
    """f32 products at the FMA peak, the kernels' 3xTF32 at 495 / 3, bf16
    at 989 TFLOP/s: a second of each sums to three seconds."""
    by_route = {"fma": 67e12, "3xtf32": 495e12 / 3, "bf16": 989e12}
    t = roofline(flops_per_dev=by_route, bytes_per_dev=0.0,
                 coll=CollectiveBytes(), chips=1, model_flops=0.0)
    np.testing.assert_allclose(t.compute_s, 3.0)
    np.testing.assert_allclose(t.hlo_flops, sum(by_route.values()))
    assert t.dominant == "compute" and t.roofline_fraction == 1.0
    assert isinstance(t, RooflineTerms)
    assert rl.HBM_BW == 3.35e12 and rl.PEAK["fma"] == 67e12
    assert rl.PEAK["3xtf32"] == 495e12 / 3
