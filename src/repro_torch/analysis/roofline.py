"""Roofline terms of a dry-run step, with NVIDIA H100 constants.

The reference's ``repro/analysis/roofline.py`` for the port.  Three terms
per (arch x shape x mesh), each per device:

  compute    = sum over routes of FLOP(route) / PEAK[route]
  memory     = bytes accessed / HBM_BW
  collective = link bytes (fast tier) / NVLINK_BW
               + link bytes (slow tier) / NDR_BW

Constants: the H100 SXM5 80 GB at 700 W, from NVIDIA's H100 Tensor Core
GPU datasheet (dense rates, no sparsity): HBM3 3.35 TB/s; fp32 FMA on the
CUDA cores 67 TFLOP/s; TF32 on the tensor cores 495 TFLOP/s, so the
kernels' 3xTF32 route (three TF32 products per fp32-accurate FLOP) 495 / 3;
bf16 989 TFLOP/s; the fast tier NVLink 4, 900 GB/s a GPU in both
directions (450 GB/s a direction); the slow tier one 400 Gb/s NDR
InfiniBand port a GPU, 50 GB/s.

The compute peak follows the route the port runs each product on: an f32
product in plain PyTorch is a cuBLAS fp32 SIMT product (``"fma"``), a bf16
one a tensor-core product (``"bf16"``), and the hand-written f32 kernels
(``csrc/*.cu``: matmul, q4, flash and its backward) run 3xTF32
(``"3xtf32"``; a bf16 operand, one TF32 product: ``"tf32"``); the scans
are bound by bytes, their FMA at ``"fma"``.

The inputs come from the dry run (``launch.dryrun``): FLOP and bytes
counted over one step on meta tensors, and the link bytes from the
substrate's traffic record (``substrate.collectives.CollectiveRecord``:
the op, its tier, its group and per-rank output), priced with the ring
model of ``analysis.traffic.RING``.  The reference parses those from
compiled HLO and corrects two undercounts (a scan body counted once, and
the sequential loops inside the kernels); eager PyTorch makes no HLO and
runs every loop iteration, so ``parse_collectives``, ``_first_group``,
``_shape_bytes``, ``extrapolate_cost``, ``CollectiveBytes.combine`` and
``Model.cost_notes`` have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

from repro_torch.analysis.traffic import RING
from repro_torch.substrate.collectives import CollectiveRecord

#: HBM3 bandwidth, bytes/s.
HBM_BW = 3.35e12
#: Dense peak rates by route, FLOP/s.
PEAK = {"fma": 67e12, "tf32": 495e12, "3xtf32": 495e12 / 3,
        "bf16": 989e12}
#: The fast tier: NVLink 4, bytes/s a direction per GPU.
NVLINK_BW = 450e9
#: The slow tier: one 400 Gb/s NDR port a GPU, bytes/s.
NDR_BW = 50e9
#: The card's device memory, bytes (80 GB).
HBM_BYTES = 80e9


@dataclasses.dataclass
class CollectiveBytes:
    """Per-chip link bytes by tier (each device's share of the traffic)."""
    fast: float = 0.0   # intra-node NVLink
    slow: float = 0.0   # cross-node NDR
    by_op: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "CollectiveBytes", scale: float = 1.0):
        self.fast += other.fast * scale
        self.slow += other.slow * scale
        for k, v in other.by_op.items():
            self.by_op[k] = self.by_op.get(k, 0.0) + v * scale
        return self

    @classmethod
    def from_records(cls, records: Iterable[CollectiveRecord]
                     ) -> "CollectiveBytes":
        """Per-rank link bytes of a traffic record: each record priced with
        the ring model, charged to its own tier; ``by_op`` keyed by the op,
        ``"/slow"`` appended on the bridge tier (the reference's keys)."""
        out = cls()
        for r in records:
            link = RING[r.op](r.out_bytes, r.group)
            slow = r.tier == "slow"
            key = f"{r.op}{'/slow' if slow else ''}"
            out.by_op[key] = out.by_op.get(key, 0.0) + link
            if slow:
                out.slow += link
            else:
                out.fast += link
        return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    fast_coll_s: float
    slow_coll_s: float
    hlo_flops: float      # counted FLOP per device (the reference's name)
    hlo_bytes: float      # counted bytes accessed per device
    model_flops: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute / max-term: 1.0 = compute-bound at peak."""
        bound = max(self.compute_s, self.memory_s, self.collective_s, 1e-30)
        return self.compute_s / bound

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant,
                "useful_flops_ratio": self.useful_flops_ratio,
                "roofline_fraction": self.roofline_fraction}


def roofline(*, flops_per_dev: Mapping[str, float], bytes_per_dev: float,
             coll: CollectiveBytes, chips: int,
             model_flops: float) -> RooflineTerms:
    """The terms of one step.  ``flops_per_dev``: FLOP per device by route
    (``{route: FLOP}``, each priced at its ``PEAK``); ``bytes_per_dev`` and
    ``coll`` per device; ``model_flops`` GLOBAL (6 N tokens for a train
    step), divided by ``chips``."""
    fast_s = coll.fast / NVLINK_BW
    slow_s = coll.slow / NDR_BW
    return RooflineTerms(
        compute_s=sum(f / PEAK[r] for r, f in flops_per_dev.items()),
        memory_s=bytes_per_dev / HBM_BW,
        collective_s=fast_s + slow_s,
        fast_coll_s=fast_s, slow_coll_s=slow_s,
        hlo_flops=sum(flops_per_dev.values()), hlo_bytes=bytes_per_dev,
        model_flops=model_flops / chips)
