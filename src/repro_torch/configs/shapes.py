"""Assigned input-shape sets (LM-family: seq_len x global_batch)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence handling: only SSM/hybrid archs run
# it; pure full-attention archs skip (recorded per-cell; see DESIGN.md §5).
LONG_CONTEXT_ARCHS = ("xlstm-1.3b", "recurrentgemma-9b")


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
