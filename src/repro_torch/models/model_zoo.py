"""Public model API: build a Model from a config name + parallel context."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.parallel import ParallelCtx
from repro_torch.models.transformer import Model, build

__all__ = ["Model", "build", "build_by_name", "make_batch", "ParallelCtx"]


def build_by_name(name: str, ctx: Optional[ParallelCtx] = None,
                  data: int = 1, reduced: bool = False, device="cuda",
                  **red_kw) -> Model:
    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced(**red_kw)
    return build(cfg, ctx or ParallelCtx.single(), data=data, device=device)


def make_batch(cfg: ModelConfig, B: int, T: int, seed: int = 0,
               device="cuda") -> dict:
    """Synthetic batch with the right structure for the family: the
    reference's numpy draws, as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "encodec":
        return {
            "frames": torch.from_numpy(rng.normal(
                size=(B, T, cfg.d_frontend)).astype(np.float32)).to(device),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.vocab, size=(B, T)).astype(np.int32)).to(device),
        }
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(B, T + 1)).astype(np.int32)).to(device)}
    if cfg.frontend == "vit":
        out["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_prefix, cfg.d_frontend)).astype(
                np.float32)).to(device)
    return out
