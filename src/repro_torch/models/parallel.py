"""ParallelCtx: how model math maps onto the mesh — the single-device form.

The reference's models are written as *local* shard_map bodies against a
``ParallelCtx``; with ``ParallelCtx.single()`` every collective helper is an
identity, so the same model code runs on one device.  The port has that
single-device form: the helpers below are the identities they are at
tp = 1 with no FSDP axes, and a ctx that names a tensor-parallel or FSDP
axis raises ``NotImplementedError`` — the sharded model (``reduce_grads``,
``ParamGroup``, ``prefetch_walk`` and the tp collectives) is ROADMAP Queue 1
item 13, the training slice, where the stacked substrate carries it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_SHARDED = ("the sharded model (tp / FSDP axes, gradient reduction, the "
            "parameter prefetcher) is not ported yet: ROADMAP Queue 1 "
            "item 13")


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    tp_axis: Optional[str] = None
    fsdp_axes: tuple[str, ...] = ()
    dp_axes: tuple[str, ...] = ()
    pod_axis: Optional[str] = None
    tp: int = 1
    mode: str = "hier"                     # hier | naive
    compute_dtype: torch.dtype = torch.bfloat16
    # the reference's perf options; in f32 at tp = 1 those on the serving
    # path are no-ops (bf16_rope rotates in the compute dtype, bf16_probs is
    # not read) and the rest need mesh axes
    opts: frozenset = frozenset()
    overlap_chunks: int = 2

    def __post_init__(self):
        if self.tp_axis or self.fsdp_axes or self.dp_axes or self.pod_axis \
                or self.tp != 1:
            raise NotImplementedError(_SHARDED)

    @staticmethod
    def single(mode: str = "hier", opts=frozenset()) -> "ParallelCtx":
        return ParallelCtx(mode=mode, compute_dtype=torch.float32,
                           opts=frozenset(opts))

    def has(self, opt: str) -> bool:
        return opt in self.opts

    # ---- indices / communicator ---------------------------------------------
    @property
    def tp_rank(self) -> int:
        return 0

    @property
    def comm(self):
        """The data-tier communicator: ``None`` for a single-device ctx."""
        return None

    # ---- weight access (identity without FSDP axes) -------------------------
    def gather_w(self, w: torch.Tensor, fsdp_dim: Optional[int]
                 ) -> torch.Tensor:
        return w.to(self.compute_dtype)

    def ag_matmul(self, x: torch.Tensor, w: torch.Tensor,
                  fsdp_dim: Optional[int]) -> torch.Tensor:
        return x @ self.gather_w(w, fsdp_dim)

    def matmul_rs(self, x: torch.Tensor, w: torch.Tensor, dim: int = 1
                  ) -> torch.Tensor:
        return x @ w

    def reduce_grads(self, grads, *args, **kwargs):
        raise NotImplementedError(_SHARDED)

    # ---- tp collectives (identities at tp = 1) ----------------------------
    def ag_tokens(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x

    def rs_tokens(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x

    def psum_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def pmax_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x


class ParamGroup:
    """The reference's FSDP2-style unshard/reshard unit (training slice)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_SHARDED)


def prefetch_walk(groups, fn, x, budget: int):
    raise NotImplementedError(_SHARDED)
