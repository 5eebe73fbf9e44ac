"""Decode-step window reads routed through a recorded ``CollectiveGraph``.

On a cluster ctx with the ``serve_fsdp`` opt the serve weights stay in the
node's one-copy ``SharedWindow`` store (the paper's C1 layout applied to
inference) and every decode step reads them at use: issued eagerly, each
read is its own collective, inside each unit's run.  ``RecordedDecoder``
instead *records* them once per batch signature through
``Communicator.record()``, runs the step-graph optimizer (same-epoch
gather dedup, every issue front-loaded on the card's one side stream
behind one event), and on later calls with the same signature replays the
cached ``Schedule`` through ``apply_schedule`` — the step graph's passes
applied to serving, with bit-identical outputs.

Every node-stored leaf is recorded: an FSDP leaf and, in the serve
layout of an MoE model, an expert leaf stored along its d_ff
(``meta.store_dim``).  Each recorded gather resolves to ONE buffer per node
(``models.domains.node_window`` read with ``read_node``), the bytes the
eager decode's per-node read gives — never every rank's copy of the
weights — and the domains then run with ``fsdp_axes=()`` on those
buffers.  Live re-tuning plugs in through ``set_table``: a fresh
``LiveTuner.overlay()`` re-optimizes later signatures under live latency
estimates instead of the committed table.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm.stepgraph import ScheduleResult, apply_schedule
from repro_torch.core import tree as T
from repro_torch.models.domains import node_window, units_flags
from repro_torch.models.meta import store_dim


def _paths(tree, prefix: str = "") -> list[str]:
    """Leaf paths in ``core.tree`` order, spelled as ``jax.tree_util.
    keystr`` spells a dict path (``['units']['b0']['attn']['wq']``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}[{k!r}]")]
    return [prefix]


class RecordedDecoder:
    """A drop-in ``decode_fn`` whose window reads go through the step
    graph.  Its call signature is ``model.decode_fn``'s; it falls back to
    that decode when the ctx has no window store (no communicator, naive
    mode, or no fsdp axes)."""

    def __init__(self, model, *, table=None,
                 target_bytes: Optional[int] = None):
        self.model = model
        self._table = table
        self._target_bytes = target_bytes
        self._schedules: dict[tuple, object] = {}

    def set_table(self, table) -> None:
        """Install a new tuning table (e.g. a ``LiveTuner.overlay()``) and
        drop the cached schedules so they re-optimize under it."""
        self._table = table
        self._schedules.clear()

    @property
    def schedules(self) -> dict:
        """Batch signature -> optimized ``Schedule`` (for inspection)."""
        return dict(self._schedules)

    @staticmethod
    def _signature(token, pos) -> tuple:
        return (tuple(token.shape), str(token.dtype), pos.dim())

    def __call__(self, params, cache, token, pos, *, unroll: int = 1):
        model, ctx = self.model, self.model.ctx
        comm = ctx.comm
        if comm is None or ctx.mode != "hier" or not ctx.fsdp_axes:
            return model.decode_fn(params, cache, token, pos, unroll=unroll)
        rec = comm.record(table=self._table)
        refs = []
        for path, m, w, u in zip(_paths(params), T.leaves(model.serve_defs),
                                 T.leaves(params),
                                 T.leaves(units_flags(params))):
            if store_dim(m) is None:
                refs.append(None)
                continue
            win = node_window(ctx, w.to(ctx.compute_dtype), store_dim(m), u)
            refs.append(rec.gather(win, key=path, node=True))

        token, pos = torch.as_tensor(token), torch.as_tensor(pos)
        sig = self._signature(token, pos)
        sched = self._schedules.get(sig)
        if sched is None:
            res = rec.run(target_bytes=self._target_bytes)
            self._schedules[sig] = res.schedule
        else:                             # replay: skip the optimizer
            res = ScheduleResult(apply_schedule(comm, sched, rec._values),
                                 sched)
        reads = [res[r] if r is not None else None for r in refs]
        return model.decode_fn(params, cache, token, pos, reads=reads)
