"""KV-cache pages as node-``SharedWindow`` state with epoch fences.

The paper's claim is that replicated state should live ONCE per node in a
shared segment, with integrity guarded by synchronization epochs.  Serving
is where replicated KV state dominates memory, so the decode cache gets
that treatment: every cache leaf is held as a
:class:`repro_torch.comm.SharedWindow` on the node communicator (one logical
copy per node — the C1 invariant), and slot reuse is guarded by store
epochs — admitting a request *stores* into the pages (opening a dirty
epoch) and the scheduler may not read the cache again until it fences.  A
dirty read raises :class:`repro_torch.comm.WindowEpochError`, as it does for
parameter windows.

Cache tree layout (``model.cache_init``): leaves under ``"units"`` carry a
leading ``n_units`` dim with the slot (batch) axis at position 1; leaves
under ``"rem"`` have the slot axis at position 0.  Stores scatter into the
pages' tensors in place (the reference builds new arrays); the window's
epoch state is what guards them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.comm import Communicator, SharedWindow


def _slot_axis(top_key: str) -> int:
    return 1 if top_key == "units" else 0


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass(frozen=True)
class KVCachePages:
    """The decode cache held as per-leaf node windows.

    ``windows`` mirrors ``model.cache_init``'s tree with every tensor leaf
    wrapped in a ``SharedWindow`` on ``comm``.  All mutators return a new
    ``KVCachePages`` (the windows are frozen dataclasses)."""

    windows: dict
    comm: Communicator

    @classmethod
    def for_model(cls, model, slots: int, s_max: int,
                  comm: Optional[Communicator] = None) -> "KVCachePages":
        """Fresh pages for ``slots`` concurrent requests at context
        ``s_max``.  ``comm`` defaults to the degenerate one-rank node (the
        single-device engine)."""
        comm = comm or Communicator(fast_axis="node", slow_axis=None,
                                    pods=1, chips=1)
        cache = model.cache_init(slots, s_max)
        windows = _map(lambda a: SharedWindow(comm, a, axis=0, epoch=1),
                       cache)
        return cls(windows=windows, comm=comm)

    # -- loads ---------------------------------------------------------------
    @property
    def cache(self):
        """The plain cache tree for the decode step.  Raises
        ``WindowEpochError`` while a store epoch is open (un-fenced admit
        or commit) — the paper's readers-wait-for-writers rule applied to
        inference state."""
        if (self.comm.chips or 1) != 1:
            raise ValueError(
                "multi-chip KV windows must be read on the mesh that owns "
                "them (window.read() inside the decode step)")

        def unwrap(w):
            w._check_clean()
            return w.shard
        return _map(unwrap, self.windows)

    # -- stores (open an epoch) ----------------------------------------------
    def admit(self, idx, sub_cache) -> "KVCachePages":
        """Scatter ``sub_cache`` (a ``len(idx)``-slot cache tree, e.g. a
        prefill result) into pages ``idx``.  Opens a dirty store epoch:
        the slots are not readable until :meth:`fence`."""
        new = {}
        for top, sub in self.windows.items():
            ax = _slot_axis(top)

            def put(w, b, ax=ax):
                a = w.shard
                i = torch.as_tensor(idx, dtype=torch.long, device=a.device)
                a.index_copy_(ax, i, b.to(a.dtype))
                return w.store(a)
            new[top] = _map(put, sub, sub_cache[top])
        return dataclasses.replace(self, windows=new)

    def commit(self, new_cache) -> "KVCachePages":
        """Store a decode step's updated cache tree into the pages (dirty
        until fenced)."""
        windows = _map(lambda w, a: w.store(a), self.windows, new_cache)
        return dataclasses.replace(self, windows=windows)

    # -- synchronization ------------------------------------------------------
    def fence(self) -> "KVCachePages":
        """Close the open store epoch.  On the degenerate one-rank node the
        barrier is vacuous (the stores are ordered on one stream), so the
        epoch bookkeeping advances host-side."""
        if (self.comm.chips or 1) != 1:
            raise NotImplementedError(
                "multi-chip pages fence on the mesh: ROADMAP Queue 1 "
                "item 17")
        windows = _map(
            lambda w: dataclasses.replace(w, dirty=False, epoch=w.epoch + 1),
            self.windows)
        return dataclasses.replace(self, windows=windows)

    # -- C1 accounting --------------------------------------------------------
    def logical_bytes(self) -> int:
        """Bytes of ONE logical cache copy."""
        chips = self.comm.chips or 1
        return sum(w.shard.nbytes * chips for w in _leaves(self.windows))

    def resident_node_bytes(self) -> int:
        """Physical bytes resident per node: the sum of every rank's window
        shard (each rank holds 1/chips of each buffer)."""
        chips = self.comm.chips or 1
        return sum(w.shard.nbytes * chips for w in _leaves(self.windows))

    def assert_c1(self) -> dict:
        """Assert the paper's C1 invariant for inference state: the node
        holds exactly ONE logical copy, not the ``chips``-way replication a
        per-rank cache would cost.  Returns the accounting."""
        chips = self.comm.chips or 1
        logical = self.logical_bytes()
        resident = self.resident_node_bytes()
        replicated = logical * chips
        if resident != logical:
            raise AssertionError(
                f"C1 violated for KV pages: {resident} bytes resident per "
                f"node vs {logical} for one copy")
        return {"logical_bytes": logical, "resident_node_bytes": resident,
                "replicated_baseline_bytes": replicated,
                "copies_per_node": resident / logical}
