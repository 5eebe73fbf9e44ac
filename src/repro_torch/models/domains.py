"""Memory domains of the stacked cluster: how a model on a cluster ctx
(one with a node communicator: ``runtime.steps.cluster_ctx``) runs its
single-device code once per domain.

A domain is ``store`` store ranks by ``tp`` tp ranks, consecutive in rank
order with tp innermost: in hier one node, its windows read as ONE buffer
(``SharedWindow.read_node``, the one path of ``ParallelCtx.gather_w``); in
naive one rank (its tp group at tp > 1) on its private replica.  At
tp > 1 every leaf and activation of a domain's run keeps a leading axis of
the domain's tp ranks, with a mesh of the tp axis alone bound
(``domain_run``), so the tp collectives are the substrate's over that
axis.  Every domain runs the same program, so the traffic record keeps the
first domain's collectives as each rank's (``muted``).

The train step's gradients (``runtime.steps._domain_grads``) and the
serving entry points of ``transformer.ClusterModel`` both run on these
views; the decode cache of the latter is the node-shared inference state,
``NodeCache``: one cache per domain, handed to the ranks as broadcast
views, never as R copies.

A dry run (``launch.dryrun``) traces one step on meta tensors at the
production meshes' 256 / 512 ranks; since every domain runs the same
program on the same shapes, ``first_domain_only`` makes each domain loop
run its first domain alone (``domain_range``) and hands the run's domain
count to a probe, which scales what it counted.  A time loop whose steps
are alike (the sLSTM's) does the same through ``scan``: one step traced,
forward and backward, counted for all.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.comm.window import SharedWindow
from repro_torch.core import tree as T
from repro_torch.models.meta import store_dim
from repro_torch.substrate.cluster import Mesh, active_mesh, bind_mesh
from repro_torch.substrate.collectives import folded, muted


@dataclasses.dataclass(frozen=True)
class Domains:
    """How the bound mesh's ``ranks`` fall into memory domains: each is
    ``store`` store ranks by ``tp`` tp ranks, consecutive in rank order
    with tp innermost (hier: a node; naive: one store rank's tp group).
    ``tp_dim``: the run's leaves carry a tp axis."""

    ranks: int
    store: int
    tp: int
    tp_dim: bool

    @classmethod
    def of(cls, ctx) -> "Domains":
        mesh = active_mesh()
        hier = ctx.mode == "hier" and bool(ctx.fsdp_axes)
        return cls(mesh.num_ranks, mesh.size(ctx.fsdp_axes) if hier else 1,
                   ctx.tp if ctx.tp_axis else 1, bool(ctx.tp_axis))

    @property
    def members(self) -> int:
        return self.store * self.tp

    @property
    def count(self) -> int:
        return self.ranks // self.members

    def fold(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """Domain ``d``'s rows of a rank-sharded stacked batch leaf ``x``
        ``(R, b, ...)``: its store ranks' rows in rank order (their tp
        ranks hold the same rows), ``(store * b, ...)``."""
        a = d * self.members
        rows = x[a:a + self.members:self.tp]
        return rows.reshape((-1,) + tuple(x.shape[2:]))

    def unfold(self, per_domain: Sequence[torch.Tensor]) -> torch.Tensor:
        """Inverse of ``fold`` for per-domain outputs over the folded rows
        (``([tp,] store * b, ...)``) -> stacked ``(R, b, ...)``: each rank
        gets its own rows (its tp rank's)."""
        x = torch.stack(list(per_domain))
        if not self.tp_dim:
            x = x.unsqueeze(1)                       # (D, tp, s * b, ...)
        rest = tuple(x.shape[3:])
        x = x.reshape((x.shape[0], self.tp, self.store, -1) + rest)
        return x.movedim(2, 1).reshape((self.ranks, -1) + rest)

    def to_ranks(self, per_domain: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-domain values (``(tp, ...)`` with a tp axis) -> stacked
        ``(R, ...)``: each rank gets its domain's value (its tp rank's)."""
        x = torch.stack(list(per_domain))
        if not self.tp_dim:
            x = x.unsqueeze(1)
        x = x.unsqueeze(1).expand((x.shape[0], self.store)
                                  + tuple(x.shape[1:]))
        return x.reshape((self.ranks,) + tuple(x.shape[3:]))


class NodeCache(dict):
    """The decode cache of a model on the cluster: one cache per memory
    domain (per node in hier: the node-shared inference state), every leaf
    ``(D, *leaf)`` where ``leaf`` is the domain run's (``(U, [tp,] B, S, kv,
    hd)`` under ``units``, ``([tp,] B, S, kv, hd)`` under ``rem``; S the
    rank's S/tp chunk at tp > 1; a recurrent block's state ``(U, [tp,] B,
    ...)``: its rank's channels or heads, or a replica).  Decode writes it
    in place."""

    def __init__(self, tree: dict, domains: Domains):
        super().__init__(tree)
        self.domains = domains

    def domain(self, d: int) -> dict:
        """Domain ``d``'s cache tree (views)."""
        return T.tree_map(lambda a: a[d], dict(self))

    def rank_view(self) -> dict:
        """Every rank's cache as a broadcast view ``(D, store, tp, *local)``
        of its domain's (its tp rank's chunk), ``local`` the reference's
        per-rank cache leaf: nothing is copied (a flat ``(R, ...)`` would
        copy each cache ``store`` times)."""
        lay = self.domains

        def view(a, unit):
            x = (a.movedim(2, 1) if unit else a) if lay.tp_dim \
                else a.unsqueeze(1)
            return x.unsqueeze(1).expand((x.shape[0], lay.store)
                                         + tuple(x.shape[1:]))
        return {k: T.tree_map(lambda a, u=(k == "units"): view(a, u), v)
                for k, v in self.items()}

    def copy_row(self, src: "NodeCache", row: int, dst_row: int) -> None:
        """Copy batch row ``row`` of ``src`` (the same cluster and model)
        into row ``dst_row`` of this cache: a prefilled prompt into its
        decode slot."""
        lay = self.domains
        for k in self:
            bdim = 1 + (k == "units") + lay.tp_dim
            for a, b in zip(T.leaves(self[k]), T.leaves(src[k])):
                a.select(bdim, dst_row).copy_(b.select(bdim, row))


def node_window(ctx, w: torch.Tensor, fsdp_dim: int, unit: bool
                ) -> SharedWindow:
    """The cluster's stacked leaf ``w`` ``(R, *local)`` stored along
    ``fsdp_dim`` (``meta.store_dim``) as node windows: a
    window per (domain, tp rank) over the domain's store ranks, shard
    ``(D, [tp,] store, *local)``; ``read_node`` gives ONE buffer per node
    ``(D, [tp,] *full)``, the same bytes a domain run's ``gather_w`` reads
    (a unit-stacked leaf whole: its unit dim stays inside the shard)."""
    lay = Domains.of(ctx)
    local = tuple(w.shape[1:])
    x = w.reshape((lay.count, lay.store, lay.tp) + local)
    x = x.movedim(1, 2) if lay.tp_dim else x.squeeze(2)
    return SharedWindow(ctx.comm, x, axis=fsdp_dim + int(unit), epoch=1,
                        lead=2 if lay.tp_dim else 1)


_PROBE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_domain_probe", default=None)


@contextlib.contextmanager
def first_domain_only(probe):
    """Inside, every loop over a cluster's memory domains
    (``domain_range``) runs its first domain only, and each such run is
    entered as ``with probe(count, "domains"):`` — ``count`` the loop's
    domains — so a dry run can count one domain's work and scale it; on
    meta tensors ``scan`` does the same for a time loop's steps
    (``probe(n, "steps")``)."""
    token = _PROBE.set(probe)
    try:
        yield
    finally:
        _PROBE.reset(token)


def domain_range(count: int) -> range:
    """The domains a loop runs: all ``count``, or the first alone inside
    ``first_domain_only``."""
    return range(min(count, 1)) if _PROBE.get() is not None \
        else range(count)


def every_domain(per_domain: list, count: int) -> list:
    """Per-domain outputs for all ``count`` domains: inside
    ``first_domain_only`` the first domain's stands for the rest."""
    return per_domain + per_domain[:1] * (count - len(per_domain))


@contextlib.contextmanager
def domain_run(ctx, lay: Domains, d: int, device, fold: int = 1):
    """Domain ``d``'s run: the tp axis alone bound, the traffic record
    muted after the first domain (inside ``first_domain_only``, entered as
    the probe's run of ``lay.count`` domains), and, when the run folds
    ``fold`` store ranks' rows into one batch, each record a rank's share
    (``collectives.folded``)."""
    mesh = Mesh((ctx.tp_axis,), (lay.tp,), (), device) if lay.tp_dim \
        else None
    probe = _PROBE.get()
    with (bind_mesh(mesh) if mesh else contextlib.nullcontext()), (
            muted() if d else contextlib.nullcontext()), folded(fold), (
            probe(lay.count, "domains") if probe is not None
            else contextlib.nullcontext()):
        yield


def scan(step, carry: tuple, xs, *args) -> list:
    """``carry = step(carry, x, *args)`` for each ``x`` of ``xs``; returns
    every step's carry.  Inside ``first_domain_only`` on meta tensors the
    steps, alike in shape, are one step traced (``_TracedOnce``), whose
    carry stands for each step's."""
    probe = _PROBE.get()
    if probe is None or not xs[0].is_meta:
        out = []
        for x in xs:
            carry = step(carry, x, *args)
            out.append(carry)
        return out
    new = _TracedOnce.apply(step, len(xs), probe, len(carry), *carry, xs[0],
                            *args)
    return [new] * len(xs)


class _TracedOnce(torch.autograd.Function):
    """One step of a loop of ``n`` alike steps on meta tensors, run inside
    ``probe(n, "steps")`` in the forward and again (its own graph, every
    floating input differentiated as a later step's would be) in the
    backward, so the probe counts it ``n`` times each way."""

    @staticmethod
    def forward(ctx, step, n, probe, n_carry, *inputs):
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in inputs]
        # the inner graph keeps its own saved tensors (an enclosing remat's
        # hooks would re-run the whole block to unpack them)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t), probe(n, "steps"):
            outs = step(tuple(leaves[:n_carry]), *leaves[n_carry:])
        ctx.graph, ctx.n, ctx.probe = (leaves, outs), n, probe
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        leaves, outs = ctx.graph
        with ctx.probe(ctx.n, "steps"):
            got = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
        return (None,) * 4 + tuple(
            g if need else None
            for g, need in zip(got, ctx.needs_input_grad[4:]))


def domain_params(ctx, lay: Domains, defs, params, d: int,
                  reads: Optional[list] = None) -> dict:
    """Domain ``d``'s parameter tree: views of the stacked leaves (a window
    leaf's store ranks' shards, read at use: a leaf with a ``store_dim``,
    the serve layout's expert d_ff included), or where ``reads`` holds a
    node buffer ``(D, [tp,] *full)``, domain ``d``'s (the unit dim
    first)."""
    a = d * lay.members
    out = []
    for i, (w, m, u) in enumerate(zip(T.leaves(params), T.leaves(defs),
                                      T.leaves(units_flags(params)))):
        if reads is not None and reads[i] is not None:
            x = reads[i][d]
            out.append(x.movedim(1, 0) if u and lay.tp_dim else x)
            continue
        win = lay.store > 1 and store_dim(m) is not None
        out.append(domain_view(w[a:a + lay.members], lay.store, lay.tp, win,
                               u, lay.tp_dim))
    return T.unflatten(params, out)


def domain_view(w: torch.Tensor, s: int, t: int, win: bool, unit: bool,
                tp: bool) -> torch.Tensor:
    """One memory domain's view of a stacked leaf ``w`` — its ``s * t``
    members' ``(n, *local)`` slice, ``s`` store ranks by ``t`` tp ranks,
    tp innermost: a window leaf's ``(t, s, *shard)`` (one window per tp
    rank), any other the first store rank's ``(t, *local)``; the unit dim
    first for a unit-stacked leaf, no tp dim without a tp axis."""
    x = w.reshape((s, t) + tuple(w.shape[1:]))
    x = x.movedim(0, 1) if win else x[0]            # (t, s, ..) / (t, ..)
    if unit:                                        # the unit dim first
        x = x.movedim(2 if win else 1, 0)
    return x if tp else x.squeeze(1 if unit else 0)


def units_flags(tree, under_units: bool = False):
    """A tree of bools: whether each leaf is stacked on the unit dim."""
    if isinstance(tree, dict):
        return {k: units_flags(v, under_units or k == "units")
                for k, v in tree.items()}
    return under_units
