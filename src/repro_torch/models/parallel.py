"""ParallelCtx: how model math maps onto the mesh, in both collective modes.

The reference's ``repro/models/parallel.py`` over the port's stacked
cluster.  Axis roles:

* ``tp_axis``   — tensor parallelism with sequence-parallel residuals
  (Megatron-SP: between blocks the activations are token-sharded over tp);
  the last axis of a factored fast tier (``runtime.steps.cluster_ctx``);
* ``fsdp_axes`` — where parameters are *stored*: in **hier** mode (the
  paper's MPI+MPI scheme) weights live once per node, sharded over the
  node's store ranks (the MPI-3 shared window); in **naive** mode (the
  pure-MPI analogue) every rank holds a private replica;
* ``dp_axes``   — batch sharding (``(pod, data)`` or ``(data,)``);
* ``pod_axis``  — the bridge (slow tier): gradient reductions cross it once
  per shard.

With ``ParallelCtx.single()`` every helper is a no-op and the model code
runs on one device.  At the top of a cluster step the ctx works on stacked
``(R, ...)`` tensors under the bound mesh, as the reference's does per rank
inside ``shard_map``: ``reduce_grads`` runs the bridge, ``comm`` is the
data-tier communicator.

**One model run per memory domain.**  The port's model code is written for
one device, so a cluster step (``runtime.steps``) runs it once per domain:
in hier once per node, on the node's window, with the node's ranks' batch
rows folded into one batch; in naive once per rank on its private replica.
So a weight with an FSDP dim reaches the model code as its node's
stacked shards ``(n, *shard)``, and ``gather_w`` reads the window as ONE
buffer (``SharedWindow.read_node``) — the weight exists once per node on
the card, which is the C1 the paper claims — and its gradient is the split
into the members' shards, the node's reduce-scatter with the sum over the
node's ranks taken by the folded batch.

**Tensor parallelism inside a domain run.**  With a tp axis the tp ranks
of a domain hold different shards and exchange activations, so the run
keeps them apart: every activation and every weight carries a leading
axis of the ``tp`` ranks, stacked as the substrate stacks ranks, with a
mesh of the tp axis alone bound.  The tp collectives (``ag_tokens``,
``rs_tokens``, ``psum_tp``, ``pmax_tp``, ``group_*``) are the substrate's
over that axis, and they work the same on the whole cluster's stacked
``(R, ...)`` tensors, so the model code is the reference's per-rank body
over stacked ranks.  ``at`` broadcasts a stacked weight against a stacked
activation and ``mm`` multiplies per rank (``(tp, B, T, d)`` by
``(tp, d, n)``, one batched product); ``tp_rank`` is each stacked rank's
index on the tp axis.  A hier weight
with an FSDP dim arrives as ``(tp, n, *shard)``: one window per tp rank,
read over the store ranks only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.comm import Communicator
from repro_torch.comm.handle import AsyncCollectiveHandle, side_stream
from repro_torch.comm.window import SharedWindow, WindowEpochError
from repro_torch.core import tree as T
from repro_torch.core.spans import span
from repro_torch.kernels import ops
from repro_torch.substrate import collectives as coll
from repro_torch.substrate.cluster import active_mesh


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    tp_axis: Optional[str] = None
    fsdp_axes: tuple[str, ...] = ()        # the node's axes in hier mode
    dp_axes: tuple[str, ...] = ()          # (pod, data) / (data,)
    pod_axis: Optional[str] = None         # the bridge
    tp: int = 1
    mode: str = "hier"                     # hier | naive
    compute_dtype: torch.dtype = torch.bfloat16
    # the reference's perf options: overlap (the window read streamed behind
    # the down-projection), prefetch[=N] (layer k+1's window read issued
    # while layer k computes, <= N groups in flight), stepgraph (the step's
    # collectives recorded and run as one optimized schedule); in f32 at
    # tp = 1 the serving options (bf16_rope, bf16_probs) are no-ops
    opts: frozenset = frozenset()
    overlap_chunks: int = 2
    # a domain run's token layout (``models.domains``): the train step
    # folds ``fold`` ranks' batch rows into one batch (the MoE block
    # dispatches each rank's rows apart, with its own capacity); hier
    # serving's run stands for its node's ``node_copies`` store ranks,
    # whose replicated batches the reference gathers into one token set
    # (the MoE decode's capacity counts them)
    fold: int = 1
    node_copies: int = 1

    def __post_init__(self):
        if self.tp != 1 and not self.tp_axis:
            raise ValueError(f"tp={self.tp} needs a tp_axis")
        if self.mode not in ("hier", "naive"):
            raise ValueError(f"mode must be hier or naive, got {self.mode!r}")

    @staticmethod
    def single(mode: str = "hier", opts=frozenset()) -> "ParallelCtx":
        return ParallelCtx(mode=mode, compute_dtype=torch.float32,
                           opts=frozenset(opts))

    def has(self, opt: str) -> bool:
        return opt in self.opts

    @property
    def prefetch(self) -> int:
        """In-flight budget of the layer-parameter prefetcher (0 = off):
        ``"prefetch"`` means 2, ``"prefetch=N"`` sets it.  Only where
        weights live in the node store (hier with fsdp axes)."""
        if self.mode != "hier" or not self.fsdp_axes:
            return 0
        for o in self.opts:
            if o == "prefetch":
                return 2
            if o.startswith("prefetch="):
                return max(0, int(o[len("prefetch="):]))
        return 0

    @property
    def stepgraph(self) -> bool:
        """The train step records its collectives into a step graph and runs
        the optimized schedule (bit-identical outputs)."""
        return "stepgraph" in self.opts

    @property
    def tp_rank(self):
        """Each stacked rank's index on the tp axis, ``(R,)`` int64 (0
        without a tp axis)."""
        return coll.axis_index(self.tp_axis) if self.tp_axis else 0

    def tp_group_rank(self, group: int):
        """(outer, inner) coords when the tp axis is factored as
        ``(tp // group, group)``: outer = rank // group, inner = rank %
        group; per stacked rank ``(R,)`` with a tp axis."""
        r = self.tp_rank
        return r // group, r % group

    def tp_ranks(self) -> list[int]:
        """``tp_rank`` as host ints, one per stacked rank of the bound
        mesh."""
        mesh = active_mesh()
        return [mesh.coord(r, self.tp_axis) for r in range(mesh.num_ranks)]

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` per stacked rank: x (R, ..., K) by w (R, K, N) as one
        batched product over the ranks with each rank's rows folded (no
        broadcast copy of w); ``x @ w`` without a tp axis.  Both through
        ``dense``, which picks the panel kernel or ``torch.matmul``."""
        if not self.tp_axis:
            return dense(x, w)
        rows = x.reshape(x.shape[0], -1, x.shape[-1])
        return dense(rows, w).reshape(tuple(x.shape[:-1]) + (w.shape[-1],))

    def at(self, w: torch.Tensor, nd: int) -> torch.Tensor:
        """A stacked per-rank tensor (leading rank axis) broadcast against
        an ``nd``-dim stacked activation: singleton dims after the rank
        axis.  Identity without a tp axis, where plain broadcasting does."""
        if not self.tp_axis:
            return w
        return w.reshape((w.shape[0],) + (1,) * (nd - w.dim())
                         + tuple(w.shape[1:]))

    # ---- the data-tier communicator -----------------------------------------
    @property
    def comm(self) -> Optional[Communicator]:
        """Fast tier = where parameters are stored (fsdp in hier, the
        non-pod dp axes in naive), slow tier = the bridge; ``None`` for a
        single-device ctx."""
        fast = self.fsdp_axes or tuple(a for a in self.dp_axes
                                       if a != self.pod_axis)
        if not fast:
            return None
        return Communicator(fast_axis=fast, slow_axis=self.pod_axis)

    def _stored(self, fsdp_dim: Optional[int]) -> bool:
        return self.mode == "hier" and bool(self.fsdp_axes) \
            and fsdp_dim is not None

    def _window(self, w: torch.Tensor, dim: int) -> SharedWindow:
        """A node window over stacked shards (one per tp rank with a tp
        axis: ``(tp, n, *shard)``)."""
        return SharedWindow(self.comm, w, axis=dim, epoch=1,
                            lead=1 if self.tp_axis else 0)

    # ---- weight load (the shared-memory window) -----------------------------
    def gather_w(self, w: torch.Tensor, fsdp_dim: Optional[int]
                 ) -> torch.Tensor:
        """Load a weight from the node store (cast first, so the compute
        dtype moves).  hier: the node's stacked shards ``(n, *shard)`` —
        ``(tp, n, *shard)`` with a tp axis, one window per tp rank — read
        through its ``SharedWindow`` as one buffer; autograd transposes the
        read into the reduce-scatter store.  naive / no FSDP dim: the local
        copy."""
        w = w.to(self.compute_dtype)
        if not self._stored(fsdp_dim):
            return w
        return self._window(w, fsdp_dim).read_node()

    def ag_matmul(self, x: torch.Tensor, w: torch.Tensor,
                  fsdp_dim: Optional[int]) -> torch.Tensor:
        """``x @ gather_w(w, fsdp_dim)``; with the ``overlap`` opt (a 2-d
        weight stored along its contraction dim, the node's ``(c, K/c,
        N)``) the window read streams panel by panel behind the matmuls —
        per rank the reference's ``comm.ag_matmul`` with
        ``use_kernel=False``.  (Under tp the one caller, the ffn's
        ``w_out``, is tp-sharded along its contraction dim, so its store
        dim is never 0 and it never streams, as in the reference.)"""
        if self.has("overlap") and self._stored(fsdp_dim) and fsdp_dim == 0 \
                and w.dim() == 3:
            shard = w.to(self.compute_dtype)
            nc = _clamp_chunks(self.overlap_chunks, shard.shape[1])
            return _node_ag_matmul(x, shard, nc)
        return self.mm(x, self.gather_w(w, fsdp_dim))

    def matmul_rs(self, x: torch.Tensor, w: torch.Tensor, dim: int = 1
                  ) -> torch.Tensor:
        """``rs_tokens(x @ w, dim)``; with the ``overlap`` opt the token-dim
        reduce-scatter of panel *k* runs behind the matmul of panel *k+1*
        (``Communicator(fast_axis=tp).matmul_rs``), otherwise the unfused
        matmul then scatter.  ``dim`` is a local dim (after the rank
        axis)."""
        if not self.tp_axis:
            return self.mm(x, w)
        if self.has("overlap"):
            nc = _clamp_chunks(self.overlap_chunks,
                               x.shape[dim + 1] // self.tp)
            if nc > 1:
                with span("tp::matmul_rs"):
                    return Communicator(fast_axis=self.tp_axis).matmul_rs(
                        x, w, axis=dim, n_chunks=nc)
        return self.rs_tokens(self.mm(x, w), dim)

    # ---- gradient reduction (the bridge) -------------------------------------
    def grad_reduce_axes(self, meta) -> tuple[str, ...]:
        """Axes a gradient leaf still needs to be summed over: the bridge in
        hier mode (plus the fsdp axes for leaves not stored sharded), the
        whole dp tier in naive mode, plus the tp axis for leaves the tp
        ranks replicate.  Bridge axes come first."""
        axes: tuple[str, ...] = ()
        if self.mode == "hier":
            if self.pod_axis:
                axes += (self.pod_axis,)
            if meta.fsdp_dim is None and self.fsdp_axes:
                axes += tuple(self.fsdp_axes)
        else:
            axes += tuple(self.dp_axes)
        if meta.tp_dim is None and self.tp_axis:
            axes += (self.tp_axis,)
        return axes

    def _axes_comm(self, axes: tuple[str, ...]) -> Communicator:
        """The two-tier communicator that reduces over exactly ``axes``."""
        fast = tuple(a for a in axes if a != self.pod_axis)
        slow = self.pod_axis if (self.pod_axis in axes and fast) else None
        return Communicator(fast_axis=fast or axes, slow_axis=slow)

    def reduce_grads(self, grads, metas=None, *, compress=None,
                     recorder=None, precision: str = "exact",
                     tol: Optional[float] = None, error_state=None):
        """Bridge gradient reduction over stacked gradients.  They already
        match the parameter layout (the window reads transposed into the
        node's reduce-scatter); what remains is the cross-pod psum in hier
        mode, or the flat dp allreduce in naive mode.

        With ``metas`` (``PMeta`` leaves in ``core.tree.leaves`` order) the
        reduction is per leaf over ``grad_reduce_axes(meta)``:
        ``precision="lossy"`` routes bridge-crossing leaves (hier) through
        the quantized wire formats, ``error_state`` (a grads-shaped tree of
        residuals, 0-d zeros to start) threads error feedback and the call
        returns ``(grads, new_error_state)``; ``compress`` is the legacy
        explicit hook; ``recorder`` (``Communicator.record()``) defers every
        exact reduction into the step graph and returns ``Deferred``
        leaves.  Without ``metas``: the legacy whole-tree reduction."""
        lossy = precision == "lossy"
        if error_state is not None and not lossy:
            raise ValueError("error_state requires precision='lossy'")
        errs = T.leaves(error_state) if error_state is not None else None
        if metas is not None:
            leaves = T.leaves(grads)
            zero = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device) if leaves else None
            new_errs = [zero for _ in leaves]
            reduced, comms, lossy_comms = [], {}, {}
            for i, (g, meta) in enumerate(zip(leaves, metas)):
                axes = self.grad_reduce_axes(meta)
                if not axes:
                    reduced.append(g)
                    continue
                bridge = (self.pod_axis in axes) if self.pod_axis else True
                if compress is not None and self.mode == "hier" and bridge:
                    reduced.append(compress(g, axes))
                    continue
                if lossy and self.mode == "hier" and bridge:
                    comm = lossy_comms.get(axes)
                    if comm is None:
                        comm = lossy_comms[axes] = \
                            Communicator(fast_axis=axes)
                    if errs is not None:
                        out, new_errs[i] = comm.allreduce(
                            g, precision="lossy", tol=tol,
                            result="replicated", error_feedback=errs[i])
                    else:
                        out = comm.allreduce(g, precision="lossy", tol=tol,
                                             result="replicated")
                    reduced.append(out)
                    continue
                if recorder is not None:
                    reduced.append(recorder.allreduce(
                        g, axes=axes, scheme="naive", key=("grad", i)))
                    continue
                comm = comms.get(axes)
                if comm is None:
                    comm = comms[axes] = self._axes_comm(axes)
                reduced.append(comm.allreduce(g, scheme="naive",
                                              result="replicated"))
            out = T.unflatten(grads, reduced)
            if error_state is not None:
                return out, T.unflatten(grads, new_errs)
            return out
        if self.mode == "hier":
            if self.pod_axis is None:
                return (grads, error_state) if error_state is not None \
                    else grads
            if lossy:
                bcomm = Communicator(fast_axis=self.pod_axis)
                if errs is not None:
                    pairs = [bcomm.allreduce(g, precision="lossy", tol=tol,
                                             result="replicated",
                                             error_feedback=e)
                             for g, e in zip(T.leaves(grads), errs)]
                    return (T.unflatten(grads, [o for o, _ in pairs]),
                            T.unflatten(grads, [e for _, e in pairs]))
                return T.tree_map(
                    lambda g: bcomm.allreduce(g, precision="lossy", tol=tol,
                                              result="replicated"), grads)
            comm = self.comm
            if comm is None:     # no node tier: the bridge is the whole comm
                comm = Communicator(fast_axis=self.pod_axis)
                return T.tree_map(
                    lambda g: comm.allreduce(g, result="replicated"), grads)
            return T.tree_map(comm.bridge_psum, grads)
        axes = self.dp_axes
        if not axes:
            return grads
        if error_state is not None:
            raise ValueError("error_state needs the hier bridge path "
                             "(metas, or hier mode)")
        dp_comm = self._axes_comm(tuple(axes))
        return T.tree_map(
            lambda g: dp_comm.allreduce(g, result="replicated",
                                        precision=precision, tol=tol),
            grads)

    # ---- tp collectives over stacked ranks (identities without a tp axis) ---
    # ``dim`` is a local dim, after the stacked rank axis.  Each forward
    # runs in a ``tp::<name>`` span (``core.spans``; its backward is the
    # substrate Function's node), which ``analysis.profile`` reads.
    def ag_tokens(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Sequence-parallel all-gather: (B, T/tp, d) -> (B, T, d) per
        rank.  Gradient: the reduce-scatter."""
        if not self.tp_axis:
            return x
        with span("tp::ag_tokens"):
            # raw-collective: ag_tokens tp fast path (one flat tp group)
            return coll.all_gather(x, self.tp_axis, axis=dim, tiled=True)

    def rs_tokens(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Sequence-parallel reduce-scatter: partial (B, T, d) ->
        (B, T/tp, d) per rank.  Gradient: the all-gather."""
        if not self.tp_axis:
            return x
        with span("tp::rs_tokens"):
            # raw-collective: rs_tokens tp fast path (one flat tp group)
            return coll.psum_scatter(x, self.tp_axis, scatter_dimension=dim)

    def gather_tp(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather the tp shards along a local dim (the vocab of the
        decode logits, the kv heads of a prefill cache).  Gradient: the
        reduce-scatter."""
        if not self.tp_axis:
            return x
        with span("tp::gather_tp"):
            # raw-collective: gather_tp tp fast path (one flat tp group)
            return coll.all_gather(x, self.tp_axis, axis=dim, tiled=True)

    def psum_tp(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tp_axis:
            return x
        with span("tp::psum_tp"):
            return coll.psum(x, self.tp_axis)  # raw-collective: tp fast path

    def pmax_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-shard max as an all-gather then a max, as the reference
        takes it (its pmax has no JVP, and this sits in differentiated
        loss code)."""
        if not self.tp_axis:
            return x
        with span("tp::pmax_tp"):
            # raw-collective: pmax_tp tp fast path
            return coll.all_gather(x, self.tp_axis, axis=0,
                                   tiled=False).amax(dim=1)

    def group_all_gather(self, x: torch.Tensor, *, group: int, dim: int
                         ) -> torch.Tensor:
        """All-gather within contiguous subgroups of ``group`` tp ranks."""
        if not self.tp_axis or group == 1:
            return x
        with span("tp::group_all_gather"):
            # raw-collective: grouped tp fast path
            return coll.all_gather(x, self.tp_axis, axis=dim, tiled=True,
                                   group=group)

    def group_psum(self, x: torch.Tensor, *, group: int) -> torch.Tensor:
        """psum within contiguous subgroups of ``group`` tp ranks."""
        if not self.tp_axis or group == 1:
            return x
        with span("tp::group_psum"):
            # raw-collective: grouped tp fast path
            return coll.psum(x, self.tp_axis, group=group)

    def shard(self, n: int) -> int:
        if n % self.tp:
            raise ValueError(f"{n} not divisible by tp={self.tp}")
        return n // self.tp


#: The panel kernel's output tile (``csrc/matmul.cu``): 128 x 128.
KERNEL_TILE = 128


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: x (..., K) by w (K, N), or x (R, M, K) by w (R, K, N) one
    product per rank.  The one rule for the panel kernel: a float32
    product on the card with a full 128-row output tile (a rank's rows)
    and at least one output tile for every SM runs on it, forward and
    backward (``ops.matmul``, 3xTF32).  Everything else keeps
    ``torch.matmul``: bf16 (cuBLAS's bf16 tensor cores run at twice TF32's
    rate, which the kernel would take bf16 through), a decode's few rows
    (most of each 128-row tile wasted), a grid that leaves SMs idle (a
    short prefill at a narrow N), and CPU and meta tensors."""
    batched = w.dim() == 3
    rows = x.shape[-2] if batched else x.numel() // max(x.shape[-1], 1)
    tiles = ((x.shape[0] if batched else 1) * -(-rows // KERNEL_TILE)
             * -(-w.shape[-1] // KERNEL_TILE))
    if not (x.is_cuda and x.dtype == w.dtype == torch.float32
            and rows >= KERNEL_TILE and tiles >= _sms(x.device.index)):
        return torch.bmm(x, w) if batched else x @ w
    if batched:
        return ops.matmul(x, w)
    return ops.matmul(x.reshape(rows, x.shape[-1]), w).reshape(
        tuple(x.shape[:-1]) + (w.shape[-1],))


def _node_ag_matmul(x: torch.Tensor, shards: torch.Tensor, n_chunks: int
                    ) -> torch.Tensor:
    """``x @ read_node(shards)`` streamed panel by panel: one node's members
    ``(c, K/c, N)`` of a weight stored along its contraction dim; panel *j*
    is the members' *j*-th row pieces joined in member order, and the
    partial products add in fp32 in panel order — per rank the reference's
    ``comm.pipeline.ag_matmul`` arithmetic."""
    c, s, n_out = shards.shape
    piece = s // n_chunks
    lead = tuple(x.shape[:-1])
    xr = x.reshape(lead + (c, n_chunks, piece))
    acc = torch.zeros(lead + (n_out,), dtype=torch.float32, device=x.device)
    for j in range(n_chunks):
        panel = SharedWindow(None, shards[:, j * piece:(j + 1) * piece],
                             axis=0).read_node()
        xj = xr[..., :, j, :].reshape(lead + (c * piece,))
        acc = acc + dense(xj, panel).float()
    return acc.to(x.dtype)


# ---------------------------------------------------------------------------
# Async parameter prefetch (FSDP2-style sharded <-> unsharded lifecycle)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParamGroup:
    """One layer's parameters as an unshard / reshard unit (torch FSDP2's
    param group): the weights live sharded in the node store;
    ``unshard()`` issues every FSDP-dim window read as an
    ``AsyncCollectiveHandle`` on the card's side stream with ONE event for
    the group, ``wait()`` resolves them into the full per-layer tree,
    ``reshard()`` drops the full copy so at most ``budget`` groups are ever
    unsharded.  Each read is ``ParallelCtx.gather_w``'s (cast first, then
    the window read), so prefetched and eager runs compute the same bits."""

    ctx: ParallelCtx
    params: object                 # this layer's (sharded) param tree
    metas: object                  # matching tree with PMeta leaves
    _handles: object = None        # issued but unresolved (in flight)
    _full: object = None           # resolved full copy (unsharded)

    @property
    def state(self) -> str:
        if self._full is not None:
            return "unsharded"
        return "in_flight" if self._handles is not None else "sharded"

    def unshard(self) -> "ParamGroup":
        """Issue the group's reads (idempotent while in flight)."""
        if self._handles is not None or self._full is not None:
            return self
        ctx = self.ctx
        ws = [w.to(ctx.compute_dtype) for w in T.leaves(self.params)]
        dims = [getattr(m, "fsdp_dim", None) for m in T.leaves(self.metas)]
        stored = [ctx._stored(d) for d in dims]
        side = side_stream(ws[0].device) if any(stored) else None
        vals = []
        for w, d, s in zip(ws, dims, stored):
            if not s:
                vals.append(w)
                continue
            vals.append(AsyncCollectiveHandle.issue(
                "allgather", ctx._window(w, d), stream=side, event=False,
                node=True))
        if side is not None:
            event = side.record_event()
            vals = [dataclasses.replace(v, event=event)
                    if isinstance(v, AsyncCollectiveHandle) else v
                    for v in vals]
        self._handles = T.unflatten(self.params, vals)
        return self

    def wait(self):
        """Resolve the in-flight reads; returns the full parameter tree.
        Each handle's epoch is checked, so a store tearing one window fails
        the wait."""
        if self._full is None:
            if self._handles is None:
                raise RuntimeError("ParamGroup.wait() before unshard()")
            vals = T.leaves(self._handles)
            for h in vals:
                if isinstance(h, AsyncCollectiveHandle) and not h.done:
                    raise WindowEpochError(
                        f"wait on a torn {h.family} handle: the window was "
                        f"stored to or fenced past epoch {h.issue_epoch} "
                        f"(now epoch {h.window.epoch}, "
                        f"dirty={h.window.dirty}) — re-issue after the "
                        "fence")
            self._full = T.unflatten(self._handles, [
                h.resolve() if isinstance(h, AsyncCollectiveHandle) else h
                for h in vals])
            self._handles = None
        return self._full

    def reshard(self) -> "ParamGroup":
        """Free the unsharded copy (back to the sharded store)."""
        self._full = None
        self._handles = None
        return self


def prefetch_schedule(n: int, budget: int) -> list[tuple[str, int]]:
    """The prefetcher's event order for ``n`` groups with at most
    ``budget`` in flight: prime ``budget`` unshards, then per group —
    wait, compute, reshard, and backfill the next unshard."""
    budget = max(1, budget)
    events = [("unshard", k) for k in range(min(budget, n))]
    for k in range(n):
        events.append(("wait", k))
        events.append(("compute", k))
        events.append(("reshard", k))
        if k + budget < n:
            events.append(("unshard", k + budget))
    return events


def prefetch_walk(groups, fn, x, budget: int):
    """Drive ``x = fn(x, k, full_params_k)`` over ``groups`` with the
    bounded-prefetch schedule: the reads issued on the side stream overlap
    the preceding groups' compute on the current stream."""
    groups = list(groups)
    for ev, k in prefetch_schedule(len(groups), budget):
        if ev == "unshard":
            groups[k].unshard()
        elif ev == "wait":
            groups[k].wait()
        elif ev == "compute":
            x = fn(x, k, groups[k].wait())
        else:
            groups[k].reshard()
    return x


def _clamp_chunks(n_chunks: int, extent: int) -> int:
    """Largest chunk count <= ``n_chunks`` that tiles ``extent``."""
    nc = max(1, min(n_chunks, extent if extent > 0 else 1))
    while extent % nc:
        nc -= 1
    return nc
