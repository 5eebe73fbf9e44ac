"""The cluster train step (forward, backward, gradient bridge, grad norm,
AdamW) over the port's stacked ``VirtualCluster``.

The reference's ``repro/runtime/steps.py`` for the paper's two training
modes:

* ``mode="hier"``  — parameters and AdamW state live ONCE per node, sharded
  over the node's ranks (the MPI-3 shared window); layer weights are read
  from the window at use; the gradient bridge is the read's transpose (the
  node's reduce-scatter) and then ONE cross-pod psum per shard;
* ``mode="naive"`` — every rank keeps a private replica, and each gradient
  takes one flat (pod, data) psum.

``make_cluster_train_step`` builds the step over a cluster's own axis
names (``cluster_ctx``).  Its ``fn`` is the reference's ``shard_map``'d step
(``VirtualCluster.smap``): global state and batch in, global state and
metrics out.  Its ``step`` takes the state laid out on the cluster (stacked
``(R, *local)`` tensors under ``state_specs``) and DONATES it, as the
reference's train loop donates its state to ``jit``: AdamW's arithmetic is
computed out of place slice by slice and stored over the old tensors
(``optim.adamw.adamw_update_``), and the same dict comes back.  So a
training loop keeps the paper's layout between steps, the card holds
exactly one copy of the state per node in hier mode, and the update needs
no second copy of it.  ``fn`` runs the same body on the fresh stacked copy
that ``smap`` lays out, so the caller's global state is left as it was.

**One model run per memory domain.**  The body is the reference's per-rank
body over stacked tensors.  The forward and backward run the port's
single-device model once per domain (``models.parallel``): in hier once per
node — its window read as one buffer, the node's ranks' batch rows folded
into one batch — and in naive once per rank on its private replica.  Each
run's gradient goes back to its ranks' stacked slots: a window leaf's to
the members' shards (the reduce-scatter store), a leaf the node keeps
replicated (no FSDP dim) to member 0 with zeros for the other members, a
naive rank's to itself.  Per-rank loss and token partials come from the
per-row loss, so the world allreduce of the metrics and the bridge
(``ParallelCtx.reduce_grads``) run over ``(R, ...)`` exactly as the
reference's do, and the sums differ from the reference's only in the
order in which a node's rows add up.

**Tensor parallelism inside a domain run.**  On a fast tier factored over
``(store, tp)`` (``cluster_ctx``: the last fast axis is tp, as in the
reference's production layout) a domain's tp ranks hold *different*
shards and exchange activations — work the reference does — so they are
not collapsed into one plain full-width run (which would give the same
numbers but skip the tp collectives, the vocab-parallel loss and the tp
gradient reductions).  The run keeps a leading axis of the tp ranks on
every leaf and activation, with a mesh of the tp axis alone bound: the tp
collectives are the substrate's over that axis, the weight products are
batched over it, and a tp-sharded window leaf is read over the store
ranks only, one window per tp rank.  A domain is a node in hier (its
store ranks' rows folded into the batch) and one store rank's tp group in
naive.  The state keeps the reference's layout, so per node hier holds
each tp shard once and naive once per store rank: C1 naive/hier is the
store size, not ``chips``.  The grad norm divides a tp-replicated leaf's
square by ``tp`` as well.

``make_step_bench`` is the ``step_time`` bench family's body: the same
step over flattened state, returning loss, grad norm and a parameter
checksum.

**The production mesh.**  ``make_ctx`` / ``build_model`` /
``batch_specs`` / ``make_train_step`` / ``make_serve_steps`` are the
reference's entry points over a ``MeshTopology`` whose mesh is its
stacked cluster (``launch.mesh.make_mesh_from_topo``: ``pod`` the bridge,
``("data", "model")`` the node as (store, tp)); ``make_ctx`` keeps
``tp_axis="model"`` at size 1 too and the store ``("data",)`` in hier.  ``make_train_step`` is the same body as the
cluster step (``_train_bundle``) with the batch split over the
data-parallel axes, every batch leaf (``tokens``; ``patches`` for a
``vit`` model; ``frames`` / ``labels`` for ``encodec``) folded per domain,
the ``int8_bridge`` opt / ``compress`` hook on the bridge and a bf16
default compute dtype, as the reference's.  ``make_serve_steps`` wraps the
serve-side domain run (``transformer.ClusterModel``), with the 2-D decode
layout under the ``decode2d`` opt.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.traffic import device_bytes
from repro_torch.comm import Communicator
from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as T
from repro_torch.models.domains import (Domains, domain_range, domain_run,
                                        domain_view, units_flags)
from repro_torch.core.topology import MeshTopology
from repro_torch.models.meta import store_dim
from repro_torch.models.parallel import ParallelCtx
from repro_torch.models.transformer import Model, _loss, build
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     adamw_update_, per_rank)
from repro_torch.substrate.cluster import P


def cluster_ctx(vc, *, mode: str = "hier", compute_dtype=torch.float32,
                opts=()) -> ParallelCtx:
    """A ``ParallelCtx`` over a ``VirtualCluster``'s own axis names: the
    slow tier is the bridge, the fast tier is where parameters are stored.
    A fast tier factored over several axes makes its last axis tensor-
    parallel and the others the store, as in the reference."""
    if len(vc.slow_names) > 1:
        raise ValueError("cluster_ctx supports at most one slow (bridge) "
                         f"axis, got {vc.slow_names}")
    pod = vc.slow_names[0] if vc.slow_names else None
    fast = vc.fast_names
    tp_axis = fast[-1] if len(fast) > 1 else None
    store = fast[:-1] if len(fast) > 1 else fast
    store_size = math.prod(s for n, s in zip(vc.axis_names, vc.axis_shapes)
                           if n in store)
    if store_size == 1:
        # a size-1 store shards nothing: no window read to issue early
        opts = tuple(o for o in opts if not str(o).startswith("prefetch"))
    return ParallelCtx(
        tp_axis=tp_axis,
        fsdp_axes=store if mode == "hier" else (),
        dp_axes=((pod,) + store) if pod else store,
        pod_axis=pod,
        tp=vc.fast_shape[-1] if tp_axis else 1,
        mode=mode, compute_dtype=compute_dtype, opts=frozenset(opts))


@dataclasses.dataclass(frozen=True)
class TrainStepBundle:
    fn: Any            # global (state, batch) -> (state, metrics)
    step: Any          # laid-out (state, batch) -> (state, metrics)
    state_specs: Any
    batch_spec: Any
    model: Model
    vc: Any
    # grad_bytes: what the last step allocated for gradients
    stats: dict = dataclasses.field(default_factory=dict)

    def init_state(self, seed: int = 0) -> dict:
        """Global state: the model's params drawn on the cluster's device
        from ``seed``, zero moments, step 0."""
        params = self.model.init_params(seed)
        m, v = adamw_init(params)
        return {"params": params, "m": m, "v": v,
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.vc.device)}

    def init_layout_state(self, seed: int = 0) -> dict:
        """``init_state`` laid out on the cluster, with the global copy
        dropped before the moments are made (zeros in the layout), so the
        card never holds more than one global parameter tree beside the
        laid-out state."""
        params = self.vc.layout(self.model.init_params(seed),
                                self.state_specs["params"])
        m, v = adamw_init(params)
        step = self.vc.layout(torch.zeros((), dtype=torch.int32),
                              self.state_specs["step"])
        return {"params": params, "m": m, "v": v, "step": step}

    def layout_state(self, state: dict) -> dict:
        """Global state -> the stacked layout ``step`` takes."""
        return self.vc.layout(state, self.state_specs)

    def unlayout_state(self, state: dict) -> dict:
        """Stacked state -> global (member 0 of each replica)."""
        return self.vc.unlayout(state, self.state_specs)

    def layout_batch(self, batch: dict) -> dict:
        """A global batch -> stacked per rank under ``batch_spec``: every
        leaf it names (``tokens``; ``patches``; ``frames`` / ``labels``)."""
        return self.vc.layout({k: torch.as_tensor(batch[k])
                               for k in self.batch_spec}, self.batch_spec)

    def abstract_state(self) -> dict:
        """The global state's shapes and dtypes as ``meta``-device tensors
        (the reference's ``eval_shape`` of ``init_state``): a checkpoint
        restore's template, with nothing drawn."""
        params = self.model.abstract_params(self.state_specs["params"])
        return {"params": params, "m": params, "v": params,
                "step": torch.empty((), dtype=torch.int32, device="meta")}

    def host_state(self, state: dict) -> dict:
        """Laid-out state -> the global state on the CPU, one leaf at a
        time, so the card never holds a second copy of the whole state —
        what a checkpoint saves."""
        mesh = self.vc.mesh
        out = [mesh.unlayout(t, spec).cpu() for t, spec in zip(
            T.leaves(state), T.leaves(self.state_specs))]
        return T.unflatten(state, out)


def _domain_grads(cfg, ctx: ParallelCtx, defs, params, batch: dict,
                  store: int, stats: dict):
    """Forward + backward once per memory domain over the stacked batch
    (every leaf ``(R, b, ...)``: ``tokens``, ``patches``, ``frames`` /
    ``labels``).  Returns the stacked per-rank gradients (the parameters'
    layout), loss and token partials (``(R,)`` each);
    ``stats["grad_bytes"]`` gets the gradients' device bytes
    (``analysis.traffic.device_bytes`` on the card).

    A domain's members are ``s`` store ranks times ``t`` tp ranks,
    consecutive in rank order with tp innermost (hier: a node, ``s`` its
    store size; naive: one store rank's tp group).  Inside the run every
    leaf and activation keeps a leading axis of the ``t`` tp ranks (dropped
    without a tp axis) under a mesh of the tp axis alone: a window leaf is
    ``(t, s, *shard)`` (one window per tp rank, read over the store ranks),
    any other the store's first member's copies ``(t, *local)``."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    first = next(iter(batch.values()))
    R, device = first.shape[0], first.device
    tp = bool(ctx.tp_axis)
    s = store if ctx.mode == "hier" and ctx.fsdp_axes else 1
    t = ctx.tp if tp else 1
    n = s * t
    leaves = T.leaves(params)
    metas = T.leaves(defs)
    units = T.leaves(units_flags(params))
    window = [s > 1 and store_dim(m) is not None for m in metas]
    on_card = device.type == "cuda"
    base = device_bytes(device) if on_card else 0
    grads = [torch.zeros_like(w) for w in leaves]
    stats["grad_bytes"] = (
        device_bytes(device) - base if on_card
        else sum(g.numel() * g.element_size() for g in grads))
    loss = torch.zeros(R, dtype=torch.float32, device=device)
    cnt = torch.zeros(R, dtype=torch.float32, device=device)
    lay = Domains(R, s, t, tp)
    # the node's rows folded into one batch: the MoE block dispatches each
    # member's rows apart (the reference's per-rank capacity)
    run_ctx = dataclasses.replace(ctx, fold=s)

    def from_domain(g, win, u, dst):
        if not tp:
            g = g.unsqueeze(1 if u else 0)
        if u:
            g = g.movedim(0, 2 if win else 1)
        if win:
            dst.copy_(g.movedim(0, 1).reshape(dst.shape))
        else:
            dst[:t].copy_(g)

    for d in domain_range(lay.count):
        a = d * n
        dom = [domain_view(w[a:a + n], s, t, win, u, tp).detach()
               .requires_grad_(True)
               for w, win, u in zip(leaves, window, units)]
        # the store ranks' rows of every leaf (their tp ranks hold the
        # same rows)
        rows = {k: lay.fold(v, d) for k, v in batch.items()}
        # every domain runs the same program: the traffic record keeps the
        # first one's collectives as each rank's
        with torch.enable_grad(), domain_run(ctx, lay, d, device, s):
            nll, count = _loss(cfg, run_ctx, defs, T.unflatten(params, dom),
                               rows, rows=True)
            got = torch.autograd.grad(nll.sum(), dom, allow_unused=True)
            for g, dst, win, u in zip(got, grads, window, units):
                if g is not None:
                    from_domain(g, win, u, dst[a:a + n])
            # per-row partials (t, s * rows) -> per rank in (store, tp)
            # order
            loss[a:a + n] = nll.detach().reshape(t, s, -1).sum(dim=2).T \
                .reshape(n)
            cnt[a:a + n] = count.reshape(t, s, -1).sum(dim=2).T.reshape(n)
        del got, nll, dom
    return T.unflatten(params, grads), loss, cnt


def _bridge_and_clip(ctx: ParallelCtx, world, node, grads, loss_sum, cnt,
                     meta_leaves, data: int, clip: float, *,
                     stats_scheme: str = "auto", schedule_sink=None,
                     compress=None, precision: str = "exact"):
    """The step after the backward: the world allreduce of the loss and
    token partials, the gradient bridge (``ParallelCtx.reduce_grads``;
    with the ``stepgraph`` opt all of it recorded into one graph and run as
    the optimized schedule, whose ``report()`` goes to ``schedule_sink``),
    the per-token mean, the global grad norm and the clip.  The gradients
    are the step's own buffers, scaled in place.  ``stats_scheme="auto"``
    is the train step's (``scheme="auto"`` under ``result="replicated"``,
    never bucketed); the step bench pins ``"naive"``, as the reference's
    does, so its program is one fixed schedule per topology.  ``compress``
    and ``precision`` go to the bridge (``make_train_step``'s legacy hook
    and its ``int8_bridge`` opt).  Returns the gradient leaves, the global
    loss and token sums and the grad norm."""
    auto = stats_scheme == "auto"
    stat_kw = dict(result="replicated") if auto else dict(
        scheme=stats_scheme)
    if ctx.stepgraph:
        rec = world.record()
        rec_kw = dict(scheme="auto", result="replicated",
                      bucketable=False) if auto else dict(
            scheme=stats_scheme)
        rl = rec.allreduce(loss_sum, axes=world.axes, key="loss", **rec_kw)
        rc = rec.allreduce(cnt, axes=world.axes, key="cnt", **rec_kw)
        grads = ctx.reduce_grads(grads, meta_leaves, recorder=rec,
                                 compress=compress, precision=precision)
        res = rec.run()
        if schedule_sink is not None:
            schedule_sink.append(res.report())
        loss_g, cnt_g = res[rl], res[rc]
        grads = res.resolve(grads)
    else:
        loss_g = world.allreduce(loss_sum, **stat_kw)
        cnt_g = world.allreduce(cnt, **stat_kw)
        grads = ctx.reduce_grads(grads, meta_leaves, compress=compress,
                                 precision=precision)
    gl = T.leaves(grads)     # the step's own buffers: in place
    del grads
    for g in gl:
        g.div_(per_rank(cnt_g, g))
    # global grad norm: each leaf weighted by 1/replication over the node
    # tier (tp ranks and store ranks), so every element counts once;
    # node-local, since the pods hold identical gradients after the bridge
    gsq = torch.zeros_like(loss_g)
    for g, meta in zip(gl, meta_leaves):
        repl = 1.0
        if meta.tp_dim is None and ctx.tp_axis:
            repl *= ctx.tp
        if meta.fsdp_dim is None or ctx.mode != "hier":
            repl *= data
        gsq = gsq + torch.sum(torch.square(g.float()),
                              dim=tuple(range(1, g.dim()))) / repl
    gsq = node.allreduce(gsq, **stat_kw)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in gl:
        g.mul_(per_rank(scale, g))
    return gl, loss_g, cnt_g, gnorm


def _train_bundle(cfg, vc, ctx: ParallelCtx, data: int, bspec, *,
                  lr: float, weight_decay: float, clip: float,
                  compress=None, precision: str = "exact"
                  ) -> TrainStepBundle:
    """The train step over ``vc`` with ``ctx``: the model built with the
    node's ``data`` store size, the state under the params' specs, the
    batch under ``bspec`` — the one body of ``make_cluster_train_step`` and
    ``make_train_step``."""
    model = build(cfg, ctx, data=data, device=vc.device)
    defs = model.defs
    pspecs = model.param_specs(tp_axis=ctx.tp_axis,
                               fsdp_axis=ctx.fsdp_axes[0]
                               if ctx.fsdp_axes else None)
    state_specs = {"params": pspecs, "m": pspecs, "v": pspecs, "step": P()}
    meta_leaves = T.leaves(defs)
    world = Communicator.from_cluster(vc)
    node = world.split_type_shared()
    stats: dict = {}

    def body(state, batch):
        params = state["params"]
        # the gradients passed on, not held: the bridge frees them as it goes
        with torch.no_grad():
            gl, loss_g, cnt_g, gnorm = _bridge_and_clip(
                ctx, world, node, *_domain_grads(
                    cfg, ctx, defs, params, batch, data, stats),
                meta_leaves, data, clip, compress=compress,
                precision=precision)
            step = state["step"] + 1
            metrics = {"loss": loss_g / cnt_g, "gnorm": gnorm,
                       "tokens": cnt_g}
            adamw_update_(params, gl, state["m"], state["v"], step, lr=lr,
                          weight_decay=weight_decay)
            state["step"] = step
        return state, metrics

    out_specs = (state_specs, {"loss": P(), "gnorm": P(), "tokens": P()})
    smapped = vc.smap(body, in_specs=(state_specs, bspec),
                      out_specs=out_specs)

    def step(state, batch):
        with vc.bind():
            return body(state, batch)

    return TrainStepBundle(fn=smapped, step=step, state_specs=state_specs,
                           batch_spec=bspec, model=model, vc=vc, stats=stats)


def make_cluster_train_step(cfg: ModelConfig, vc, *, mode: str = "hier",
                            lr: float = 3e-4, weight_decay: float = 0.1,
                            clip: float = 1.0, unroll: int = 1,
                            global_batch: int = 8, opts=(),
                            compute_dtype=torch.float32) -> TrainStepBundle:
    """The train step over a ``VirtualCluster``'s own mesh and axis names.

    When ``global_batch`` does not divide the data-parallel rank count the
    batch is REPLICATED instead of sharded — every rank computes the full
    batch and the token count absorbs the overcount.  ``unroll`` is the
    reference's scan unroll and does not change the port's Python loop.
    The token frontend only, as in the reference (``make_train_step``
    drives the ``vit`` / ``encodec`` ones)."""
    del unroll
    if cfg.frontend not in (None, "", "tokens"):
        raise ValueError(f"cluster train step only drives the token "
                         f"frontend, not {cfg.frontend!r}")
    ctx = cluster_ctx(vc, mode=mode, compute_dtype=compute_dtype, opts=opts)
    sizes = dict(zip(vc.axis_names, vc.axis_shapes))
    data = math.prod(sizes[a] for a in (
        ctx.fsdp_axes or tuple(a for a in ctx.dp_axes
                               if a != ctx.pod_axis)))
    n_dp = math.prod(sizes[a] for a in ctx.dp_axes)
    shard_batch = global_batch % n_dp == 0
    bspec = {"tokens": P(ctx.dp_axes) if shard_batch else P()}
    return _train_bundle(cfg, vc, ctx, data, bspec, lr=lr,
                         weight_decay=weight_decay, clip=clip)


# ---------------------------------------------------------------------------
# The production mesh: a MeshTopology over the stacked cluster
# ---------------------------------------------------------------------------

def make_ctx(topo: MeshTopology, mode: str,
             compute_dtype=torch.bfloat16, opts=()) -> ParallelCtx:
    """The production ctx of a topology (the reference's): ``tp_axis``
    ``"model"`` (at size 1 too), the node store ``("data",)`` in hier,
    batch over ``(pod, data)``, the bridge over ``pod`` where the topology
    has more than one."""
    if "model" not in topo.axis_sizes or "data" not in topo.axis_sizes:
        raise ValueError(f"the production ctx needs 'data' and 'model' axes, "
                         f"got {tuple(topo.axis_sizes)}")
    if topo.fast_axes[-1] != "model":
        raise ValueError("'model' must be the innermost fast axis (the tp "
                         f"ranks consecutive), got {topo.fast_axes}")
    has_pod = "pod" in topo.axis_sizes and topo.num_pods > 1
    return ParallelCtx(
        tp_axis="model",
        fsdp_axes=("data",) if mode == "hier" else (),
        dp_axes=("pod", "data") if has_pod else ("data",),
        pod_axis="pod" if has_pod else None,
        tp=topo.size("model"),
        mode=mode,
        compute_dtype=compute_dtype,
        opts=frozenset(opts))


def build_model(cfg: ModelConfig, topo: MeshTopology, mode: str,
                compute_dtype=torch.bfloat16, opts=(), device="cuda"
                ) -> Model:
    """The model over ``make_ctx(topo, ...)``: a ``ClusterModel``."""
    ctx = make_ctx(topo, mode, compute_dtype, opts)
    return build(cfg, ctx, data=topo.size("data"), device=device)


def batch_specs(cfg: ModelConfig, topo: MeshTopology) -> dict:
    """The batch's specs on the production mesh: every leaf split over the
    data-parallel axes (``tokens``; ``patches`` for ``vit``; ``frames`` /
    ``labels`` for ``encodec``)."""
    dp = tuple(a for a in ("pod", "data") if a in topo.axis_sizes
               and not (a == "pod" and topo.num_pods == 1))
    if cfg.frontend == "encodec":
        return {"frames": P(dp), "labels": P(dp)}
    out = {"tokens": P(dp)}
    if cfg.frontend == "vit":
        out["patches"] = P(dp)
    return out


def make_train_step(cfg: ModelConfig, topo: MeshTopology, mesh, *,
                    mode: str = "hier", lr: float = 3e-4,
                    weight_decay: float = 0.1, clip: float = 1.0,
                    unroll: int = 1, compress=None, opts=(),
                    compute_dtype=torch.bfloat16) -> TrainStepBundle:
    """The train step on the production mesh: ``mesh`` is the stacked
    cluster of ``topo`` (``launch.mesh.make_mesh_from_topo``), the ctx
    ``make_ctx``'s, the batch split over the data-parallel axes
    (``batch_specs``), every frontend driven.  The ``int8_bridge`` opt asks
    the bridge for ``precision="lossy"`` (without ``compress``, the legacy
    explicit hook); the grad norm weights each leaf by its replication over
    the node (``model`` for a tp-replicated leaf, ``data`` for one not
    stored sharded).  Same body as ``make_cluster_train_step``
    (``_train_bundle``).  ``unroll`` is the reference's scan unroll and
    does not change the port's Python loop."""
    del unroll
    vc = mesh
    if tuple(vc.axis_names) != tuple(
            a for a in topo.axis_names()
            if not (a in topo.slow_axes and topo.num_pods == 1)):
        raise ValueError(f"mesh axes {vc.axis_names} are not the topology's "
                         f"{topo.axis_names()} (launch.mesh."
                         f"make_mesh_from_topo)")
    ctx = make_ctx(topo, mode, compute_dtype, opts)
    precision = "lossy" if (compress is None
                            and "int8_bridge" in opts) else "exact"
    return _train_bundle(cfg, vc, ctx, topo.size("data"),
                         batch_specs(cfg, topo), lr=lr,
                         weight_decay=weight_decay, clip=clip,
                         compress=compress, precision=precision)


def make_step_bench(cfg: ModelConfig, vc, *, opts=(), unroll: int = 1,
                    lr: float = 3e-4, weight_decay: float = 0.1,
                    clip: float = 1.0, global_batch: int = 8, seq: int = 32,
                    seed: int = 0, schedule_sink=None):
    """Whole-train-step bench body for one cluster (the reference's): the
    forward + backward, the gradient bridge and AdamW, as a
    ``repro_torch.bench`` case.

    Returns ``(body, in_specs, out_specs, make_args, elems)``.  ``body``
    takes the state FLATTENED into top-level stacked ``(R, *local)``
    arguments (``core.tree.leaves`` order of ``{"params", "m", "v",
    "step"}`` under ``in_specs``) and the stacked tokens last, and returns
    three stacked replicated f32 values: the loss, the grad norm and a
    checksum of the updated parameters (which keeps the whole update in the
    step).  It is pure: AdamW runs out of place, so the same arguments can
    be fed again.  ``make_args()`` draws the parameters from ``seed`` and a
    deterministic token stream (the reference's Knuth multiplicative hash
    of position), laid out on the cluster's device.  ``elems`` is the
    model's global parameter element count.  The step is hier; the scalar
    stats are pinned to the flat ``naive`` scheme.  ``unroll`` is the
    reference's scan unroll and does not change the port's Python loop.
    With the ``stepgraph`` opt, ``schedule_sink`` (a list) receives each
    run's schedule ``report()``."""
    del unroll
    ctx = cluster_ctx(vc, opts=opts)
    sizes = dict(zip(vc.axis_names, vc.axis_shapes))
    data = math.prod(sizes[a] for a in ctx.fsdp_axes)
    model = build(cfg, ctx, data=data, device=vc.device)
    defs = model.defs
    pspecs = model.param_specs(tp_axis=ctx.tp_axis,
                               fsdp_axis=ctx.fsdp_axes[0]
                               if ctx.fsdp_axes else None)
    state_specs = {"params": pspecs, "m": pspecs, "v": pspecs, "step": P()}
    bspec = P(ctx.dp_axes)
    meta_leaves = T.leaves(defs)
    world = Communicator.from_cluster(vc)
    node = world.split_type_shared()
    stats: dict = {}

    def body(*args):
        state = T.unflatten(state_specs, list(args[:-1]))
        params = state["params"]
        with torch.no_grad():
            gl, loss_g, cnt_g, gnorm = _bridge_and_clip(
                ctx, world, node, *_domain_grads(
                    cfg, ctx, defs, params, {"tokens": args[-1]}, data,
                    stats),
                meta_leaves, data, clip, stats_scheme="naive",
                schedule_sink=schedule_sink)
            new_params, _, _ = adamw_update(
                params, T.unflatten(params, gl), state["m"], state["v"],
                state["step"] + 1, lr=lr, weight_decay=weight_decay)
            csum = torch.zeros_like(loss_g)
            for leaf in T.leaves(new_params):
                csum = csum + torch.sum(leaf.float(),
                                        dim=tuple(range(1, leaf.dim())))
            csum = world.allreduce(csum, scheme="naive")
        return loss_g / cnt_g, gnorm, csum

    in_specs = tuple(T.leaves(state_specs)) + (bspec,)
    out_specs = (P(), P(), P())

    def make_args():
        params = model.init_params(seed)
        m, v = adamw_init(params)
        state = {"params": params, "m": m, "v": v,
                 "step": torch.zeros((), dtype=torch.int32)}
        toks = (np.arange(global_batch * (seq + 1), dtype=np.uint32)
                * np.uint32(2654435761)) % np.uint32(cfg.vocab)
        tokens = torch.from_numpy(
            toks.astype(np.int32).reshape(global_batch, seq + 1))
        return tuple(vc.layout(x, spec) for x, spec in zip(
            T.leaves(state) + [tokens], in_specs))

    elems = sum(math.prod(t.shape) for t in T.leaves(
        model.abstract_params(pspecs)))
    return body, in_specs, out_specs, make_args, elems


# ---------------------------------------------------------------------------
# Serve steps on the production mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeStepBundle:
    """``make_serve_steps``' prefill and decode over the stacked cluster.

    ``prefill(params, batch)`` takes the params laid out under
    ``prefill_param_specs`` (the train layout) and the batch stacked under
    ``batch_spec``; it returns the ``NodeCache`` and the stacked last-token
    logits ``(R, b_loc, 1, V)``.  ``decode(params, cache, token, pos)``
    takes the params under ``param_specs`` (the serve layout; with the
    ``decode2d`` opt the head-group layout), the ``NodeCache``, the
    stacked tokens ``(R, b_loc, 1)`` (``encodec``: frames) and ``pos`` —
    a position shared by the batch or stacked ``(R, b_loc)`` per-slot
    positions (1-D decode only); the cache is updated in place.  A batch
    that the data-parallel ranks divide is split over them (each node folds
    its ranks' rows into one run), else replicated, as the reference's
    small batches are."""

    prefill: Any
    decode: Any
    param_specs: Any          # serve layout
    prefill_param_specs: Any  # train layout (prefill runs in it)
    batch_spec: Any
    model: Model
    s_max: int
    b_loc: int
    vc: Any
    sharded: bool

    def layout_params(self, params: dict, *, serve: bool = True) -> dict:
        """Global params -> stacked, under the serve (decode) or train
        (prefill) specs."""
        return self.vc.layout(params, self.param_specs if serve
                              else self.prefill_param_specs)

    def layout_batch(self, batch: dict) -> dict:
        """A global batch -> stacked per rank under ``batch_spec``."""
        return self.vc.layout({k: torch.as_tensor(batch[k])
                               for k in self.batch_spec}, self.batch_spec)

    def layout_tokens(self, token) -> torch.Tensor:
        """A global decode input ``(B, 1)`` / ``(B, 1, d_f)`` -> stacked
        per rank, split like the batch."""
        spec = next(iter(self.batch_spec.values()))
        return self.vc.layout(torch.as_tensor(token), spec)

    def cache_init(self):
        """An empty ``NodeCache`` for ``b_loc`` rows a rank."""
        with self.vc.bind():
            return self.model.cache_init(self.b_loc, self.s_max,
                                         sharded=self.sharded)

    def unlayout_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Stacked ``(R, b_loc, 1, V)`` -> the global ``(B, 1, V)``."""
        spec = next(iter(self.batch_spec.values()))
        return self.vc.unlayout(logits, spec)


def make_serve_steps(cfg: ModelConfig, topo: MeshTopology, mesh, *,
                     mode: str = "hier", global_batch: int, s_max: int,
                     unroll: int = 1, opts=(),
                     compute_dtype=torch.bfloat16) -> ServeStepBundle:
    """Prefill and decode on the production mesh (``mesh`` the stacked
    cluster of ``topo``): the model over ``make_ctx`` run once per memory
    domain (``transformer.ClusterModel``), prefill in the train layout,
    decode in the serve layout — the 2-D head-group x seq-group layout
    with the ``decode2d`` opt (``meta.decode2d_groups``).  A global batch
    the data-parallel ranks divide is split over them, else replicated."""
    del unroll
    vc = mesh
    model = build_model(cfg, topo, mode, compute_dtype, opts,
                        device=vc.device)
    ctx = model.ctx
    bspec = batch_specs(cfg, topo)
    dp = next(iter(bspec.values()))[0] if bspec else ()
    n_dp = math.prod(topo.size(a) for a in dp)
    shard = global_batch % n_dp == 0 and global_batch >= n_dp
    b_loc = global_batch // n_dp if shard else global_batch
    if not shard:
        bspec = {k: P() for k in bspec}
    fsdp = ctx.fsdp_axes[0] if ctx.fsdp_axes else None
    pspecs_serve = model.param_specs(serve=True, tp_axis=ctx.tp_axis,
                                     fsdp_axis=fsdp)
    pspecs_train = model.param_specs(tp_axis=ctx.tp_axis, fsdp_axis=fsdp)

    def prefill(params, batch):
        with vc.bind():
            return model.prefill_fn(params, batch, s_max, sharded=shard)

    def decode(params, cache, token, pos):
        pos = torch.as_tensor(pos, device=vc.device)
        if pos.dim() == 0:             # a shared position, every rank's
            pos = pos.expand(vc.num_devices)
        with vc.bind():
            return model.decode_fn(params, cache, token, pos, sharded=shard)

    return ServeStepBundle(prefill=prefill, decode=decode,
                           param_specs=pspecs_serve,
                           prefill_param_specs=pspecs_train,
                           batch_spec=bspec, model=model, s_max=s_max,
                           b_loc=b_loc, vc=vc, sharded=shard)
