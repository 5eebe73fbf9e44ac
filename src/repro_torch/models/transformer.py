"""Decoder assembly: the pattern units and the prefill / decode entry points.

The reference's ``repro/models/transformer.py`` for a dense model.  The
model is a stack of *pattern units* (``cfg.pattern`` repeated
``cfg.n_units`` times, plus an unrolled remainder); unit params are stacked
on a leading ``n_units`` dim, exactly the reference's parameter tree, and a
Python loop over units takes the place of ``lax.scan``.

Ported: the ``attn`` / ``local`` blocks (prefill and the 1D decode path),
the ``rglru`` block (``models/rglru.py``: prefill through the lru_scan
kernel, a one-step decode), the ``mlstm`` / ``slstm`` blocks
(``models/xlstm.py``: the chunkwise mLSTM, ``MLSTM_CHUNK`` tokens a chunk
or the ``mchunk=N`` opt, and the sLSTM time loop; each a one-step
decode), the dense ffn and the MoE channel mix
(``models/moe.py``: the train path on prefill and the loss, the serve path
on decode), the frontends (``_embed_sp``: tokens; ``vit`` patches in
place of the first ``n_prefix`` token embeddings, their labels masked;
``encodec`` frames with their own labels, and a frame as the decode
input), prefill with the cache
re-layout (ring slots for a window; recurrent state passed through),
decode with per-slot positions, and the training loss (``_loss``): the
unit walk with a per-unit remat (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``), the bounded prefetch of the units' window
reads (kept outside the remat region, as the reference keeps them) and the
streamed cross-entropy.  Training through the ``rglru`` block runs the
lru_scan kernel forward (twice a step under the remat) and its backward
kernel (``kernels.ops.LruScan``: ``csrc/lru_scan_bwd.cu``) on the card,
the plain scan's autograd on the CPU.

With a tp axis (``models.parallel``: the tp ranks stacked on a leading
axis) the training loss runs the reference's sequence-parallel layout: the
vocab-parallel embedding reduce-scatters into the (B, T/tp, d) residual
stream of each rank, every block gathers its tokens in and scatters them
out, attention picks ``head_tp`` or ``cp`` per arch
(``meta.attn_mode_for``), and the loss is the vocab-parallel
``unembed_xent``.  Serving at tp > 1: prefill runs that same layout and
writes each rank's S/tp chunk of the cache (``_state_to_cache``), decode
runs the serve defs (attention weights replicated over tp, every head on
every rank) with split-K attention over the T-sharded cache, the tp-sharded
ffn and the vocab-parallel embedding and logits; an ``rglru`` block's
recurrent state stays sharded over tp along its channels, an ``mlstm``
block's over its heads (and v-slices) and its conv channels, and an
``slstm`` block's is replicated.  With the ``decode2d`` opt at tp > 1
(``meta.decode2d_groups``) decode attention runs the 2-D layout instead
(``_decode_attn_2d``): g_h head groups x g_s seq groups, the attention
weights stored by head group and an S/g_s x kv/g_h cache a rank.

On a cluster ctx (one with a node communicator: ``runtime.steps.
cluster_ctx``) the entry points ``prefill_fn`` / ``decode_fn`` /
``cache_init`` take the cluster's stacked ``(R, ...)`` parameters and run
the model once per memory domain: ``build`` returns a ``ClusterModel``
there (``models.domains``); the functions here are one domain's run.

Decode updates the cache in place and returns the same cache tree:
attention blocks write each slot's new position
(``attention.cache_write``); a recurrent block's new state (``rglru``:
``h`` / ``conv``; ``mlstm``: ``C`` / ``n`` / ``m`` / ``conv``; ``slstm``:
``h`` / ``c`` / ``n`` / ``m``) is copied over its old one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as T
from repro_torch.models import meta as M
from repro_torch.models.attention import (_kv_head_map, attn_block,
                                          cache_write, decode_attention)
from repro_torch.models.domains import (Domains, NodeCache, domain_params,
                                        domain_range, domain_run,
                                        every_domain)
from repro_torch.models.layers import (decode_logits, embed, ffn, ffn_decode,
                                       residual, rms_norm, rope_decode,
                                       sinusoidal_pe, unembed_xent,
                                       unembed_xent_rows)
from repro_torch.models.moe import moe_block
from repro_torch.models.parallel import (ParallelCtx, ParamGroup,
                                         prefetch_walk)
from repro_torch.models.rglru import rglru_block, rglru_state_init
from repro_torch.models.xlstm import (mlstm_block, mlstm_state_init,
                                      slstm_block, slstm_state_init)
from repro_torch.substrate.collectives import keep_mesh

XENT_CHUNK = 512
MLSTM_CHUNK = 128


class Model(torch.nn.Module):
    """A dense decoder on one device.  Parameters are not held by the module:
    every entry point takes the parameter tree (``init_params``, or the
    reference's through ``convert.params_from_reference``) as the
    reference's does, so one model serves any set of weights."""

    def __init__(self, cfg: ModelConfig, ctx: ParallelCtx, defs: Any,
                 serve_defs: Any, device):
        super().__init__()
        self.cfg = cfg
        self.ctx = ctx
        self.defs = defs
        self.serve_defs = serve_defs
        self.device = torch.device(device)

    # ---- params ------------------------------------------------------------
    def init_params(self, seed: int = 0) -> dict:
        """The parameter tree drawn on ``self.device`` from a
        ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return M.init_params(self.defs, self.cfg, gen, self.device)

    def param_specs(self, *, serve: bool = False, tp_axis=None,
                    fsdp_axis="data") -> dict:
        defs = self.serve_defs if serve else self.defs
        return M.param_specs(defs, self.cfg, tp_axis=tp_axis,
                             fsdp_axis=fsdp_axis)

    def abstract_params(self, specs, *, serve: bool = False) -> dict:
        defs = self.serve_defs if serve else self.defs
        return M.abstract_params(defs, self.cfg, specs)

    # ---- entry points ------------------------------------------------------
    def loss_fn(self, params, batch):
        """(nll sum, token count) of ``batch["tokens"]`` (B, T+1)."""
        return _loss(self.cfg, self.ctx, self.defs, params, batch)

    def prefill_fn(self, params, batch, s_max: int, *, unroll: int = 1):
        """Prefill runs in the TRAIN parallel layout (``defs``)."""
        return _prefill(self.cfg, self.ctx, self.defs, params, batch, s_max)

    def decode_fn(self, params, cache, token, pos, *, unroll: int = 1):
        """Decode runs the serve layout (``serve_defs``)."""
        return _decode(self.cfg, self.ctx, self.serve_defs, params, cache,
                       token, pos)

    def cache_init(self, B_loc: int, s_max: int) -> dict:
        return _cache_init(self.cfg, self.ctx, B_loc, s_max, self.device)


class ClusterModel(Model):
    """The model on a cluster ctx (one with a node communicator:
    ``runtime.steps.cluster_ctx``; ``opts=("serve_fsdp",)`` keeps every
    serve weight in the node store, the paper's C1 layout applied to
    inference).  ``prefill_fn`` / ``decode_fn`` / ``cache_init`` take the
    cluster's stacked ``(R, ...)`` parameters (laid out under
    ``param_specs``: the train specs for prefill, the serve specs for
    decode) and the batch stacked per rank, and run the single-device model
    once per memory domain (``models.domains``).  By default the batch is
    replicated (the reference's ``P()`` token and position specs), so a
    domain takes its first member's rows; with ``sharded=True`` each
    data-parallel rank holds its own rows (the reference's ``P(dp)`` batch
    of ``make_serve_steps``) and a domain folds its store ranks' rows into
    one batch, as the train step does (``Domains.fold``).  Every batch leaf
    goes with the rows (``tokens``, ``patches``, ``frames`` / ``labels``).
    Logits come back stacked per rank; the decode cache is a
    ``NodeCache``, one per domain (holding a domain's folded rows when
    sharded)."""

    def prefill_fn(self, params, batch, s_max: int, *, unroll: int = 1,
                   sharded: bool = False):
        """``batch`` leaves stacked per rank (``tokens`` ``(R, B, T+1)``;
        ``patches`` ``(R, B, P, d_f)``; ``frames`` ``(R, B, T, d_f)`` and
        ``labels`` ``(R, B, T)``).  Returns the ``NodeCache`` and the
        stacked last-token logits ``(R, B, 1, V)``."""
        lay = Domains.of(self.ctx)
        leaves = {k: torch.as_tensor(v) for k, v in batch.items()}
        device = next(iter(leaves.values())).device
        # folded rows: the MoE block dispatches each member's apart
        fold = lay.store if sharded else 1
        run_ctx = dataclasses.replace(self.ctx, fold=fold) if sharded \
            else self.ctx
        cache, logits = None, []
        for d in domain_range(lay.count):
            dom = domain_params(self.ctx, lay, self.defs, params, d)
            rows = {k: lay.fold(v, d) if sharded else v[d * lay.members]
                    for k, v in leaves.items()}
            with domain_run(self.ctx, lay, d, device, fold):
                c, lg = _prefill(self.cfg, run_ctx, self.defs, dom, rows,
                                 s_max)
            if cache is None:
                cache = T.tree_map(lambda x: x.new_empty(
                    (lay.count,) + tuple(x.shape)), c)
            for dst, src in zip(T.leaves(cache), T.leaves(c)):
                dst[d].copy_(src)
            logits.append(lg)
            del c
        logits = every_domain(logits, lay.count)
        out = lay.unfold(logits) if sharded else lay.to_ranks(logits)
        return NodeCache(cache, lay), out

    def decode_fn(self, params, cache, token, pos, *, unroll: int = 1,
                  reads: Optional[list] = None, sharded: bool = False):
        """``token`` ``(R, B, 1)`` (``encodec``: a frame ``(R, B, 1,
        d_f)``) and ``pos`` ``(R,)`` / ``(R, B)``, replicated or, with
        ``sharded``, each rank's own rows; ``cache`` the ``NodeCache``
        (updated in place and returned).  ``reads``: per parameter leaf
        (``core.tree`` order) its node buffers from
        ``domains.node_window(...).read_node()``, or ``None`` — the
        recorded decoder's pre-read weights (``serving.recorded``), run with
        ``fsdp_axes=()``."""
        if not isinstance(cache, NodeCache):
            raise TypeError("decode on the cluster takes the NodeCache of "
                            "model.cache_init / model.prefill_fn")
        lay = Domains.of(self.ctx)
        # a replicated batch: the node's run stands for its store ranks'
        # copies of it; a sharded one: the node's rows are its token set
        run_ctx = dataclasses.replace(
            self.ctx, node_copies=1 if sharded else lay.store)
        if reads is not None:
            run_ctx = dataclasses.replace(run_ctx, fsdp_axes=())
        token, pos = torch.as_tensor(token), torch.as_tensor(pos)
        logits = []
        for d in domain_range(lay.count):
            dom = domain_params(self.ctx, lay, self.serve_defs, params, d,
                                reads)
            a = d * lay.members
            tok = lay.fold(token, d) if sharded else token[a]
            ps = lay.fold(pos, d) if sharded and pos.dim() > 1 else pos[a]
            with domain_run(self.ctx, lay, d, token.device,
                            lay.store if sharded else 1):
                _, lg = _decode(self.cfg, run_ctx, self.serve_defs, dom,
                                cache.domain(d), tok, ps)
            logits.append(lg)
        logits = every_domain(logits, lay.count)
        out = lay.unfold(logits) if sharded else lay.to_ranks(logits)
        return cache, out

    def cache_init(self, B_loc: int, s_max: int, *,
                   sharded: bool = False) -> NodeCache:
        """Empty decode caches (``_cache_init``'s), one per memory domain:
        ``B_loc`` rows, or with ``sharded`` the domain's store ranks'
        ``B_loc`` rows each."""
        lay = Domains.of(self.ctx)
        rows = B_loc * lay.store if sharded else B_loc
        one = _cache_init(self.cfg, self.ctx, rows, s_max, self.device)
        return NodeCache(T.tree_map(lambda x: x.expand(
            (lay.count,) + tuple(x.shape)).clone(), one), lay)


def build(cfg: ModelConfig, ctx: ParallelCtx, data: int = 1,
          device="cuda") -> Model:
    defs = M.model_defs(cfg, ctx.tp, data, ctx.mode, serve=False,
                        opts=ctx.opts)
    serve_defs = M.model_defs(cfg, ctx.tp, data, ctx.mode, serve=True,
                              opts=ctx.opts)
    cls = Model if ctx.comm is None else ClusterModel
    return cls(cfg, ctx, defs, serve_defs, device)


def _unit(tree: dict, u: int) -> dict:
    """Unit ``u``'s slice of a tree stacked on a leading ``n_units`` dim."""
    return {k: _unit(v, u) if isinstance(v, dict) else v[u]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _mix(kind: str, x, p, mt, ctx, cfg, *, serve=False):
    """Channel-mixing half of attn/local/rglru blocks: the MoE block
    (``models.moe``) or the dense ffn."""
    if cfg.moe:
        return moe_block(x, p["moe"], mt["moe"], ctx, cfg, serve=serve)
    if not cfg.d_ff:
        return x
    f = ffn_decode if serve else ffn
    return f(x, p["ffn"], mt["ffn"], ctx, act=cfg.act, eps=cfg.norm_eps,
             residual_scale=cfg.residual_scale)


def _mlstm_chunk(ctx) -> int:
    """The mLSTM chunk: ``MLSTM_CHUNK``, or the ``mchunk=N`` opt."""
    chunk = MLSTM_CHUNK
    for o in ctx.opts:
        if o.startswith("mchunk="):
            chunk = int(o[len("mchunk="):])
    return chunk


def _block_train(kind: str, x, p, mt, ctx, cfg, *, return_state=False):
    if kind == "mlstm":
        return mlstm_block(x, p["mlstm"], mt["mlstm"], ctx, cfg,
                           chunk=_mlstm_chunk(ctx),
                           return_state=return_state)
    if kind == "slstm":
        return slstm_block(x, p["slstm"], mt["slstm"], ctx, cfg,
                           return_state=return_state)
    if kind == "rglru":
        out = rglru_block(x, p["rglru"], mt["rglru"], ctx, cfg,
                          return_state=return_state)
        if return_state:
            x, st = out
            return _mix(kind, x, p, mt, ctx, cfg), st
        return _mix(kind, out, p, mt, ctx, cfg)
    if kind not in ("attn", "local"):
        raise ValueError(kind)
    window = cfg.window if kind == "local" else None
    mode = M.attn_mode_for(cfg, ctx.tp)
    out = attn_block(x, p["attn"], mt["attn"], ctx, cfg, mode=mode,
                     window=window, return_kv=return_state)
    if return_state:
        x, (k, v) = out
        return _mix(kind, x, p, mt, ctx, cfg), {"k": k, "v": v}
    return _mix(kind, out, p, mt, ctx, cfg)


def _decode2d(cfg, ctx):
    """The (g_h, g_s) factorization of the tp axis when decode runs the 2-D
    layout (the ``decode2d`` opt at tp > 1 on an arch that has one)."""
    if not (ctx.has("decode2d") and ctx.tp_axis):
        return None
    return M.decode2d_groups(cfg, ctx.tp)


def _decode_attn_2d(x, p, mt, state, ctx, cfg, *, pos, window):
    """2-D decode attention: the tp axis factored into g_h head groups x
    g_s seq groups (tp rank r: head group ``r // g_s``, seq index ``r %
    g_s``).  The attention weights are stored by head group (``meta.
    attn_defs``' decode2d branch: no per-step gather), each rank holds an
    S/g_s chunk of its head group's kv heads, and the partial softmax
    merges within the g_s ranks of the head group (``group_all_gather`` of
    the maxima, ``group_psum`` of the sums); the out projection of each
    head group's seq index 0 is summed over tp.  ``pos`` must be a scalar
    shared by the batch."""
    pos = torch.as_tensor(pos)
    if pos.dim() != 0:
        raise ValueError("decode2d decode attention needs a scalar pos; "
                         "per-slot position vectors (continuous batching) "
                         "are only supported on the 1D decode path")
    g_h, g_s = M.decode2d_groups(cfg, ctx.tp)
    H, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    Hg, kvg = H // g_h, kv // g_h
    pa, ma = p["attn"], mt["attn"]
    lead = tuple(x.shape[:-2])                  # (tp, B)
    h = rms_norm(x, ctx.at(ctx.gather_w(pa["ln"], ma["ln"].fsdp_dim),
                           x.dim()), cfg.norm_eps)
    # each rank's head-group slot of the stored (tp, 1, ...) weights
    wq = ctx.gather_w(pa["wq"], ma["wq"].fsdp_dim)[:, 0]     # (tp, d, ..)
    wkv = ctx.gather_w(pa["wkv"], ma["wkv"].fsdp_dim)[:, 0]
    wo = ctx.gather_w(pa["wo"], ma["wo"].fsdp_dim)[:, 0]
    q = ctx.mm(h, wq).reshape(lead + (1, Hg, hd))
    kvp = ctx.mm(h, wkv.flatten(-2)).reshape(lead + (1, 2, kvg, hd))
    k_new, v_new = kvp[..., 0, :, :], kvp[..., 1, :, :]
    if cfg.qk_norm:
        q = rms_norm(q, ctx.at(ctx.gather_w(
            pa["q_norm"], ma["q_norm"].fsdp_dim), q.dim()), cfg.norm_eps)
        k_new = rms_norm(k_new, ctx.at(ctx.gather_w(
            pa["k_norm"], ma["k_norm"].fsdp_dim), k_new.dim()),
            cfg.norm_eps)
    if cfg.pos == "rope":
        rdt = ctx.compute_dtype if ctx.has("bf16_rope") else None
        q = rope_decode(q, pos, cfg.rope_theta, rdt)
        k_new = rope_decode(k_new, pos, cfg.rope_theta, rdt)

    # the cache write: the slot's owner among the head group's seq ranks
    kc, vc = state["k"], state["v"]             # (tp, B, S/g_s, kvg, hd)
    S_loc = kc.shape[-3]
    dev = kc.device
    pos = pos.to(dev)
    gpos = pos % window if window is not None else pos
    s_idx = ctx.tp_rank % g_s                   # (tp,)
    owner = gpos // S_loc
    local = gpos - owner * S_loc
    hit = (torch.arange(S_loc, device=dev) == local)[None, :] \
        & (s_idx == owner)[:, None]             # (tp, S/g_s)
    hit = hit[:, None, :, None, None]
    kc = torch.where(hit, k_new.to(kc.dtype), kc)
    vc = torch.where(hit, v_new.to(vc.dtype), vc)

    # partial attention over the rank's S/g_s chunk
    slot = (s_idx * S_loc)[:, None] + torch.arange(S_loc, device=dev)
    if window is not None:
        gidx = pos - ((pos - slot) % window)
        valid = (gidx >= 0) & (gidx <= pos) & (pos - gidx < window)
    else:
        valid = slot <= pos                     # (tp, S/g_s)
    kvmap = _kv_head_map(Hg, 0, Hg, kvg, device=dev)
    kq = kc.index_select(-2, kvmap).float()     # (tp, B, S/g_s, Hg, hd)
    vq = vc.index_select(-2, kvmap).float()
    qs = q.float() / math.sqrt(hd) if cfg.attn_scale is None \
        else q.float() * cfg.attn_scale
    sc = torch.einsum("rbqhd,rbkhd->rbhqk", qs, kq)
    sc = torch.where(valid[:, None, None, None, :], sc,
                     torch.full((), -1e30, device=dev))
    m_loc = sc.amax(dim=-1)                     # (tp, B, Hg, 1)
    mg = ctx.group_all_gather(m_loc.unsqueeze(1), group=g_s, dim=0)
    m_all = mg.amax(dim=1)
    pexp = torch.exp(sc - m_all[..., None])
    den = ctx.group_psum(pexp.sum(dim=-1), group=g_s)
    o = ctx.group_psum(torch.einsum("rbhqk,rbkhd->rbhqd", pexp, vq),
                       group=g_s)
    o = (o / den[..., None].clamp_min(1e-30)).transpose(2, 3)  # (tp,B,1,Hg,hd)
    y = ctx.mm(o.reshape(lead + (1, Hg * hd)).to(ctx.compute_dtype), wo)
    # every head group's seq index 0 contributes its heads' projection
    y = torch.where((s_idx == 0)[:, None, None, None], y,
                    torch.zeros((), dtype=y.dtype, device=dev))
    return residual(x, ctx.psum_tp(y), cfg.residual_scale), \
        {"k": kc, "v": vc}


def _block_decode(kind: str, x, p, mt, state, ctx, cfg, *, pos):
    if kind in ("mlstm", "slstm"):
        fn = mlstm_block if kind == "mlstm" else slstm_block
        return fn(x, p[kind], mt[kind], ctx, cfg, state=state, decode=True)
    if kind == "rglru":
        x, st = rglru_block(x, p["rglru"], mt["rglru"], ctx, cfg,
                            state=state, decode=True)
        return _mix(kind, x, p, mt, ctx, cfg, serve=True), st
    if kind not in ("attn", "local"):
        raise ValueError(kind)
    window = cfg.window if kind == "local" else None
    if _decode2d(cfg, ctx):
        x, st = _decode_attn_2d(x, p, mt, state, ctx, cfg, pos=pos,
                                window=window)
        return _mix(kind, x, p, mt, ctx, cfg, serve=True), st
    H, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    pa, ma = p["attn"], mt["attn"]
    h = rms_norm(x, ctx.at(ctx.gather_w(pa["ln"], ma["ln"].fsdp_dim),
                           x.dim()), cfg.norm_eps)
    wq = ctx.gather_w(pa["wq"], ma["wq"].fsdp_dim)
    wkv = ctx.gather_w(pa["wkv"], ma["wkv"].fsdp_dim)
    wo = ctx.gather_w(pa["wo"], ma["wo"].fsdp_dim)
    lead = tuple(x.shape[:-2])                  # (B,) / (tp, B) stacked
    q = ctx.mm(h, wq).reshape(lead + (1, H, hd))
    kvp = ctx.mm(h, wkv.flatten(-2)).reshape(lead + (1, 2, kv, hd))
    k_new, v_new = kvp[..., 0, :, :], kvp[..., 1, :, :]
    if cfg.qk_norm:
        q = rms_norm(q, ctx.at(ctx.gather_w(
            pa["q_norm"], ma["q_norm"].fsdp_dim), q.dim()), cfg.norm_eps)
        k_new = rms_norm(k_new, ctx.at(ctx.gather_w(
            pa["k_norm"], ma["k_norm"].fsdp_dim), k_new.dim()),
            cfg.norm_eps)
    if cfg.pos == "rope":
        rdt = ctx.compute_dtype if ctx.has("bf16_rope") else None
        q = rope_decode(q, pos, cfg.rope_theta, rdt)
        k_new = rope_decode(k_new, pos, cfg.rope_theta, rdt)
    kc = cache_write(state["k"], k_new, ctx, pos=pos, window=window)
    vc = cache_write(state["v"], v_new, ctx, pos=pos, window=window)
    o = decode_attention(q, kc, vc, ctx, pos=pos, H=H, window=window,
                         ring=window is not None, scale=cfg.attn_scale)
    # q / kv / o are replicated over tp (split-K merged them), so the
    # output projection is the same on every tp rank: no collective
    x = residual(x, ctx.mm(o.reshape(lead + (1, H * hd)), wo),
                 cfg.residual_scale)
    x = _mix(kind, x, p, mt, ctx, cfg, serve=True)
    return x, {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# Embedding glue
# ---------------------------------------------------------------------------

def _stack_tp(x: torch.Tensor, ctx, nd: int) -> torch.Tensor:
    """A batch leaf of ``nd`` dims as every stacked tp rank's copy (no copy
    without a tp axis, or when it is stacked already)."""
    if ctx.tp_axis and x.dim() == nd:
        return x.expand((ctx.tp,) + tuple(x.shape))
    return x


def _embed_sp(cfg, ctx, defs, params, batch, *, T: int):
    """The sequence-parallel input embedding (B, T/tp, d) plus the FULL
    (labels, mask) of shape (B, T); stacked per tp rank with a tp axis
    (the rows are every rank's).  The token frontend looks the ids up in
    the vocab-parallel embedding; ``encodec`` projects each rank's T/tp
    slice of ``batch["frames"]`` (B, T, d_f) through ``w_fe`` and takes
    ``batch["labels"]`` (B, T) with a mask of ones; ``vit`` projects
    ``batch["patches"]`` (B, P, d_f) and puts patch ``t`` in place of the
    token embedding at every global position ``t < n_prefix`` (each tp
    rank its own chunk's positions), and masks the loss of the labels a
    patch predicts (``t + 1 < n_prefix``)."""
    tp = bool(ctx.tp_axis)
    if cfg.frontend == "encodec":
        w_fe = ctx.gather_w(params["frontend"], defs["frontend"].fsdp_dim)
        dev = w_fe.device
        frames = _stack_tp(torch.as_tensor(batch["frames"], device=dev),
                           ctx, 3)                  # ([tp,] B, T, d_f)
        if tp:
            T_loc = ctx.shard(T)
            frames = torch.stack([frames[i].narrow(1, r * T_loc, T_loc)
                                  for i, r in enumerate(ctx.tp_ranks())])
        x = ctx.mm(frames.to(ctx.compute_dtype), w_fe)
        labels = _stack_tp(torch.as_tensor(batch["labels"], device=dev),
                           ctx, 2)
        mask = torch.ones(labels.shape, dtype=torch.float32, device=dev)
    else:
        emb = ctx.gather_w(params["embed"], defs["embed"].fsdp_dim)
        dev = emb.device
        tokens = _stack_tp(torch.as_tensor(batch["tokens"], device=dev),
                           ctx, 2)                  # ([tp,] B, T+1)
        ids = tokens[..., :T]
        labels = tokens[..., 1:T + 1]
        x = embed(ids, emb, ctx, sp=tp)
        mask = torch.ones(labels.shape, dtype=torch.float32, device=dev)
        if cfg.frontend == "vit":
            w_fe = ctx.gather_w(params["frontend"],
                                defs["frontend"].fsdp_dim)
            patches = _stack_tp(torch.as_tensor(batch["patches"],
                                                device=dev), ctx, 3)
            pe = ctx.mm(patches.to(ctx.compute_dtype), w_fe)  # (.., B, P, d)
            P_ = cfg.n_prefix
            T_loc = x.shape[-2]
            pos = torch.arange(T_loc, device=dev)
            if tp:                                          # (tp, T/tp)
                pos = pos + (ctx.tp_rank * T_loc)[:, None]
            idx = pos.clamp(0, P_ - 1)
            if tp:
                pex = torch.take_along_dim(pe, idx[:, None, :, None],
                                           dim=2)
            else:
                pex = pe.index_select(1, idx)
            is_patch = (pos < P_)[..., None, :, None]
            x = torch.where(is_patch, pex, x)
            mask = mask * ((torch.arange(T, device=dev) + 1) >= P_)
    if cfg.input_scale != 1.0:  # gemma's sqrt(d) when tied; granite's 12
        x = x * torch.tensor(cfg.input_scale, dtype=x.dtype)
    if cfg.pos == "sinusoidal":
        T_loc = x.shape[-2]
        pos = torch.arange(T_loc, device=dev)
        if tp:                                         # (R, T/tp)
            pos = pos + (ctx.tp_rank * T_loc)[:, None]
        pe = sinusoidal_pe(pos, cfg.d_model).to(x.dtype)
        x = x + ctx.at(pe, x.dim())
    return x, labels, mask


def _seq_len(cfg, batch) -> int:
    """The sequence length T of a batch: the frames' for ``encodec``,
    else the tokens' less the last label column."""
    if cfg.frontend == "encodec":
        return torch.as_tensor(batch["frames"]).shape[-2]
    return torch.as_tensor(batch["tokens"]).shape[-1] - 1


def _unembed_weight(cfg, ctx, defs, params):
    if cfg.tie_embeddings:
        w = ctx.gather_w(params["embed"], defs["embed"].fsdp_dim)
        return w.transpose(-1, -2)                     # (d, V/tp)
    return ctx.gather_w(params["unembed"], defs["unembed"].fsdp_dim)


# ---------------------------------------------------------------------------
# Train loss
# ---------------------------------------------------------------------------

def _remat(fn, ctx):
    """``fn`` rematerialised in the backward (the reference's
    ``jax.checkpoint``) when gradients are being recorded; the recompute
    runs under the mesh and traffic record bound here (its tp collectives,
    its window reads)."""
    def run(*args):
        if torch.is_grad_enabled():
            return checkpoint(keep_mesh(fn), *args, use_reentrant=False)
        return fn(*args)
    return run


def _scan_units(cfg, ctx, defs, params, x):
    """The unit stack for training: each unit rematerialised.  With the
    ``prefetch`` opt the units' window reads go through ``ParamGroup``s
    (unit k+1's issued while unit k computes, at most ``ctx.prefetch``
    unsharded at once) and stay OUTSIDE the remat region, so the backward's
    recompute reuses the read instead of reading again."""
    kinds = cfg.pattern

    def unit(c, pu, uctx):
        for i, k in enumerate(kinds):
            key = f"b{i}"
            c = _block_train(k, c, pu[key], defs["units"][key], uctx, cfg)
        return c

    budget = ctx.prefetch
    if budget > 0:
        inner = dataclasses.replace(ctx, fsdp_axes=())
        unit_f = _remat(lambda c, full: unit(c, full, inner), ctx)
        groups = [ParamGroup(ctx, _unit(params["units"], u), defs["units"])
                  for u in range(cfg.n_units)]
        return prefetch_walk(groups, lambda c, _k, full: unit_f(c, full), x,
                             budget)
    unit_r = _remat(lambda c, pu: unit(c, pu, ctx), ctx)
    for u in range(cfg.n_units):
        x = unit_r(x, _unit(params["units"], u))
    return x


def _loss(cfg, ctx, defs, params, batch, *, rows: bool = False):
    """(nll sum, token count) — local partials the caller reduces (per
    stacked rank with a tp axis); with ``rows`` the (..., B) per-row
    partials."""
    T = _seq_len(cfg, batch)
    x, labels, mask = _embed_sp(cfg, ctx, defs, params, batch, T=T)
    x = _scan_units(cfg, ctx, defs, params, x)
    for i, k in enumerate(cfg.remainder_kinds):
        key = f"r{i}"
        x = _block_train(k, x, params["rem"][key], defs["rem"][key], ctx,
                         cfg)
    x = rms_norm(x, ctx.at(ctx.gather_w(params["final_ln"],
                                        defs["final_ln"].fsdp_dim), x.dim()),
                 cfg.norm_eps)
    w_un = _unembed_weight(cfg, ctx, defs, params)
    xent = unembed_xent_rows if rows else unembed_xent
    return xent(x, labels, mask, w_un, ctx, chunk=XENT_CHUNK,
                softcap=cfg.logit_softcap, logit_scale=cfg.logit_scale,
                vocab=cfg.softmax_vocab)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def _state_to_cache(cfg, ctx, st, T: int, s_max: int, kind: str,
                    tdim: int = 1):
    """Re-layout prefill (k, v) into the decode cache layout: padded to
    ``s_max`` along the time axis ``tdim`` — or, for a window, the ring of
    the last ``W = min(window, s_max)`` positions, slot s holding position
    g = T-W + ((s - (T-W)) mod W), zero-filled where g < 0 (those slots are
    masked out of decode attention, but must not hold NaN).  With a tp axis
    (the stacked ranks' axis just before the batch, ``tdim - 2``) every
    rank's full-T state is cut to its own S/tp chunk of that layout."""
    if kind not in ("attn", "local"):
        return st
    if ctx.tp_axis:
        rdim = tdim - 2
        full = _state_to_cache(cfg, dataclasses.replace(
            ctx, tp_axis=None, tp=1), st, T, s_max, kind, tdim)
        S_loc = ctx.shard(full["k"].shape[tdim])
        return {n: torch.stack([
            a.select(rdim, i).narrow(tdim - 1, r * S_loc, S_loc)
            for i, r in enumerate(ctx.tp_ranks())], dim=rdim)
            for n, a in full.items()}
    window = cfg.window if kind == "local" else None
    if window is None and T > s_max:
        raise ValueError(f"a {T}-token prefill does not fit a cache of "
                         f"s_max={s_max}")

    def relayout(a):
        if window is not None:
            W = min(window, s_max)
            s = torch.arange(W, device=a.device)
            g = T - W + ((s - (T - W)) % W)
            full = a.index_select(tdim, g.clamp_min(0))
            shape = [1] * full.dim()
            shape[tdim] = W
            return torch.where((g >= 0).reshape(shape), full,
                               torch.zeros((), dtype=a.dtype,
                                           device=a.device))
        shape = list(a.shape)
        shape[tdim] = s_max
        full = a.new_zeros(shape)
        full.narrow(tdim, 0, T).copy_(a)
        return full

    return {"k": relayout(st["k"]), "v": relayout(st["v"])}


def _cache_init(cfg, ctx, B_loc: int, s_max: int, device) -> dict:
    """Empty caches (zeros; an xLSTM stabilizer ``m`` at -1e30); every
    leaf its own tensor (decode writes in place).  With a tp axis every
    leaf has the stacked tp ranks' axis after the unit dim: an attention
    leaf each rank's S/tp chunk (tp, B, S/tp, kv, hd), an ``rglru`` leaf
    its channel shard, an ``mlstm`` leaf its heads' (and v-slice's) state
    and conv channel shard, an ``slstm`` leaf a replica."""
    tp = (ctx.tp,) if ctx.tp_axis else ()
    d2d = _decode2d(cfg, ctx)
    recurrent = {
        "rglru": lambda: rglru_state_init(cfg, B_loc, ctx, ctx.compute_dtype,
                                          device),
        "mlstm": lambda: mlstm_state_init(cfg, B_loc, ctx, ctx.compute_dtype,
                                          device),
        "slstm": lambda: slstm_state_init(cfg, B_loc, device)}

    def one(kind, lead=()):
        if kind in recurrent:
            return {n: a.expand(lead + tp + tuple(a.shape)).clone()
                    for n, a in recurrent[kind]().items()}
        if kind not in ("attn", "local"):
            raise ValueError(kind)
        window = cfg.window if kind == "local" else None
        S = min(window, s_max) if window else s_max
        if d2d:                       # the head group's kv, S/g_s slots
            g_h, g_s = d2d
            shape = lead + tp + (B_loc, S // g_s, cfg.n_kv // g_h,
                                 cfg.head_dim)
        else:
            shape = lead + tp + (B_loc, ctx.shard(S), cfg.n_kv,
                                 cfg.head_dim)
        return {n: torch.zeros(shape, dtype=ctx.compute_dtype, device=device)
                for n in ("k", "v")}

    out = {"units": {f"b{i}": one(k, (cfg.n_units,))
                     for i, k in enumerate(cfg.pattern)}}
    if cfg.remainder_kinds:
        out["rem"] = {f"r{i}": one(k)
                      for i, k in enumerate(cfg.remainder_kinds)}
    return out


def _prefill(cfg, ctx, defs, params, batch, s_max: int):
    """Run the prompt (``batch["tokens"]`` (B, T+1); the last column is
    the label of token T-1), return (cache, last-token logits (B, 1, V))."""
    T = _seq_len(cfg, batch)
    x, _, _ = _embed_sp(cfg, ctx, defs, params, batch, T=T)
    states = {f"b{i}": [] for i in range(len(cfg.pattern))}
    for u in range(cfg.n_units):
        pu = _unit(params["units"], u)
        for i, k in enumerate(cfg.pattern):
            key = f"b{i}"
            x, st = _block_train(k, x, pu[key], defs["units"][key], ctx,
                                 cfg, return_state=True)
            states[key].append(st)
    rem_states = {}
    for i, k in enumerate(cfg.remainder_kinds):
        key = f"r{i}"
        x, rem_states[key] = _block_train(k, x, params["rem"][key],
                                          defs["rem"][key], ctx, cfg,
                                          return_state=True)
    x = rms_norm(x, ctx.at(ctx.gather_w(params["final_ln"],
                                        defs["final_ln"].fsdp_dim), x.dim()),
                 cfg.norm_eps)
    # the last token lives on the last tp rank's chunk: gather it first
    last = ctx.ag_tokens(x)[..., -1:, :] if ctx.tp_axis else x[:, -1:]
    w_un = _unembed_weight(cfg, ctx, defs, params)
    logits = decode_logits(last, w_un, ctx, softcap=cfg.logit_softcap,
                           logit_scale=cfg.logit_scale,
                           vocab=cfg.softmax_vocab)

    tdim = 3 if ctx.tp_axis else 2          # (U, [tp,] B, T, ...)
    cache = {"units": {}}
    for i, k in enumerate(cfg.pattern):
        key = f"b{i}"
        stacked = {n: torch.stack([st[n] for st in states[key]])
                   for n in states[key][0]}
        cache["units"][key] = _state_to_cache(cfg, ctx, stacked, T, s_max,
                                              k, tdim=tdim)
    if cfg.remainder_kinds:
        cache["rem"] = {key: _state_to_cache(cfg, ctx, rem_states[key], T,
                                             s_max, k, tdim=tdim - 1)
                        for key, k in zip(rem_states, cfg.remainder_kinds)}
    return cache, logits


def _store_state(state: dict, new: dict) -> None:
    """Copy a block's new decode state over its cache leaves in place (a
    leaf the block already wrote in place, as ``cache_write`` does, is the
    same tensor and is skipped)."""
    for n, t in new.items():
        if t is not state[n]:
            state[n].copy_(t)


def _decode(cfg, ctx, defs, params, cache, token, pos):
    """One decode step.  token: (B, 1) int, or a (B, 1, d_f) frame for
    ``encodec``; pos: current position — a scalar shared by the batch, or
    a (B,) vector of per-slot positions.
    Returns (cache, logits (B, 1, V)); the cache is updated in place."""
    if cfg.frontend == "encodec":             # token: a (B, 1, d_f) frame
        w_fe = ctx.gather_w(params["frontend"], defs["frontend"].fsdp_dim)
        dev = w_fe.device
        token = _stack_tp(torch.as_tensor(token, device=dev), ctx, 3)
        x = ctx.mm(token.to(ctx.compute_dtype), w_fe)
    else:
        emb = ctx.gather_w(params["embed"], defs["embed"].fsdp_dim)
        dev = emb.device
        token = _stack_tp(torch.as_tensor(token, device=dev), ctx, 2)
        x = embed(token, emb, ctx)
    pos = torch.as_tensor(pos, device=dev)
    if cfg.input_scale != 1.0:
        x = x * torch.tensor(cfg.input_scale, dtype=x.dtype)
    if cfg.pos == "sinusoidal":
        if pos.dim() == 1:               # per-slot positions: (B, 1, d)
            x = x + sinusoidal_pe(pos, cfg.d_model)[:, None].to(x.dtype)
        else:
            x = x + sinusoidal_pe(pos[None], cfg.d_model)[None].to(x.dtype)

    for u in range(cfg.n_units):
        pu = _unit(params["units"], u)
        for i, k in enumerate(cfg.pattern):
            key = f"b{i}"
            state = _unit(cache["units"][key], u)   # views of the pages
            x, new = _block_decode(k, x, pu[key], defs["units"][key], state,
                                   ctx, cfg, pos=pos)
            _store_state(state, new)
    for i, k in enumerate(cfg.remainder_kinds):
        key = f"r{i}"
        state = cache["rem"][key]
        x, new = _block_decode(k, x, params["rem"][key], defs["rem"][key],
                               state, ctx, cfg, pos=pos)
        _store_state(state, new)
    x = rms_norm(x, ctx.at(ctx.gather_w(params["final_ln"],
                                        defs["final_ln"].fsdp_dim), x.dim()),
                 cfg.norm_eps)
    w_un = _unembed_weight(cfg, ctx, defs, params)
    return cache, decode_logits(x, w_un, ctx, softcap=cfg.logit_softcap,
                                logit_scale=cfg.logit_scale,
                                vocab=cfg.softmax_vocab)
