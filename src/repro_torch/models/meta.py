"""Parameter metadata: global shapes, TP/FSDP dims, init rules.

Every param leaf carries a ``PMeta``; the tree (``model_defs``) has the
reference's layout (``repro/models/meta.py``), so a parameter tree the
reference's ``init_params`` made maps leaf for leaf onto the port's
(``repro_torch.convert.params_from_reference``).  ``init_params`` draws the
tree on a device from an explicit ``torch.Generator`` with the reference's
init rules; it cannot reproduce ``jax.random``'s draws.

Sharding policy, as the reference's: ``tp_dim`` is the dim the tensor-
parallel axis shards, the same in naive and hier mode (head-parallel
attention shards the q / out heads and, when the kv heads divide by tp, the
kv heads; context-parallel attention replicates its weights; the ffn and
RG-LRU shard their hidden width, the embed and unembed their vocab);
``fsdp_dim`` (hier mode, ``data`` > 1) is the dim sharded over the node's
store ranks — the node's shared window — picked by ``_resolve_fsdp``;
``param_specs`` gives the port's ``P`` tree the cluster step lays the state
out with, and ``abstract_params`` the shapes on the ``meta`` device (no
memory).  Serve-time defs (``serve=True``) replicate the attention weights
over tp (decode computes every head on every tp rank and splits the cache
along T instead); the ``serve_fsdp`` opt keeps every serve weight in the
node store.  ``data_dim`` is the serve-only storage of the experts' d_ff
(``moe_defs``): the node's store ranks hold a slice each, and the node's
run reads the leaf as one buffer along it (``store_dim``).  Where the
reference's ``serve_fsdp`` defs give such a leaf an FSDP dim too, its
``param_specs`` maps the store axis to two dims (a spec JAX refuses); the
port stores the leaf along its ``data_dim`` alone.  The 2-D decode layout
(the ``decode2d`` opt, serve defs at tp > 1 on an arch with a
``decode2d_groups`` factorization) stores ``wq`` / ``wkv`` / ``wo`` by
head group, ``(tp, ...)`` with ``tp_dim`` 0; ``relayout_attn_decode2d`` /
``decode2d_params`` put baseline weights into it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.substrate.cluster import P


@dataclasses.dataclass
class PMeta:
    shape: tuple[int, ...]
    tp_dim: Optional[int] = None
    fsdp_dim: Optional[int] = None
    data_dim: Optional[int] = None
    init: str = "normal"           # normal | out | zeros | ones | lam
    dtype: torch.dtype = torch.float32


def store_dim(meta: PMeta) -> Optional[int]:
    """The dim a leaf is stored along over the node's store ranks: its
    ``data_dim`` (the serve layout's expert d_ff) if it has one, else its
    ``fsdp_dim``."""
    return meta.data_dim if meta.data_dim is not None else meta.fsdp_dim


def not_ported(what: str, item: int) -> NotImplementedError:
    """``item``: the ROADMAP Queue 1 item that ports ``what``."""
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 "
                               f"item {item}")


def _resolve_fsdp(meta: PMeta, data: int, mode: str, serve: bool,
                  force: bool = False) -> PMeta:
    """Pick the FSDP dim: the largest dim divisible by the data size,
    excluding tp / data dims.  Serve: only when requested upstream (the
    ``fsdp_dim == -2`` sentinel, or ``force``)."""
    if mode != "hier" or data <= 1:
        meta.fsdp_dim = None
        return meta
    if serve and not force and meta.fsdp_dim != -2:
        meta.fsdp_dim = None
        return meta
    best, best_size = None, 0
    for dim, s in enumerate(meta.shape):
        if dim == meta.tp_dim or dim == meta.data_dim:
            continue
        if s % data == 0 and s // data >= 1 and s > best_size:
            best, best_size = dim, s
    meta.fsdp_dim = best
    return meta


def attn_mode_for(cfg: ModelConfig, tp: int) -> str:
    return "head_tp" if cfg.n_heads % tp == 0 else "cp"


def decode2d_groups(cfg: ModelConfig, tp: int):
    """(g_h, g_s) factorization of the tp axis for 2-D decode attention:
    g_h head groups (dividing H and kv) x g_s seq groups; None where the
    arch cannot use it (g_h would be 1)."""
    g_h = math.gcd(math.gcd(cfg.n_heads, cfg.n_kv), tp)
    if g_h <= 1 or tp % g_h:
        return None
    return g_h, tp // g_h


# ---------------------------------------------------------------------------
# Per-block param/meta definitions
# ---------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig, tp: int, serve: bool,
              opts=frozenset()) -> dict[str, PMeta]:
    d, H, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    mode = attn_mode_for(cfg, tp)
    d2d = decode2d_groups(cfg, tp) if (serve and "decode2d" in opts) \
        else None
    if d2d:
        # 2-D decode: the weights sharded by head group, stored (tp, ...)
        # with tp rank r holding head group r // g_s (duplicated over the
        # group's g_s seq ranks; no per-step gather)
        g_h, _ = d2d
        out = {
            "ln": PMeta((d,), init="zeros"),
            "wq": PMeta((tp, d, H * hd // g_h), tp_dim=0),
            "wkv": PMeta((tp, d, 2, kv * hd // g_h), tp_dim=0),
            "wo": PMeta((tp, H * hd // g_h, d), tp_dim=0, init="out"),
        }
        if cfg.qk_norm:
            out["q_norm"] = PMeta((hd,), init="zeros")
            out["k_norm"] = PMeta((hd,), init="zeros")
        return out
    if serve:
        # decode: every tp rank computes all heads (the cache is T-sharded)
        q_tp = kv_tp = o_tp = None
    else:
        # head_tp shards the q / out heads and the kv heads when they
        # divide by tp (at tp = 1 too, so the FSDP dim avoids them as in
        # the reference); cp replicates every attention weight
        q_tp = 1 if mode == "head_tp" else None
        kv_tp = 2 if (mode == "head_tp" and kv % tp == 0) else None
        o_tp = 0 if mode == "head_tp" else None
    out = {
        "ln": PMeta((d,), init="zeros"),
        "wq": PMeta((d, H * hd), tp_dim=q_tp),
        "wkv": PMeta((d, 2, kv * hd), tp_dim=kv_tp),
        "wo": PMeta((H * hd, d), tp_dim=o_tp, init="out"),
    }
    if cfg.qk_norm:
        out["q_norm"] = PMeta((hd,), init="zeros")
        out["k_norm"] = PMeta((hd,), init="zeros")
    if serve and _attn_bytes(cfg) > 4e9:
        # big-attn serve: keep the one-copy-per-node store
        for k in ("wq", "wkv", "wo"):
            out[k].fsdp_dim = -2  # sentinel: resolve even in serve mode
    return out


def _attn_bytes(cfg: ModelConfig) -> float:
    d, H, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    per = d * (H + 2 * kv) * hd + H * hd * d
    n_attn = sum(1 for k in cfg.block_kinds if k in ("attn", "local"))
    return 2.0 * per * n_attn


def ffn_defs(cfg: ModelConfig, tp: int) -> dict[str, PMeta]:
    d, dff = cfg.d_model, cfg.d_ff
    g = 1 if cfg.act == "gelu" else 2
    return {
        "ln": PMeta((d,), init="zeros"),
        "w_in": PMeta((d, g, dff), tp_dim=2),
        "w_out": PMeta((dff, d), tp_dim=0, init="out"),
    }


def moe_defs(cfg: ModelConfig, tp: int, serve: bool) -> dict[str, PMeta]:
    """The experts stored ``(tp, E_loc, ...)`` with dim 0 over tp (one
    entry per rank: ``(ep, tp_ff) = MoESpec.ep_tp(tp)``); serve stores
    their d_ff over the node's store ranks (``data_dim``)."""
    d = cfg.d_model
    spec = cfg.moe
    ep, tp_ff = spec.ep_tp(tp)
    e_loc = spec.num_experts // ep
    n_ff = spec.d_ff_expert // tp_ff
    return {
        "ln": PMeta((d,), init="zeros"),
        "router": PMeta((d, spec.num_experts)),
        "w_in": PMeta((tp, e_loc, d, 2, n_ff), tp_dim=0,
                      data_dim=4 if serve else None),
        "w_out": PMeta((tp, e_loc, n_ff, d), tp_dim=0, init="out",
                       data_dim=2 if serve else None),
    }


def mlstm_defs(cfg: ModelConfig, tp: int) -> dict[str, PMeta]:
    """The inner width head-major and tp-sharded; the per-head q / k / v /
    gate weights replicated over tp (each rank slices its heads)."""
    d, din, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
    hd = din // nh
    return {
        "ln": PMeta((d,), init="zeros"),
        "w_up": PMeta((d, 2, din), tp_dim=2),
        "conv": PMeta((din, cfg.conv_kernel), tp_dim=0),
        "wq": PMeta((nh, hd, hd)),
        "wk": PMeta((nh, hd, hd)),
        "wv": PMeta((nh, hd, hd)),
        "wif": PMeta((nh, hd, 2)),
        "w_down": PMeta((din, d), tp_dim=0, init="out"),
    }


def slstm_defs(cfg: ModelConfig, tp: int) -> dict[str, PMeta]:
    """Every weight replicated over tp (the batch is split instead)."""
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    return {
        "ln": PMeta((d,), init="zeros"),
        "w_x": PMeta((d, 4, d)),
        "r": PMeta((nh, dh, 4, dh)),
        "b": PMeta((4, d), init="zeros"),
        "w_out": PMeta((d, d), init="out"),
    }


def rglru_defs(cfg: ModelConfig, tp: int) -> dict[str, PMeta]:
    d, dr = cfg.d_model, cfg.rnn_width
    return {
        "ln": PMeta((d,), init="zeros"),
        "w_x": PMeta((d, 2, dr), tp_dim=2),
        "conv": PMeta((dr, cfg.conv_kernel), tp_dim=0),
        "w_rg": PMeta((d, 2, dr), tp_dim=2),
        "lam": PMeta((dr,), tp_dim=0, init="lam"),
        "w_out": PMeta((dr, d), tp_dim=0, init="out"),
    }


def block_defs(kind: str, cfg: ModelConfig, tp: int, serve: bool,
               opts=frozenset()) -> dict:
    if kind in ("attn", "local", "rglru"):
        out = ({"rglru": rglru_defs(cfg, tp)} if kind == "rglru"
               else {"attn": attn_defs(cfg, tp, serve, opts)})
        if cfg.moe:
            out["moe"] = moe_defs(cfg, tp, serve)
        elif cfg.d_ff:
            out["ffn"] = ffn_defs(cfg, tp)
        return out
    if kind == "mlstm":
        return {"mlstm": mlstm_defs(cfg, tp)}
    if kind == "slstm":
        return {"slstm": slstm_defs(cfg, tp)}
    raise ValueError(kind)


def model_defs(cfg: ModelConfig, tp: int, data: int, mode: str,
               serve: bool = False, opts=frozenset()) -> dict:
    """Full meta tree.  'units' metas describe PER-LAYER shapes (they get a
    stacked leading dim at materialization)."""
    d = cfg.d_model
    defs: dict = {
        "embed": PMeta((cfg.vocab_padded, d), tp_dim=0),
        "final_ln": PMeta((d,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = PMeta((d, cfg.vocab_padded), tp_dim=1)
    if cfg.frontend:
        defs["frontend"] = PMeta((cfg.d_frontend, d))
    defs["units"] = {f"b{i}": block_defs(k, cfg, tp, serve, opts)
                     for i, k in enumerate(cfg.pattern)}
    if cfg.remainder_kinds:
        defs["rem"] = {f"r{i}": block_defs(k, cfg, tp, serve, opts)
                       for i, k in enumerate(cfg.remainder_kinds)}
    force = serve and "serve_fsdp" in opts
    return map_defs(lambda _p, m: _resolve_fsdp(m, data, mode, serve, force),
                    defs)


# ---------------------------------------------------------------------------
# Materialization
# ---------------------------------------------------------------------------

def _stacked_shape(meta: PMeta, stacked: Optional[int]) -> tuple[int, ...]:
    return ((stacked,) + meta.shape) if stacked else meta.shape


def map_defs(fn, defs: dict, path: tuple = ()) -> dict:
    """``fn(path, meta)`` over every ``PMeta`` leaf; same nesting."""
    if isinstance(defs, PMeta):
        return fn(path, defs)
    return {k: map_defs(fn, v, path + (k,)) for k, v in defs.items()}


def init_leaf(meta: PMeta, n_layers: int, stacked: Optional[int], *,
              generator: torch.Generator, device) -> torch.Tensor:
    shape = _stacked_shape(meta, stacked)
    if meta.init == "zeros":
        return torch.zeros(shape, dtype=meta.dtype, device=device)
    if meta.init == "ones":
        return torch.ones(shape, dtype=meta.dtype, device=device)
    if meta.init == "lam":
        # RG-LRU: target a in [0.9, 0.999] at r=1 -> softplus(lam) = -log(a)/C
        # (the reference's float64 numpy arithmetic, so bit-equal; no draw)
        a = np.linspace(0.9, 0.999, meta.shape[-1])
        lam = np.log(np.expm1(np.maximum(-np.log(a) / 8.0, 1e-8)))
        out = np.broadcast_to(lam, shape).astype(np.float32)
        return torch.from_numpy(out).to(device=device, dtype=meta.dtype)
    scale = 0.02
    if meta.init == "out":
        scale = 0.02 / math.sqrt(2.0 * max(n_layers, 1))
    return torch.randn(shape, generator=generator, dtype=meta.dtype,
                       device=device) * scale


def init_params(defs: dict, cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """Draw the parameter tree on ``device`` from ``generator`` (which
    must live on that device type): ``normal`` x0.02, ``out``
    x0.02/sqrt(2L), ``zeros``, ``ones``, ``lam`` (the RG-LRU decay
    parameter, deterministic); leaves under ``units`` stacked on a
    leading ``n_units`` dim."""
    def leaf(path, meta):
        stacked = cfg.n_units if path and path[0] == "units" else None
        return init_leaf(meta, cfg.n_layers, stacked, generator=generator,
                         device=device)
    return map_defs(leaf, defs)


def abstract_params(defs: dict, cfg: ModelConfig, specs: dict) -> dict:
    """The parameter tree's global shapes and dtypes as tensors on the
    ``meta`` device (no memory), with each leaf's ``P`` spec attached as
    ``.spec`` — the reference's ``ShapeDtypeStruct``s with shardings."""
    def mk(path, meta):
        stacked = cfg.n_units if path and path[0] == "units" else None
        t = torch.empty(_stacked_shape(meta, stacked), dtype=meta.dtype,
                        device="meta")
        spec = specs
        for k in path:
            spec = spec[k]
        t.spec = spec
        return t
    return map_defs(mk, defs)


def param_specs(defs: dict, cfg: ModelConfig, *, tp_axis: Optional[str],
                fsdp_axis: Optional[str]) -> dict:
    """The ``P`` tree of the parameters (stacked unit dims accounted
    for): ``tp_dim`` over ``tp_axis``, ``fsdp_dim`` / ``data_dim`` over
    ``fsdp_axis``, or ``data_dim`` alone where a leaf has one
    (``store_dim``)."""
    def mk(path, meta: PMeta):
        off = 1 if path and path[0] == "units" else 0
        spec = [None] * (len(meta.shape) + off)
        if meta.tp_dim is not None and tp_axis:
            spec[meta.tp_dim + off] = tp_axis
        if store_dim(meta) is not None and fsdp_axis:
            spec[store_dim(meta) + off] = fsdp_axis
        return P(*spec)
    return map_defs(mk, defs)


def relayout_attn_decode2d(w, cfg: ModelConfig, tp: int, kind: str):
    """A baseline attention weight re-laid out into the decode2d storage:
    entry r is tp rank r's head-group slice (head group ``r // g_s``,
    duplicated over the group's g_s seq ranks).  ``kind``: ``wq`` (d,
    H*hd) | ``wkv`` (d, 2, kv*hd) | ``wo`` (H*hd, d)."""
    g = decode2d_groups(cfg, tp)
    if not g:
        raise ValueError(f"{cfg.name} has no decode2d factorization at "
                         f"tp={tp}")
    g_h, g_s = g
    hd = cfg.head_dim
    out = []
    for r in range(tp):
        hg = r // g_s
        if kind == "wq":
            n = cfg.n_heads * hd // g_h
            out.append(w[:, hg * n:(hg + 1) * n])
        elif kind == "wkv":
            n = cfg.n_kv * hd // g_h
            out.append(w[:, :, hg * n:(hg + 1) * n])
        elif kind == "wo":
            n = cfg.n_heads * hd // g_h
            out.append(w[hg * n:(hg + 1) * n, :])
        else:
            raise ValueError(kind)
    return torch.stack(out)


def decode2d_params(params: dict, cfg: ModelConfig, tp: int) -> dict:
    """A baseline parameter tree (``init_params`` of the train or serve
    defs) as the decode2d serve layout's: every attention block's ``wq`` /
    ``wkv`` / ``wo`` re-laid out by ``relayout_attn_decode2d`` (each unit's
    slice of a unit-stacked leaf), every other leaf as it is."""
    def blocks(tree, stacked):
        out = {}
        for key, blk in tree.items():
            blk = dict(blk)
            if "attn" in blk:
                attn = dict(blk["attn"])
                for kind in ("wq", "wkv", "wo"):
                    w = attn[kind]
                    attn[kind] = (torch.stack([relayout_attn_decode2d(
                        u, cfg, tp, kind) for u in w]) if stacked
                        else relayout_attn_decode2d(w, cfg, tp, kind))
                blk["attn"] = attn
            out[key] = blk
        return out
    out = dict(params)
    out["units"] = blocks(params["units"], True)
    if "rem" in params:
        out["rem"] = blocks(params["rem"], False)
    return out
