"""Serving engine: batched prefill -> greedy (or sampled) decode loop.

The generation driver of the single-device engine: the prompts are
prefilled in one batch, then decoded a token per step at a shared position.
The continuous-batching scheduler (``serving.scheduler``) is the serving
path proper; this is its solo reference.  ``materialize_params`` hands it
one-rank windows; ``materialize_params_on_mesh`` reads a multi-rank
window's node buffer on the cluster that owns it.  There is no jit to cache: the
reference's ``compiled_serve_fns`` has no counterpart, and ``model.prefill_fn``
/ ``model.decode_fn`` are called as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.comm import SharedWindow
from repro_torch.substrate.cluster import P


def materialize_params(params):
    """Unwrap ``repro_torch.comm.SharedWindow`` leaves into plain tensors.

    Hier-mode training state hands weights around as node-shared windows;
    the single-device engine needs full private copies.  A degenerate
    window (one rank per node — the shard IS the whole buffer) unwraps for
    free; a wider one (or one of unknown width) is refused, and an *open*
    store epoch is rejected outright rather than served stale (paper §6's
    integrity rule)."""
    if isinstance(params, dict):
        return {k: materialize_params(v) for k, v in params.items()}
    if not isinstance(params, SharedWindow):
        return params
    _check_clean(params)
    if params.comm.chips != 1:
        raise ValueError(
            f"params contain a {params.comm.chips or 'unknown'}-way "
            "SharedWindow; materialize it on the mesh "
            "(materialize_params_on_mesh) before handing state to the "
            "single-device engine")
    return params.shard


def _check_clean(window: SharedWindow) -> None:
    if window.dirty:
        raise ValueError(
            "refusing to serve from a dirty SharedWindow: a store "
            "opened an epoch that was never closed — fence() it first")


def materialize_params_on_mesh(params, cluster, *, scheme: str = "auto"):
    """The multi-rank companion of ``materialize_params``: read every
    node-window leaf back into a full private tensor by gathering its
    shards on the cluster that owns them.

    ``cluster`` is the ``repro_torch.substrate.VirtualCluster`` whose mesh
    matches each window's communicator; a leaf's ``shard`` is the GLOBAL
    rank-major stack of the per-rank window shards along ``leaf.axis`` (the
    layout ``VirtualCluster.smap`` hands a body under that spec).  The
    gather dispatches through the window's own communicator (``scheme``,
    ``"auto"`` by default: the tuning table or the closed forms pick),
    constrained to the replicated class so the engine receives plain
    tensors.  A multi-pod window is pod-replicated — every pod holds the
    same node copy — so it is read through the node tier
    (``split_type_shared``), never a bridge collective, and the NODE
    buffer comes back.  A one-rank window unwraps as it is; a dirty window
    is refused, and so is one whose communicator has no static
    ``pods`` / ``chips`` counts."""
    if isinstance(params, dict):
        return {k: materialize_params_on_mesh(v, cluster, scheme=scheme)
                for k, v in params.items()}
    if not isinstance(params, SharedWindow):
        return params
    _check_clean(params)
    comm, axis = params.comm, params.axis
    if comm.chips == 1:
        return params.shard
    if comm.pods is None or comm.chips is None:
        raise ValueError(
            "materialize_params_on_mesh needs windows with static "
            "pods/chips counts (construct their Communicator via "
            "from_cluster/from_topology)")
    node = comm.split_type_shared() if comm.slow_axis is not None else comm

    def body(shard):
        return node.allgather(shard, scheme=scheme, axis=axis,
                              result="replicated")

    spec = P(*((None,) * axis + (cluster.axis_names,)))
    return cluster.smap(body, in_specs=(spec,), out_specs=P())(params.shard)


@dataclasses.dataclass
class GenResult:
    tokens: np.ndarray      # (B, max_new)
    logprobs: np.ndarray    # (B, max_new)


def greedy_generate(model, params, prompts: np.ndarray, *, max_new: int,
                    s_max: Optional[int] = None, temperature: float = 0.0,
                    seed: int = 0) -> GenResult:
    """prompts: (B, T0) int32.  Single-device engine (ctx = single).
    ``params`` may carry ``SharedWindow`` leaves — they are materialized
    (or rejected, if unreadable here) up front.  ``temperature > 0``
    samples from a ``torch.Generator`` seeded with ``seed`` (not
    ``jax.random``'s draws)."""
    params = materialize_params(params)
    prompts = np.asarray(prompts, np.int32)
    B, T0 = prompts.shape
    s_max = s_max or (T0 + max_new)
    dev = model.device
    batch = {"tokens": torch.from_numpy(
        np.concatenate([prompts, prompts[:, -1:]], axis=1)).to(dev)}
    cache, logits = model.prefill_fn(params, batch, s_max)

    gen = torch.Generator(device=dev).manual_seed(seed)
    out_toks = np.zeros((B, max_new), np.int32)
    out_lp = np.zeros((B, max_new), np.float32)
    for i in range(max_new):
        lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        if temperature > 0:
            tok = torch.multinomial(torch.softmax(lp / temperature, dim=-1),
                                    1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(lp, dim=-1)
        out_toks[:, i] = tok.cpu().numpy()
        out_lp[:, i] = lp.gather(1, tok[:, None])[:, 0].cpu().numpy()
        cache, logits = model.decode_fn(params, cache,
                                        tok[:, None].to(torch.int32), T0 + i)
    return GenResult(tokens=out_toks, logprobs=out_lp)
