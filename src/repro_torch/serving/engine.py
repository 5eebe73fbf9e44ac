"""Serving engine: batched prefill -> greedy (or sampled) decode loop.

The generation driver of the single-device engine: the prompts are
prefilled in one batch, then decoded a token per step at a shared position.
The continuous-batching scheduler (``serving.scheduler``) is the serving
path proper; this is its solo reference.  There is no jit to cache: the
reference's ``compiled_serve_fns`` has no counterpart, and ``model.prefill_fn``
/ ``model.decode_fn`` are called as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.comm import SharedWindow


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
    if params.dirty:
        raise ValueError(
            "refusing to serve from a dirty SharedWindow: a store "
            "opened an epoch that was never closed — fence() it first")
    if params.comm.chips != 1:
        raise ValueError(
            f"params contain a {params.comm.chips or 'unknown'}-way "
            "SharedWindow; the single-device engine reads only one-rank "
            "windows (the multi-card read is ROADMAP Queue 1 item 17)")
    return params.shard


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
