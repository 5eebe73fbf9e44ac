"""AdamW on parameter shards.

The reference's ``repro/optim/adamw.py`` on tensor trees (nested dicts).  In
hier mode the optimizer state inherits the paper's one-copy-per-node layout:
m / v are allocated exactly like the FSDP parameter shards, and the update
runs on the shard.  The update is out of place, as the reference's is (the
caller drops the old tree), with the reference's f32 order of operations.
``step`` may be a scalar or, inside a cluster step, a stacked per-rank
``(R,)`` tensor; ``lr`` a number or such a tensor.  A per-rank value
broadcasts over each leaf's leading rank axis.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.tree import leaves, tree_map


def per_rank(s, leaf: torch.Tensor):
    """A scalar, or a stacked ``(R,)`` tensor viewed to broadcast over
    ``leaf``'s leading rank axis."""
    if isinstance(s, torch.Tensor) and s.dim() == 1:
        return s.reshape((-1,) + (1,) * (leaf.dim() - 1))
    return s


def adamw_init(params):
    """Zero f32 first and second moments shaped like ``params``."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return tree_map(zeros, params), tree_map(zeros, params)


def adamw_update(params, grads, m, v, step, *, lr, weight_decay=0.1,
                 b1=0.9, b2=0.95, eps=1e-8):
    """One AdamW step: ``(new_params, new_m, new_v)``, every leaf a new
    tensor.  ``step`` counts from 1 (bias corrections ``1 - b ** step``)."""
    stepf = torch.as_tensor(step, dtype=torch.float32,
                            device=leaves(params)[0].device)
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf

    def upd(p, g, m_, v_):
        return _leaf_update(p, g, m_, v_, c1, c2, lr, weight_decay, b1, b2,
                            eps)

    out = tree_map(upd, params, grads, m, v)
    return _pick_tree(out, 0), _pick_tree(out, 1), _pick_tree(out, 2)


def _leaf_update(p, g, m_, v_, c1, c2, lr, weight_decay, b1, b2, eps):
    g32 = g.float()
    m_n = b1 * m_ + (1.0 - b1) * g32
    v_n = b2 * v_ + (1.0 - b2) * g32 * g32
    mhat = m_n / per_rank(c1, m_n)
    vhat = v_n / per_rank(c2, v_n)
    p32 = p.float()
    p_n = p32 - per_rank(lr, p32) * (mhat / (torch.sqrt(vhat) + eps)
                                     + weight_decay * p32)
    return p_n.to(p.dtype), m_n, v_n


def adamw_update_(params, grads, m, v, step, *, lr, weight_decay=0.1,
                  b1=0.9, b2=0.95, eps=1e-8) -> None:
    """``adamw_update`` for a caller that donates its state (the
    reference's train loop donates it to ``jit``): the same f32 arithmetic,
    computed out of place one rank slice of one stacked ``(R, ...)`` leaf at
    a time and stored over the old values, so the update needs room for one
    slice's temporaries instead of a second state.  ``step`` is the stacked
    ``(R,)`` step count.  ``grads`` may be a list of leaves (in
    ``core.tree.leaves`` order), which the update consumes: each entry is
    released once used."""
    stepf = torch.as_tensor(step, dtype=torch.float32,
                            device=leaves(params)[0].device)
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device) \
        .expand(stepf.shape)
    gs = grads if isinstance(grads, list) else leaves(grads)
    for i, (p, m_, v_) in enumerate(zip(leaves(params), leaves(m),
                                        leaves(v))):
        g = gs[i]
        gs[i] = None
        # a rank slice at a time bounds the temporaries on a device; meta
        # tensors (a dry run: launch.dryrun) hold nothing, so all at once
        rows = [slice(None)] if p.is_meta else [
            slice(r, r + 1) for r in range(p.shape[0])]
        for sl in rows:
            p_n, m_n, v_n = _leaf_update(p[sl], g[sl], m_[sl], v_[sl],
                                         c1[sl], c2[sl], lr[sl],
                                         weight_decay, b1, b2, eps)
            p[sl].copy_(p_n)
            m_[sl].copy_(m_n)
            v_[sl].copy_(v_n)
        del g


def _pick_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick_tree(v, i) for k, v in tree.items()}
    return tree[i]


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to a tenth of it at ``total`` (f32, as the reference)."""
    def lr(step):
        stepf = torch.as_tensor(step, dtype=torch.float32)
        warm = stepf / max(warmup, 1)
        prog = torch.clamp((stepf - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return base_lr * torch.where(stepf < warmup, warm, 0.1 + 0.9 * cos)
    return lr
