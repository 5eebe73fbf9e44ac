"""Plain reference of a Granite-3.0 MoE decoder's training step, and its
inputs.

The model (transformers' ``GraniteMoeForCausalLM``), one row x of T tokens:

* ``x0 = embedding_multiplier * E[ids]`` (the embedding tied to the head);
* ``h = x + residual_multiplier * Attn(rms(x))``: GQA with rotary positions
  (the rotate-half pairing) and the softmax scale ``attention_multiplier``
  (1 / 64 for Granite, not 1 / sqrt(64));
* ``x' = h + residual_multiplier * MoE(rms(h))``, where ``MoE(u)`` is the
  sum over the top ``num_experts_per_tok`` experts of ``u R`` of the gate
  (the softmax of those k logits) times the expert's SwiGLU
  ``W2_e (silu(u W1g_e) * u W1u_e)``; dropless: every token reaches all k
  of its experts;
* ``logits = rms(x_L) E^T / logits_scaling``, over the ``vocab_size``
  rows of the vocabulary.

``init_params`` makes the parameter tree that both sides receive, in the
program's layout, on the device from the seed (a few large draws): the
embedding (``embed``, the vocabulary padded to a multiple of 128, as the
program holds it; the pad rows are never looked up and stay out of the
softmax), the final RMSNorm, and per layer (stacked on a leading
layer axis) the attention block (``ln``, ``wq``, ``wkv`` as (d, 2, kv * hd),
``wo``) and the expert block (``ln``, ``router`` (d, E), ``w_in`` as (1, E,
d, 2, d_ff): gate then up, ``w_out`` (1, E, d_ff, d); the 1 is the
program's tensor-parallel axis).  Matrices are normal at 0.02 (the output
projections at 0.02 / sqrt(2 L)); the RMSNorm scales are 0.

``train`` follows the steps one device would take in float32 with TF32 off,
as ``reference.qwen3.train`` does: every row's loss, forward and backward
one row and one layer at a time (``torch.utils.checkpoint``), the gradient
as the mean over all tokens, one global-norm clip, then AdamW with bias
corrections.  The expert block runs expert by expert in ascending order,
each on the tokens routed to it, its output added into the row's sum in
that order.

Departures from the published model, each shared with the program: the
RMSNorm scales are held as ``1 + w`` (drawn 0); no dropout, and no router
auxiliary loss (the loss is the next-token cross-entropy alone).

Routing near-ties.  Rounding may flip a token's k-th and (k+1)-th expert.
Where the reference's own gap between those two logits is under
``margin`` and ``program_routes`` (the program's routing ids of the check
steps, ``{(step, row, layer): (T, k)}``) are given, the reference takes the
program's choice for that token; ``tie_share`` is the share of all
assignments that this changed.

``precision="tf32"`` is the control: every product, forward and backward,
on TF32 operands.  ``fault`` plants a program fault in the reference put in
the program's place: ``half_batch`` and ``no_exchange`` as in
``reference.qwen3``; ``capacity_1.25`` (each expert takes at most
``int(T k / E * 1.25) + 1`` of a row's assignments, in token order, and the
rest are dropped: the capacity routing of one folded member a row);
``sqrt_scale`` (the attention scale 1 / sqrt(head_dim)).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.qwen3 import (_unflatten, gaps, leaves, matmul_for,
                                       rms_norm, rope)

FAULTS = ("half_batch", "no_exchange", "capacity_1.25", "sqrt_scale")

__all__ = ["FAULTS", "gaps", "init_params", "leaves", "padded_vocab",
           "row_nll", "train"]


def padded_vocab(m: Mapping) -> int:
    """The embedding's rows: the vocabulary padded to a multiple of 128."""
    return -(-m["vocab_size"] // 128) * 128


def init_params(m: Mapping, seed: int, device) -> dict:
    """The global parameter tree, drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, d = m["num_hidden_layers"], m["hidden_size"]
    H, kv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    E, dff = m["num_local_experts"], m["intermediate_size"]
    std, out_std = 0.02, 0.02 / math.sqrt(2.0 * L)

    def normal(shape, s):
        return torch.randn(shape, generator=g, device=device) * s

    def zeros(shape):
        return torch.zeros(shape, device=device)

    return {
        "embed": normal((padded_vocab(m), d), std),
        "final_ln": zeros((d,)),
        "units": {"b0": {
            "attn": {"ln": zeros((L, d)),
                     "wq": normal((L, d, H * hd), std),
                     "wkv": normal((L, d, 2, kv * hd), std),
                     "wo": normal((L, H * hd, d), out_std)},
            "moe": {"ln": zeros((L, d)),
                    "router": normal((L, d, E), std),
                    "w_in": normal((L, 1, E, d, 2, dff), std),
                    "w_out": normal((L, 1, E, dff, d), out_std)}}},
    }


class _Routing:
    """What the expert blocks of one step saw: per (row, layer) the ids
    used, the assignments the near-tie rule changed and those dropped (a
    rematerialised forward writes the same entry again)."""

    def __init__(self, step: int, program: Optional[Mapping], margin: float):
        self.step, self.program, self.margin = step, program, margin
        self.ids: dict = {}
        self.changed: dict = {}
        self.dropped: dict = {}


def _moe(u, p: dict, m: Mapping, mm, rt: _Routing, key, capacity):
    """The dropless expert block on one row u (T, d), expert by expert."""
    T, d = u.shape
    E, k = m["num_local_experts"], m["num_experts_per_tok"]
    logits = mm(u, p["router"])                            # (T, E)
    vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    idx = order[:, :k]
    prog = rt.program.get((rt.step,) + key) if rt.program else None
    changed = 0
    if prog is not None:
        near = (vals[:, k - 1] - vals[:, k]) < rt.margin
        prog = prog.to(idx.device)
        same = (prog[:, :, None] == idx[:, None, :]).any(-1).sum(-1)
        changed = ((k - same) * near).sum()
        idx = torch.where(near[:, None], prog, idx)
    gate = torch.softmax(logits.gather(-1, idx), dim=-1)
    y = torch.zeros_like(u)
    dropped = 0
    w_in, w_out = p["w_in"][0], p["w_out"][0]
    for e in range(E):
        tok, j = (idx == e).nonzero(as_tuple=True)
        if capacity is not None:
            dropped += max(0, tok.numel() - capacity)
            tok, j = tok[:capacity], j[:capacity]
        if tok.numel() == 0:
            continue
        g = mm(u[tok], w_in[e].reshape(d, -1)).reshape(tok.numel(), 2, -1)
        ye = mm(F.silu(g[:, 0]) * g[:, 1], w_out[e])
        y = y.index_add(0, tok, ye * gate[tok, j, None])
    rt.ids[key] = idx.detach()
    rt.changed[key] = changed
    rt.dropped[key] = dropped
    return y


def _layer(x, p: dict, m: Mapping, mm, rt: _Routing, key, fault):
    """One decoder layer on one row x (T, d)."""
    T, d = x.shape
    H, kv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    eps, rm = m["rms_norm_eps"], m["residual_multiplier"]
    scale = 1.0 / math.sqrt(hd) if fault == "sqrt_scale" else \
        m["attention_multiplier"]
    a = p["attn"]
    h = rms_norm(x, a["ln"], eps)
    q = mm(h, a["wq"]).reshape(T, H, hd)
    kvp = mm(h, a["wkv"].reshape(d, 2 * kv * hd)).reshape(T, 2, kv, hd)
    q = rope(q, m["rope_theta"])
    k = rope(kvp[:, 0], m["rope_theta"]).repeat_interleave(H // kv, dim=1)
    v = kvp[:, 1].repeat_interleave(H // kv, dim=1)
    s = mm(q.transpose(0, 1), k.permute(1, 2, 0)) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    pr = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(pr, v.transpose(0, 1)).transpose(0, 1).reshape(T, H * hd)
    x = x + rm * mm(o, a["wo"])
    capacity = None
    if fault == "capacity_1.25":
        capacity = int(T * m["num_experts_per_tok"]
                       / m["num_local_experts"] * 1.25) + 1
    f = p["moe"]
    return x + rm * _moe(rms_norm(x, f["ln"], eps), f, m, mm, rt, key,
                         capacity)


def row_nll(params: dict, tokens: torch.Tensor, m: Mapping, mm,
            rt: _Routing, row: int, fault: Optional[str] = None
            ) -> torch.Tensor:
    """Summed next-token negative log-likelihood of one row of T + 1 token
    ids (the global batch's row ``row``)."""
    ids, labels = tokens[:-1].long(), tokens[1:].long()
    x = m["embedding_multiplier"] * params["embed"][ids]
    units = params["units"]["b0"]
    grad = torch.is_grad_enabled()
    for layer in range(m["num_hidden_layers"]):
        p = {blk: {k: w[layer] for k, w in units[blk].items()}
             for blk in ("attn", "moe")}
        args = (x, p, m, mm, rt, (row, layer), fault)
        x = (checkpoint(_layer, *args, use_reentrant=False) if grad
             else _layer(*args))
    x = rms_norm(x, params["final_ln"], m["rms_norm_eps"])
    logits = mm(x, params["embed"][:m["vocab_size"]].T) / m["logits_scaling"]
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def train(params0: dict, batches: list, m: Mapping, opt: Mapping, *,
          precision: str = "fp32", fault: Optional[str] = None,
          nodes: int = 2, program_routes: Optional[Mapping] = None,
          margin: float = 0.0) -> dict:
    """Follow ``len(batches)`` steps from ``params0`` (left unchanged).

    Returns ``losses``, ``grad1`` and ``update`` as ``reference.qwen3.train``
    does; ``routes``, the routing ids used, ``{(step, row, layer): (T,
    k)}``; ``tie_share``, the share of the assignments that the near-tie
    rule took from ``program_routes`` and changed; ``dropped_share``, the
    share that a capacity dropped."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = matmul_for(precision)
    named = leaves(params0)
    p = [w.detach().clone().requires_grad_(True) for _, w in named]
    tree = _unflatten(params0, p)
    mom = [torch.zeros_like(w) for w in p]
    vel = [torch.zeros_like(w) for w in p]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, grad1, routes = [], {}, {}
    changed = dropped = assigned = 0
    for step, tokens in enumerate(batches, 1):
        B = tokens.shape[0]
        first = B // nodes
        half = fault == "half_batch"
        loss_rows = range(first) if half else range(B)
        grad_rows = range(first) if fault in ("half_batch", "no_exchange") \
            else range(B)
        count = (tokens.shape[1] - 1) * len(loss_rows)
        rt = _Routing(step - 1, program_routes, margin)
        total = 0.0
        for w in p:
            w.grad = None
        for r in loss_rows:
            if r in grad_rows:
                nll = row_nll(tree, tokens[r], m, mm, rt, r, fault)
                nll.backward()
            else:
                with torch.no_grad():
                    nll = row_nll(tree, tokens[r], m, mm, rt, r, fault)
            total += float(nll.detach())
        losses.append(total / count)
        routes.update({(step - 1,) + key: ids for key, ids in rt.ids.items()})
        changed += sum(float(c) for c in rt.changed.values())
        dropped += sum(rt.dropped.values())
        assigned += sum(ids.numel() for ids in rt.ids.values())
        grads = [w.grad / count for w in p]
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(opt["clip"] / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = [g * scale for g in grads]
        if step == 1:
            grad1 = {n: float(g.norm()) for (n, _), g in zip(named, grads)}
        c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        with torch.no_grad():
            for w, g, m_, v_ in zip(p, grads, mom, vel):
                m_.mul_(b1).add_((1.0 - b1) * g)
                v_.mul_(b2).add_((1.0 - b2) * g * g)
                w.sub_(opt["lr"] * ((m_ / c1) / (torch.sqrt(v_ / c2) + eps)
                                    + opt["weight_decay"] * w))
        del grads
    update = {n: float((w.detach() - w0).norm())
              for (n, w0), w in zip(named, p)}
    return {"losses": losses, "grad1": grad1, "update": update,
            "routes": routes, "tie_share": changed / max(assigned, 1),
            "dropped_share": dropped / max(assigned, 1)}
