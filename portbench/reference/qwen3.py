"""Plain reference of a Qwen3 dense decoder's training step, and its inputs.

``init_params`` makes the parameter tree that both sides receive, on the
device from the seed (a few large draws): the embedding and unembedding,
and per layer (stacked on a leading layer axis) the attention block (pre
RMSNorm ``ln``, ``wq``, ``wkv`` as (d, 2, kv * hd), ``wo``, the per-head
``q_norm`` / ``k_norm``) and the gated FFN (``ln``, ``w_in`` as (d, 2,
d_ff): gate then up, ``w_out``).  Matrices are normal at 0.02 (the output
projections at 0.02 / sqrt(2 L)); the RMSNorm scales are 0 and act as
``1 + w``.

``train`` follows the steps one device would take in float32 with TF32
off: every row's loss (next-token cross-entropy over the full vocabulary),
forward and backward one row at a time and one layer at a time
(``torch.utils.checkpoint``), the gradient as the mean over all tokens, one
global-norm clip, then AdamW with bias corrections.  ``precision="tf32"``
is the control: every product, forward and backward, on TF32 operands.
``fault`` plants a program fault in the reference put in the program's
place: ``half_batch`` (the first half of the rows, the mean over them) or
``no_exchange`` (the first node's rows alone reach the update, divided by
the global token count, as when the gradient bridge is left out).
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.summa import round_tf32


def init_params(m: Mapping, seed: int, device) -> dict:
    """The global parameter tree, drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, d, V = m["num_hidden_layers"], m["hidden_size"], m["vocab_size"]
    H, kv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    dff = m["intermediate_size"]
    std, out_std = 0.02, 0.02 / math.sqrt(2.0 * L)

    def normal(shape, s):
        return torch.randn(shape, generator=g, device=device) * s

    def zeros(shape):
        return torch.zeros(shape, device=device)

    return {
        "embed": normal((V, d), std),
        "final_ln": zeros((d,)),
        "unembed": normal((d, V), std),
        "units": {"b0": {
            "attn": {"ln": zeros((L, d)),
                     "wq": normal((L, d, H * hd), std),
                     "wkv": normal((L, d, 2, kv * hd), std),
                     "wo": normal((L, H * hd, d), out_std),
                     "q_norm": zeros((L, hd)),
                     "k_norm": zeros((L, hd))},
            "ffn": {"ln": zeros((L, d)),
                    "w_in": normal((L, d, 2, dff), std),
                    "w_out": normal((L, dff, d), out_std)}}},
    }


def leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, leaf) pairs, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


class _TF32Matmul(torch.autograd.Function):
    """A product on TF32 operands, and its two gradient products on TF32
    operands too, as a card in TF32 mode computes them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return (torch.matmul(g, round_tf32(b).transpose(-1, -2)),
                torch.matmul(round_tf32(a).transpose(-1, -2), g))


def matmul_for(precision: str) -> Callable:
    if precision == "fp32":
        return torch.matmul
    if precision == "tf32":
        return _TF32Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def rope(x, theta: float):
    """Rotary position embedding of x (T, n, hd), positions 0..T-1, the
    rotate-half pairing."""
    T, hd = x.shape[0], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _layer(x, p: dict, m: Mapping, mm):
    """One decoder layer on one row x (T, d)."""
    T, d = x.shape
    H, kv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    eps = m["rms_norm_eps"]
    a = p["attn"]
    h = rms_norm(x, a["ln"], eps)
    q = mm(h, a["wq"]).reshape(T, H, hd)
    kvp = mm(h, a["wkv"].reshape(d, 2 * kv * hd)).reshape(T, 2, kv, hd)
    k, v = kvp[:, 0], kvp[:, 1]
    q = rope(rms_norm(q, a["q_norm"], eps), m["rope_theta"])
    k = rope(rms_norm(k, a["k_norm"], eps), m["rope_theta"])
    k = k.repeat_interleave(H // kv, dim=1)
    v = v.repeat_interleave(H // kv, dim=1)
    s = mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    pr = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(pr, v.transpose(0, 1)).transpose(0, 1).reshape(T, H * hd)
    x = x + mm(o, a["wo"])
    f = p["ffn"]
    u = mm(rms_norm(x, f["ln"], eps),
           f["w_in"].reshape(d, -1)).reshape(T, 2, -1)
    return x + mm(F.silu(u[:, 0]) * u[:, 1], f["w_out"])


def row_nll(params: dict, tokens: torch.Tensor, m: Mapping, mm
            ) -> torch.Tensor:
    """Summed next-token negative log-likelihood of one row of T + 1
    token ids."""
    ids, labels = tokens[:-1].long(), tokens[1:].long()
    x = params["embed"][ids]
    units = params["units"]["b0"]
    grad = torch.is_grad_enabled()
    for layer in range(m["num_hidden_layers"]):
        p = {blk: {k: w[layer] for k, w in units[blk].items()}
             for blk in ("attn", "ffn")}
        x = (checkpoint(_layer, x, p, m, mm, use_reentrant=False) if grad
             else _layer(x, p, m, mm))
    x = rms_norm(x, params["final_ln"], m["rms_norm_eps"])
    logits = mm(x, params["unembed"])
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def train(params0: dict, batches: list, m: Mapping, opt: Mapping, *,
          precision: str = "fp32", fault: Optional[str] = None,
          nodes: int = 2) -> dict:
    """Follow ``len(batches)`` steps from ``params0`` (left unchanged).

    Returns ``losses`` (each step's mean token loss), ``grad1`` (per leaf,
    the norm of the first step's clipped gradient: what AdamW receives) and
    ``update`` (per leaf, the norm of the parameters' change over all the
    steps)."""
    if fault not in (None, "half_batch", "no_exchange"):
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
    losses, grad1 = [], {}
    for step, tokens in enumerate(batches, 1):
        B = tokens.shape[0]
        first = B // nodes
        loss_rows = range(first) if fault == "half_batch" else range(B)
        grad_rows = range(first) if fault else range(B)
        count = (tokens.shape[1] - 1) * len(
            range(first) if fault == "half_batch" else range(B))
        total = 0.0
        for w in p:
            w.grad = None
        for r in loss_rows:
            if r in grad_rows:
                nll = row_nll(tree, tokens[r], m, mm)
                nll.backward()
            else:
                with torch.no_grad():
                    nll = row_nll(tree, tokens[r], m, mm)
            total += float(nll.detach())
        losses.append(total / count)
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
    return {"losses": losses, "grad1": grad1, "update": update}


def _unflatten(like: dict, values: list) -> dict:
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def gaps(prog: Mapping, ref: Mapping, *, moving_floor: float = 1e-3
         ) -> dict:
    """The numbers compared, program against reference.

    ``loss_gap``: the largest relative gap of a step's loss.  ``grad1_gap``
    and ``update_gap``: by the worst leaf, the gap between the two sides'
    norms over the larger of the reference's norm of that leaf and of the
    median leaf.  A leaf whose first reference gradient is under
    ``moving_floor`` of the median leaf's moves by round-off alone under
    Adam and is left out of ``update_gap``."""
    steps = min(len(prog["losses"]), len(ref["losses"]))
    loss_gap = max(abs(prog["losses"][i] - ref["losses"][i])
                   / abs(ref["losses"][i]) for i in range(steps))

    def worst(key, names):
        med = statistics.median(ref[key][n] for n in names)
        return max(abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med)
                   for n in names)

    names = sorted(ref["grad1"])
    med_g = statistics.median(ref["grad1"][n] for n in names)
    moving = [n for n in names if ref["grad1"][n] >= moving_floor * med_g]
    return {"loss_gap": loss_gap, "grad1_gap": worst("grad1", names),
            "update_gap": worst("update", moving)}
