"""The work of a sparse-expert decoder's training step, counted once, as
``work.py`` counts the dense one: the model FLOP of the active parameters,
and the expert products' FLOP and bytes.

The active matrix parameters a token passes through: every layer's q, k,
v and o, its router and its top k experts' three matrices (gate, up,
down), and the unembedding (tied or not; the embedding lookup is no
product).  An expert product's work is its routed rows' (tokens x top k)
products, whatever the route: no padding to a capacity, no empty slots.
"""

from __future__ import annotations

from typing import Mapping

from portbench.work import F32, flash_fwd_work


def active_matrix_params(m: Mapping) -> int:
    """Parameters of the weight matrices one token passes through."""
    d, H, kv, hd = (m["hidden_size"], m["num_attention_heads"],
                    m["num_key_value_heads"], m["head_dim"])
    attn = d * H * hd + 2 * d * kv * hd + H * hd * d
    experts = m["num_experts_per_tok"] * 3 * d * m["intermediate_size"]
    layer = attn + d * m["num_local_experts"] + experts
    return m["num_hidden_layers"] * layer + d * m["vocab_size"]


def moe_step_flops(m: Mapping, B: int, T: int) -> float:
    """Model FLOP of one training step on B rows of T tokens: 6 x the
    active matrix parameters x the tokens, plus 3 x every layer's causal
    attention forward.  No recomputation is counted."""
    attn = m["num_hidden_layers"] * flash_fwd_work(
        B, T, m["num_attention_heads"], m["num_key_value_heads"],
        m["head_dim"])[0]
    return 6.0 * active_matrix_params(m) * B * T + 3.0 * attn


def experts_pass_work(m: Mapping, B: int, T: int) -> tuple[float, float]:
    """(FLOP, bytes) of one layer's expert products over B rows of T
    tokens, one pass (the forward's gate-up and down products; each of the
    backward's two passes, dX and dW, is as much): 2 x 3 d d_ff FLOP per
    routed row, B T k rows; every expert's matrices read once, the routed
    rows read and the products' outputs written once."""
    d, dff, k = m["hidden_size"], m["intermediate_size"], \
        m["num_experts_per_tok"]
    rows = B * T * k
    flops = 2.0 * rows * 3 * d * dff
    nbytes = F32 * (m["num_local_experts"] * 3 * d * dff
                    + rows * (d + 2 * dff)      # gate-up: in, out
                    + rows * (dff + d))         # down: in, out
    return flops, float(nbytes)
