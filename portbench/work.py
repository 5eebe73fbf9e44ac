"""The yardstick's arithmetic: the work an input needs, and the card's peaks.

Every count here is of the algorithm, once: the FLOP and bytes that a
product, an attention call or a training step needs for its inputs, whatever
route implements it (no 3xTF32 passes, no recomputation, each operand read
once and each output written once).  A share of a roofline or of a peak is
that work over the time the card took, against the datasheet peaks that each
configuration file states (``peak``); ``DATASHEET`` is NVIDIA's H100 SXM
datasheet at 700 W, dense rates.
"""

from __future__ import annotations

from typing import Mapping

#: NVIDIA H100 SXM datasheet, dense: FLOP/s by operand route, HBM3 bytes/s.
DATASHEET = {"tf32": 495e12, "fp32_fma": 67e12, "bf16": 989e12,
             "hbm_bytes_per_s": 3.35e12}

F32 = 4  # bytes of a float32


def bound_s(flops: float, nbytes: float, peak: Mapping) -> float:
    """The least time the card could take: the larger of FLOP over the peak
    rate and bytes over the memory bandwidth."""
    return max(flops / peak["flops_per_s"], nbytes / peak["bytes_per_s"])


# -- SUMMA --------------------------------------------------------------------

def summa_flops(n: int) -> float:
    """FLOP of one C = A @ B of (n, n) operands: 2 n^3."""
    return 2.0 * n ** 3


def summa_panel_bytes(n: int, nodes: int, cores: int) -> float:
    """Bytes the panel products of one multiply must move: each round's
    A panel, B panel and C panel of every rank, read or written once."""
    if nodes != cores or n % nodes:
        raise ValueError(f"SUMMA needs a square grid dividing n, got "
                         f"{nodes}x{cores} and n={n}")
    blk = (n // nodes) * (n // cores)
    return float(cores * nodes * cores * 3 * blk * F32)


# -- attention ----------------------------------------------------------------

def causal_pairs(T: int) -> int:
    """Query-key pairs of causal attention over T positions."""
    return T * (T + 1) // 2


def flash_fwd_work(B: int, T: int, H: int, kv: int, hd: int
                   ) -> tuple[float, float]:
    """(FLOP, bytes) of one causal attention forward: QK^T and PV over the
    causal pairs; Q, K, V read and O and the row log-sum-exp written once."""
    flops = 4.0 * B * H * causal_pairs(T) * hd
    nbytes = F32 * (2 * B * T * H * hd + 2 * B * T * kv * hd + B * H * T)
    return flops, float(nbytes)


def flash_bwd_work(B: int, T: int, H: int, kv: int, hd: int
                   ) -> tuple[float, float]:
    """(FLOP, bytes) of its backward: the four gradient products (dV, dP,
    dQ, dK: twice the forward's FLOP; the recompute of S is not counted);
    Q, K, V, O, dO and lse read and dQ, dK, dV written once."""
    flops = 2.0 * flash_fwd_work(B, T, H, kv, hd)[0]
    nbytes = F32 * (4 * B * T * H * hd + 4 * B * T * kv * hd + B * H * T)
    return flops, float(nbytes)


# -- the dense decoder ----------------------------------------------------------

def matrix_params(m: Mapping) -> int:
    """Parameters of the weight matrices a token passes through: every
    layer's q, k, v, o and gated-FFN matrices, and the unembedding (the
    embedding lookup is no product)."""
    d, H, kv, hd = (m["hidden_size"], m["num_attention_heads"],
                    m["num_key_value_heads"], m["head_dim"])
    layer = d * H * hd + 2 * d * kv * hd + H * hd * d \
        + 3 * d * m["intermediate_size"]
    return m["num_hidden_layers"] * layer + d * m["vocab_size"]


def train_step_flops(m: Mapping, B: int, T: int) -> float:
    """Model FLOP of one training step on B rows of T tokens: 6 x the matrix
    parameters x the tokens, plus 3 x every layer's causal attention
    forward (QK^T and PV).  No recomputation is counted."""
    attn = m["num_hidden_layers"] * flash_fwd_work(
        B, T, m["num_attention_heads"], m["num_key_value_heads"],
        m["head_dim"])[0]
    return 6.0 * matrix_params(m) * B * T + 3.0 * attn
