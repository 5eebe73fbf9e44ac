"""Model configuration system.

One ``ModelConfig`` per assigned architecture (``configs/<id>.py``), plus
``reduced()`` variants for CPU smoke tests.  A copy of the reference's
``repro/configs`` (plain frozen dataclasses), so the port imports nothing
of the JAX package; ``reduced()`` gives the same tiny configs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # tokens an expert takes per member, over the even share (drops beyond
    # it); None: dropless, every token reaches all top_k of its experts
    capacity_factor: Optional[float] = 1.25

    def ep_tp(self, tp: int) -> tuple[int, int]:
        """Factor the model axis into (expert-parallel, ffn-tensor-parallel)
        degrees: largest ep dividing both tp and num_experts."""
        ep = math.gcd(self.num_experts, tp)
        return ep, tp // ep


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # block pattern, repeated to fill n_layers (remainder allowed):
    #   attn | local | mlstm | slstm | rglru  — each block includes its own
    #   channel-mixing (ffn/moe) except mlstm/slstm (xLSTM has none).
    pattern: tuple[str, ...] = ("attn",)
    act: str = "swiglu"            # swiglu|geglu
    norm_eps: float = 1e-6
    qk_norm: bool = False
    rope_theta: float = 10000.0
    pos: str = "rope"              # rope|sinusoidal|none
    window: Optional[int] = None   # sliding window for "local" blocks
    moe: Optional[MoESpec] = None
    frontend: Optional[str] = None  # None|"vit"|"encodec" (stub embeddings)
    d_frontend: int = 0
    n_prefix: int = 0              # frontend tokens prepended (vlm)
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    # the input embedding's multiplier (None: sqrt(d_model) when tied,
    # Gemma's rule, else 1), the multiplier of the attention and channel-
    # mixing (ffn / moe) residual branches, the attention softmax scale
    # (None: 1 / sqrt(head_dim)) and the divisor of the logits; Granite
    # sets all four
    embed_scale: Optional[float] = None
    residual_scale: float = 1.0
    attn_scale: Optional[float] = None
    logit_scale: float = 1.0
    # the softmax over the published vocabulary alone: the padded rows'
    # logits (``vocab`` to ``vocab_padded``) -inf in the loss and at
    # decode, as a model trained at its own vocabulary has them; off, they
    # take part, as in the reference package's loss
    mask_vocab_pad: bool = False
    # xLSTM specifics
    proj_factor: float = 2.0       # mLSTM inner-dim multiplier
    conv_kernel: int = 4
    d_rnn: int = 0                 # RG-LRU recurrence width (0 -> d_model)

    # ---- derived ------------------------------------------------------------
    @property
    def input_scale(self) -> float:
        """The multiplier of the input embedding."""
        if self.embed_scale is not None:
            return self.embed_scale
        return self.d_model ** 0.5 if self.tie_embeddings else 1.0

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab, 128)

    @property
    def softmax_vocab(self) -> Optional[int]:
        """The rows the logits' softmax runs over where fewer than the
        padded vocabulary (``mask_vocab_pad``), else None."""
        if self.mask_vocab_pad and self.vocab < self.vocab_padded:
            return self.vocab
        return None

    @property
    def block_kinds(self) -> tuple[str, ...]:
        reps = (self.n_layers + len(self.pattern) - 1) // len(self.pattern)
        return (self.pattern * reps)[: self.n_layers]

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder_kinds(self) -> tuple[str, ...]:
        return self.block_kinds[self.n_units * len(self.pattern):]

    @property
    def d_inner(self) -> int:
        """mLSTM inner width."""
        return int(self.d_model * self.proj_factor)

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (embedding included, padding excluded)."""
        d, hd, H, kv = self.d_model, self.head_dim, self.n_heads, self.n_kv
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.frontend:
            total += self.d_frontend * d
        attn = d * (H + 2 * kv) * hd + H * hd * d + 2 * d
        nmat = 2 if self.act == 'gelu' else 3
        ffn = nmat * d * self.d_ff + 2 * d if self.d_ff else 0
        if self.moe:
            ffn = (self.moe.num_experts * 3 * d * self.moe.d_ff_expert
                   + d * self.moe.num_experts + 2 * d)
        din = self.d_inner
        nh = max(self.n_heads, 1)
        mlstm = (d * 2 * din + 3 * din * din // nh + 3 * din * nh
                 + din * self.conv_kernel + din * d + 2 * d)
        slstm = 8 * d * d + 4 * d + d * self.conv_kernel + 2 * d
        dr = self.rnn_width
        # w_x (d,2,dr) + w_rg (d,2,dr) + conv + lam + w_out + ln
        rglru = (4 * d * dr + dr * self.conv_kernel
                 + dr + dr * d + d) + ffn
        per_kind = {"attn": attn + ffn, "local": attn + ffn,
                    "mlstm": mlstm, "slstm": slstm, "rglru": rglru}
        for k in self.block_kinds:
            total += per_kind[k]
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not self.moe:
            return self.param_count()
        moe_all = (self.n_layers * self.moe.num_experts * 3 * self.d_model
                   * self.moe.d_ff_expert)
        frac = self.moe.top_k / self.moe.num_experts
        return self.param_count() - int(moe_all * (1 - frac))

    def reduced(self, *, n_layers: int = 2, d_model: int = 64,
                n_heads: int = 4, n_kv: Optional[int] = None,
                vocab: int = 256, d_ff: Optional[int] = None,
                seq: int = 32) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        del seq
        kv = n_kv if n_kv is not None else min(self.n_kv, n_heads)
        kv = max(1, min(kv, n_heads))
        moe = None
        if self.moe:
            moe = MoESpec(num_experts=4, top_k=2, d_ff_expert=32,
                          capacity_factor=self.moe.capacity_factor)
        pat_reps = max(1, n_layers // len(self.pattern))
        return dataclasses.replace(
            self, n_layers=len(self.pattern) * pat_reps, d_model=d_model,
            n_heads=n_heads, n_kv=kv, head_dim=d_model // n_heads,
            d_ff=(d_ff if d_ff is not None else (0 if self.d_ff == 0 else 128)),
            vocab=vocab, moe=moe, window=min(self.window, 16) if self.window
            else None, d_frontend=32 if self.frontend else 0,
            n_prefix=4 if self.n_prefix else 0,
            d_rnn=d_model if self.d_rnn else 0)


_REGISTRY: dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> Sequence[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    import importlib
    for mod in ("qwen3_moe_235b_a22b", "granite_moe_3b_a800m", "xlstm_1_3b",
                "qwen3_0_6b", "starcoder2_7b", "gemma_2b", "mistral_nemo_12b",
                "internvl2_1b", "recurrentgemma_9b", "musicgen_medium"):
        importlib.import_module(f"repro_torch.configs.{mod}")
