"""RecurrentGemma-9B [arXiv:2402.19427; unverified] — RG-LRU + local attn 1:2."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, head_dim=256,
    d_ff=12288, vocab=256000, act="geglu", window=2048,
    pattern=("rglru", "rglru", "local"), d_rnn=4096, conv_kernel=4,
    tie_embeddings=True,
))
