"""Qwen3 0.6B [hf:Qwen/Qwen3-8B family; hf] — qk_norm, GQA."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv=8, head_dim=128,
    d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
))
