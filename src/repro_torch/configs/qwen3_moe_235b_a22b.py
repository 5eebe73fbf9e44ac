"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf]."""
from repro_torch.configs.base import ModelConfig, MoESpec, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, head_dim=128,
    d_ff=1536, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
    moe=MoESpec(num_experts=128, top_k=8, d_ff_expert=1536),
))
