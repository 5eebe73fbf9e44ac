"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite/granite-3.0-3b-a800m-base; hf]."""
from repro_torch.configs.base import ModelConfig, MoESpec, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, head_dim=64,
    d_ff=512, vocab=49155, rope_theta=10000.0,
    moe=MoESpec(num_experts=40, top_k=8, d_ff_expert=512),
))
