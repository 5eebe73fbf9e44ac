"""Gemma-2B [arXiv:2403.08295; hf] — GeGLU, head_dim 256, MQA."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
    d_ff=16384, vocab=256000, act="geglu", tie_embeddings=True,
))
