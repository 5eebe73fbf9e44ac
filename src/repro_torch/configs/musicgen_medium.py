"""MusicGen-medium [arXiv:2306.05284; hf] — decoder over EnCodec tokens (stub)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24, head_dim=64,
    d_ff=6144, vocab=2048, act="geglu", pos="sinusoidal",
    frontend="encodec", d_frontend=128,
))
