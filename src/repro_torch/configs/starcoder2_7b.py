"""StarCoder2-7B [arXiv:2402.19173; hf] — GQA, RoPE."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv=4, head_dim=128,
    d_ff=18432, vocab=49152, act="gelu", rope_theta=100000.0,
))
