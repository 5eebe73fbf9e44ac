"""InternVL2-1B [arXiv:2404.16821; hf] — InternViT stub + Qwen2-0.5B backbone."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, head_dim=64,
    d_ff=4864, vocab=151655, rope_theta=1_000_000.0,
    frontend="vit", d_frontend=1024, n_prefix=256,
))
