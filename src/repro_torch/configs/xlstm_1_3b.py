"""xLSTM 1.3B [arXiv:2405.04517; unverified] — 7:1 mLSTM:sLSTM units."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, head_dim=512,
    d_ff=0, vocab=50304, pos="none", proj_factor=2.0, conv_kernel=4,
    pattern=("mlstm",) * 7 + ("slstm",),
))
