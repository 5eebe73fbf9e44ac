from repro_torch.configs.base import (ModelConfig, MoESpec, get_config,
                                      list_configs, register)

__all__ = ["ModelConfig", "MoESpec", "get_config", "list_configs", "register"]
