"""Model configurations of the dense family (``repro/configs`` in the
reference)."""

from repro_torch.configs.base import (ModelConfig, MoECfg, RGLRUCfg, SSMCfg,
                                      get_config, register)

__all__ = ["ModelConfig", "MoECfg", "RGLRUCfg", "SSMCfg", "get_config",
           "register"]
