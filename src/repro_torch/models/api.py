"""Unified model API: family dispatch.

Counterpart of ``repro/models/api.py``.  The port runs the dense, MoE and
VLM families through ``models/transformer.py``, the encoder-decoder
through ``models/whisper.py``, the SSM family through ``models/mamba2.py``
and the hybrid through ``models/recurrentgemma.py``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import mamba2, recurrentgemma, transformer, whisper

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "encdec": whisper, "ssm": mamba2, "hybrid": recurrentgemma}


def model_module(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def param_defs(cfg: ModelConfig):
    return model_module(cfg).param_defs(cfg)


def forward_train(cfg: ModelConfig, params, batch):
    return model_module(cfg).forward_train(cfg, params, batch)


def forward_prefill(cfg: ModelConfig, params, batch):
    return model_module(cfg).forward_prefill(cfg, params, batch)


def forward_decode(cfg: ModelConfig, params, tokens, caches):
    return model_module(cfg).forward_decode(cfg, params, tokens, caches)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device="cuda"):
    """The family's empty decode caches, on the card unless ``device``
    names the CPU."""
    return model_module(cfg).init_cache(cfg, batch, s_max, dtype,
                                        resolve_device(device))
