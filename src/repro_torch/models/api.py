"""Unified model API: family dispatch.

Counterpart of ``repro/models/api.py``.  The port runs the dense, MoE and
VLM families through ``models/transformer.py``, the SSM family through
``models/mamba2.py`` and the hybrid through ``models/recurrentgemma.py``;
the encoder-decoder family of the reference raises
``NotImplementedError`` until its slice lands (ROADMAP item 15).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, not_ported
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import mamba2, recurrentgemma, transformer

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "ssm": mamba2, "hybrid": recurrentgemma}


def model_module(cfg: ModelConfig):
    mod = _FAMILY.get(cfg.family)
    if mod is None:
        raise not_ported(f"the {cfg.family} family ({cfg.name})")
    return mod


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
