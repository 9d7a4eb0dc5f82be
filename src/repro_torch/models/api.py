"""Unified model API: family dispatch, the dry-run's abstract inputs
(``input_specs``, ``meta`` tensors) and the logical axes of batches and
caches.

Counterpart of ``repro/models/api.py``.  The port runs the dense, MoE and
VLM families through ``models/transformer.py``, the encoder-decoder
through ``models/whisper.py``, the SSM family through ``models/mamba2.py``
and the hybrid through ``models/recurrentgemma.py``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import mamba2, recurrentgemma, transformer, whisper
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.layers.rglru import RGLRUCache
from repro_torch.models.layers.ssm import SSMCache

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "encdec": whisper, "ssm": mamba2, "hybrid": recurrentgemma}


def model_module(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def param_defs(cfg: ModelConfig):
    return model_module(cfg).param_defs(cfg)


def sharding_dims(cfg: ModelConfig) -> Dict[str, int]:
    return model_module(cfg).sharding_dims(cfg)


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


class _OnMeta(TorchDispatchMode):
    """Every tensor a factory makes lands on ``meta``: the shapes and types
    of a computation without storage (the reference's ``eval_shape``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


def abstract_cache(cfg: ModelConfig, batch: int, s_max: int,
                   dtype=torch.bfloat16):
    """The family's decode caches as ``meta`` tensors."""
    with _OnMeta():
        return model_module(cfg).init_cache(cfg, batch, s_max, dtype,
                                            torch.device("cpu"))


# ---------------------------------------------------------------------------
# input_specs — meta stand-ins of one cell's inputs, no storage
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """Model inputs for one (arch × shape) cell, on ``meta``.

    train:   {tokens, labels [, frames][, positions]}
    prefill: {tokens [, frames][, positions]}
    decode:  {tokens (B, 1), caches (KV or state of length seq_len)}
    """
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.act_dtype)

    def ints(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": ints(B, S)}
        if shape.kind == "train":
            specs["labels"] = ints(B, S)
        if cfg.family == "encdec":
            specs["frames"] = torch.empty((B, cfg.enc_frames, cfg.d_model),
                                          dtype=act, device="meta")
        if cfg.family == "vlm":
            specs["positions"] = ints(B, S, 3)
        return specs
    return {"tokens": ints(B, 1), "caches": abstract_cache(cfg, B, S, act)}


# ---------------------------------------------------------------------------
# Logical axes of batches and caches (the dry-run's input placements)
# ---------------------------------------------------------------------------


def batch_axes(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    axes = {"tokens": ("batch", "seq")}
    if shape.kind == "train":
        axes["labels"] = ("batch", "seq")
    if cfg.family == "encdec":
        axes["frames"] = ("batch", "frames", "embed")
    if cfg.family == "vlm" and shape.kind != "decode":
        axes["positions"] = ("batch", "seq", None)
    if shape.kind == "decode":
        axes = {"tokens": ("batch", None), "caches": cache_axes(cfg)}
    return axes


def _kv_axes(kv_logical="kv"):
    # 'kv_seq' shards the cache's sequence over 'model' where the KV heads
    # do not divide it (make_rules)
    return KVCache(k=(None, "batch", "kv_seq", kv_logical, None),
                   v=(None, "batch", "kv_seq", kv_logical, None),
                   length=(None, "batch"))


def cache_axes(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return _kv_axes()
    if cfg.family == "encdec":
        return whisper.WhisperCache(
            self_kv=_kv_axes("heads"),
            cross_k=(None, "batch", "frames", "heads", None),
            cross_v=(None, "batch", "frames", "heads", None))
    if cfg.family == "ssm":
        return SSMCache(conv_x=(None, "batch", None, "inner"),
                        conv_bc=(None, "batch", None, None),
                        state=(None, "batch", "heads", None, None))
    if cfg.family == "hybrid":
        rec = RGLRUCache(h=(None, "batch", "lru"),
                         conv=(None, "batch", None, "lru"))
        return recurrentgemma.RGCache(
            rec1=rec, rec2=rec, attn=_kv_axes(), tail=rec)
    raise ValueError(cfg.family)
