"""Mamba2-2.7b: an attention-free stack of SSD blocks (arXiv:2405.21060).

Counterpart of ``repro/models/mamba2.py``: L layers of (RMSNorm → Mamba2
mixer → residual), tied embeddings, and an O(1) recurrent state a layer
in decode (``models/layers/ssm.py``).  The reference's ``lax.scan`` over
the stacked ``(L, ...)`` weights is a Python loop over the layer axis.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.common import embed, logits, rms_norm
from repro_torch.models.layers.ssm import (SSMCache, _dims, mamba_block,
                                           mamba_cache_init,
                                           mamba_decode_step)
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import _act, _layer, _remat


def param_defs(cfg: ModelConfig) -> Dict:
    """The reference's layout: the fused in-projection split per role
    (``wz``, ``wx``, ``wbc``, ``wdt``), the convs' weights at scale 0.2."""
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    di, gn, H = _dims(cfg)
    K = cfg.ssm.d_conv
    layers = {
        "norm": ParamDef((L, D), (None, "embed"), "zeros"),
        "wz": ParamDef((L, D, di), (None, "embed", "inner")),
        "wx": ParamDef((L, D, di), (None, "embed", "inner")),
        "wbc": ParamDef((L, D, 2 * gn), (None, "embed", None)),
        "wdt": ParamDef((L, D, H), (None, "embed", "heads")),
        "conv_x_w": ParamDef((L, K, di), (None, "conv", "inner"), scale=0.2),
        "conv_x_b": ParamDef((L, di), (None, "inner"), "zeros"),
        "conv_bc_w": ParamDef((L, K, 2 * gn), (None, "conv", None),
                              scale=0.2),
        "conv_bc_b": ParamDef((L, 2 * gn), (None, None), "zeros"),
        "A_log": ParamDef((L, H), (None, "heads"), "zeros"),
        "dt_bias": ParamDef((L, H), (None, "heads"), "zeros"),
        "D_skip": ParamDef((L, H), (None, "heads"), "ones"),
        "norm_gate": ParamDef((L, di), (None, "inner"), "zeros"),
        "out_proj": ParamDef((L, di, D), (None, "inner", "embed")),
    }
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.01),
        "final_norm": ParamDef((D,), ("embed",), "zeros"),
        "layers": layers,
    }


def sharding_dims(cfg: ModelConfig) -> Dict[str, int]:
    """'inner' is d_inner, head-aligned with 'heads' (di = H·P)."""
    di, _, H = _dims(cfg)
    return {"heads": H, "inner": di, "vocab": cfg.vocab, "ff": 0, "kv": 0,
            "embed": cfg.d_model}


def _layer_params(lp):
    """The mixer's weights: the layer's own, with ``norm_gate`` as the
    gated norm's ``norm``."""
    p = {k: w for k, w in lp.items() if k not in ("norm", "norm_gate")}
    p["norm"] = lp["norm_gate"]
    return p


def _layer_train(cfg: ModelConfig, x, lp):
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    out, _ = mamba_block(cfg, _layer_params(lp), h)
    return x + out


def forward_train(cfg: ModelConfig, params, batch):
    """tokens (B, S) → (logits (B, S, V) f32, aux = 0)."""
    tokens = batch["tokens"]
    x = embed(tokens, params["embed"]).to(_act(cfg))
    layer = _remat(cfg, functools.partial(_layer_train, cfg))
    for i in range(cfg.n_layers):
        x = layer(x, _layer(params, i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (logits(x, params["embed"]),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device="cuda") -> SSMCache:
    """Stacked per-layer conv windows and states (L, B, ...); ``s_max`` is
    not used (the state is O(1) in the sequence)."""
    del s_max
    one = mamba_cache_init(cfg, batch, dtype, device)
    return SSMCache(*(t.expand((cfg.n_layers,) + t.shape).clone()
                      for t in one))


def forward_prefill(cfg: ModelConfig, params, batch):
    """The whole-prompt forward that also gives each layer's final state
    and conv tails.  Returns (last-position logits (B, 1, V) f32, stacked
    caches)."""
    tokens = batch["tokens"]
    x = embed(tokens, params["embed"]).to(_act(cfg))
    caches = []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["norm"], cfg.norm_eps)
        out, cache = mamba_block(cfg, _layer_params(lp), h,
                                 return_cache=True)
        x = x + out
        caches.append(cache)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return (logits(x, params["embed"]),
            SSMCache(*(torch.stack(ts) for ts in zip(*caches))))


def forward_decode(cfg: ModelConfig, params, tokens, caches: SSMCache):
    """One-token decode.  tokens (B, 1).  Returns (logits (B, 1, V) f32,
    the new caches)."""
    x = embed(tokens, params["embed"]).to(_act(cfg))
    new = []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["norm"], cfg.norm_eps)
        out, cache = mamba_decode_step(
            cfg, _layer_params(lp), h,
            SSMCache(*(t[i] for t in caches)))
        x = x + out
        new.append(cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (logits(x, params["embed"]),
            SSMCache(*(torch.stack(ts) for ts in zip(*new))))
