"""Decoder-only dense transformer: smollm-135m / qwen1.5-0.5b / minitron-4b
/ llama3-8b (GQA), prefill and decode.

Counterpart of ``repro/models/transformer.py`` for the dense family.
Pre-norm RMSNorm blocks, RoPE, SwiGLU, KV-cache prefill and decode.  The
reference's ``lax.scan`` over the stacked ``(L, ...)`` layer weights is a
Python loop over the layer axis; the weights keep the stacked layout.
MoE, M-RoPE and training come in later slices (ROADMAP item 15).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, not_ported
from repro_torch.models.layers.attention import (KVCache, attention_any,
                                                 decode_attention,
                                                 kv_cache_append,
                                                 kv_cache_init)
from repro_torch.models.layers.common import (apply_rope, embed, logits,
                                              matmul, rms_norm)
from repro_torch.models.layers.mlp import swiglu
from repro_torch.models.params import ParamDef


def _dense_only(cfg: ModelConfig) -> None:
    """Refuse what a dense-family config could name but the port lacks."""
    if cfg.moe:
        raise not_ported(f"the MoE block of {cfg.name}")
    if cfg.mrope_sections is not None:
        raise not_ported(f"M-RoPE of {cfg.name}")


def param_defs(cfg: ModelConfig) -> Dict:
    _dense_only(cfg)
    L, D, dh = cfg.n_layers, cfg.d_model, cfg.dh
    H, KV, F, V = cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab
    layers: Dict = {
        "attn_norm": ParamDef((L, D), "zeros"),
        "wq": ParamDef((L, D, H * dh)),
        "wk": ParamDef((L, D, KV * dh)),
        "wv": ParamDef((L, D, KV * dh)),
        "wo": ParamDef((L, H * dh, D)),
        "mlp_norm": ParamDef((L, D), "zeros"),
        "wg": ParamDef((L, D, F)),
        "wu": ParamDef((L, D, F)),
        "wd": ParamDef((L, F, D)),
    }
    if cfg.qkv_bias:
        layers["bq"] = ParamDef((L, H * dh), "zeros")
        layers["bk"] = ParamDef((L, KV * dh), "zeros")
        layers["bv"] = ParamDef((L, KV * dh), "zeros")
    defs = {
        "embed": ParamDef((V, D), scale=0.01),
        "final_norm": ParamDef((D,), "zeros"),
        "layers": layers,
    }
    if not cfg.tied_embeddings:
        defs["lm_head"] = ParamDef((V, D), scale=0.01)
    return defs


def _act(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def _layer(params, i: int) -> Dict[str, torch.Tensor]:
    return {name: w[i] for name, w in params["layers"].items()}


def _rope(cfg: ModelConfig, x, positions):
    return apply_rope(x, positions, cfg.rope_theta)


def _qkv(cfg: ModelConfig, lp, h, positions):
    B, S, _ = h.shape
    dh = cfg.dh
    q = matmul(h, lp["wq"])
    k = matmul(h, lp["wk"])
    v = matmul(h, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, cfg.n_heads, dh)
    k = k.reshape(B, S, cfg.n_kv, dh)
    v = v.reshape(B, S, cfg.n_kv, dh)
    if cfg.rope_theta:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    return q, k, v


def _attn_out_and_mlp(cfg: ModelConfig, lp, x, attn):
    """The rest of a pre-norm block once attention is done: the output
    projection and residual, then the MLP and its residual."""
    B, S, _ = x.shape
    x = x + matmul(attn.reshape(B, S, cfg.n_heads * cfg.dh), lp["wo"])
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + swiglu(h2, lp["wg"], lp["wu"], lp["wd"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    """Stacked per-layer KV caches: k, v (L, B, s_max, Hkv, dh), length
    (L, B); on the card unless ``device`` names the CPU."""
    one = kv_cache_init(batch, s_max, cfg.n_kv, cfg.dh, dtype, device)
    return KVCache(*(t.expand((cfg.n_layers,) + t.shape).clone()
                     for t in one))


def _final_logits(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params.get("lm_head", params["embed"])
    return logits(x, table)


def forward_prefill(cfg: ModelConfig, params, batch):
    """Prefill: the full-sequence forward that also materialises the KV
    caches.  Returns (last-position logits (B, 1, V) f32, stacked caches
    whose ``length`` is S for every layer and sequence)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    act = _act(cfg)
    x = embed(tokens, params["embed"]).to(act)

    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        attn = attention_any(q, k, v, causal=True,
                             chunk_threshold=cfg.attn_full_threshold,
                             chunk_q=cfg.attn_chunk_q,
                             chunk_kv=cfg.attn_chunk_kv,
                             use_flash=cfg.use_flash)
        x = _attn_out_and_mlp(cfg, lp, x, attn)
        ks.append(k.to(act))
        vs.append(v.to(act))
    caches = KVCache(k=torch.stack(ks), v=torch.stack(vs),
                     length=torch.full((cfg.n_layers, B), S,
                                       dtype=torch.int32,
                                       device=tokens.device))
    return _final_logits(cfg, params, x[:, -1:]), caches


def forward_decode(cfg: ModelConfig, params, tokens, caches: KVCache):
    """One-token decode.  tokens (B, 1); caches = stacked KVCache.  Returns
    (logits (B, 1, V) f32, the new caches)."""
    pos = caches.length[0][:, None].to(torch.int32)           # (B, 1)
    x = embed(tokens, params["embed"]).to(_act(cfg))
    new = []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, pos)
        cache = kv_cache_append(
            KVCache(caches.k[i], caches.v[i], caches.length[i]), k, v)
        x = _attn_out_and_mlp(cfg, lp, x, decode_attention(q, cache))
        new.append(cache)
    caches = KVCache(*(torch.stack(ts) for ts in zip(*new)))
    return _final_logits(cfg, params, x), caches
