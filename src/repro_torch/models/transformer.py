"""Decoder-only transformer: smollm-135m / qwen1.5-0.5b / minitron-4b /
llama3-8b (dense GQA) and grok-1 / kimi-k2 (MoE), training forward,
prefill and decode.

Counterpart of ``repro/models/transformer.py`` for the dense and MoE
families.  Pre-norm RMSNorm blocks, RoPE, SwiGLU or the MoE block
(``models/layers/moe.py``, one device), KV-cache prefill and decode.  The
reference's ``lax.scan`` over the stacked ``(L, ...)`` layer weights is a
Python loop over the layer axis; the weights keep the stacked layout, and
its ``jax.checkpoint`` policies become ``torch.utils.checkpoint`` per
layer.  M-RoPE comes in a later slice (ROADMAP item 15).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils import checkpoint as tcp

from repro_torch.configs.base import ModelConfig, not_ported
from repro_torch.models.layers.attention import (KVCache, attention_any,
                                                 decode_attention,
                                                 kv_cache_append,
                                                 kv_cache_init)
from repro_torch.models.layers.common import (apply_rope, embed, logits,
                                              matmul, rms_norm)
from repro_torch.models.layers.mlp import swiglu
from repro_torch.models.layers.moe import moe_block, virtual_expert_shapes
from repro_torch.models.params import ParamDef


def _check_ported(cfg: ModelConfig) -> None:
    """Refuse what a config of this family could name but the port lacks."""
    if cfg.mrope_sections is not None:
        raise not_ported(f"M-RoPE of {cfg.name}")


def param_defs(cfg: ModelConfig) -> Dict:
    _check_ported(cfg)
    L, D, dh = cfg.n_layers, cfg.d_model, cfg.dh
    H, KV, F, V = cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab
    layers: Dict = {
        "attn_norm": ParamDef((L, D), "zeros"),
        "wq": ParamDef((L, D, H * dh)),
        "wk": ParamDef((L, D, KV * dh)),
        "wv": ParamDef((L, D, KV * dh)),
        "wo": ParamDef((L, H * dh, D)),
        "mlp_norm": ParamDef((L, D), "zeros"),
    }
    if cfg.moe:
        # one device: model-axis size 1, so no virtual split
        E_v, Fv = virtual_expert_shapes(cfg.moe, D, 1)
        layers["wr"] = ParamDef((L, D, cfg.moe.n_experts))
        layers["wg"] = ParamDef((L, E_v, D, Fv))
        layers["wu"] = ParamDef((L, E_v, D, Fv))
        layers["wd"] = ParamDef((L, E_v, Fv, D))
    else:
        layers["wg"] = ParamDef((L, D, F))
        layers["wu"] = ParamDef((L, D, F))
        layers["wd"] = ParamDef((L, F, D))
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


def _mlp(cfg: ModelConfig, lp, h):
    """The feed-forward block and its balance loss (0 for SwiGLU)."""
    if cfg.moe:
        return moe_block(h, lp["wr"], lp["wg"], lp["wu"], lp["wd"],
                         moe=cfg.moe)
    return (swiglu(h, lp["wg"], lp["wu"], lp["wd"]),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _attn_out_and_mlp(cfg: ModelConfig, lp, x, attn):
    """The rest of a pre-norm block once attention is done: the output
    projection and residual, then the MLP and its residual.  Returns the
    block's output and the MLP's balance loss."""
    B, S, _ = x.shape
    x = x + matmul(attn.reshape(B, S, cfg.n_heads * cfg.dh), lp["wo"])
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    y, aux = _mlp(cfg, lp, h2)
    return x + y, aux


def _layer_train(cfg: ModelConfig, x, lp, positions):
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, positions)
    attn = attention_any(q, k, v, causal=True,
                         chunk_threshold=cfg.attn_full_threshold,
                         chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
                         use_flash=cfg.use_flash)
    return _attn_out_and_mlp(cfg, lp, x, attn)


_SAVED_BY_MINIMAL = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The policy of ``remat="minimal"``: keep the matrix products' outputs
    (the reference's ``dots_with_no_batch_dims_saveable``), recompute the
    rest."""
    del ctx, args, kwargs
    return (tcp.CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_MINIMAL
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, body):
    """``body`` under the config's remat policy: "full" keeps only the
    layer's inputs and recomputes its forward in the backward, "minimal"
    also keeps its matrix products, "none" keeps everything."""
    if cfg.remat == "full":
        return functools.partial(tcp.checkpoint, body, use_reentrant=False)
    if cfg.remat == "minimal":
        return functools.partial(
            tcp.checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(
                tcp.create_selective_checkpoint_contexts, _save_matmuls))
    if cfg.remat == "none":
        return body
    raise ValueError(f"remat {cfg.remat!r} not in ('none', 'minimal', "
                     "'full')")


def forward_train(cfg: ModelConfig, params, batch
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V) f32, aux): aux is the MoE
    balance loss averaged over the layers, 0 for the dense family."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    x = embed(tokens, params["embed"]).to(_act(cfg))
    layer = _remat(cfg, functools.partial(_layer_train, cfg))
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.n_layers):
        x, a = layer(x, _layer(params, i), positions)
        aux = aux + a
    return _final_logits(cfg, params, x), aux / cfg.n_layers


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
        x, _ = _attn_out_and_mlp(cfg, lp, x, attn)
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
        x, _ = _attn_out_and_mlp(cfg, lp, x, decode_attention(q, cache))
        new.append(cache)
    caches = KVCache(*(torch.stack(ts) for ts in zip(*new)))
    return _final_logits(cfg, params, x), caches
