"""Whisper-large-v3: a 32-layer encoder and a 32-layer decoder with
LayerNorm, GELU MLPs, learned positions and cross-attention decode caches
(arXiv:2212.04356).

Counterpart of ``repro/models/whisper.py``.  The conv audio frontend is a
stub in both packages: the caller passes the (B, enc_frames, D) frame
embeddings after it as ``batch["frames"]``, and the encoder consumes them
directly; without them prefill and the training forward raise (the
reference's ``ServeEngine`` passes none and fails in ``encode``).  The
reference's ``lax.scan`` over the stacked ``(L, ...)`` layer weights is a
Python loop over the layer axis, and its ``jax.checkpoint`` a
``torch.utils.checkpoint`` per layer.

Three facts of the reference that the port keeps: ``wk`` has no bias; a
decode step reads slot 0's cache length as every slot's position; and
``forward_prefill`` returns a self-attention cache of exactly S slots, so
a decode step on it stores nothing (``kv_cache_append`` matches no slot)
while ``length`` still grows, and the new token attends to the S prompt
positions and not to itself.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.layers.attention import (KVCache, attention_any,
                                                 decode_attention,
                                                 full_attention,
                                                 kv_cache_append,
                                                 kv_cache_init)
from repro_torch.models.layers.common import embed, layer_norm, logits, \
    matmul
from repro_torch.models.layers.mlp import gelu_mlp
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import _act, _remat
from repro_torch.parallel.sharding import constrain

MAX_DEC_POS = 32_768   # the reference's: sized past Whisper's 448


def _attn_defs(L, D, H, dh, prefix=""):
    return {
        prefix + "wq": ParamDef((L, D, H * dh), (None, "embed", "heads")),
        prefix + "bq": ParamDef((L, H * dh), (None, "heads"), "zeros"),
        prefix + "wk": ParamDef((L, D, H * dh), (None, "embed", "heads")),
        prefix + "wv": ParamDef((L, D, H * dh), (None, "embed", "heads")),
        prefix + "bv": ParamDef((L, H * dh), (None, "heads"), "zeros"),
        prefix + "wo": ParamDef((L, H * dh, D), (None, "heads", "embed")),
        prefix + "bo": ParamDef((L, D), (None, "embed"), "zeros"),
    }


def _ln_defs(L, D, name):
    return {name + "_s": ParamDef((L, D), (None, "embed"), "ones"),
            name + "_b": ParamDef((L, D), (None, "embed"), "zeros")}


def _mlp_defs(L, D, F):
    return {
        "w_in": ParamDef((L, D, F), (None, "embed", "ff")),
        "b_in": ParamDef((L, F), (None, "ff"), "zeros"),
        "w_out": ParamDef((L, F, D), (None, "ff", "embed")),
        "b_out": ParamDef((L, D), (None, "embed"), "zeros"),
    }


def param_defs(cfg: ModelConfig) -> Dict:
    D, dh, H, F, V = (cfg.d_model, cfg.dh, cfg.n_heads, cfg.d_ff, cfg.vocab)
    Le, Ld = cfg.enc_layers, cfg.n_layers
    enc = {**_ln_defs(Le, D, "ln1"), **_attn_defs(Le, D, H, dh),
           **_ln_defs(Le, D, "ln2"), **_mlp_defs(Le, D, F)}
    dec = {**_ln_defs(Ld, D, "ln1"), **_attn_defs(Ld, D, H, dh),
           **_ln_defs(Ld, D, "ln2"), **_attn_defs(Ld, D, H, dh, "x_"),
           **_ln_defs(Ld, D, "ln3"), **_mlp_defs(Ld, D, F)}
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.01),
        "enc_pos": ParamDef((cfg.enc_frames, D), ("frames", "embed"),
                            scale=0.01),
        "dec_pos": ParamDef((MAX_DEC_POS, D), ("pos", "embed"), scale=0.01),
        "enc_final_s": ParamDef((D,), ("embed",), "ones"),
        "enc_final_b": ParamDef((D,), ("embed",), "zeros"),
        "dec_final_s": ParamDef((D,), ("embed",), "ones"),
        "dec_final_b": ParamDef((D,), ("embed",), "zeros"),
        "enc_layers": enc,
        "dec_layers": dec,
    }


def sharding_dims(cfg: ModelConfig) -> Dict[str, int]:
    return {"heads": cfg.n_heads, "kv": cfg.n_kv, "ff": cfg.d_ff,
            "vocab": cfg.vocab, "embed": cfg.d_model}


def _stack(params, stack: str, i: int) -> Dict[str, torch.Tensor]:
    return {name: w[i] for name, w in params[stack].items()}


def _proj_qkv(cfg: ModelConfig, lp, hq, hkv, prefix=""):
    B, Sq = hq.shape[:2]
    Skv = hkv.shape[1]
    H, dh = cfg.n_heads, cfg.dh
    q = matmul(hq, lp[prefix + "wq"]) + lp[prefix + "bq"]
    k = matmul(hkv, lp[prefix + "wk"])
    v = matmul(hkv, lp[prefix + "wv"]) + lp[prefix + "bv"]
    return (q.reshape(B, Sq, H, dh), k.reshape(B, Skv, H, dh),
            v.reshape(B, Skv, H, dh))


def _out(cfg: ModelConfig, lp, attn, prefix=""):
    B, S = attn.shape[:2]
    return (matmul(attn.reshape(B, S, cfg.n_heads * cfg.dh),
                   lp[prefix + "wo"]) + lp[prefix + "bo"])


def _mlp(cfg: ModelConfig, lp, x, norm: str):
    h = layer_norm(x, lp[norm + "_s"], lp[norm + "_b"], cfg.norm_eps)
    return x + gelu_mlp(h, lp["w_in"], lp["b_in"], lp["w_out"], lp["b_out"])


def _frames(cfg: ModelConfig, batch):
    """The batch's (B, enc_frames, D) frame embeddings, which an
    encoder-decoder batch must carry."""
    frames = batch.get("frames")
    B = batch["tokens"].shape[0]
    want = (B, cfg.enc_frames, cfg.d_model)
    if frames is None or tuple(frames.shape) != want:
        raise ValueError(
            f"{cfg.name} needs the (B, enc_frames, d_model) = {want} frame "
            "embeddings of its audio as batch['frames'] (its conv frontend "
            "is a stub); got " + ("none" if frames is None
                                  else f"shape {tuple(frames.shape)}"))
    return frames


def _enc_layer(cfg: ModelConfig, x, lp):
    h = layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
    q, k, v = _proj_qkv(cfg, lp, h, h)
    x = x + _out(cfg, lp, full_attention(q, k, v, causal=False))
    return _mlp(cfg, lp, x, "ln2")


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, enc_frames, D), the stub's embeddings → encoder states
    (B, enc_frames, D) in the activation type."""
    x = (frames + params["enc_pos"][None]).to(_act(cfg))
    x = constrain(x, "batch", "seq", "embed")
    layer = _remat(cfg, functools.partial(_enc_layer, cfg))
    for i in range(cfg.enc_layers):
        x = layer(x, _stack(params, "enc_layers", i))
    return layer_norm(x, params["enc_final_s"], params["enc_final_b"],
                      cfg.norm_eps)


def _dec_layer(cfg: ModelConfig, x, lp, enc_out):
    """One decoder layer over the whole prompt: causal self-attention,
    cross-attention to the encoder states, the MLP.  Returns the output
    and the layer's (k, v, kx, vx)."""
    h = layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
    q, k, v = _proj_qkv(cfg, lp, h, h)
    a = attention_any(q, k, v, causal=True,
                      chunk_threshold=cfg.attn_full_threshold,
                      chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    x = x + _out(cfg, lp, a)
    hx = layer_norm(x, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
    qx, kx, vx = _proj_qkv(cfg, lp, hx, enc_out, "x_")
    ax = attention_any(qx, kx, vx, causal=False,
                       chunk_threshold=cfg.attn_full_threshold)
    x = x + _out(cfg, lp, ax, "x_")
    return _mlp(cfg, lp, x, "ln3"), (k, v, kx, vx)


def _dec_layer_train(cfg: ModelConfig, x, lp, enc_out):
    return _dec_layer(cfg, x, lp, enc_out)[0]


def _dec_input(cfg: ModelConfig, params, tokens):
    S = tokens.shape[1]
    return (embed(tokens, params["embed"])
            + params["dec_pos"][:S][None]).to(_act(cfg))


def _final_logits(cfg: ModelConfig, params, x):
    x = layer_norm(x, params["dec_final_s"], params["dec_final_b"],
                   cfg.norm_eps)
    return logits(x, params["embed"])


def forward_train(cfg: ModelConfig, params, batch):
    """tokens (B, S) and frames → (logits (B, S, V) f32, aux = 0)."""
    frames = _frames(cfg, batch)
    enc_out = encode(cfg, params, frames)
    tokens = batch["tokens"]
    x = _dec_input(cfg, params, tokens)
    layer = _remat(cfg, functools.partial(_dec_layer_train, cfg))
    for i in range(cfg.n_layers):
        x = layer(x, _stack(params, "dec_layers", i), enc_out)
    return (_final_logits(cfg, params, x),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


class WhisperCache(NamedTuple):
    self_kv: KVCache           # stacked (Ld, ...)
    cross_k: torch.Tensor      # (Ld, B, frames, H, dh)
    cross_v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device="cuda") -> WhisperCache:
    """Stacked self-attention KV caches (Ld, B, s_max, H, dh) with their
    lengths (Ld, B), and empty cross K/V (Ld, B, enc_frames, H, dh); on
    the card unless ``device`` names the CPU."""
    device = resolve_device(device)
    one = kv_cache_init(batch, s_max, cfg.n_heads, cfg.dh, dtype, device)
    Ld = cfg.n_layers
    shape = (Ld, batch, cfg.enc_frames, cfg.n_heads, cfg.dh)
    return WhisperCache(
        self_kv=KVCache(*(t.expand((Ld,) + t.shape).clone() for t in one)),
        cross_k=torch.zeros(shape, dtype=dtype, device=device),
        cross_v=torch.zeros(shape, dtype=dtype, device=device))


def forward_prefill(cfg: ModelConfig, params, batch):
    """Encode, then run the decoder over the prompt, materialising the
    self and cross caches.  Returns (last-position logits (B, 1, V) f32,
    a ``WhisperCache`` whose self cache holds exactly the S prompt
    positions, ``length`` S)."""
    frames = _frames(cfg, batch)
    enc_out = encode(cfg, params, frames)
    tokens = batch["tokens"]
    B, S = tokens.shape
    act = _act(cfg)
    x = _dec_input(cfg, params, tokens)
    leaves = []
    for i in range(cfg.n_layers):
        x, kv = _dec_layer(cfg, x, _stack(params, "dec_layers", i), enc_out)
        leaves.append(tuple(t.to(act) for t in kv))
    ks, vs, kxs, vxs = (torch.stack(ts) for ts in zip(*leaves))
    cache = WhisperCache(
        self_kv=KVCache(k=ks, v=vs,
                        length=torch.full((cfg.n_layers, B), S,
                                          dtype=torch.int32,
                                          device=tokens.device)),
        cross_k=kxs, cross_v=vxs)
    return _final_logits(cfg, params, x[:, -1:]), cache


def forward_decode(cfg: ModelConfig, params, tokens,
                   caches: WhisperCache):
    """One-token decode.  tokens (B, 1); every slot takes slot 0's cache
    length as its position, as in the reference.  Returns (logits
    (B, 1, V) f32, the new caches; the cross K/V are carried as they
    are)."""
    B = tokens.shape[0]
    H, dh = cfg.n_heads, cfg.dh
    pos = torch.clamp(caches.self_kv.length[0][:1], 0, MAX_DEC_POS - 1)
    x = (embed(tokens, params["embed"])
         + params["dec_pos"].index_select(0, pos.long())[None]
         ).to(_act(cfg))
    new = []
    for i in range(cfg.n_layers):
        lp = _stack(params, "dec_layers", i)
        h = layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
        q, k, v = _proj_qkv(cfg, lp, h, h)
        cache = kv_cache_append(KVCache(*(t[i] for t in caches.self_kv)),
                                k, v)
        x = x + _out(cfg, lp, decode_attention(q, cache))
        hx = layer_norm(x, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
        qx = (matmul(hx, lp["x_wq"]) + lp["x_bq"]).reshape(B, 1, H, dh)
        ax = full_attention(qx, caches.cross_k[i], caches.cross_v[i],
                            causal=False)
        x = _mlp(cfg, lp, x + _out(cfg, lp, ax, "x_"), "ln3")
        new.append(cache)
    self_kv = KVCache(*(torch.stack(ts) for ts in zip(*new)))
    return (_final_logits(cfg, params, x),
            WhisperCache(self_kv=self_kv, cross_k=caches.cross_k,
                         cross_v=caches.cross_v))
