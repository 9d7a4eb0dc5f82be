"""RecurrentGemma-9B: the Griffin hybrid (arXiv:2402.19427), RG-LRU
recurrent blocks and MQA local attention 2 : 1, GeGLU MLPs, a ring KV cache
of ``local_window`` positions and an O(1) recurrent state.

Counterpart of ``repro/models/recurrentgemma.py``, with its fixed layout:
``N_GROUPS`` = 12 groups of (rec, mlp, rec, mlp, attn, mlp), stacked
``(12, ...)`` under ``groups``, then ``N_TAIL`` = 2 (rec, mlp) pairs under
``tail``: 38 mixing layers whatever ``cfg.n_layers`` says, as in the
reference (``reduced()`` builds 38 too).  The reference's ``lax.scan``
over the groups is a Python loop.

As in the reference, decode turns every slot's queries and keys by one
position, slot 0's cache length (ROADMAP §3 note (l)); a batch whose
slots hold different lengths decodes all but slot 0 at another position
than their own.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.attention import (KVCache, attention_any,
                                                 decode_attention,
                                                 kv_cache_append,
                                                 kv_cache_init)
from repro_torch.models.layers.common import (apply_rope, embed, logits,
                                              matmul, rms_norm)
from repro_torch.models.layers.rglru import (_N_BLOCKS, RGLRUCache,
                                             causal_conv1d, gelu,
                                             recurrent_block,
                                             recurrent_block_decode,
                                             rglru_scan)
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import _act, _remat
from repro_torch.parallel.sharding import constrain
from repro_torch.tree import map_dicts

N_GROUPS = 12      # (rec, mlp, rec, mlp, attn, mlp) groups
N_TAIL = 2         # trailing (rec, mlp) pairs: 38 = 12·3 + 2


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def _rec_defs(L, D, R, K):
    bw = R // _N_BLOCKS
    return {
        "norm": ParamDef((L, D), (None, "embed"), "zeros"),
        "w_branch1": ParamDef((L, D, R), (None, "embed", "lru")),
        "w_branch2": ParamDef((L, D, R), (None, "embed", "lru")),
        "conv_w": ParamDef((L, K, R), (None, "conv", "lru"), scale=0.2),
        "conv_b": ParamDef((L, R), (None, "lru"), "zeros"),
        "w_a": ParamDef((L, _N_BLOCKS, bw, bw), (None, None, None, None)),
        "b_a": ParamDef((L, R), (None, "lru"), "zeros"),
        "w_x": ParamDef((L, _N_BLOCKS, bw, bw), (None, None, None, None)),
        "b_x": ParamDef((L, R), (None, "lru"), "zeros"),
        "lam": ParamDef((L, R), (None, "lru"), "ones"),
        "w_out": ParamDef((L, R, D), (None, "lru", "embed")),
    }


def _mlp_defs(L, D, F):
    return {
        "norm": ParamDef((L, D), (None, "embed"), "zeros"),
        "wg": ParamDef((L, D, F), (None, "embed", "ff")),
        "wu": ParamDef((L, D, F), (None, "embed", "ff")),
        "wd": ParamDef((L, F, D), (None, "ff", "embed")),
    }


def _attn_defs(L, D, H, KV, dh):
    return {
        "norm": ParamDef((L, D), (None, "embed"), "zeros"),
        "wq": ParamDef((L, D, H * dh), (None, "embed", "heads")),
        "wk": ParamDef((L, D, KV * dh), (None, "embed", "kv")),
        "wv": ParamDef((L, D, KV * dh), (None, "embed", "kv")),
        "wo": ParamDef((L, H * dh, D), (None, "heads", "embed")),
    }


def param_defs(cfg: ModelConfig) -> Dict:
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    R, K = _lru_width(cfg), cfg.rglru.conv_k
    G = N_GROUPS
    groups = {
        "rec1": _rec_defs(G, D, R, K), "mlp1": _mlp_defs(G, D, F),
        "rec2": _rec_defs(G, D, R, K), "mlp2": _mlp_defs(G, D, F),
        "attn": _attn_defs(G, D, H, KV, dh), "mlp3": _mlp_defs(G, D, F),
    }
    tail = {
        "rec": _rec_defs(N_TAIL, D, R, K), "mlp": _mlp_defs(N_TAIL, D, F),
    }
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.01),
        "final_norm": ParamDef((D,), ("embed",), "zeros"),
        "groups": groups,
        "tail": tail,
    }


def sharding_dims(cfg: ModelConfig) -> Dict[str, int]:
    return {"heads": cfg.n_heads, "kv": cfg.n_kv, "ff": cfg.d_ff,
            "vocab": cfg.vocab, "lru": _lru_width(cfg),
            "embed": cfg.d_model}


def _at(tree, i: int):
    """Entry ``i`` of every stacked leaf of a dict tree."""
    return map_dicts(lambda w: w[i], tree)


def _embed(cfg: ModelConfig, params, tokens):
    """The embedding scaled by √D, the scale taken in the activation type
    first, as in the reference."""
    act = _act(cfg)
    e = embed(tokens, params["embed"])
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32,
                                    device=e.device)).to(act)
    t = torch.promote_types(e.dtype, act)
    return (e.to(t) * scale.to(t)).to(act)


def _gelu_mlp(cfg: ModelConfig, lp, x):
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    g = gelu(matmul(h, lp["wg"]))
    u = matmul(h, lp["wu"])
    hh = constrain(g * u, "batch", "seq", "ff")
    return x + constrain(matmul(hh, lp["wd"]), "batch", "seq", "embed")


def _rec_layer(cfg: ModelConfig, lp, x):
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    return x + recurrent_block(cfg, lp, h)


def _qkv(cfg: ModelConfig, lp, h, positions):
    B, S, _ = h.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    q = matmul(h, lp["wq"]).reshape(B, S, H, dh)
    k = matmul(h, lp["wk"]).reshape(B, S, KV, dh)
    v = matmul(h, lp["wv"]).reshape(B, S, KV, dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _attn_layer(cfg: ModelConfig, lp, x, positions):
    """Local MQA attention over the window; returns (x + attn, (k, v)).
    The flash kernel's gate refuses a window, so this never takes it (the
    reference does not offer it either)."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, positions)
    a = attention_any(q, k, v, causal=True, window=cfg.rglru.local_window,
                      chunk_threshold=cfg.attn_full_threshold,
                      chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    a = matmul(a.reshape(B, S, cfg.n_heads * cfg.dh), lp["wo"])
    return x + constrain(a, "batch", "seq", "embed"), (k, v)


def _group_train(cfg: ModelConfig, x, gp, positions):
    x = _gelu_mlp(cfg, gp["mlp1"], _rec_layer(cfg, gp["rec1"], x))
    x = _gelu_mlp(cfg, gp["mlp2"], _rec_layer(cfg, gp["rec2"], x))
    x, _ = _attn_layer(cfg, gp["attn"], x, positions)
    return _gelu_mlp(cfg, gp["mlp3"], x)


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device).expand(B, S)


def forward_train(cfg: ModelConfig, params, batch):
    """tokens (B, S) → (logits (B, S, V) f32, aux = 0)."""
    tokens = batch["tokens"]
    positions = _positions(tokens)
    x = _embed(cfg, params, tokens)
    group = _remat(cfg, functools.partial(_group_train, cfg))
    for i in range(N_GROUPS):
        x = group(x, _at(params["groups"], i), positions)
    for i in range(N_TAIL):
        tp = _at(params["tail"], i)
        x = _gelu_mlp(cfg, tp["mlp"], _rec_layer(cfg, tp["rec"], x))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (logits(x, params["embed"]),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


class RGCache(NamedTuple):
    rec1: RGLRUCache       # stacked (N_GROUPS, ...)
    rec2: RGLRUCache
    attn: KVCache          # ring caches of min(local_window, s_max) slots
    tail: RGLRUCache       # stacked (N_TAIL, ...)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device="cuda") -> RGCache:
    """Empty LRU states (f32), conv windows and ring KV caches of
    ``min(local_window, s_max)`` slots, on the card unless ``device``
    names the CPU."""
    R, K = _lru_width(cfg), cfg.rglru.conv_k
    W = min(cfg.rglru.local_window, s_max)
    one_kv = kv_cache_init(batch, W, cfg.n_kv, cfg.dh, dtype, device)
    dev = one_kv.k.device

    def rec(n):
        return RGLRUCache(
            h=torch.zeros((n, batch, R), dtype=torch.float32, device=dev),
            conv=torch.zeros((n, batch, K - 1, R), dtype=dtype, device=dev))

    return RGCache(
        rec1=rec(N_GROUPS), rec2=rec(N_GROUPS),
        attn=KVCache(*(t.expand((N_GROUPS,) + t.shape).clone()
                       for t in one_kv)),
        tail=rec(N_TAIL))


def _rec_with_cache(cfg: ModelConfig, lp, x):
    """A recurrent layer over the prompt that also gives its decode cache:
    the last LRU state and the conv's last K − 1 inputs."""
    S, K = x.shape[1], cfg.rglru.conv_k
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    y1 = gelu(matmul(h, lp["w_branch1"]))
    x2 = matmul(h, lp["w_branch2"])
    hseq = rglru_scan(lp, causal_conv1d(x2, lp["conv_w"], lp["conv_b"]))
    out = matmul(y1 * hseq, lp["w_out"])
    cache = RGLRUCache(h=hseq[:, -1].float(),
                       conv=x2[:, S - (K - 1):, :].to(_act(cfg)))
    return x + out, cache


def _stack(caches, cls):
    return cls(*(torch.stack(ts) for ts in zip(*caches)))


def forward_prefill(cfg: ModelConfig, params, batch):
    """The whole-prompt forward that also gives the decode caches: final
    LRU states, conv windows and each attention layer's last
    ``min(local_window, S)`` keys and values with length S.  Returns
    (last-position logits (B, 1, V) f32, the caches)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(tokens)
    W = min(cfg.rglru.local_window, S)
    act = _act(cfg)
    x = _embed(cfg, params, tokens)
    c1s, c2s, kvs, tails = [], [], [], []
    for i in range(N_GROUPS):
        gp = _at(params["groups"], i)
        x, c1 = _rec_with_cache(cfg, gp["rec1"], x)
        x = _gelu_mlp(cfg, gp["mlp1"], x)
        x, c2 = _rec_with_cache(cfg, gp["rec2"], x)
        x = _gelu_mlp(cfg, gp["mlp2"], x)
        x, (k, v) = _attn_layer(cfg, gp["attn"], x, positions)
        kvs.append(KVCache(
            k=k[:, S - W:].to(act), v=v[:, S - W:].to(act),
            length=torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)))
        x = _gelu_mlp(cfg, gp["mlp3"], x)
        c1s.append(c1)
        c2s.append(c2)
    for i in range(N_TAIL):
        tp = _at(params["tail"], i)
        x, ct = _rec_with_cache(cfg, tp["rec"], x)
        x = _gelu_mlp(cfg, tp["mlp"], x)
        tails.append(ct)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return logits(x, params["embed"]), RGCache(
        rec1=_stack(c1s, RGLRUCache), rec2=_stack(c2s, RGLRUCache),
        attn=_stack(kvs, KVCache), tail=_stack(tails, RGLRUCache))


def forward_decode(cfg: ModelConfig, params, tokens, caches: RGCache):
    """One-token decode.  tokens (B, 1).  Every slot takes slot 0's
    position (note (l)).  Returns (logits (B, 1, V) f32, the new caches)."""
    B = tokens.shape[0]
    pos = caches.attn.length[0][:1][:, None].expand(B, 1).to(torch.int32)
    x = _embed(cfg, params, tokens)

    def rec_step(lp, x, cache):
        h = rms_norm(x, lp["norm"], cfg.norm_eps)
        out, cache = recurrent_block_decode(cfg, lp, h, cache)
        return x + out, cache

    def attn_step(lp, x, cache):
        h = rms_norm(x, lp["norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, pos)
        cache = kv_cache_append(cache, k, v, ring=True)
        a = decode_attention(q, cache, window=cfg.rglru.local_window)
        return x + matmul(a.reshape(B, 1, cfg.n_heads * cfg.dh),
                          lp["wo"]), cache

    def at(cache, i):
        return type(cache)(*(t[i] for t in cache))

    c1s, c2s, kvs, tails = [], [], [], []
    for i in range(N_GROUPS):
        gp = _at(params["groups"], i)
        x, c1 = rec_step(gp["rec1"], x, at(caches.rec1, i))
        x = _gelu_mlp(cfg, gp["mlp1"], x)
        x, c2 = rec_step(gp["rec2"], x, at(caches.rec2, i))
        x = _gelu_mlp(cfg, gp["mlp2"], x)
        x, kv = attn_step(gp["attn"], x, at(caches.attn, i))
        x = _gelu_mlp(cfg, gp["mlp3"], x)
        c1s.append(c1)
        c2s.append(c2)
        kvs.append(kv)
    for i in range(N_TAIL):
        tp = _at(params["tail"], i)
        x, tc = rec_step(tp["rec"], x, at(caches.tail, i))
        x = _gelu_mlp(cfg, tp["mlp"], x)
        tails.append(tc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits(x, params["embed"]), RGCache(
        rec1=_stack(c1s, RGLRUCache), rec2=_stack(c2s, RGLRUCache),
        attn=_stack(kvs, KVCache), tail=_stack(tails, RGLRUCache))
