"""Decoder-only transformer: smollm-135m / qwen1.5-0.5b / minitron-4b /
llama3-8b (dense GQA), grok-1 / kimi-k2 (MoE) and qwen2-vl-2b (M-RoPE
VLM), training forward, prefill and decode.

Counterpart of ``repro/models/transformer.py``.  Pre-norm RMSNorm blocks,
RoPE or M-RoPE, SwiGLU or the MoE block (``models/layers/moe.py``, one
device), KV-cache prefill and decode.  The reference's ``lax.scan`` over
the stacked ``(L, ...)`` layer weights is a Python loop over the layer
axis; the weights keep the stacked layout, and its ``jax.checkpoint``
policies become ``torch.utils.checkpoint`` per layer.

Under a mesh of processes whose rules put 'heads', 'kv', 'ff' and 'vocab'
on the model axis (``train/loop.py::train_rules``), each process holds its
block of those leaves and the blocks are Megatron's: the QKV projections
and SwiGLU's ``wg``/``wu`` column-parallel after the input enters the
model group (``parallel/sharding.py::enter_group``: identity forward,
all-reduce backward), ``wo`` and ``wd`` row-parallel with their partial
outputs summed (``all_reduce``: all-reduce forward, identity backward),
the embedding a lookup in this process's rows summed over the group and
the logits this process's vocabulary block.  The residual stream is whole
and the same on every process.  Where the heads do not divide the axis the
attention stays whole; where the KV heads do not, each process takes the
KV heads its query heads read.

The VLM's vision frontend is a stub in both packages: its prefill and
training forward take the (B, S, 3) M-RoPE position ids from the caller
and raise without them (the reference has no default ids either; its
``ServeEngine`` passes none and fails in ``apply_mrope``).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils import checkpoint as tcp

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.attention import (KVCache, attention_any,
                                                 decode_attention,
                                                 kv_cache_append,
                                                 kv_cache_init)
from repro_torch.models.layers.common import (apply_mrope, apply_rope,
                                              embed, logits, matmul,
                                              rms_norm)
from repro_torch.models.layers.mlp import swiglu
from repro_torch.models.layers.moe import moe_block, virtual_expert_shapes
from repro_torch.models.params import ParamDef
from repro_torch.parallel.sharding import (all_reduce, axis_rules,
                                           constrain, constrain_divisible,
                                           current_mesh, current_rules,
                                           enter_group, model_size,
                                           tp_split)


def _msize() -> int:
    """The model axis's size in the mesh in force (1 without one): MoE
    expert shapes follow ``virtual_expert_shapes`` at it."""
    return model_size()


def param_defs(cfg: ModelConfig) -> Dict:
    L, D, dh = cfg.n_layers, cfg.d_model, cfg.dh
    H, KV, F, V = cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab
    layers: Dict = {
        "attn_norm": ParamDef((L, D), (None, "embed"), "zeros"),
        "wq": ParamDef((L, D, H * dh), (None, "embed", "heads")),
        "wk": ParamDef((L, D, KV * dh), (None, "embed", "kv")),
        "wv": ParamDef((L, D, KV * dh), (None, "embed", "kv")),
        "wo": ParamDef((L, H * dh, D), (None, "heads", "embed")),
        "mlp_norm": ParamDef((L, D), (None, "embed"), "zeros"),
    }
    if cfg.qkv_bias:
        layers["bq"] = ParamDef((L, H * dh), (None, "heads"), "zeros")
        layers["bk"] = ParamDef((L, KV * dh), (None, "kv"), "zeros")
        layers["bv"] = ParamDef((L, KV * dh), (None, "kv"), "zeros")
    if cfg.moe:
        E = cfg.moe.n_experts
        E_v, Fv = virtual_expert_shapes(cfg.moe, D, _msize())
        layers["wr"] = ParamDef((L, D, E), (None, "embed", None))
        layers["wg"] = ParamDef((L, E_v, D, Fv),
                                (None, "experts", "embed", "expert_ff"))
        layers["wu"] = ParamDef((L, E_v, D, Fv),
                                (None, "experts", "embed", "expert_ff"))
        layers["wd"] = ParamDef((L, E_v, Fv, D),
                                (None, "experts", "expert_ff", "embed"))
    else:
        layers["wg"] = ParamDef((L, D, F), (None, "embed", "ff"))
        layers["wu"] = ParamDef((L, D, F), (None, "embed", "ff"))
        layers["wd"] = ParamDef((L, F, D), (None, "ff", "embed"))
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.01),
        "final_norm": ParamDef((D,), ("embed",), "zeros"),
        "layers": layers,
    }
    if not cfg.tied_embeddings:
        defs["lm_head"] = ParamDef((V, D), ("vocab", "embed"), scale=0.01)
    return defs


def sharding_dims(cfg: ModelConfig) -> Dict[str, int]:
    """Logical dimension sizes that ``make_rules`` tests for divisibility."""
    dims = {"heads": cfg.n_heads, "kv": cfg.n_kv, "ff": cfg.d_ff,
            "vocab": cfg.vocab, "embed": cfg.d_model}
    if cfg.moe:
        E_v, _ = virtual_expert_shapes(cfg.moe, cfg.d_model, _msize())
        dims["experts"] = E_v
        dims["expert_ff"] = 0           # stays unsharded (EP is on model)
        dims["ff"] = 0
    return dims


def _act(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def _layer(params, i: int) -> Dict[str, torch.Tensor]:
    return {name: w[i] for name, w in params["layers"].items()}


def _rope(cfg: ModelConfig, x, positions):
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def _positions(cfg: ModelConfig, batch, tokens):
    """The batch's position ids: (B, S, 3) M-RoPE ids, which a VLM batch
    must carry, or (B, S) ids, 0..S-1 by default."""
    positions = batch.get("positions")
    B, S = tokens.shape
    if cfg.mrope_sections is not None:
        if positions is None or tuple(positions.shape) != (B, S, 3):
            raise ValueError(
                f"{cfg.name} needs the (B, S, 3) = ({B}, {S}, 3) M-RoPE "
                "position ids of its tokens as batch['positions'] (its "
                "vision frontend is a stub); got "
                + ("none" if positions is None
                   else f"shape {tuple(positions.shape)}"))
        return positions
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    return positions


def _kv_heads(cfg: ModelConfig, m: int, M: int):
    """The KV heads that process ``m`` of ``M`` needs where its query heads
    are split and the KV heads are not: a slice of whole heads where its
    H/M query heads read them in groups as the whole model's do (query
    head h reads KV head h // G), else one KV head per query head (groups
    of one)."""
    H_l, G = cfg.n_heads // M, cfg.n_heads // cfg.n_kv
    want = [(m * H_l + j) // G for j in range(H_l)]
    lo, n = want[0], want[-1] + 1 - want[0]
    if H_l % n == 0 and want == [lo + j // (H_l // n) for j in range(H_l)]:
        return slice(lo * cfg.dh, (lo + n) * cfg.dh)
    return torch.tensor([h * cfg.dh + i for h in want for i in range(cfg.dh)])


def _kv_block(w: torch.Tensor, cols, group) -> torch.Tensor:
    """This process's KV columns of a whole ``wk``/``wv``/``bk``/``bv``:
    the leaf enters the model group, so its gradient is the sum of the
    processes' partial ones (each computes its own heads' part)."""
    w = enter_group(w, group)
    if isinstance(cols, slice):
        return w[..., cols]
    return w.index_select(-1, cols.to(w.device))


def _qkv(cfg: ModelConfig, lp, h, positions):
    """q (B, S, H, dh), k and v (B, S, KV, dh), rotated.  Where the rules
    put 'heads' on a model axis of processes (``tp_split``) the
    projections are column-parallel: the normed input enters the model
    group, and H and KV are this process's counts (H/M, and KV/M or the
    KV heads its query heads read, ``_kv_heads``)."""
    B, S, _ = h.shape
    dh = cfg.dh
    wk, wv = lp["wk"], lp["wv"]
    bk, bv = (lp["bk"], lp["bv"]) if cfg.qkv_bias else (None, None)
    tp = tp_split("heads", lp["wq"])
    if tp is not None:
        m, M, group = tp
        h = enter_group(h, group)
        if tp_split("kv", wk) is None:
            cols = _kv_heads(cfg, m, M)
            wk, wv = _kv_block(wk, cols, group), _kv_block(wv, cols, group)
            if cfg.qkv_bias:
                bk, bv = _kv_block(bk, cols, group), _kv_block(bv, cols,
                                                              group)
    q = matmul(h, lp["wq"])
    k = matmul(h, wk)
    v = matmul(h, wv)
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + bk, v + bv
    # a DTensor's sharded dimension splits into heads only where the heads
    # divide its shards: lay the projections out by heads first
    q = constrain_divisible(q, "batch", "seq_attn", "heads")
    k = constrain_divisible(k, "batch", "seq_attn", "kv")
    v = constrain_divisible(v, "batch", "seq_attn", "kv")
    q = q.reshape(B, S, q.shape[-1] // dh, dh)
    k = k.reshape(B, S, k.shape[-1] // dh, dh)
    v = v.reshape(B, S, v.shape[-1] // dh, dh)
    # 'seq_attn' is live only where the heads cannot shard over 'model':
    # sequence-parallel attention in place of replicated head compute
    q = constrain_divisible(q, "batch", "seq_attn", "heads", None)
    k = constrain_divisible(k, "batch", "seq_attn", "kv", None)
    if cfg.rope_theta:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    return q, k, v


def _mlp(cfg: ModelConfig, lp, h):
    """The feed-forward block and its balance loss (0 for SwiGLU).  Where
    the rules put 'ff' on a model axis of processes, SwiGLU is
    column-parallel in ``wg`` and ``wu`` and row-parallel in ``wd``: the
    input enters the model group and the partial outputs are summed."""
    if cfg.moe:
        return moe_block(h, lp["wr"], lp["wg"], lp["wu"], lp["wd"],
                         moe=cfg.moe)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    tp = tp_split("ff", lp["wg"])
    if tp is None:
        return swiglu(h, lp["wg"], lp["wu"], lp["wd"]), zero
    group = tp[2]
    y = swiglu(enter_group(h, group), lp["wg"], lp["wu"], lp["wd"])
    return all_reduce(y, group, "sum"), zero


def _attn_out_and_mlp(cfg: ModelConfig, lp, x, attn):
    """The rest of a pre-norm block once attention is done: the output
    projection and residual, then the MLP and its residual.  Returns the
    block's output and the MLP's balance loss.  With the heads split over
    a model axis of processes ``wo`` is row-parallel: this process's
    heads' projection, summed over the group."""
    B, S, _ = x.shape
    attn = matmul(attn.reshape(B, S, -1), lp["wo"])
    tp = tp_split("heads", lp["wo"])
    if tp is not None:
        attn = all_reduce(attn, tp[2], "sum")
    x = x + constrain(attn, "batch", "seq", "embed")
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    y, aux = _mlp(cfg, lp, h2)
    return x + y, aux


def _layer_train(cfg: ModelConfig, x, lp, positions):
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    h = constrain_divisible(h, "batch", "seq_attn", "embed")
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
    also keeps its matrix products, "none" keeps everything.  The
    recompute runs under the mesh and rules in force at the forward: on
    the card it runs on autograd's device thread, which does not hold the
    caller's (a process mesh's expert-parallel layer needs them)."""
    if cfg.remat == "none":
        return body
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "minimal":
        kw = {"context_fn": functools.partial(
            tcp.create_selective_checkpoint_contexts, _save_matmuls)}
    else:
        raise ValueError(f"remat {cfg.remat!r} not in ('none', 'minimal', "
                         "'full')")

    def run(*args):
        mesh = current_mesh()
        fn = body if mesh is None else _under(body, mesh, current_rules())
        return tcp.checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def _under(body, mesh, rules):
    def call(*args):
        with axis_rules(mesh, rules):
            return body(*args)
    return call


def _check_blocks(cfg: ModelConfig, params) -> None:
    """Where the rules split 'vocab', 'heads', 'kv' or 'ff' over a model
    axis of M processes, each must hold 1/M of the leaves they lay out:
    a process that holds them whole under such rules raises."""
    lay = params["layers"]
    dh = cfg.dh
    checks = [("vocab", params["embed"], 0, cfg.vocab),
              ("heads", lay["wq"], -1, cfg.n_heads * dh),
              ("kv", lay["wk"], -1, cfg.n_kv * dh)]
    if not cfg.moe:
        checks.append(("ff", lay["wg"], -1, cfg.d_ff))
    for name, leaf, dim, whole in checks:
        tp = tp_split(name, leaf)
        if tp is not None and leaf.shape[dim] * tp[1] != whole:
            raise ValueError(
                f"the rules split '{name}' over {tp[1]} processes, but this "
                f"process holds {leaf.shape[dim]} of its {whole} entries in "
                f"a leaf of shape {tuple(leaf.shape)}: hold this process's "
                "block (convert.local_params)")


def forward_train(cfg: ModelConfig, params, batch
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V) f32, aux): aux is the MoE
    balance loss averaged over the layers, 0 for the dense family.  Where
    the rules put 'vocab' on a model axis of processes the logits are this
    process's (B, S, V/M) block (``train_step.py::loss_fn`` reduces over
    the group)."""
    _check_blocks(cfg, params)
    tokens = batch["tokens"]
    positions = _positions(cfg, batch, tokens)
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
    positions = _positions(cfg, batch, tokens)
    act = _act(cfg)
    x = embed(tokens, params["embed"]).to(act)

    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        h = constrain_divisible(h, "batch", "seq_attn", "embed")
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
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(pos.shape[0], 1, 3)        # t = h = w
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
