"""Analytic MODEL_FLOPS per (arch × shape): the "useful compute" numerator
of a roofline share, 6·N_active·tokens (train) or 2·N_active·tokens
(inference forward), plus the quadratic attention term.

Counterpart of ``repro/launch/flops.py``, the same arithmetic over the
port's configs, so the two give the same numbers for every config and
``SHAPES`` cell.

Counting conventions (standard MFU accounting):
* matmul params only (norms/embedding-lookup excluded; the logits matmul
  counts as V·D).
* causal attention scores: 2·S²·H·dh per layer forward (the ½ from
  causality cancels the 2 matmuls QKᵀ and AV: 2·(2·S²·H·dh)/2).
* MoE counts only routed-active expert params (top_k × 3·D·d_expert).
* SSD (mamba2) per-token state flops ≈ 6·d_inner·d_state fwd — the three
  chunk matmuls (decay·x→state, state carry, state→y); documented approx.
* decode shapes are one step: tokens = global_batch, and the attention
  term reads the full S-long KV cache: 4·S·H·dh per layer per token fwd.

The encoder-decoder's prefill and decode are not its work: like the
reference, they count the encoder's weights once per *decoder* token and
never over the frames, and the GELU MLP as 3·D·F where it has 2·D·F.  A
Whisper bound must be counted from the model's own shapes.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec


def _dense_layer_params(cfg: ModelConfig) -> float:
    D, dh = cfg.d_model, cfg.dh
    qkvo = D * cfg.n_heads * dh + 2 * D * cfg.n_kv * dh + cfg.n_heads * dh * D
    if cfg.moe:
        mlp = D * cfg.moe.n_experts + cfg.moe.top_k * 3 * D * cfg.moe.d_expert
    else:
        mlp = 3 * D * cfg.d_ff
    return float(qkvo + mlp)


def _mamba_layer_params(cfg: ModelConfig) -> float:
    s = cfg.ssm
    D = cfg.d_model
    d_inner = s.expand * D
    heads = d_inner // s.headdim
    in_p = D * (2 * d_inner + 2 * s.n_groups * s.d_state + heads)
    out_p = d_inner * D
    ssd = 3 * d_inner * s.d_state          # ≈ per-token state matmuls
    return float(in_p + out_p + ssd)


def _rg_layer_params(cfg: ModelConfig, kind: str) -> float:
    D, dh = cfg.d_model, cfg.dh
    w = cfg.rglru.lru_width or D
    if kind == "attn":
        qkvo = D * cfg.n_heads * dh + 2 * D * cfg.n_kv * dh \
            + cfg.n_heads * dh * D
        blk = qkvo
    else:
        # rg-lru block: x/gate projections D→w, gates 2·w (diag-ish), out w→D
        blk = 2 * D * w + w * D
    return float(blk + 3 * D * cfg.d_ff)


def active_matmul_params(cfg: ModelConfig) -> float:
    """N_active — matmul params touched per token (logits included)."""
    logits_p = float(cfg.vocab * cfg.d_model)
    if cfg.family == "ssm":
        return cfg.n_layers * _mamba_layer_params(cfg) + logits_p
    if cfg.family == "hybrid":
        pat = cfg.rglru.pattern
        per_block = sum(_rg_layer_params(cfg, k) for k in pat) / len(pat)
        return cfg.n_layers * per_block + logits_p
    per = _dense_layer_params(cfg)
    total = cfg.n_layers * per
    if cfg.family == "encdec":
        # encoder: self-attn with n_heads==n_kv + mlp, over enc_frames
        total += cfg.enc_layers * _dense_layer_params(cfg)
        # decoder cross-attn (already not in per; approx: add q,o + kv once)
        total += cfg.n_layers * (2 * cfg.d_model * cfg.n_heads * cfg.dh)
    return total + logits_p


def _attn_positions(cfg: ModelConfig) -> bool:
    return cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid")


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Total useful FLOPs for one step of this cell (all chips)."""
    B, S = shape.global_batch, shape.seq_len
    N = active_matmul_params(cfg)
    H = cfg.n_heads
    dh = cfg.dh if H else 0           # attn-free (mamba2): no attention term
    if shape.kind == "train":
        flops = 6.0 * N * B * S
        if _attn_positions(cfg):
            layers = cfg.n_layers
            if cfg.family == "hybrid":
                # only 1-in-3 blocks attend, over a local window
                pat = cfg.rglru.pattern
                frac = pat.count("attn") / len(pat)
                w = min(cfg.rglru.local_window, S)
                flops += 3 * 2.0 * B * S * w * H * dh * layers * frac
            else:
                flops += 3 * 2.0 * B * S * S / 2 * H * dh * layers * 2
        if cfg.family == "encdec":
            F = cfg.enc_frames
            flops += 3 * 4.0 * B * F * F * H * dh * cfg.enc_layers / 2
        return flops
    if shape.kind == "prefill":
        flops = 2.0 * N * B * S
        if _attn_positions(cfg):
            if cfg.family == "hybrid":
                pat = cfg.rglru.pattern
                frac = pat.count("attn") / len(pat)
                w = min(cfg.rglru.local_window, S)
                flops += 2.0 * B * S * w * H * dh * cfg.n_layers * frac * 2
            else:
                flops += 2.0 * B * S * S * H * dh * cfg.n_layers
        return flops
    # decode: one token per sequence against an S-long cache
    flops = 2.0 * N * B
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        flops += 4.0 * B * S * cfg.n_kv * (H // max(cfg.n_kv, 1)) * dh \
            * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.rglru.pattern
        frac = pat.count("attn") / len(pat)
        w = min(cfg.rglru.local_window, S)
        flops += 4.0 * B * w * H * dh * cfg.n_layers * frac
    return flops
