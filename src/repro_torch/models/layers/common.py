"""Shared layers: RMSNorm and LayerNorm, RoPE and M-RoPE, embedding and
logits.

Counterpart of ``repro/models/layers/common.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.parallel.sharding import (all_reduce, constrain,
                                           enter_group, tp_split)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``1 + scale`` gain, computed in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (the encoder-decoder family's): mean and variance in f32,
    then the gain and bias in f32, cast back to x's type."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _rope_freqs(dh: int, theta: float, device) -> torch.Tensor:
    """The dh/2 rotary frequencies θ^(−i/half), f32."""
    half = dh // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)


def _rope_angles(positions: torch.Tensor, dh: int,
                 theta: float) -> torch.Tensor:
    """positions (..., S) → angles (..., S, dh//2), f32."""
    return positions.float()[..., None] * _rope_freqs(dh, theta,
                                                      positions.device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the split halves (x1, x2) of each head of x (B, S, H, dh) by
    the angles (B, S, dh/2), in f32, cast back to x's type."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int.  Rotates the split halves
    (x1, x2) of each head, not interleaved pairs."""
    return _rotate(x, _rope_angles(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (B, S, H, dh); positions: (B, S, 3),
    the (t, h, w) ids of each token (text tokens carry t = h = w).  The
    dh/2 rotary frequencies are split into the three sections in order,
    and each section turns by its own id."""
    dh = x.shape[-1]
    half = dh // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"dh/2 = {half}")
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=half)                                     # (half,)
    pos = positions[..., sec_id].float()                      # (B, S, half)
    return _rotate(x, pos * _rope_freqs(dh, theta, x.device))


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` (V, D) at ``tokens``.  Where the rules put
    'vocab' on a model axis of processes (``tp_split``), ``table`` is this
    process's rows [m·V/M, (m+1)·V/M): it looks up the tokens in that
    range, gives 0 for the others, and the group's results are summed
    (one addend is nonzero, so the sum is the row itself)."""
    tp = tp_split("vocab", table)
    if tp is None:
        return constrain(table[tokens], "batch", "seq", "embed")
    m, _, group = tp
    V_l = table.shape[0]
    local = tokens.long() - m * V_l
    own = (local >= 0) & (local < V_l)
    rows = table[local.clamp(0, V_l - 1)]
    return all_reduce(torch.where(own[..., None], rows, rows.new_zeros(())),
                      group, "sum")


def logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ tableᵀ (D, V) → (B, S, V) in f32.  Where the rules
    put 'vocab' on a model axis of processes, x enters the model group and
    this process computes its (B, S, V/M) block from its rows of the
    table."""
    tp = tp_split("vocab", table)
    if tp is not None:
        x = enter_group(x, tp[2])
    out = torch.matmul(x.float(), table.float().t())
    return constrain(out, "batch", "seq", "vocab")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two, as ``jnp.einsum`` gives
    for mixed inputs (bf16 with f32 is f32); ``torch.matmul`` itself
    refuses mixed types."""
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(t), b.to(t))
