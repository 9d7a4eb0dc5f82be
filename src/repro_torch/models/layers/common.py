"""Shared layers: RMSNorm, RoPE, embedding and logits.

Counterpart of ``repro/models/layers/common.py`` (the dense family's part).
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``1 + scale`` gain, computed in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def _rope_angles(positions: torch.Tensor, dh: int,
                 theta: float) -> torch.Tensor:
    """positions (..., S) → angles (..., S, dh//2), f32."""
    half = dh // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    return positions.float()[..., None] * freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int.  Rotates the split halves
    (x1, x2) of each head, not interleaved pairs."""
    dh = x.shape[-1]
    ang = _rope_angles(positions, dh, theta)          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ tableᵀ (D, V) → (B, S, V) in f32."""
    return torch.matmul(x.float(), table.float().t())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two, as ``jnp.einsum`` gives
    for mixed inputs (bf16 with f32 is f32); ``torch.matmul`` itself
    refuses mixed types."""
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(t), b.to(t))
