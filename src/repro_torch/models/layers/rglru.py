"""The RG-LRU recurrent block of Griffin / RecurrentGemma (arXiv:2402.19427).

    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)
    a_t = exp(−c · softplus(Λ) · r_t),  r_t, i_t = σ(blockdiag gates(x_t))

Counterpart of ``repro/models/layers/rglru.py``.  Training and prefill
solve the linear recurrence over the whole sequence; the reference does it
with ``jax.lax.associative_scan`` over the pairs (a, b) under
(a, b) ∘ (a', b') = (a·a', a'·b + b'), and the port with the same operator
in a doubling scan: ⌈log₂ S⌉ rounds, each combining every position with
the one 2^k before it, in f32 (9 rounds at S = 512, against S steps of a
loop).  Decode carries (h, the conv window), O(1) in the sequence.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.common import matmul
from repro_torch.parallel.sharding import constrain

_C = 8.0
_N_BLOCKS = 16  # block-diagonal gate heads, as RecurrentGemma's


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in f32 with the tanh approximation (``jax.nn.gelu``'s default),
    cast back to x's type."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def _blocked_gate(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: (..., R) → σ(blockdiag(w)·x + b);  w: (nb, R/nb, R/nb)."""
    nb, bw, _ = w.shape
    xs = x.reshape(x.shape[:-1] + (nb, bw))
    out = torch.einsum("...ni,nij->...nj", xs, w)
    return torch.sigmoid(out.reshape(x.shape) + b)


def _rglru_coeffs(p, xb: torch.Tensor):
    """The recurrence's (a, b) for each position: a the decay, b the gated
    input √(1 − a²)·(i ⊙ x), both f32."""
    xf = xb.float()
    r = _blocked_gate(xf, p["w_a"].float(), p["b_a"].float())
    i = _blocked_gate(xf, p["w_x"].float(), p["b_x"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * xf)
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t from h_{-1} = 0 over dim 1, by doubling:
    after the round of stride d each (a_t, b_t) composes the ≤ 2d
    positions ending at t."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(p, xb: torch.Tensor) -> torch.Tensor:
    """The RG-LRU over whole sequences.  xb: (B, S, R), the conv's output."""
    a, gated = _rglru_coeffs(p, xb)
    return linear_scan(a, gated).to(xb.dtype)


class RGLRUCache(NamedTuple):
    h: torch.Tensor        # (B, R) the recurrent state, f32
    conv: torch.Tensor     # (B, K-1, R) the conv window


def rglru_decode_step(p, xb: torch.Tensor, h: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb: (B, 1, R); h: (B, R) → (y (B, 1, R), the new h)."""
    a, gated = _rglru_coeffs(p, xb[:, 0])
    h_new = a * h + gated
    return h_new.to(xb.dtype)[:, None], h_new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, no activation (Griffin applies none here)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return (sum(xp[:, i:i + S, :] * w[i] for i in range(K)) + b).to(x.dtype)


def recurrent_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Griffin's recurrent block: a GELU branch gating the conv → RG-LRU
    branch.  x: (B, S, D)."""
    del cfg
    y1 = gelu(matmul(x, p["w_branch1"]))
    x2 = causal_conv1d(matmul(x, p["w_branch2"]), p["conv_w"], p["conv_b"])
    x2 = constrain(x2, "batch", "seq", "lru")
    out = matmul(y1 * rglru_scan(p, x2), p["w_out"])
    return constrain(out, "batch", "seq", "embed")


def recurrent_block_decode(cfg: ModelConfig, p, x: torch.Tensor,
                           cache: RGLRUCache
                           ) -> Tuple[torch.Tensor, RGLRUCache]:
    """One token of the recurrent block.  x: (B, 1, D)."""
    del cfg
    y1 = gelu(matmul(x, p["w_branch1"]))
    x2 = matmul(x, p["w_branch2"])
    K = p["conv_w"].shape[0]
    window = torch.cat([cache.conv, x2.to(cache.conv.dtype)], dim=1)
    x2c = (sum(window[:, i, :] * p["conv_w"][i] for i in range(K))
           + p["conv_b"]).to(x.dtype)[:, None]
    h_out, h_new = rglru_decode_step(p, x2c, cache.h)
    return (matmul(y1 * h_out, p["w_out"]),
            RGLRUCache(h=h_new, conv=window[:, 1:]))
