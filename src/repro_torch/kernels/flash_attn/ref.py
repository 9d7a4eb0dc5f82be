"""Plain PyTorch version of the flash-attention forward: exact softmax
attention plus the log-sum-exp, in f32.

Counterpart of ``repro/kernels/flash_attn/ref.py``.  It is what a CPU
tensor runs and what ``chip_smoke.py`` holds the CUDA kernel against.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True):
    """q: (BH, S, dh); k, v: (BHkv, S, dh), BH = BHkv·G, q head bh reading
    KV head bh // G.  Returns (o (BH, S, dh) in q's type, lse (BH, S) f32)."""
    BH, S, dh = q.shape
    G = BH // k.shape[0]
    kr = torch.repeat_interleave(k, G, dim=0).float()
    vr = torch.repeat_interleave(v, G, dim=0).float()
    s = torch.matmul(q.float(), kr.transpose(1, 2)) / math.sqrt(dh)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.matmul(p / l, vr)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse
