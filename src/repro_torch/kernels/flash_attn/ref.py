"""Plain PyTorch versions of the flash-attention forward (exact softmax
attention plus the log-sum-exp) and backward, in f32.

Counterpart of ``repro/kernels/flash_attn/ref.py`` (the forward) and of
the custom VJP's ``_bwd`` in ``repro/kernels/flash_attn/ops.py`` (the
backward).  They are what a CPU tensor runs and what ``chip_smoke.py``
holds the CUDA kernels against.
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


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True):
    """The flash identities of the reference's ``_bwd``, untiled, in f32:
    P = exp(q·kᵀ/√dh − lse) under the causal mask (−1e30, so masked
    entries are exactly 0), D = rowsum(dO∘O), dV = Pᵀ·dO,
    dS = P∘(dO·Vᵀ − D), dQ = dS·K/√dh, dK = dSᵀ·q/√dh; dK and dV summed
    over each GQA group onto its KV head.  ``lse`` is the forward's.
    Returns (dq, dk, dv) in the inputs' types."""
    BH, S, dh = q.shape
    BHkv = k.shape[0]
    G = BH // BHkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.float() * scale
    kr = torch.repeat_interleave(k, G, dim=0).float()
    vr = torch.repeat_interleave(v, G, dim=0).float()
    dof = do.float()
    D = torch.sum(dof * o.float(), dim=-1)                    # (BH, S)
    s = torch.matmul(qf, kr.mT)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.float()[..., None])
    ds = p * (torch.matmul(dof, vr.mT) - D[..., None])
    dq = torch.matmul(ds, kr) * scale
    dk = torch.matmul(ds.mT, qf).reshape(BHkv, G, S, dh).sum(1)
    dv = torch.matmul(p.mT, dof).reshape(BHkv, G, S, dh).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
