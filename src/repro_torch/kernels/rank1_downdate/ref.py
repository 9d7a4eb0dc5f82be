"""Plain PyTorch version of the rank-1 downdate kernel, batched over S.

Same math as ``repro/kernels/rank1_downdate/ref.py``: D and v in f32,
D − (Dv)vᵀ, cast back to D's dtype.  A CPU tensor runs this;
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch


def rank1_downdate_ref(D: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """D′ (S, m, d) = D − (D v) vᵀ per stream of D (S, m, d), v (S, d)."""
    Df = D.to(torch.float32)
    vf = v.to(torch.float32)
    p = torch.bmm(Df, vf.unsqueeze(-1))            # (S, m, 1)
    return (Df - p * vf[:, None, :]).to(D.dtype)
