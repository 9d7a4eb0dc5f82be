"""Plain PyTorch versions of the fused krylov-tick kernels, batched over S.

Same math as ``repro/kernels/fused_tick/ref.py``: the uniform start
u₀ = 1/√m, and the ``sqrt(max(Σw², 1e-30))`` norm floor of the fused path.
``floor_norm=True`` takes the floor of the reference's inline krylov path
(``repro/core/dsfd.py:200,253``), ``max(‖w‖, 1e-30)``, instead; the two
differ only on vectors with Σw² < 1e-30.  A CPU tensor runs these; the
tests hold them against the reference, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.power_iter.ref import matvec, normalise, \
    power_iter_ref


def gram_power_ref(D: torch.Tensor, iters: int = 24, floor_norm: bool = False):
    """(λ̂ (S,), û (S, m)) of K = DDᵀ for each D of the (S, m, d) slab."""
    Df = D.to(torch.float32)
    return power_iter_ref(Df @ Df.mT, iters, floor_norm)


def fused_krylov_step_ref(D: torch.Tensor, lam: torch.Tensor, u: torch.Tensor,
                          iters: int = 24, floor_norm: bool = False):
    """One krylov dump step per stream.  D (S, m, d), lam (S,), u (S, m).
    Returns (snap (S, d), D′ (S, m, d), λ̂′ (S,), û′ (S, m))."""
    Df = D.to(torch.float32)
    sigma = torch.sqrt(torch.clamp(lam.to(torch.float32), min=1e-30))
    v = torch.bmm(u.to(torch.float32).unsqueeze(1), Df).squeeze(1) \
        / sigma[:, None]
    v = normalise(v, floor_norm)
    snap = sigma[:, None] * v
    D2 = Df - matvec(Df, v)[:, :, None] * v[:, None, :]
    lam2, u2 = power_iter_ref(D2 @ D2.mT, iters, floor_norm)
    return snap, D2.to(D.dtype), lam2, u2
