"""Plain PyTorch version of the power-iteration kernel, batched over S.

Same math as ``repro/kernels/power_iter/kernel.py`` (and its ``ref.py``):
K in f32, the uniform start u₀ = 1/√m, ``iters`` steps w = Ku,
u = w / √max(Σw², 1e-30), then λ̂ = uᵀKu.  ``floor_norm=True`` takes the
floor of the reference's inline krylov path (``repro/core/dsfd.py:200``),
w / max(‖w‖, 1e-30), instead; the two differ only on vectors with
Σw² < 1e-30.  A CPU tensor runs this; ``chip_smoke.py`` holds the CUDA
kernel against it on the card.  The fused-tick plain versions share it.
"""

from __future__ import annotations

import torch


def matvec(K: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K u per stream: K (S, m, n), u (S, n) → (S, m)."""
    return torch.bmm(K, u.unsqueeze(-1)).squeeze(-1)


def normalise(w: torch.Tensor, floor_norm: bool) -> torch.Tensor:
    """Rows of w over their norms, with the Σw² (False) or ‖w‖ (True)
    floor at 1e-30."""
    if floor_norm:
        return w / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True),
                               min=1e-30)
    return w / torch.sqrt(torch.clamp(torch.sum(w * w, dim=1, keepdim=True),
                                      min=1e-30))


def power_iter_ref(K: torch.Tensor, iters: int = 24,
                   floor_norm: bool = False):
    """Top eigenpair (λ̂ (S,), û (S, m)) of each PSD K (S, m, m)."""
    K = K.to(torch.float32)
    S, m = K.shape[0], K.shape[1]
    u0 = 1.0 / torch.sqrt(torch.tensor(float(m), dtype=torch.float32,
                                       device=K.device))
    u = u0.expand(S, m).clone()
    for _ in range(iters):
        u = normalise(matvec(K, u), floor_norm)
    lam = torch.sum(u * matvec(K, u), dim=1)
    return lam, u
