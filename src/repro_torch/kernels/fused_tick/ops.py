"""Public wrappers of the fused krylov-tick kernels, batched over streams.

Counterpart of ``repro/kernels/fused_tick/ops.py``.  The reference wrote
its wrappers for one stream and got the fleet from ``jax.vmap``; these take
the stream axis explicitly: D (S, m, d), λ̂ (S,), û (S, m).  A CUDA tensor
launches the hand-written kernel (``kernel.py``, one CTA per stream); a CPU
tensor runs the plain version (``ref.py``).  No padding is needed: the
kernel bounds every loop by the true m and d.

``floor_norm`` picks the norm floor: False is the fused path's
``sqrt(max(Σw², 1e-30))``, True the reference's inline path's
``max(‖w‖, 1e-30)``.  Either way the tensor's device alone decides
between kernel and plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.fused_tick import kernel, ref


def _slab(D: torch.Tensor) -> torch.Tensor:
    if D.dim() != 3:
        raise ValueError(f"expected an (S, m, d) slab, got shape "
                         f"{tuple(D.shape)}")
    return D.to(torch.float32).contiguous()


def gram_power(D: torch.Tensor, *, iters: int = 24, floor_norm: bool = False):
    """(λ̂ (S,), û (S, m)) of K = DDᵀ for every stream, in one launch."""
    D = _slab(D)
    if use_kernel(D):
        return kernel.gram_power_cuda(D, iters, floor_norm)
    return ref.gram_power_ref(D, iters, floor_norm)


def fused_krylov_step(D: torch.Tensor, lam: torch.Tensor, u: torch.Tensor,
                      *, iters: int = 24, floor_norm: bool = False):
    """One krylov dump step for every stream, in one launch: v-extraction,
    snapshot, rank-1 downdate, Gram and power iteration.
    Returns (snap (S, d), D′ (S, m, d), λ̂′ (S,), û′ (S, m))."""
    D = _slab(D)
    lam = lam.to(torch.float32).contiguous()
    u = u.to(torch.float32).contiguous()
    if use_kernel(D):
        return kernel.fused_krylov_step_cuda(D, lam, u, iters, floor_norm)
    return ref.fused_krylov_step_ref(D, lam, u, iters, floor_norm)
