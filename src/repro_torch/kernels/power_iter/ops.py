"""Public wrapper of the power-iteration kernel, batched over streams.

Counterpart of ``repro/kernels/power_iter/ops.py``.  The reference wrote
its wrapper for one (m, m) K and padded it to a multiple of 8; this one
takes the stream axis explicitly, K (S, m, m), and needs no padding.  A
CUDA tensor launches the hand-written kernel (``kernel.py``); a CPU tensor
runs the plain version (``ref.py``).  K is cast to f32, as the reference
casts it.

``floor_norm`` picks the norm floor: False is the reference kernel's
``sqrt(max(Σw², 1e-30))``, True the reference's inline krylov path's
``max(‖w‖, 1e-30)``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import kernel_work, use_kernel
from repro_torch.kernels.power_iter import kernel, ref


def work(S: int, m: int, iters: int):
    """(f32 operations, bytes) of one launch at (S, m, m), as its bound
    counts them: K read once, (λ̂, û) written; 2m² a step and the
    Rayleigh quotient."""
    return (S * ((iters + 1) * 2 * m * m + iters * 3 * m + 2 * m),
            4 * S * (m * m + 1 + m))


def power_iter(K: torch.Tensor, *, iters: int = 24, floor_norm: bool = False):
    """Top eigenpair (λ̂ (S,), û (S, m)) of every stream's PSD K, in one
    launch."""
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"power_iter: expected an (S, m, m) slab, got shape "
                         f"{tuple(K.shape)}")
    with kernel_work("power_iter", *work(K.shape[0], K.shape[1], iters)):
        if use_kernel(K):
            return kernel.power_iter_cuda(K.to(torch.float32).contiguous(),
                                          iters, floor_norm)
        return ref.power_iter_ref(K, iters, floor_norm)
