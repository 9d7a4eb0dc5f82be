"""Public wrapper of the gram kernel, batched over streams.

Counterpart of ``repro/kernels/gram/ops.py``.  The reference wrote its
wrapper for one (m, d) buffer and padded it to (8, 128) tiles; this one
takes the stream axis explicitly, X (S, m, d), and needs no padding (the
kernel bounds its loops by the true m and d).  A CUDA tensor launches the
hand-written kernel (``kernel.py``); a CPU tensor runs the plain version
(``ref.py``).  X is f32 or bf16; K comes back in X's dtype, accumulated
in f32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import kernel_work, use_kernel
from repro_torch.kernels.gram import kernel, ref


def work(S: int, m: int, d: int, elt: int = 4):
    """(f32 operations, bytes) of one launch at (S, m, d), as its bound
    counts them: X read, K written once; a symmetric K's m(m+1)/2 dot
    products of length d."""
    return S * m * (m + 1) * d, S * (elt * m * d + 4 * m * m)


def gram(X: torch.Tensor) -> torch.Tensor:
    """K (S, m, m) = X Xᵀ for every stream, in one launch."""
    if X.dim() != 3:
        raise ValueError(f"gram: expected an (S, m, d) slab, got shape "
                         f"{tuple(X.shape)}")
    with kernel_work("gram", *work(*X.shape, X.element_size())):
        if use_kernel(X):
            return kernel.gram_cuda(X.contiguous())
        return ref.gram_ref(X)
