"""Public wrapper of the window-gram kernel, batched over streams.

Counterpart of ``repro/kernels/window_gram/ops.py``.  The reference wrote
its wrapper for one (n, d) window and padded it to (256, 128) tiles; this
one takes the stream axis explicitly, A (S, n, d), and needs no padding.
A CUDA tensor launches the hand-written kernel (``kernel.py``); a CPU
tensor runs the plain version (``ref.py``).  A is f32 or bf16; G is f32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import kernel_work, use_kernel
from repro_torch.kernels.window_gram import kernel, ref


def work(S: int, n: int, d: int, elt: int = 4):
    """(f32 operations, bytes) of one launch at (S, n, d), as its bound
    counts them: A read, G written once; a symmetric G's d(d+1)/2 dot
    products of length n."""
    return S * d * (d + 1) * n, S * (elt * n * d + 4 * d * d)


def window_gram(A: torch.Tensor) -> torch.Tensor:
    """G (S, d, d) = AᵀA for every stream's window, in one launch."""
    if A.dim() != 3:
        raise ValueError(f"window_gram: expected an (S, n, d) slab, got "
                         f"shape {tuple(A.shape)}")
    with kernel_work("window_gram", *work(*A.shape, A.element_size())):
        if use_kernel(A):
            return kernel.window_gram_cuda(A.contiguous())
        return ref.window_gram_ref(A)
