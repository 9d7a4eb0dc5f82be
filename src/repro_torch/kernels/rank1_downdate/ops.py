"""Public wrapper of the rank-1 downdate kernel, batched over streams.

Counterpart of ``repro/kernels/rank1_downdate/ops.py``.  The reference
wrote its wrapper for one (m, d) buffer and padded it to (8, 512) tiles;
this one takes the stream axis explicitly, D (S, m, d) and v (S, d), and
needs no padding.  A CUDA tensor launches the hand-written kernel
(``kernel.py``); a CPU tensor runs the plain version (``ref.py``).  D is
f32 or bf16 and D′ comes back in its dtype; v is used in f32, as the
reference casts it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import kernel_work, use_kernel
from repro_torch.kernels.rank1_downdate import kernel, ref


def work(S: int, m: int, d: int):
    """(f32 operations, bytes) of one launch at (S, m, d), as its bound
    counts them: D and v read, D′ written once; Dv and the outer product,
    4md a stream."""
    return S * 4 * m * d, 4 * S * (2 * m * d + d)


def rank1_downdate(D: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """D − (D v) vᵀ for every stream, in one launch."""
    if D.dim() != 3 or v.dim() != 2:
        raise ValueError(f"rank1_downdate: expected D (S, m, d) and v (S, d),"
                         f" got {tuple(D.shape)} and {tuple(v.shape)}")
    with kernel_work("rank1_downdate", *work(*D.shape)):
        if use_kernel(D):
            return kernel.rank1_downdate_cuda(
                D.contiguous(), v.to(torch.float32).contiguous())
        return ref.rank1_downdate_ref(D, v)
