"""Plain PyTorch version of the window-gram kernel, batched over S.

Same math as ``repro/kernels/window_gram/ref.py``: A in f32, G = AᵀA in
f32.  A CPU tensor runs this; ``chip_smoke.py`` holds the CUDA kernel
against it on the card.
"""

from __future__ import annotations

import torch


def window_gram_ref(A: torch.Tensor) -> torch.Tensor:
    """G (S, d, d) = AᵀA per stream of A (S, n, d), in f32."""
    Af = A.to(torch.float32)
    return Af.mT @ Af
