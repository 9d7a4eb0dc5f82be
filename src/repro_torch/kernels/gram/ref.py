"""Plain PyTorch version of the gram kernel, batched over S.

Same math as ``repro/kernels/gram/ref.py``: X in f32, K = X Xᵀ, cast back
to X's dtype.  A CPU tensor runs this; the tests hold it against the
reference, and ``chip_smoke.py`` holds the CUDA kernel against it on the
card.
"""

from __future__ import annotations

import torch


def gram_ref(X: torch.Tensor) -> torch.Tensor:
    """K (S, m, m) = X Xᵀ per stream of X (S, m, d), in X's dtype."""
    Xf = X.to(torch.float32)
    return (Xf @ Xf.mT).to(X.dtype)
