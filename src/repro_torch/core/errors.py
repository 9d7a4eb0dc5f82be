"""Covariance-error metrics (Problem 1 definitions) and the exact window
ground truth.  Counterpart of ``repro/core/errors.py``.

The metrics take torch tensors, batched or not, and compute in f32 as the
reference does.  :func:`window_gram` is the exact window covariance on the
tensor's device: a CUDA tensor launches the hand-written kernel
(``kernels/window_gram``), a CPU tensor runs its plain version.  The
``*_np`` functions are the reference's host versions over a numpy stream.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.window_gram.ops import window_gram as _window_gram


def spectral_norm(mat: torch.Tensor) -> torch.Tensor:
    """‖M‖₂ of a symmetric matrix (or a batch of them) via eigvalsh."""
    return torch.amax(torch.abs(torch.linalg.eigvalsh(mat)), dim=-1)


def window_gram(A: torch.Tensor) -> torch.Tensor:
    """Exact AᵀA in f32 of a window A (n, d) → (d, d), or of every
    stream's window A (S, n, d) → (S, d, d), in one launch on the card."""
    if A.dim() == 2:
        return _window_gram(A[None])[0]
    return _window_gram(A)


def cova_error(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """‖AᵀA − BᵀB‖₂, the paper's covariance error."""
    return cova_error_gram(window_gram(A), B)


def cova_error_gram(AtA: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """‖AᵀA − BᵀB‖₂, the paper's covariance error, from the exact Gram."""
    return spectral_norm(AtA - B.mT @ B)


def relative_error(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """‖AᵀA − BᵀB‖₂ / ‖A‖_F² (the metric reported in Figures 4-9)."""
    Af = A.to(torch.float32)
    return cova_error(A, B) / torch.clamp(torch.sum(Af * Af, dim=(-2, -1)),
                                          min=1e-30)


def window_gram_np(rows: np.ndarray, t: int, window: int) -> np.ndarray:
    """Exact A_WᵀA_W for the window (t−N, t] of a host-resident (n, d)
    stream; ``t`` is 1-indexed."""
    lo = max(t - window, 0)
    aw = rows[lo:t]
    return aw.T @ aw


def window_fro_np(rows: np.ndarray, t: int, window: int) -> float:
    """‖A_W‖_F² of the window (t−N, t]; ``t`` is 1-indexed."""
    lo = max(t - window, 0)
    aw = rows[lo:t]
    return float(np.sum(aw * aw))
