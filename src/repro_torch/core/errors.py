"""Covariance-error metrics (Problem 1 definitions) and the exact window
Gram on the host.  Counterpart of ``repro/core/errors.py``."""

from __future__ import annotations

import numpy as np
import torch


def spectral_norm(mat: torch.Tensor) -> torch.Tensor:
    """‖M‖₂ of a symmetric matrix (or a batch of them) via eigvalsh."""
    return torch.amax(torch.abs(torch.linalg.eigvalsh(mat)), dim=-1)


def cova_error_gram(AtA: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """‖AᵀA − BᵀB‖₂, the paper's covariance error, from the exact Gram."""
    return spectral_norm(AtA - B.mT @ B)


def window_gram_np(rows: np.ndarray, t: int, window: int) -> np.ndarray:
    """Exact A_WᵀA_W for the window (t−N, t] of a host-resident (n, d)
    stream; ``t`` is 1-indexed."""
    lo = max(t - window, 0)
    aw = rows[lo:t]
    return aw.T @ aw
