"""Top-r eigenbasis of the windowed covariance a stack of sketch rows
(snapshots ∪ FD residual) represents, batched over streams.

Counterpart of ``repro/sketch/basis.py``, whose functions take one
stream's (k, d) stack; here every argument carries the stream axis S
first.  The (k, k) Gram K = rows·rowsᵀ (k = cap + m ≪ d) is formed by the
port's ``gram`` (the hand-written f32 kernel on the card, its plain
version on the CPU, never TF32, so a score that feeds a threshold sees
f32 products), and ``torch.linalg.eigh`` gives its eigenpairs as
``jnp.linalg.eigh`` does in the reference (in f64, see ``topr_basis``);
left eigenvectors map back to right singular directions of the row
space.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.gram.ops import gram


def topr_basis(rows: torch.Tensor, r: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-r (eigenvalues (S, r), right-singular basis (S, r, d)) of
    rowsᵀrows for each stream of ``rows`` (S, k, d).

    Eigenvalues are sorted descending; the basis rows are orthonormal (up
    to rounding) and zero where the spectrum is empty."""
    r = min(r, rows.shape[1])
    rows = rows.to(torch.float32)
    # K in f32 from the gram kernel; its eigenpairs in f64: LAPACK's f32
    # solver (MKL's ssyevd) fails to converge on some K whose empty ring
    # slots leave most of it zero
    lam, U = torch.linalg.eigh(gram(rows).double())      # ascending
    lam, U = lam.float(), U.float()
    lam = lam.flip(-1)[:, :r]
    U = U.flip(-1)[:, :, :r]                             # (S, k, r)
    safe = torch.sqrt(torch.clamp(lam, min=1e-12))
    V = (U.mT @ rows) / safe[..., None]                  # (S, r, d)
    live = (lam > 1e-10).to(torch.float32)               # no energy → 0
    return lam * live, V * live[..., None]


def project_rank_r(X: torch.Tensor, V: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the rows of ``X`` (S, n, d) onto the orthonormal bases ``V``
    (S, r, d): the coefficients X Vᵀ and the reconstruction coef·V."""
    coef = X @ V.mT
    return coef, coef @ V


def residual_scores(rows: torch.Tensor, X) -> torch.Tensor:
    """(S, n) residual anomaly scores: for each stream, the energy of each
    row of ``X`` ((n, d) shared by every stream, or (S, n, d)) outside the
    row space of its sketch stack ``rows`` (S, k, d), ``‖x‖² − ‖x Vᵀ‖²``
    clamped at 0, with V the full orthonormal basis of that row space."""
    _, V = topr_basis(rows, rows.shape[1])
    X = torch.as_tensor(X).to(device=rows.device, dtype=torch.float32)
    if X.dim() == 2:
        X = X.expand(rows.shape[0], *X.shape)
    coef = X @ V.mT
    tot = torch.sum(X * X, dim=-1)
    cap = torch.sum(coef * coef, dim=-1)
    return torch.clamp(tot - cap, min=0.0)


def subspace_overlap(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """``‖V_a V_bᵀ‖_F²`` (S,) for orthonormal (S, r, d) bases: r where the
    spans coincide, 0 where they are orthogonal."""
    m = va @ vb.mT
    return torch.sum(m * m, dim=(-2, -1))
