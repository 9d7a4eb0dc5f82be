"""Vector-stream sources (§7.1).  Counterpart of ``repro/data/streams.py``
for the SYNTHETIC set, kept as this package's own copy.

``synthetic`` is the paper's Random Noisy matrix A = S·D·U + N/ζ,
generated exactly as the reference generates it from the same seed.
``SyntheticSource`` draws the same model in chunks with U fixed once, so a
long fleet stream never has to exist whole on the host; its ``k`` is the
signal dimension of Ghashami et al.'s form of the model (S has k columns,
D_ii = 1 − (i−1)/k, U is k×d), and ``k = d`` is the paper's set.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    name: str
    rows: np.ndarray                  # (n, d) float32
    window: int                       # the paper's window size N
    timestamps: Optional[np.ndarray]  # int64 (time-based) or None (seq)

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    @property
    def d(self) -> int:
        return self.rows.shape[1]


def synthetic(n: int = 500_000, d: int = 300, zeta: float = 10.0,
              window: int = 100_000, seed: int = 0) -> StreamSpec:
    """The paper's Random Noisy matrix: A = S·D·U + N/ζ  (§7.1).

    S: (n, d) N(0,1) signal coefficients; D diagonal with
    D_ii = 1 − (i−1)/d; U a random orthonormal basis; N: N(0,1)."""
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((n, d)).astype(np.float32)
    Dd = (1.0 - np.arange(d) / d).astype(np.float32)
    U, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float32))
    noise = rng.standard_normal((n, d)).astype(np.float32) / zeta
    rows = (S * Dd[None, :]) @ U.T + noise
    return StreamSpec("SYNTHETIC", rows.astype(np.float32), window, None)


class SyntheticSource:
    """Rows of A = S·D·U + N/ζ drawn chunk by chunk from one generator,
    optionally scaled to unit norm (the normalised Problem 1.1)."""

    def __init__(self, d: int = 300, *, k: Optional[int] = None,
                 zeta: float = 10.0, seed: int = 0, unit: bool = True):
        self.d, self.k = int(d), int(d if k is None else k)
        if not 1 <= self.k <= self.d:
            raise ValueError(f"signal dimension k={self.k} outside [1, {d}]")
        self.zeta, self.unit = float(zeta), bool(unit)
        self.rng = np.random.default_rng(seed)
        self.Dd = (1.0 - np.arange(self.k) / self.k).astype(np.float32)
        U, _ = np.linalg.qr(
            self.rng.standard_normal((self.d, self.d)).astype(np.float32))
        self.U = np.ascontiguousarray(U[:, :self.k].T)     # (k, d)

    def rows(self, n: int) -> np.ndarray:
        """The next ``n`` rows, (n, d) float32."""
        S = self.rng.standard_normal((n, self.k)).astype(np.float32)
        noise = self.rng.standard_normal((n, self.d)).astype(np.float32)
        rows = (S * self.Dd[None, :]) @ self.U + noise / self.zeta
        if self.unit:
            rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        return rows.astype(np.float32)


_GENERATORS = {"synthetic": synthetic}


def get_stream(name: str, scale: float = 1.0, seed: int = 0) -> StreamSpec:
    """Build a dataset, optionally scaled down: ``scale`` < 1 shrinks n
    and the window proportionally (d unchanged)."""
    gen = _GENERATORS[name.lower()]
    defaults = inspect.signature(gen).parameters
    n = max(int(defaults["n"].default * scale), 1_000)
    window = max(int(defaults["window"].default * scale), 200)
    return gen(n=n, window=window, seed=seed)
