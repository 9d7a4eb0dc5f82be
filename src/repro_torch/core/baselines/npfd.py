"""Host-side (numpy) FrequentDirections used by the baseline sketches."""

from __future__ import annotations

import numpy as np


class NpFD:
    """FastFD with a 2ℓ row buffer (Liberty 2013 / Ghashami et al. 2016)."""

    def __init__(self, ell: int, d: int):
        self.ell = int(max(1, min(ell, d)))
        self.d = int(d)
        self.buf = np.zeros((2 * self.ell, d), np.float32)
        self.nbuf = 0
        self.fro = 0.0  # Σ‖a‖² absorbed

    # -- core ---------------------------------------------------------------
    def _shrink(self) -> None:
        _, s, vt = np.linalg.svd(self.buf[: self.nbuf], full_matrices=False)
        k = min(self.ell - 1, len(s))
        s2 = np.maximum(s * s - (s[self.ell - 1] ** 2 if len(s) >= self.ell
                                 else 0.0), 0.0)
        rows = np.sqrt(s2)[:, None] * vt
        self.buf[:] = 0.0
        self.buf[: rows.shape[0]] = rows
        self.nbuf = k

    def update(self, row: np.ndarray) -> None:
        if self.nbuf >= self.buf.shape[0]:
            self._shrink()
        self.buf[self.nbuf] = row
        self.nbuf += 1
        self.fro += float(row @ row)
        if self.nbuf >= self.buf.shape[0]:
            self._shrink()

    def absorb(self, rows: np.ndarray) -> None:
        for r in rows:
            self.update(r)

    def merge(self, other: "NpFD") -> None:
        rows = other.rows()
        for r in rows:
            if self.nbuf >= self.buf.shape[0]:
                self._shrink()
            self.buf[self.nbuf] = r
            self.nbuf += 1
        self.fro += other.fro

    def rows(self) -> np.ndarray:
        return self.buf[: self.nbuf].copy()

    def query(self) -> np.ndarray:
        """ℓ-row sketch (shrinks the buffer if over-full)."""
        if self.nbuf > self.ell:
            self._shrink()
        return self.buf[: self.ell].copy()

    @property
    def n_rows_stored(self) -> int:
        return self.nbuf
