"""DI-FD — FrequentDirections over Dyadic Intervals (Arasu & Manku 2004;
Wei et al. 2016).  §2.2 of the paper.

Levels j = 0..J partition the timeline into aligned intervals of length
N/2ʲ; level j intervals carry FD sketches of size ℓⱼ = max(1, ⌈ℓ·2⁻ʲ·(J+1)⌉)
so every level stores ≈ ℓ·(J+1) rows across the window and the total space is
O(d/ε·log(1/ε)).  A query decomposes the window into ≤ 2 aligned intervals
per level (dyadic suffix decomposition) and FD-merges their sketches.

This is the practical variant used for the paper's comparison figures; the
exact constants in Wei et al. differ but the error/space trade-off curve is
parameter-swept in the benchmarks either way (as the paper does).
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.baselines.npfd import NpFD


class DIFD:
    def __init__(self, d: int, eps: float, window: int, *, R: float = 1.0):
        self.d = d
        self.eps = eps
        self.window = int(window)
        self.ell = int(max(1, min(round(1.0 / eps), d)))
        self.J = max(1, int(np.ceil(np.log2(max(1.0 / eps, 2.0) * max(R, 1.0)))))
        # interval length per level (level j: N / 2^j, floored at 1)
        self.len_j = [max(1, self.window // (2 ** j)) for j in range(self.J + 1)]
        self.ell_j = [max(1, int(np.ceil(self.ell * (self.J + 1) / (2 ** j))))
                      for j in range(self.J + 1)]
        # open + sealed sketches per (level, interval_index)
        self.sketches: Dict[Tuple[int, int], NpFD] = {}
        self.t = 0

    def update(self, row: np.ndarray, t: int | None = None) -> None:
        self.t = int(t) if t is not None else self.t + 1
        for j in range(self.J + 1):
            idx = (self.t - 1) // self.len_j[j]
            key = (j, idx)
            fd = self.sketches.get(key)
            if fd is None:
                fd = NpFD(min(self.ell_j[j], self.d), self.d)
                self.sketches[key] = fd
            fd.update(row)
        self._expire()

    def _expire(self) -> None:
        horizon = self.t - self.window
        dead = []
        for (j, idx) in self.sketches:
            end = (idx + 1) * self.len_j[j]
            if end <= horizon:
                dead.append((j, idx))
        for k in dead:
            del self.sketches[k]

    def combine(self, other: "DIFD") -> "DIFD":
        """Native merge of two DI-FDs that watched *disjoint rows of the
        same timeline* (the sharded-fleet case): dyadic intervals are
        timestamp-aligned, so sketches at the same (level, index) FD-merge
        pairwise.  Mutates and returns ``self``."""
        if (other.d, other.window, other.J) != (self.d, self.window, self.J):
            raise ValueError("combine requires identically-configured DIFDs")
        for key, fd in other.sketches.items():
            mine = self.sketches.get(key)
            if mine is None:
                # deep copy: adopting other's live NpFD by reference would
                # let later updates to either DIFD mutate the other
                self.sketches[key] = copy.deepcopy(fd)
            else:
                mine.merge(fd)
        self.t = max(self.t, other.t)
        self._expire()
        return self

    def query(self) -> np.ndarray:
        """Dyadic suffix decomposition of [t-N+1, t]."""
        lo, hi = self.t - self.window + 1, self.t
        out = NpFD(self.ell, self.d)
        pos = max(lo, 1)
        # Greedy: at each position use the coarsest aligned interval fully
        # inside [pos, hi].
        guard = 0
        while pos <= hi and guard < 4 * (self.J + 2):
            guard += 1
            used = False
            for j in range(self.J + 1):          # coarse → fine
                L = self.len_j[j]
                if (pos - 1) % L == 0 and pos + L - 1 <= hi:
                    fd = self.sketches.get((j, (pos - 1) // L))
                    if fd is not None:
                        out.absorb(fd.rows())
                    pos += L
                    used = True
                    break
            if not used:
                # finest open interval straddles hi — include it and stop
                j = self.J
                fd = self.sketches.get((j, (pos - 1) // self.len_j[j]))
                if fd is not None:
                    out.absorb(fd.rows())
                pos += self.len_j[j]
        return out.rows()

    @property
    def n_rows_stored(self) -> int:
        return sum(fd.n_rows_stored for fd in self.sketches.values())
