"""LM-FD — FrequentDirections inside the Exponential Histogram framework
(Datar et al. 2002; Wei et al. 2016).  §2.2 of the paper.

Blocks are FD sketches over disjoint stream segments.  Level k holds blocks
of energy quota q·2ᵏ; when a level exceeds ``b`` blocks its two oldest merge
into the next level.  Queries FD-merge every non-expired block (the oldest,
window-straddling block is the εN error source).  Space O(d/ε²) for b = 1/ε.
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.baselines.npfd import NpFD


class _Block:
    __slots__ = ("fd", "start", "end", "energy", "level")

    def __init__(self, fd: NpFD, start: int, end: int, energy: float,
                 level: int):
        self.fd, self.start, self.end = fd, start, end
        self.energy, self.level = energy, level


class LMFD:
    def __init__(self, d: int, eps: float, window: int, *,
                 blocks_per_level: int | None = None):
        self.d = d
        self.eps = eps
        self.window = int(window)
        self.ell = int(max(1, min(round(1.0 / eps), d)))
        self.b = int(blocks_per_level or max(2, round(1.0 / eps)))
        self.q0 = float(self.ell)           # level-0 energy quota
        self.levels: List[List[_Block]] = [[]]
        self.active = NpFD(self.ell, d)
        self.active_start = 1
        self.active_energy = 0.0
        self.t = 0

    # -- update --------------------------------------------------------------
    def update(self, row: np.ndarray, t: int | None = None) -> None:
        self.t = int(t) if t is not None else self.t + 1
        if self.active_energy == 0.0:
            self.active_start = self.t
        self.active.update(row)
        self.active_energy += float(row @ row)
        if self.active_energy >= self.q0:
            self._seal_active()
        self._expire()

    def _seal_active(self) -> None:
        blk = _Block(self.active, self.active_start, self.t,
                     self.active_energy, 0)
        self.levels[0].insert(0, blk)
        self.active = NpFD(self.ell, self.d)
        self.active_energy = 0.0
        self._cascade(0)

    def _cascade(self, k: int) -> None:
        while len(self.levels[k]) > self.b:
            old2 = self.levels[k].pop()   # two oldest
            old1 = self.levels[k].pop()
            fd = NpFD(self.ell, self.d)
            fd.absorb(old1.fd.rows())
            fd.absorb(old2.fd.rows())
            merged = _Block(fd, min(old1.start, old2.start),
                            max(old1.end, old2.end),
                            old1.energy + old2.energy, k + 1)
            if len(self.levels) <= k + 1:
                self.levels.append([])
            self.levels[k + 1].insert(0, merged)
            k_next = k + 1
            self._cascade(k_next)
            return

    def _expire(self) -> None:
        horizon = self.t - self.window
        for lv in self.levels:
            while lv and lv[-1].end <= horizon:
                lv.pop()

    def combine(self, other: "LMFD") -> "LMFD":
        """LM-FD has no sound native merge: block boundaries are sealed by
        per-instance *energy* quotas, so two histograms over the same
        timeline chop the stream at different points and their levels do
        not align (unlike DI-FD's timestamp-aligned dyadic intervals).
        Concatenating block lists would double-count the straddling-block
        error budget and break the εN guarantee, so this is an explicit
        ``NotImplementedError`` — the conformance suite asserts it raises
        rather than silently passing."""
        raise NotImplementedError(
            "LMFD.combine: exponential-histogram blocks are energy-aligned "
            "per instance; merging two histograms has no error guarantee")

    # -- query ---------------------------------------------------------------
    def query(self) -> np.ndarray:
        out = NpFD(self.ell, self.d)
        for lv in self.levels:
            for blk in lv:
                out.absorb(blk.fd.rows())
        out.absorb(self.active.rows())
        return out.rows()

    @property
    def n_rows_stored(self) -> int:
        n = self.active.n_rows_stored
        for lv in self.levels:
            for blk in lv:
                n += blk.fd.n_rows_stored
        return n
