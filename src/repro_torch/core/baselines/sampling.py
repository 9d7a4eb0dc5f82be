"""Row-sampling sketches over sliding windows (Braverman et al. 2020;
Wei et al. 2016) — the SWR / SWOR baselines of §7.

SWR: ℓ independent samplers; each keeps the in-window row maximizing the
priority key u^(1/w) (w = ‖a‖²).  A monotone deque per sampler stores only
rows that can still become the maximum (expected O(log N) entries).

SWOR: Efraimidis–Spirakis keys; keep rows not dominated by ≥ ℓ newer rows
with larger keys (the standard bounded "skyline" structure).

Queries return rows rescaled so that E[BᵀB] = A_WᵀA_W.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple

import numpy as np


class SWR:
    """Sampling With Replacement: ℓ independent max-priority samplers."""

    def __init__(self, d: int, ell: int, window: int, seed: int = 0):
        self.d, self.ell, self.window = d, int(ell), int(window)
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        # per sampler: deque of (priority, t, row) with decreasing priority
        self.deques: List[Deque[Tuple[float, int, np.ndarray]]] = [
            deque() for _ in range(self.ell)]
        self.t = 0
        self.fro_hist: Deque[Tuple[int, float]] = deque()  # (t, ‖a_t‖²)
        self.fro_sum = 0.0

    def update(self, row: np.ndarray, t: int | None = None) -> None:
        self.t = int(t) if t is not None else self.t + 1
        w = float(row @ row)
        self.fro_hist.append((self.t, w))
        self.fro_sum += w
        while self.fro_hist and self.fro_hist[0][0] + self.window <= self.t:
            self.fro_sum -= self.fro_hist.popleft()[1]
        if w > 0:
            us = self.rng.random(self.ell)
            prios = us ** (1.0 / w)
            for dq, p in zip(self.deques, prios):
                while dq and dq[-1][0] <= p:
                    dq.pop()
                dq.append((p, self.t, row.copy()))
        for dq in self.deques:
            while dq and dq[0][1] + self.window <= self.t:
                dq.popleft()

    def combine(self, other: "SWR") -> "SWR":
        """Native merge for disjoint rows of a shared timeline: sampler i
        keeps the max-priority row over the union, which is exactly what a
        single sketch over the interleaved stream would hold — valid only
        when the two sides drew their priority keys *independently*, so
        identically-seeded sketches (whose key streams are byte-identical
        and hence fully correlated) are rejected.  The merged deque is
        rebuilt to the monotone invariant.  Mutates and returns ``self``."""
        if (other.d, other.ell, other.window) != (self.d, self.ell,
                                                  self.window):
            raise ValueError("combine requires identically-configured SWRs")
        if other.seed == self.seed:
            raise ValueError(
                "combine requires independently-seeded SWRs: identical "
                "seeds give correlated priority keys and a biased sample")
        self.t = max(self.t, other.t)
        for i, dq_o in enumerate(other.deques):
            entries = sorted(list(self.deques[i]) + list(dq_o),
                             key=lambda e: e[1])          # by timestamp
            dq: Deque[Tuple[float, int, np.ndarray]] = deque()
            for e in entries:
                if e[1] + self.window <= self.t:
                    continue
                while dq and dq[-1][0] <= e[0]:
                    dq.pop()
                dq.append(e)
            self.deques[i] = dq
        hist = sorted(list(self.fro_hist) + list(other.fro_hist))
        self.fro_hist = deque(h for h in hist
                              if h[0] + self.window > self.t)
        self.fro_sum = sum(w for _, w in self.fro_hist)
        return self

    def query(self) -> np.ndarray:
        rows = []
        for dq in self.deques:
            if dq:
                _, _, r = dq[0]
                w = float(r @ r)
                rows.append(r * np.sqrt(self.fro_sum / (self.ell * w)))
        if not rows:
            return np.zeros((1, self.d), np.float32)
        return np.stack(rows).astype(np.float32)

    @property
    def n_rows_stored(self) -> int:
        return sum(len(dq) for dq in self.deques)


class SWOR:
    """Sampling WithOut Replacement via Efraimidis–Espirakis keys."""

    def __init__(self, d: int, ell: int, window: int, seed: int = 0):
        self.d, self.ell, self.window = d, int(ell), int(window)
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        # candidates: list of (key, t, row, weight), kept iff fewer than ℓ
        # newer candidates have a larger key.
        self.cands: List[Tuple[float, int, np.ndarray, float]] = []
        self.t = 0
        self.fro_hist: Deque[Tuple[int, float]] = deque()
        self.fro_sum = 0.0

    def update(self, row: np.ndarray, t: int | None = None) -> None:
        self.t = int(t) if t is not None else self.t + 1
        w = float(row @ row)
        self.fro_hist.append((self.t, w))
        self.fro_sum += w
        while self.fro_hist and self.fro_hist[0][0] + self.window <= self.t:
            self.fro_sum -= self.fro_hist.popleft()[1]
        if w > 0:
            key = self.rng.random() ** (1.0 / w)
            self.cands.append((key, self.t, row.copy(), w))
        if self.t % 64 == 0 or len(self.cands) > 8 * self.ell + 64:
            self._prune()

    def _prune(self) -> None:
        import heapq
        self.cands = [c for c in self.cands if c[1] + self.window > self.t]
        # keep c iff fewer than ℓ newer candidates have a larger key:
        # scan newest→oldest keeping a heap of the ℓ largest newer keys.
        self.cands.sort(key=lambda c: -c[1])          # newest first
        heap: list[float] = []
        kept = []
        for c in self.cands:
            if len(heap) < self.ell or c[0] > heap[0]:
                kept.append(c)
            heapq.heappush(heap, c[0])
            if len(heap) > self.ell:
                heapq.heappop(heap)
        kept.reverse()
        self.cands = kept

    def combine(self, other: "SWOR") -> "SWOR":
        """Native merge for disjoint rows of a shared timeline: the union
        of the two candidate skylines, re-pruned, is the skyline a single
        sketch over the interleaved stream would keep — valid only when the
        Efraimidis–Spirakis keys were drawn independently per side, so
        identically-seeded sketches are rejected (correlated keys bias the
        top-ℓ).  Mutates and returns ``self``."""
        if (other.d, other.ell, other.window) != (self.d, self.ell,
                                                  self.window):
            raise ValueError("combine requires identically-configured SWORs")
        if other.seed == self.seed:
            raise ValueError(
                "combine requires independently-seeded SWORs: identical "
                "seeds give correlated priority keys and a biased sample")
        self.t = max(self.t, other.t)
        self.cands.extend(other.cands)
        hist = sorted(list(self.fro_hist) + list(other.fro_hist))
        self.fro_hist = deque(h for h in hist
                              if h[0] + self.window > self.t)
        self.fro_sum = sum(w for _, w in self.fro_hist)
        self._prune()
        return self

    def query(self) -> np.ndarray:
        self._prune()
        live = [c for c in self.cands if c[1] + self.window > self.t]
        top = sorted(live, key=lambda c: -c[0])[: self.ell]
        if not top:
            return np.zeros((1, self.d), np.float32)
        rows = [c[2] * np.sqrt(self.fro_sum / (len(top) * c[3])) for c in top]
        return np.stack(rows).astype(np.float32)

    @property
    def n_rows_stored(self) -> int:
        return len(self.cands)
