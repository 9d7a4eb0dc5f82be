"""The scoring plane: residual anomaly scores against the sketch basis.

Counterpart of ``repro/sketch/score.py``.  The energy of a row outside the
span of the live sketch rows, ``‖x‖² − ‖x Vᵀ‖²``, is a per-row anomaly
score the FD guarantee makes principled (``sketch/basis.py``).

* The ``score(state, X, t=None) → (S, n)`` capability of every variant
  is ``residual_scores`` over its own ``query_rows`` (``make_sketch``
  installs it).  The reference's ``make_jax_score`` wrapper has no
  counterpart: there is nothing to jit, and the port's functions carry
  the stream axis already, so a fleet scores a whole (S, B, d) slab in
  one call of its base sketch's ``score``.
* :func:`make_host_score` is the numpy adapter of the host baselines
  (lmfd / difd / swr / swor): the float64 residual of
  :func:`host_residual_scores` against the orthonormal row space of
  whatever their ``query_rows`` returns, as in the reference.
* :class:`ScorePlane` holds the per-user EWMA thresholds the serving
  engine keeps at ingest (``SketchFleetEngine(score=True)``), float64 on
  the host with the reference's arithmetic, so both flag the same users.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def host_residual_scores(rows: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Numpy residual of ``X``'s rows against the row space of ``rows``."""
    rows = np.asarray(rows, np.float64)
    X = np.asarray(X, np.float64)
    tot = np.sum(X * X, axis=-1)
    live = rows[np.linalg.norm(rows, axis=-1) > 0.0]
    if live.size == 0:
        return np.maximum(tot, 0.0).astype(np.float32)
    _, s, vt = np.linalg.svd(live, full_matrices=False)
    V = vt[s > 1e-9 * max(float(s[0]), 1e-30)]
    coef = X @ V.T
    res = tot - np.sum(coef * coef, axis=-1)
    return np.maximum(res, 0.0).astype(np.float32)


def make_host_score(query_rows: Callable) -> Callable:
    """The host-baseline ``score`` adapter: residual against whatever row
    stack the baseline's ``query_rows`` returns (its native compressed
    sketch), via numpy SVD on the host."""

    def score(state, X, t=None):
        return host_residual_scores(np.asarray(query_rows(state, t)),
                                    np.asarray(X))

    return score


class ScorePlane:
    """Per-user EWMA anomaly thresholds over per-tick residual scores.

    For each stream the plane tracks an exponentially weighted mean and
    variance of its per-tick peak score; once ``warmup`` ticks of history
    exist, a tick whose peak exceeds ``mean + zscore·σ`` flags the user.
    The state is a few float64/int64 vectors of length S on the host;
    ``state_dict`` / ``load_state_dict`` / ``spec`` carry it through
    engine checkpoints under the reference's keys (``KEYS``)."""

    KEYS = ("score_mean", "score_var", "score_count", "score_flag",
            "score_last")

    def __init__(self, streams: int, *, ema: float = 0.05,
                 zscore: float = 4.0, warmup: int = 5):
        self.S = int(streams)
        self.ema = float(ema)
        self.zscore = float(zscore)
        self.warmup = int(warmup)
        self.mean = np.zeros(self.S, np.float64)
        self.var = np.zeros(self.S, np.float64)
        self.count = np.zeros(self.S, np.int64)
        self.flagged = np.zeros(self.S, bool)
        self.last = np.zeros(self.S, np.float64)

    def observe(self, scores: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Fold one tick: ``scores`` is the (S, B) slab score matrix,
        ``counts`` the (S,) number of real rows per stream this tick (slab
        rows past a stream's count are padding and are ignored).  Returns
        the stream ids newly flagged this tick."""
        counts = np.asarray(counts, np.int64)
        idx = np.flatnonzero(counts > 0)
        if idx.size == 0:
            return idx
        sc = np.asarray(scores, np.float64)[idx]
        mask = np.arange(sc.shape[1])[None, :] < counts[idx, None]
        peak = np.where(mask, sc, -np.inf).max(axis=1)
        warm = self.count[idx] >= self.warmup
        thr = self.mean[idx] + self.zscore * np.sqrt(
            np.maximum(self.var[idx], 0.0))
        newly = idx[warm & (peak > thr)]
        self.flagged[newly] = True
        self.last[idx] = peak
        a = self.ema
        delta = peak - self.mean[idx]
        self.mean[idx] += a * delta
        self.var[idx] = (1.0 - a) * (self.var[idx] + a * delta * delta)
        self.count[idx] += 1
        return newly

    def anomalies(self, *, reset: bool = False) -> np.ndarray:
        """Stream ids currently flagged; ``reset=True`` clears the flags
        after reading (the mean/var history is kept either way)."""
        out = np.flatnonzero(self.flagged)
        if reset:
            self.flagged[:] = False
        return out

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"score_mean": self.mean.copy(),
                "score_var": self.var.copy(),
                "score_count": self.count.copy(),
                "score_flag": self.flagged.copy(),
                "score_last": self.last.copy()}

    def load_state_dict(self, arrays: Dict[str, np.ndarray]) -> None:
        self.mean = np.asarray(arrays["score_mean"], np.float64).copy()
        self.var = np.asarray(arrays["score_var"], np.float64).copy()
        self.count = np.asarray(arrays["score_count"], np.int64).copy()
        self.flagged = np.asarray(arrays["score_flag"], bool).copy()
        self.last = np.asarray(arrays["score_last"], np.float64).copy()
        if self.mean.shape[0] != self.S:
            raise ValueError(
                f"score plane holds {self.S} streams but the checkpoint "
                f"carries {self.mean.shape[0]} — same stream partition "
                "required")

    def spec(self) -> Dict[str, float]:
        return {"ema": self.ema, "zscore": self.zscore,
                "warmup": self.warmup}
