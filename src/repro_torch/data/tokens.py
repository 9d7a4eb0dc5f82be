"""Synthetic LM token pipeline — deterministic, checkpointable, shardable.

Counterpart of ``repro/data/tokens.py``, kept as this package's own numpy
copy: batch k is the same pure function of (seed, k) in both packages, so
they train on the same tokens.

Real deployments swap this for a file-backed loader; everything above the
``next_batch`` contract (train loop, checkpoint resume, multi-host
sharding) is identical.  Sequences follow a Zipfian unigram mixed with a
repeated-ngram process so the loss is learnable (a model that memorizes
local structure beats the unigram entropy) — a pure-noise stream would
make convergence tests meaningless.

State is a single int64 step counter: batch k is a pure function of
(seed, k), so resuming from a checkpoint or resharding to a different
data-parallel layout replays identically.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    ngram: int = 8

    def init_state(self) -> Dict:
        return {"step": 0}

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def next_batch(self, state: Dict) -> Tuple[Dict, Dict[str, np.ndarray]]:
        step = state["step"]
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # Zipf unigrams over an effective vocab slice
        eff = min(V, 4096)
        ranks = np.arange(1, eff + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(eff, size=(B, S + 1), p=probs).astype(np.int32)
        # overlay repeated n-grams: each row repeats a motif with period p
        motif = rng.choice(eff, size=(B, self.ngram), p=probs).astype(np.int32)
        period = self.ngram * 2
        pos = np.arange(S + 1) % period
        mask = pos < self.ngram
        toks[:, mask] = motif[:, pos[mask] % self.ngram]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        return {"step": step + 1}, batch

    def shard_slice(self, batch: Dict[str, np.ndarray], shard: int,
                    num_shards: int) -> Dict[str, np.ndarray]:
        """Per-host slice of the global batch (multi-host feeding)."""
        B = self.global_batch
        assert B % num_shards == 0
        lo = (B // num_shards) * shard
        hi = lo + B // num_shards
        return {k: v[lo:hi] for k, v in batch.items()}
