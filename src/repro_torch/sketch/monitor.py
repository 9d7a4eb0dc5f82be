"""SlidingGradSketch — DS-FD over the stream of per-step gradient
summaries: a windowed streaming PCA of the optimisation's dynamics.

Counterpart of ``repro/sketch/monitor.py``.  Each train step the gradient
tree is reduced to one d-dimensional row by a deterministic count-sketch
(a pure arithmetic hash: no projection matrix to store, O(n) work over the
n parameters), L2-normalised (the raw norm is kept apart), and fed to a
DS-FD sketch whose window is N steps.  Queries give the top windowed
directions: drift ("the gradient subspace rotated"), loss-spike forensics.

The buckets and signs are the reference's bit for bit: its hash is uint32
arithmetic that wraps, done here in int64 with the low 32 bits kept after
every product and sum; each leaf's seed hashes the ``jax.tree_util``
path string of the leaf (``"['layers']['wq']"``), and the leaves are added
in that package's order (dict keys sorted).  The bucket sums are
``index_add_``, which on a CUDA tensor sums by atomics in an order that
changes from run to run: the row agrees with the CPU's to rounding, not
bit for bit.  The monitor's sketch is one DS-FD stream (S = 1); queries
give the reference's single-stream shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.sketch.api import ALL, SlidingSketch, make_sketch, \
    query_cohort
from repro_torch.sketch.basis import subspace_overlap, topr_basis
from repro_torch.train.checkpoint import leaves_with_paths

_P1 = 2654435761          # Knuth multiplicative hashes
_P2 = 40503
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    d: int = 256                      # count-sketch width
    eps: float = 0.125                # DS-FD 1/ℓ
    window: int = 256                 # sliding window, in train steps
    mode: str = "fast"

    def sketch(self, device="cuda") -> SlidingSketch:
        return make_sketch("dsfd", d=self.d, eps=self.eps,
                           window=self.window, mode=self.mode,
                           device=device)


def _leaf_seed(path: str) -> int:
    h = 2166136261
    for ch in path:
        h = ((h ^ ord(ch)) * 16777619) & _U32
    return h


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2³²`` for int64 ``x`` in [0, 2³²) and c < 2³², with
    every intermediate below 2⁶³: the 16-bit halves of x times c."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_buckets(path: str, n: int, d: int, device) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """The count-sketch bucket (int64, in [0, d)) and sign (±1 f32) of the
    n entries of the leaf at ``path``."""
    idx = (torch.arange(n, dtype=torch.int64, device=device)
           + _leaf_seed(path)) & _U32
    bucket = (_mul_u32(idx, _P1) >> 16) % d
    sign = torch.where((_mul_u32(idx, _P2) & (1 << 15)) != 0, 1.0, -1.0)
    return bucket, sign


def project_grads(cfg: SketchConfig, grads) -> torch.Tensor:
    """Count-sketch the whole gradient tree into one (d,) f32 row."""
    vec = None
    for path, g in leaves_with_paths(grads):
        gf = g.reshape(-1).float()
        if vec is None:
            vec = torch.zeros((cfg.d,), dtype=torch.float32,
                              device=gf.device)
        bucket, sign = hash_buckets(path, gf.numel(), cfg.d, gf.device)
        vec.index_add_(0, bucket, gf * sign)
    return vec


def sketch_init(cfg: SketchConfig, device="cuda") -> Dict:
    """Monitor state, on the card unless ``device`` names the CPU: the
    DS-FD state (S = 1) and the rolling raw-norm history."""
    dev = resolve_device(device)
    return {"dsfd": cfg.sketch(dev).init(),
            "norm_hist": torch.zeros((cfg.window,), dtype=torch.float32,
                                     device=dev)}


def sketch_update(cfg: SketchConfig, state: Optional[Dict], grads,
                  step) -> Tuple[Dict, Dict]:
    """Feed one step's gradients; returns (state, metrics).  A missing
    state starts on the gradients' device."""
    row = project_grads(cfg, grads)
    if state is None:
        state = sketch_init(cfg, row.device)
    sk = cfg.sketch(row.device)
    norm = torch.linalg.vector_norm(row)
    unit = row / torch.clamp(norm, min=1e-30)
    now = torch.as_tensor(step, device=row.device).to(torch.int32) + 1
    dsfd = sk.update(state["dsfd"], unit[None], now)
    hist = state["norm_hist"].clone()
    hist[torch.remainder(now, cfg.window).long()] = norm
    metrics = {
        "sketch/grad_norm_proj": norm,
        "sketch/top_energy": dsfd.main.sig1[0],
        "sketch/window_norm2": torch.sum(hist * hist),
    }
    return {"dsfd": dsfd, "norm_hist": hist}, metrics


def _device(state: Dict) -> torch.device:
    return state["norm_hist"].device


def sketch_query(cfg: SketchConfig, state: Dict, r: int = 8):
    """Top-r windowed gradient directions: (eigenvalues (r,), basis (r, d))."""
    rows = cfg.sketch(_device(state)).query_rows(state["dsfd"])
    lam, V = topr_basis(rows, r)
    return lam[0], V[0]


def sketch_score(cfg: SketchConfig, state: Dict, rows,
                 t=None) -> torch.Tensor:
    """Residual anomaly scores (n,) of the probe rows (n, d) against the
    windowed gradient subspace."""
    return cfg.sketch(_device(state)).score(state["dsfd"], rows, t)[0]


def subspace_drift(cfg: SketchConfig, state_a: Dict, state_b: Dict,
                   r: int = 8) -> torch.Tensor:
    """1 − ‖V_a V_bᵀ‖_F²/r: 0 when the windowed top-r subspaces align,
    toward 1 when they rotate apart."""
    _, va = sketch_query(cfg, state_a, r)
    _, vb = sketch_query(cfg, state_b, r)
    return 1.0 - subspace_overlap(va[None], vb[None])[0] / r


def cohort_sketch_query(cfg: SketchConfig, fleet, state, cohort=ALL,
                        r: int = 8, t=None):
    """Fleet form of :func:`sketch_query`: the top-r directions of a
    cohort of per-worker monitor sketches, through the fleet's cached
    query tree (one merged base state)."""
    merged = query_cohort(fleet, state, cohort, t)
    rows = fleet.meta["base"].query_rows(merged, t)
    lam, V = topr_basis(rows, r)
    return lam[0], V[0]
