"""``sketchy_dsfd`` — Sketchy-style (Feinberg et al. 2024) low-rank adaptive
preconditioning whose per-layer gradient covariance comes from a
sliding-window DS-FD sketch: stale curvature is forgotten.

Counterpart of ``repro/sketch/sketchy.py``.  Per parameter of at least two
dimensions (rows n, cols d ≥ ``min_dim``)::

    sketch S_t  ← DS-FD over FD-compressed rows of g_t  (window W steps)
    (λ_i, v_i)  ← top-r eigenpairs of the windowed covariance Σ_W gᵀg
    precond(g)  = (g V) diag(1/√(λ·s + ρ)) Vᵀ + (g − (g V) Vᵀ)/√ρ

Sketchy's "low-rank + isotropic tail" inverse root; other parameters take
Adam-style diagonal second moments.  The optimizer follows
``train/optimizer.py``'s contract: ``SketchyState`` keeps the reference's
fields (a per-leaf DS-FD state of one stream, S = 1, or None; the
diagonal; the momentum), and ``update`` writes the parameters, the
diagonal and the momentum in place.  The summary rows are ``fd_compress``
of the whole gradient matrix (``core/fd.py``, ℓ + 1 rows a round).

Under a model axis of processes (``parallel/sharding.py::model_sharded``
gives each leaf's split dimension) a process holds one block of a split
leaf: the summary is the whole leaf's, carried across the axis
(``sketch/blocks.py``), so the DS-FD state stays the same on every
process; the gradient energy and the trust region's mean square are
summed over the axis's group; the projection, the momentum and the
parameter are row-local.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.parallel.sharding import model_sharded_leaves
from repro_torch.sketch.api import SlidingSketch, make_sketch
from repro_torch.sketch.basis import topr_basis
from repro_torch.sketch.blocks import fd_summary, whole_numel, whole_sum
from repro_torch.train.optimizer import Optimizer, _first, _schedule, \
    _step_f32
from repro_torch.tree import map_dicts, tree_map


@dataclasses.dataclass(frozen=True)
class SketchyConfig:
    lr: float = 1e-2
    rank: int = 8
    eps: float = 0.25                # DS-FD resolution (ℓ = 1/eps)
    window: int = 64                 # steps the curvature window spans
    rho: float = 1e-6                # isotropic tail
    momentum: float = 0.9
    summary_rows: int = 4            # FD-compressed rows fed per step
    min_dim: int = 8                 # cols below this → diagonal path
    warmup: int = 20

    def sketch(self, d: int, device="cuda") -> SlidingSketch:
        return make_sketch("dsfd", d=d, eps=self.eps,
                           window=self.window * self.summary_rows,
                           mode="fast", device=device)


class SketchyState(NamedTuple):
    sketch: Any        # per-leaf DS-FD state (or None)
    diag: Any          # per-leaf diagonal v (1-D fallback)
    mom: Any


def _sketched(p: torch.Tensor, cfg: SketchyConfig) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= cfg.min_dim


def sketchy_dsfd(cfg: SketchyConfig = SketchyConfig()) -> Optimizer:
    def init(params):
        def sk(p):
            if not _sketched(p, cfg):
                return None
            if p.device.type == "meta":    # shapes only (a layout)
                return tree_map(lambda x: x.to("meta"),
                                cfg.sketch(p.shape[-1], "cpu").init())
            return cfg.sketch(p.shape[-1], p.device).init()

        def dg(p):
            return torch.zeros(() if _sketched(p, cfg) else p.shape,
                               dtype=torch.float32, device=p.device)

        def mom(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return SketchyState(sketch=map_dicts(sk, params),
                            diag=map_dicts(dg, params),
                            mom=map_dicts(mom, params))

    def precondition(g, step, sk, dim):
        """(the sketched update of one leaf, its new DS-FD state); ``g``
        is this process's block of the leaf along ``dim`` under a model
        axis (None: the whole leaf)."""
        d = g.shape[-1]
        sliding = cfg.sketch(d, g.device)
        g2 = g.reshape(-1, d)
        # the FD-compressed row summary of the whole leaf, unit-normalised
        summary = fd_summary(g, max(cfg.summary_rows // 2, 1), dim)
        summary = summary[:, :cfg.summary_rows]
        scale2 = whole_sum(torch.sum(g2 * g2), dim)
        nrm = torch.linalg.vector_norm(summary, dim=2, keepdim=True)
        unit = summary / torch.clamp(nrm, min=1e-30)
        base = torch.as_tensor(step, device=g.device).to(torch.int32) \
            * cfg.summary_rows + 1
        sk = sliding.update_block(
            sk, unit, base + torch.arange(unit.shape[1], dtype=torch.int32,
                                          device=g.device))
        lam, V = topr_basis(sliding.query_rows(sk), cfg.rank)
        lam, V = lam[0], V[0]                          # directions only
        # eigenvalues rescaled from unit rows to gradient energy
        lam = lam * scale2 / torch.clamp(torch.sum(lam), min=1e-30)
        coef = g2 @ V.T                                # (n, r)
        inv = 1.0 / torch.sqrt(lam + cfg.rho)
        low = (coef * inv[None, :]) @ V
        tail = (g2 - coef @ V) / math.sqrt(cfg.rho)
        upd = (low + tail).reshape(g.shape)
        # trust-region style normalisation (Sketchy App. B), over the whole
        # leaf
        if dim is None:
            ms = torch.mean(upd * upd)
        else:
            ms = whole_sum(torch.sum(upd * upd), dim) / whole_numel(upd, dim)
        rms = torch.sqrt(ms + 1e-30)
        return upd / torch.clamp(rms, min=1.0), sk

    @torch.no_grad()
    def update(grads, state, params, step):
        stepf = _step_f32(step, _first(params))
        sched = _schedule(cfg.lr, cfg.warmup, stepf)
        dims = model_sharded_leaves()
        if dims is None:
            dims = map_dicts(lambda _: None, params)

        def leaf(p, g, sk, dg, m, dim):
            gf = g.float()
            if sk is None:
                dg.mul_(0.99).add_(0.01 * (gf * gf))
                upd = gf / torch.clamp(torch.sqrt(dg), min=1e-8)
            else:
                upd, sk = precondition(gf, step, sk, dim)
            m.mul_(cfg.momentum).add_(upd)
            p.copy_(p.float() - sched * m)
            return sk

        sketch = map_dicts(leaf, params, grads, state.sketch, state.diag,
                           state.mom, dims)
        return params, state._replace(sketch=sketch)

    return Optimizer("sketchy_dsfd", init, update)
