"""FD low-rank gradient compression with error feedback.

Counterpart of ``repro/sketch/compress.py``.  Instead of exchanging the
full (n, d) gradient of each large matrix across the slowest links, a
worker exchanges its projection onto the top-r right-singular basis of
the sliding window of recent gradients, kept by a DS-FD sketch so stale
directions age out.  The residual enters an error-feedback accumulator, so
the compression is unbiased over time.  Per leaf of at least two
dimensions and ``min_size`` entries::

    basis V_r   ← top-r of the DS-FD sketch over summary rows
    g'          = g + err                      (error feedback in)
    low         = (g' V_rᵀ) V_r                (rank-r pass)
    err         = g' − low                     (error feedback out)
    wire bytes  = r·(rows + cols)  vs  rows·cols

Each leaf's sketch is one DS-FD stream (S = 1).  Its summary rows are
``fd_compress`` of the whole (rows, d) gradient, which the port's
``core/fd.py`` absorbs ℓ + 1 rows a round; under a model axis of
processes, that of the whole leaf carried across the axis
(``sketch/blocks.py``).  ``compressed_psum`` is the
reference's ``shard_map`` psum: an all-reduce of the rank-r coefficients
over a ``torch.distributed`` process group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.dsfd import DSFDConfig, dsfd_init, dsfd_query_rows, \
    dsfd_update_block, make_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.sketch.basis import project_rank_r, topr_basis
from repro_torch.sketch.blocks import fd_summary, whole_numel
from repro_torch.tree import leaves, map_dicts


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    rank: int = 8
    eps: float = 0.125                 # DS-FD sketch resolution (ℓ = 1/eps)
    window: int = 64                   # sliding window (steps × summary rows)
    min_size: int = 65536              # smaller leaves pass through
    summary_rows: int = 8              # FD-compressed rows fed per step

    def dsfd(self, d: int) -> DSFDConfig:
        # each step contributes `summary_rows` timestamps
        return make_config(d, self.eps, self.window * self.summary_rows,
                           mode="fast")


def _compressed(cfg: CompressConfig, g: torch.Tensor,
                dim: Optional[int] = None) -> bool:
    """Whether the leaf of which ``g`` is this process's block along
    ``dim`` (None: the whole leaf) is compressed: its whole size counts."""
    return g.dim() >= 2 and whole_numel(g, dim) >= cfg.min_size


def _as2d(g: torch.Tensor) -> torch.Tensor:
    return g.reshape(-1, g.shape[-1])


def _unzip(pairs):
    """A tree of (a, b) pairs as two trees."""
    return (map_dicts(lambda t: t[0], pairs), map_dicts(lambda t: t[1], pairs))


def _dims(split, grads):
    """``split`` (each leaf's split dimension or None, as ``grads``; None
    for no split), or a tree of None."""
    return split if split is not None else map_dicts(lambda _: None, grads)


def compress_init(cfg: CompressConfig, grads, device="cuda",
                  split=None) -> Dict:
    """Per leaf: None (passes through) or {"dsfd", "err", "step"}, on the
    card unless ``device`` names the CPU.  Under a model axis (``split``:
    each leaf's split dimension, as in :func:`compress_grads`) a block's
    ``err`` has the block's 2-D shape."""
    dev = resolve_device(device)

    def leaf(g, dim):
        if not _compressed(cfg, g, dim):
            return None
        return {"dsfd": dsfd_init(cfg.dsfd(g.shape[-1]), device=dev),
                "err": torch.zeros(_as2d(g).shape, dtype=torch.float32,
                                   device=dev),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    return map_dicts(leaf, grads, _dims(split, grads))


def _compress_leaf(cfg: CompressConfig, g: torch.Tensor, st: Dict,
                   dim: Optional[int]) -> Tuple[torch.Tensor, Dict]:
    d = g.shape[-1]
    dcfg = cfg.dsfd(d)
    gi = _as2d(g).float() + st["err"]

    rows = dsfd_query_rows(dcfg, st["dsfd"])
    _, V = topr_basis(rows, cfg.rank)                  # (1, r, d)
    _, low = project_rank_r(gi[None], V)               # coef is the wire
    low = low[0]
    err = gi - low

    # a row summary of the EF-corrected gradient enters the sketch: how new
    # directions reach the basis (projecting `low` alone never could); on
    # a split leaf, the summary of the whole leaf, the same on every process
    summary = fd_summary(gi.view(g.shape), max(cfg.summary_rows // 2, 1),
                         dim)
    summary = summary[:, :cfg.summary_rows]
    nrm = torch.linalg.vector_norm(summary, dim=2, keepdim=True)
    unit = summary / torch.clamp(nrm, min=1e-30)
    base = st["step"] * cfg.summary_rows + 1
    ts = base + torch.arange(unit.shape[1], dtype=torch.int32,
                             device=unit.device)
    dsfd = dsfd_update_block(dcfg, st["dsfd"], unit, ts)

    out = low.reshape(g.shape).to(g.dtype)
    return out, {"dsfd": dsfd, "err": err, "step": st["step"] + 1}


def compress_grads(cfg: CompressConfig, grads, state: Optional[Dict],
                   split=None) -> Tuple[Dict, Dict]:
    """Error-feedback low-rank compression leaf by leaf.  Returns
    (grads', state); a missing state starts on the gradients' device.

    ``split`` (a tree as ``grads``: each leaf's split dimension, or None
    for a leaf held whole; ``train/train_step.py::_model_split``) marks
    the leaves of which each process of the model axis holds one block.
    Their summary is the whole leaf's, carried across the axis
    (``sketch/blocks.py::fd_summary``), so the DS-FD state and its basis
    stay the same on every process; the error feedback and the projection
    are row-local, and each process keeps its block of them."""
    if state is None:
        state = compress_init(cfg, grads, next(leaves(grads)).device, split)

    def leaf(g, st, dim):
        return (g, None) if st is None else _compress_leaf(cfg, g, st, dim)

    return _unzip(map_dicts(leaf, grads, state, _dims(split, grads)))


def wire_bytes(cfg: CompressConfig, grads) -> Tuple[int, int]:
    """(compressed, dense) bytes per cross-worker all-reduce."""
    comp = dense = 0
    for g in leaves(grads):
        n = int(g.numel())
        if g.dim() >= 2 and n >= cfg.min_size:
            rows = n // g.shape[-1]
            comp += 4 * cfg.rank * rows
            dense += 4 * n
        else:
            comp += 4 * n
            dense += 4 * n
    return comp, dense


def compressed_psum(x: torch.Tensor, group, V: torch.Tensor) -> torch.Tensor:
    """All-reduce only the rank-r coefficients over the process ``group``
    (None: the default group).

    x: (rows, d) local partial gradient; V: (r, d) shared basis.  Wire
    volume shrinks from rows·d to rows·r (the residual's error feedback
    stays local)."""
    import torch.distributed as dist

    coef = x @ V.T
    dist.all_reduce(coef, group=group)
    return coef @ V
