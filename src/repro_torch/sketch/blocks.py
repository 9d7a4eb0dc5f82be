"""The gradient sketches on a leaf that a model axis of processes splits.

Under a process mesh (``launch/mesh.py::make_process_mesh``) each process
holds one block of a split leaf along one dimension (``train/train_step.py
::_model_split``), and every process holds the other leaves whole.  The
sketches compute what the reference computes on the global arrays:

* a sum over the whole leaf is the blocks' sums added over the model
  axis's group (:func:`whole_sum`);
* the FD summary of the leaf's ``(-1, d)`` view (:func:`fd_summary`) is
  carried across the axis.  On a split leaf the rows of that view come in
  runs: for each index of the dimensions before the split one, one run
  for each model coordinate, in coordinate order.  The ``FDState`` goes
  through the runs in that order: the owner of a run absorbs it
  (``core/fd.py::fd_absorb``) and broadcasts ``(buf, nbuf, shed)`` over
  the group, 2ℓ·d + 2 floats, and the next owner continues from there.
  Absorbing consecutive blocks equals absorbing their concatenation (a
  round fills the free slots and shrinks a full buffer, so a run that ends
  mid-round leaves a carry the next run completes; zero rows are skipped
  in both), so after the last run every process holds the summary of the
  whole leaf, bit for bit the one-process ``fd_compress``'s on the same
  device.

A leaf split along its last dimension splits the columns of that view.
Tensor parallelism splits such leaves, but a train step that carries a
gradient sketch keeps the dense part whole (``train/loop.py::
train_rules``), so none reaches the sketches; the FD of rows split by
columns is not ported (ROADMAP §1, "The gradient sketches over
column-split leaves"), and raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.fd import FDState, fd_absorb, fd_compress, fd_init
from repro_torch.parallel.sharding import (all_reduce, broadcast,
                                           model_coord, model_size)


def check_split(shape, dim: Optional[int]) -> None:
    """Raise for a split along the last dimension of a leaf of ``shape``."""
    if dim is not None and dim == len(shape) - 1:
        raise NotImplementedError(
            f"a gradient sketch of a leaf {tuple(shape)} split along its "
            "last dimension: ROADMAP §1, 'The gradient sketches over "
            "column-split leaves'")


def whole_sum(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``x`` (this process's part of a sum over a leaf) summed over the
    model axis's group where the leaf is split (``dim`` not None)."""
    if dim is None:
        return x
    _, group = model_coord()
    return all_reduce(x, group, "sum")


def whole_numel(x: torch.Tensor, dim: Optional[int]) -> int:
    """The element count of the whole leaf of which ``x`` is a block."""
    return x.numel() * (model_size() if dim is not None else 1)


def _handoff(st: FDState, owner: int, group) -> FDState:
    """``owner``'s state on every process: one broadcast of buf, shed and
    nbuf packed in one f32 buffer (a count up to 2ℓ is exact in f32)."""
    buf, nbuf, shed = st
    flat = broadcast(torch.cat([buf.reshape(-1), shed.to(buf.dtype),
                                nbuf.to(buf.dtype)]), owner, group)
    n = buf.numel()
    return FDState(flat[:n].view(buf.shape), flat[n + 1:].to(nbuf.dtype),
                   flat[n:n + 1].to(shed.dtype))


def fd_summary(x: torch.Tensor, ell: int,
               dim: Optional[int]) -> torch.Tensor:
    """The (1, 2ℓ, d) FD buffer of the ``(-1, d)`` view of the whole leaf
    of which ``x`` is this process's block along ``dim`` (None: ``x`` is
    the whole leaf, and this is ``fd_compress`` of its view)."""
    d = x.shape[-1]
    if dim is None:
        return fd_compress(x.reshape(1, -1, d), ell)
    check_split(x.shape, dim)
    coord, group = model_coord()
    runs = x.reshape(math.prod(x.shape[:dim]), -1, d)
    st = fd_init(ell, d, 1, device=x.device, dtype=x.dtype)
    for run in runs:
        for owner in range(model_size()):
            if owner == coord:
                st = fd_absorb(st, run[None], ell=ell)
            st = _handoff(st, owner, group)
    return st.buf
