"""Parameter declarations and their initialisation.

Counterpart of ``repro/models/params.py``.  A model declares a nested dict
of ``ParamDef`` (shape, logical axes and init law); ``init_params``
materialises it with the reference's law (normal·scale, zeros, ones) from a
``torch.Generator``.  The logical axes give each leaf's spec under a rule
table (``param_pspecs``, ``parallel/sharding.py``).  Stacked layers carry
a leading layer axis, as in the reference.  On the ``meta`` device
``init_params`` and ``abstract_params`` give the tree's shapes and types
without allocating or drawing anything (the reference's abstract
parameters): a full grok-1 or kimi-k2 fits no card.  ``init_params`` with
``local=`` keeps one process's slice of each leaf under a mesh, drawing
the same numbers as the whole tree.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.parallel.sharding import to_pspec


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis per dim
    init: str = "normal"                 # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _leaves(defs, prefix=()):
    """(path, ParamDef) pairs in sorted key order, as ``jax.tree.flatten``
    orders a dict."""
    for key in sorted(defs):
        val = defs[key]
        if isinstance(val, ParamDef):
            yield prefix + (key,), val
        else:
            yield from _leaves(val, prefix + (key,))


def _set(out: Dict, path, leaf) -> None:
    node = out
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf


def _normal(d: ParamDef, generator, dtype, device,
            keep: Optional[Tuple[slice, ...]] = None) -> torch.Tensor:
    """scale · N(0, 1) drawn in f32, then cast; a stacked leaf is drawn one
    layer at a time (a stacked expert leaf one expert of a layer at a
    time), so the f32 draw never needs more than that much memory.  With
    ``keep`` (a slice a dimension) only that block of the leaf is kept;
    the draws are the whole leaf's, so the block holds the same numbers."""
    keep = keep or tuple(slice(0, n) for n in d.shape)
    lead = 2 if len(d.shape) > 3 else 1 if len(d.shape) > 2 else 0
    out = torch.empty(tuple(s.stop - s.start for s in keep), dtype=dtype,
                      device=device)
    part_shape = d.shape[lead:]
    for idx in itertools.product(*(range(n) for n in d.shape[:lead])):
        x = torch.randn(part_shape, generator=generator, dtype=torch.float32,
                        device=device)
        if not all(s.start <= i < s.stop for i, s in zip(idx, keep)):
            continue
        dst = out[tuple(i - s.start for i, s in zip(idx, keep))]
        dst.copy_(x.mul_(d.scale)[keep[lead:]])
    return out


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device="cuda", *,
                local: Optional[Callable[[ParamDef],
                                         Tuple[slice, ...]]] = None) -> Dict:
    """The nested dict of tensors that ``defs`` declares, on ``device``
    (the card unless it names the CPU, or ``meta`` for shapes only).
    ``local(d)`` gives the block (a slice a dimension) of leaf ``d`` that
    this process keeps (``convert.local_block``); every leaf is still
    drawn whole, so each block holds the numbers of the whole tree."""
    out: Dict = {}
    meta = torch.device(device).type == "meta"
    if not meta:
        device = resolve_device(device)
    for path, d in _leaves(defs):
        keep = local(d) if local is not None else None
        shape = (tuple(s.stop - s.start for s in keep) if keep is not None
                 else d.shape)
        if meta:
            leaf = torch.empty(shape, dtype=dtype, device=device)
        elif d.init == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        elif d.init == "ones":
            leaf = torch.ones(shape, dtype=dtype, device=device)
        else:
            leaf = _normal(d, generator, dtype, device, keep)
        _set(out, path, leaf)
    return out


def abstract_params(defs, dtype=torch.bfloat16) -> Dict:
    """The tree's tensors on ``meta``: shapes and types, no storage."""
    out: Dict = {}
    for path, d in _leaves(defs):
        _set(out, path, torch.empty(d.shape, dtype=dtype, device="meta"))
    return out


def param_pspecs(defs, rules=None) -> Dict:
    """Each leaf's spec (a tuple of mesh axes) under ``rules`` (default:
    those in force)."""
    out: Dict = {}
    for path, d in _leaves(defs):
        _set(out, path, to_pspec(d.axes, rules))
    return out


def count_params(defs) -> int:
    total = 0
    for _, d in _leaves(defs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total
