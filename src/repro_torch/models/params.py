"""Parameter declarations and their initialisation.

Counterpart of ``repro/models/params.py``.  A model declares a nested dict
of ``ParamDef`` (shape and init law); ``init_params`` materialises it with
the reference's law (normal·scale, zeros, ones) from a ``torch.Generator``.
The reference's logical axes and partition specs serve its sharding and
have no counterpart on one device.  Stacked layers carry a leading layer
axis, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones
    scale: float = 0.02


def _leaves(defs, prefix=()):
    """(path, ParamDef) pairs in sorted key order, as ``jax.tree.flatten``
    orders a dict."""
    for key in sorted(defs):
        val = defs[key]
        if isinstance(val, ParamDef):
            yield prefix + (key,), val
        else:
            yield from _leaves(val, prefix + (key,))


def _normal(d: ParamDef, generator, dtype, device) -> torch.Tensor:
    """scale · N(0, 1) drawn in f32, then cast; a stacked leaf is drawn one
    layer at a time, so the f32 draw never needs more than one layer's
    memory."""
    out = torch.empty(d.shape, dtype=dtype, device=device)
    parts = out if len(d.shape) > 2 else out[None]
    for part in parts:
        x = torch.randn(part.shape, generator=generator, dtype=torch.float32,
                        device=device)
        part.copy_(x.mul_(d.scale))
    return out


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device="cuda") -> Dict:
    """The nested dict of tensors that ``defs`` declares, on ``device``."""
    out: Dict = {}
    for path, d in _leaves(defs):
        if d.init == "zeros":
            leaf = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            leaf = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            leaf = _normal(d, generator, dtype, device)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def count_params(defs) -> int:
    total = 0
    for _, d in _leaves(defs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total
