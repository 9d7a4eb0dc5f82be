"""Parameter declarations and their initialisation.

Counterpart of ``repro/models/params.py``.  A model declares a nested dict
of ``ParamDef`` (shape and init law); ``init_params`` materialises it with
the reference's law (normal·scale, zeros, ones) from a ``torch.Generator``.
The reference's logical axes and partition specs serve its sharding and
have no counterpart on one device.  Stacked layers carry a leading layer
axis, as in the reference.  On the ``meta`` device ``init_params`` gives
the tree's shapes and types without allocating or drawing anything (the
reference's abstract parameters): a full grok-1 or kimi-k2 fits no card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device


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
    layer at a time (a stacked expert leaf one expert of a layer at a
    time), so the f32 draw never needs more than that much memory."""
    out = torch.empty(d.shape, dtype=dtype, device=device)
    parts = (out.flatten(0, 1) if len(d.shape) > 3 else
             out if len(d.shape) > 2 else out[None])
    for part in parts:
        x = torch.randn(part.shape, generator=generator, dtype=torch.float32,
                        device=device)
        part.copy_(x.mul_(d.scale))
    return out


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device="cuda") -> Dict:
    """The nested dict of tensors that ``defs`` declares, on ``device``
    (the card unless it names the CPU, or ``meta`` for shapes only)."""
    out: Dict = {}
    meta = torch.device(device).type == "meta"
    if not meta:
        device = resolve_device(device)
    for path, d in _leaves(defs):
        if meta:
            leaf = torch.empty(d.shape, dtype=dtype, device=device)
        elif d.init == "zeros":
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
