"""Optimizers as (init, update) pairs on parameter trees.

Counterpart of ``repro/train/optimizer.py``:

* ``adamw`` — f32 m and v;
* ``adafactor`` — factored f32 second moments and bf16 momentum; under a
  process mesh its update clipping adds a leaf's blocks up over the model
  axis (``parallel/sharding.py::model_sharded``), and so do its row and
  column means over a dimension that the axis splits (a tensor-parallel
  leaf); the rest is local;
* ``sgdm`` — for toy runs.

The states are the reference's NamedTuples (``AdamState(m, v)``,
``FactoredState(vr, vc, mom)``) whose fields mirror the parameter tree, so
a checkpoint of ``(params, opt_state, step)`` has the reference's leaf
paths and either package resumes the other's run.  Where the reference is
pure, ``update`` here writes into the parameters and the state it is
given, under ``torch.no_grad()``, and returns them: a full-width model
then needs no second copy of either.  ``step`` is a 0-d int32 tensor (or
an int); the schedule is computed from it on its device, without a host
read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (all_reduce, model_coord,
                                           model_sharded_leaves)
from repro_torch.tree import map_dicts, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def _zeros(p: torch.Tensor, shape=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape, dtype=dtype,
                       device=p.device)


def _step_f32(step, like: torch.Tensor) -> torch.Tensor:
    """``step + 1`` as a 0-d f32 tensor on ``like``'s device."""
    return torch.as_tensor(step, device=like.device).to(torch.float32) + 1.0


def _schedule(lr: float, warmup: int, stepf: torch.Tensor) -> torch.Tensor:
    return lr * torch.clamp(stepf / warmup, max=1.0)


def _first(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


# -- AdamW -------------------------------------------------------------------


class AdamState(NamedTuple):
    m: Any
    v: Any


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, wd: float = 0.01,
          warmup: int = 100) -> Optimizer:
    def init(params):
        return AdamState(m=map_dicts(_zeros, params),
                         v=map_dicts(_zeros, params))

    @torch.no_grad()
    def update(grads, state, params, step):
        stepf = _step_f32(step, _first(params))
        sched = _schedule(lr, warmup, stepf)
        c1 = 1 - torch.pow(b1, stepf)
        c2 = 1 - torch.pow(b2, stepf)

        def leaf(p, g, m, v):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g * g))
            pf = p.float()
            upd = (m / c1) / (torch.sqrt(v / c2) + eps) + wd * pf
            p.copy_(pf - sched * upd)

        map_dicts(leaf, params, grads, state.m, state.v)
        return params, state

    return Optimizer("adamw", init, update)


# -- Adafactor (factored second moments) --------------------------------------


class FactoredState(NamedTuple):
    vr: Any      # row stats (or full v for <2D leaves)
    vc: Any      # col stats (or 0-d placeholder)
    mom: Any     # bf16 momentum


def adafactor(lr: float = 1e-3, decay: float = 0.99, eps: float = 1e-30,
              momentum: float = 0.9, warmup: int = 100) -> Optimizer:
    """``momentum=0`` keeps a 0-d bf16 placeholder per leaf instead of the
    momentum tree, as the reference does."""

    def init(params):
        def vr(p):
            return _zeros(p, p.shape[:-1] if p.dim() >= 2 else None)

        def vc(p):
            return _zeros(p, p.shape[:-2] + p.shape[-1:]
                          if p.dim() >= 2 else ())

        def mom(p):
            return _zeros(p, None if momentum else (), torch.bfloat16)

        return FactoredState(vr=map_dicts(vr, params),
                             vc=map_dicts(vc, params),
                             mom=map_dicts(mom, params))

    @torch.no_grad()
    def update(grads, state, params, step):
        stepf = _step_f32(step, _first(params))
        sched = _schedule(lr, warmup, stepf)
        sharded = model_sharded_leaves()
        if sharded is None:
            sharded = map_dicts(lambda _: None, params)

        # the reference's arithmetic, with every full-size temporary
        # written in place where that computes the same values, so that an
        # expert leaf of a full-width MoE needs at most three f32 copies
        def leaf(p, g, vr, vc, mom, split):
            g = g.float()
            g2 = g * g
            g2.add_(eps)
            if p.dim() >= 2:
                # a mean over the dimension the model axis splits is the
                # blocks' sums added over its group, over the whole count
                last = split is not None and split == p.dim() - 1
                rows = split is not None and split == p.dim() - 2
                vr.mul_(decay).add_((1 - decay) * _whole_mean(g2, -1, last))
                vc.mul_(decay).add_((1 - decay) * _whole_mean(g2, -2, rows))
                del g2
                norm = torch.clamp(
                    _whole_mean(vr, -1, rows, keepdim=True)[..., None],
                    min=eps)
                denom = vr[..., None] * vc[..., None, :]
                denom.div_(norm).sqrt_().clamp_(min=1e-12)
                u = g / denom
                del denom
            else:
                vr.mul_(decay).add_((1 - decay) * g2)
                u = g / torch.clamp(torch.sqrt(vr), min=1e-12)
            del g
            # update clipping (Shazeer & Stern): the RMS over the whole
            # leaf, whose blocks the model axis's processes add up
            rms = torch.sqrt(_mean_square(u, split) + 1e-30)
            u.div_(torch.clamp(rms, min=1.0))
            if momentum:
                u = momentum * mom.float() + u
                mom.copy_(u)
            u.mul_(sched)
            p.copy_(p.float().sub_(u))

        map_dicts(leaf, params, grads, state.vr, state.vc, state.mom, sharded)
        return params, state

    return Optimizer("adafactor", init, update)


def _whole_mean(x: torch.Tensor, dim: int, split: bool,
                keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)``, where ``split`` says that each process of the
    model axis holds one equal block of ``x`` along ``dim``: then the
    blocks' sums added over the axis's group, over the whole count."""
    if not split:
        return x.mean(dim=dim, keepdim=keepdim)
    _, group = model_coord()
    total = all_reduce(x.sum(dim=dim, keepdim=keepdim), group, "sum")
    return total / (x.shape[dim] * dist.get_world_size(group))


def _mean_square(u: torch.Tensor, split) -> torch.Tensor:
    """mean(u²) of a whole leaf: of ``u`` itself (``split`` None), or
    where each process of the model axis holds one equal block of it
    along dimension ``split``, the sum over the axis's group over the
    count of the whole leaf."""
    if split is None:
        return torch.mean(u * u)
    _, group = model_coord()
    total = all_reduce(torch.sum(u * u), group, "sum")
    return total / (u.numel() * dist.get_world_size(group))


def sgdm(lr: float = 0.1, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return map_dicts(_zeros, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        del step

        def leaf(p, g, m):
            m.mul_(momentum).add_(g.float())
            p.copy_(p.float() - lr * m)

        map_dicts(leaf, params, grads, state)
        return params, state

    return Optimizer("sgdm", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}[name](**kw)


def opt_state_pspecs(opt: Optimizer, param_specs, aparams, astate, *,
                     by_field: bool = False):
    """Each optimizer-state leaf's spec, found by matching its shape
    against its parameter's: the same shape takes the parameter's spec, the
    row statistics (all but the last dimension) its spec without the last
    entry, the column statistics (all but the next to last) its spec
    without that entry, anything else (a 0-d placeholder) is replicated.
    The states' fields (``AdamState``, ``FactoredState``) mirror the
    parameter tree; sgdm's state is that tree itself.  A nested state of a
    leaf (Sketchy's sketch, a NamedTuple of tensors) is replicated, as the
    reference's is.

    The match tries the rows first, as the reference's does, so the column
    statistics of a leaf whose last two dimensions are equal take the
    rows' spec (ROADMAP §3 note (x)).  ``by_field=True`` lays Adafactor's
    ``vr`` and ``vc`` of a leaf of two dimensions or more out as the rows
    and the columns they are, whatever their shapes: the layout of a
    process mesh's blocks (``train/loop.py``)."""
    del opt

    def leaf(spec, p, s, name=None):
        if s is None:
            return None
        if not hasattr(s, "shape"):
            # a nested state (Sketchy's DS-FD sketch of a leaf): small, and
            # the same on every process, so replicated
            return tree_map(lambda _: (), s)
        t = tuple(spec)
        if name in ("vr", "vc") and p.dim() >= 2:
            return t[:-1] if name == "vr" else t[:-2] + t[-1:]
        if tuple(s.shape) == tuple(p.shape):
            return t
        if tuple(s.shape) == tuple(p.shape[:-1]):
            return t[:-1]
        if p.dim() >= 2 and tuple(s.shape) == tuple(p.shape[:-2]
                                                   + p.shape[-1:]):
            return t[:-2] + t[-1:]
        return ()

    def field(ftree, name=None):
        return map_dicts(lambda sp, p, s: leaf(sp, p, s, name), param_specs,
                         aparams, ftree)

    if hasattr(astate, "_fields"):
        named = by_field and isinstance(astate, FactoredState)
        return type(astate)(*[field(getattr(astate, f), f if named else None)
                              for f in astate._fields])
    return field(astate)
