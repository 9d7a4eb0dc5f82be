"""Optimizers as (init, update) pairs on parameter trees.

Counterpart of ``repro/train/optimizer.py``:

* ``adamw`` — f32 m and v;
* ``adafactor`` — factored f32 second moments and bf16 momentum;
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

from repro_torch.tree import map_dicts


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

        def leaf(p, g, vr, vc, mom):
            g = g.float()
            g2 = g * g + eps
            if p.dim() >= 2:
                vr.mul_(decay).add_((1 - decay) * g2.mean(dim=-1))
                vc.mul_(decay).add_((1 - decay) * g2.mean(dim=-2))
                norm = torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                   min=eps)
                denom = torch.sqrt(vr[..., None] * vc[..., None, :] / norm)
                u = g / torch.clamp(denom, min=1e-12)
            else:
                vr.mul_(decay).add_((1 - decay) * g2)
                u = g / torch.clamp(torch.sqrt(vr), min=1e-12)
            # update clipping (Shazeer & Stern)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            if momentum:
                u = momentum * mom.float() + u
                mom.copy_(u)
            p.copy_(p.float() - sched * u)

        map_dicts(leaf, params, grads, state.vr, state.vc, state.mom)
        return params, state

    return Optimizer("adafactor", init, update)


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
