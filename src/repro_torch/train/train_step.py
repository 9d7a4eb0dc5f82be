"""Train step: microbatched gradient accumulation, cross-entropy loss (+ MoE
aux), the optimizer update, and the optional DS-FD gradient sketches
(monitor) and FD gradient compression.

Counterpart of ``repro/train/train_step.py``.  The step's order is the
reference's: gradients (accumulated over microbatches in
``accum_dtype``), compression, the clip to ``grad_clip``, the optimizer
update, then the monitor on the clipped gradients.  The reference's jitted
``lax.scan`` over microbatches is a Python loop of ``torch.autograd.grad``
calls; the parameters are the nested dict of tensors the optimizer updates
in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import api
from repro_torch.models.params import count_params
from repro_torch.sketch.compress import compress_grads, compress_init
from repro_torch.sketch.monitor import sketch_init, sketch_update
from repro_torch.train.optimizer import Optimizer
from repro_torch.tree import leaves, map_dicts

ACT_BUDGET = 2 * 1024**3          # per-device activation-checkpoint budget
BIG_PARAMS = 50e9                 # > this → Adafactor


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_micro: int = 1
    accum_dtype: str = "float32"
    aux_coeff: float = 0.01
    grad_clip: float = 1.0
    sketch: Optional[object] = None       # repro_torch.sketch.SketchConfig
    compress: Optional[object] = None     # repro_torch.sketch.CompressConfig


def auto_microbatches(cfg: ModelConfig, shape: ShapeSpec,
                      data_shards: int, *, fsdp: bool = False,
                      nparams: float = 0.0) -> int:
    """Choose n_micro so a device's layer-checkpoint bytes (a bf16 carry
    per layer) fit ``ACT_BUDGET``; a power of two that divides the local
    batch, at most 8 under FSDP for the ≥500B tier (the reference's
    rule)."""
    per_layer = shape.seq_len * cfg.d_model * 2
    n_layers = cfg.n_layers + cfg.enc_layers
    local_batch = max(shape.global_batch // max(data_shards, 1), 1)
    total = per_layer * n_layers * local_batch
    n = 1
    while total / n > ACT_BUDGET and n < local_batch:
        n *= 2
    while local_batch % n and n < local_batch:
        n *= 2
    n = min(n, local_batch)
    if fsdp and nparams > 500e9:
        n = min(n, 8)
    return n


def loss_fn(cfg: ModelConfig, params, micro_batch,
            aux_coeff: float = 0.01):
    """Cross-entropy ``logsumexp(z) − z[label]`` plus the z-loss
    1e-4·mean(lse²) and ``aux_coeff``·aux.  The reference forms a one-hot
    only to keep the vocab axis sharded; the label logit is gathered here,
    the same value."""
    logits, aux = api.forward_train(cfg, params, micro_batch)
    zf = logits.float()
    lse = torch.logsumexp(zf, dim=-1)                          # (B, S)
    labels = micro_batch["labels"].long()
    label_logit = torch.gather(zf, -1, labels[..., None])[..., 0]
    loss = torch.mean(lse - label_logit)
    # z-loss keeps the softmax normalizer bounded (stability at scale)
    zl = 1e-4 * torch.mean(lse * lse)
    return loss + aux_coeff * aux + zl, (loss, aux)


def _grads(cfg: ModelConfig, params, batch, aux_coeff: float):
    ps = [p.requires_grad_(True) for p in leaves(params)]
    tot, (loss, aux) = loss_fn(cfg, params, batch, aux_coeff)
    it = iter(torch.autograd.grad(tot, ps))
    return map_dicts(lambda _: next(it), params), loss.detach(), \
        aux.detach()


def build_train_step(cfg: ModelConfig, opt: Optimizer,
                     tsc: TrainStepConfig = TrainStepConfig()):
    """Returns train_step(params, opt_state, step, batch [, sketch_state])
    → (params, opt_state, step+1, metrics [, sketch_state]).  ``step`` is
    a 0-d int32 tensor; ``metrics`` holds 0-d tensors."""
    accum_dtype = getattr(torch, tsc.accum_dtype)

    def grads_of(params, batch):
        n_micro = tsc.n_micro
        if n_micro <= 1:
            return _grads(cfg, params, batch, tsc.aux_coeff)
        B = next(iter(batch.values())).shape[0]
        if B % n_micro:
            # the reference's reshape to (n_micro, B // n_micro, ...) fails
            raise ValueError(f"n_micro={n_micro} does not divide the "
                             f"batch of {B}")
        size = B // n_micro
        gacc = map_dicts(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                               device=p.device), params)
        dev = next(leaves(params)).device
        lacc = torch.zeros((), dtype=torch.float32, device=dev)
        aacc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            g, loss, aux = _grads(cfg, params, micro, tsc.aux_coeff)
            gacc = map_dicts(lambda a, b: a + b.to(accum_dtype) / n_micro,
                             gacc, g)
            lacc = lacc + loss / n_micro
            aacc = aacc + aux / n_micro
        return gacc, lacc, aacc

    def train_step(params, opt_state, step, batch, sketch_state=None):
        """sketch_state (optional): {"compress": ..., "monitor": ...}, the
        DS-FD training-integration state."""
        grads, loss, aux = grads_of(params, batch)
        if sketch_state is not None:
            sk = dict(sketch_state)
        elif tsc.compress is not None or tsc.sketch is not None:
            sk = {}
        else:
            sk = None

        if tsc.compress is not None:
            grads, sk["compress"] = compress_grads(
                tsc.compress, grads, sk.get("compress"))

        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves(grads)))
        scale = torch.clamp(tsc.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = map_dicts(lambda g: g * scale.to(g.dtype), grads)

        new_params, new_opt = opt.update(grads, opt_state, params, step)
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm}

        if tsc.sketch is not None:
            sk["monitor"], sk_metrics = sketch_update(
                tsc.sketch, sk.get("monitor"), grads, step)
            metrics.update(sk_metrics)

        out = (new_params, new_opt, step + 1, metrics)
        if sk is not None:
            return out + (sk,)
        return out

    return train_step


def init_sketch_state(tsc: TrainStepConfig, params, opt: Optimizer,
                      device="cuda"):
    """The DS-FD integration state for this config (or None), on the card
    unless ``device`` names the CPU."""
    del opt
    if tsc.sketch is None and tsc.compress is None:
        return None
    dev = resolve_device(device)
    sk = {}
    if tsc.compress is not None:
        sk["compress"] = compress_init(tsc.compress, params, dev)
    if tsc.sketch is not None:
        sk["monitor"] = sketch_init(tsc.sketch, dev)
    return sk


def pick_optimizer_name(cfg: ModelConfig) -> str:
    """AdamW up to 50B parameters, factored Adafactor beyond."""
    return "adafactor" if count_params(api.param_defs(cfg)) > BIG_PARAMS \
        else "adamw"
