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

Under a mesh of processes (``launch/mesh.py::make_process_mesh``, plain
tensors, one block a process) each process computes the gradients of its
own batch shard; the step then averages every gradient and the loss over
the data axes ('pod', 'data'), one host round trip per dtype
(``parallel/sharding.py::all_reduce_flat``), takes the gradient norm over
the whole model (a leaf the model axis splits adds its sum of squares over
that axis's group) and reports data coordinate 0's balance loss.  Where
the vocabulary is split over the model axis (tensor parallelism), the loss
reads the logits' blocks through the group without gathering them.  The
gradient sketches compute the reference's values on the global arrays:
under a data axis every process holds the same reduced gradients; under a
model axis of more than one process a split leaf's block is hashed by its
global indices and its FD summary is carried across the axis
(``sketch/blocks.py``), so every process holds the same sketches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import api
from repro_torch.models.params import count_params, param_pspecs
from repro_torch.parallel.sharding import (all_reduce, all_reduce_flat,
                                           all_reduce_max, constrain,
                                           current_mesh, data_axes,
                                           is_dtensor, model_coord,
                                           model_sharded, model_size,
                                           split_dim, tp_split)
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
    only to keep the vocab axis sharded; the label logit is gathered here
    (the one-hot form only for DTensor logits), the same value.  Logits
    split by vocabulary over a model axis of processes give their terms
    through the group (:func:`_split_vocab_terms`)."""
    logits, aux = api.forward_train(cfg, params, micro_batch)
    zf = logits.float()
    labels = micro_batch["labels"].long()
    tp = tp_split("vocab", zf)
    if tp is not None:
        lse, label_logit = _split_vocab_terms(zf, labels, tp[0], tp[2])
    elif not is_dtensor(zf):
        lse = torch.logsumexp(zf, dim=-1)                      # (B, S)
        label_logit = torch.gather(zf, -1, labels[..., None])[..., 0]
    else:
        lse = torch.logsumexp(zf, dim=-1)
        # on DTensors, the reference's one-hot keeps the vocab axis
        # sharded: a gather over it would gather the (B, S, V) logits
        onehot = constrain(F.one_hot(labels, zf.shape[-1]).to(zf.dtype),
                           "batch", "seq", "vocab")
        label_logit = torch.sum(zf * onehot, dim=-1)
    loss = torch.mean(lse - label_logit)
    # z-loss keeps the softmax normalizer bounded (stability at scale)
    zl = 1e-4 * torch.mean(lse * lse)
    return loss + aux_coeff * aux + zl, (loss, aux)


def _split_vocab_terms(zf: torch.Tensor, labels: torch.Tensor, m: int,
                       group):
    """(lse, the label's logit), each (B, S) and the same on every process,
    from this process's (B, S, V/M) block ``zf`` of the logits, without
    gathering them: the row maximum all-reduced (no gradient), the sum of
    exponentials all-reduced (which gives the whole lse and its
    gradient), and the label's logit taken where this process holds the
    label and summed over the group."""
    V_l = zf.shape[-1]
    top = all_reduce_max(torch.amax(zf, dim=-1), group)
    total = all_reduce(torch.sum(torch.exp(zf - top[..., None]), dim=-1),
                       group, "sum")
    lse = top + torch.log(total)
    local = labels - m * V_l
    own = (local >= 0) & (local < V_l)
    picked = torch.gather(zf, -1, local.clamp(0, V_l - 1)[..., None])[..., 0]
    label_logit = all_reduce(torch.where(own, picked, picked.new_zeros(())),
                             group, "sum")
    return lse, label_logit


def _grads(cfg: ModelConfig, params, batch, aux_coeff: float):
    ps = [p.requires_grad_(True) for p in leaves(params)]
    tot, (loss, aux) = loss_fn(cfg, params, batch, aux_coeff)
    it = iter(torch.autograd.grad(tot, ps))
    return map_dicts(lambda _: next(it), params), loss.detach(), \
        aux.detach()


def _micro(v: torch.Tensor, i: int, n_micro: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n_micro`` of a batch leaf: rows ``[i·b,
    (i+1)·b)``.  A DTensor batch split over the data axes gives each
    shard's own i-th block instead (``local_map``), so that no shard
    gathers another's rows; the microbatches then differ from the
    one-process split, and their mean gradient does not."""
    if not is_dtensor(v):
        size = v.shape[0] // n_micro
        return v[i * size:(i + 1) * size]
    from torch.distributed.tensor.experimental import local_map

    def block(x):
        b = x.shape[0] // n_micro
        return x[i * b:(i + 1) * b]

    pl = list(v.placements)
    return local_map(block, out_placements=pl, in_placements=(pl,),
                     device_mesh=v.device_mesh)(v)


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
        gacc = map_dicts(lambda p: torch.zeros_like(p, dtype=accum_dtype),
                         params)
        dev = next(leaves(params)).device
        lacc = torch.zeros((), dtype=torch.float32, device=dev)
        aacc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            micro = {k: _micro(v, i, n_micro) for k, v in batch.items()}
            g, loss, aux = _grads(cfg, params, micro, tsc.aux_coeff)
            gacc = map_dicts(lambda a, b: a + b.to(accum_dtype) / n_micro,
                             gacc, g)
            lacc = lacc + loss / n_micro
            aacc = aacc + aux / n_micro
        return gacc, lacc, aacc

    def train_step(params, opt_state, step, batch, sketch_state=None):
        """sketch_state (optional): {"compress": ..., "monitor": ...}, the
        DS-FD training-integration state."""
        split = _model_split(cfg, params)
        grads, loss, aux = grads_of(params, batch)
        grads, loss, aux = _reduce_over_data(grads, loss, aux)
        if sketch_state is not None:
            sk = dict(sketch_state)
        elif tsc.compress is not None or tsc.sketch is not None:
            sk = {}
        else:
            sk = None

        if tsc.compress is not None:
            grads, sk["compress"] = compress_grads(
                tsc.compress, grads, sk.get("compress"), split)

        gnorm = _global_norm(grads, split)
        scale = torch.clamp(tsc.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = map_dicts(lambda g: g * scale.to(g.dtype), grads)

        with model_sharded(split):
            new_params, new_opt = opt.update(grads, opt_state, params, step)
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm}

        if tsc.sketch is not None:
            sk["monitor"], sk_metrics = sketch_update(
                tsc.sketch, sk.get("monitor"), grads, step, split)
            metrics.update(sk_metrics)

        out = (new_params, new_opt, step + 1, metrics)
        if sk is not None:
            return out + (sk,)
        return out

    return train_step


def _in_processes(params) -> bool:
    """True under a mesh of processes (``launch/mesh.py::
    make_process_mesh``) whose parameters are plain tensors, one block a
    process: the step reduces over the mesh's groups itself.  On DTensors
    (the dry-run) DTensor places the reductions."""
    mesh = current_mesh()
    return (mesh is not None and hasattr(mesh, "get_group")
            and not is_dtensor(next(leaves(params))))


def _model_split(cfg: ModelConfig, params):
    """Under a process mesh with a model axis of more than one process,
    the tree (as ``params``) of each leaf's split dimension, read from its
    spec under the rules in force, or None for a leaf every process holds
    whole; None without such an axis.  Dimension 0 is a split: a reader
    tests ``is not None``."""
    if model_size() == 1 or not _in_processes(params):
        return None
    specs = param_pspecs(api.param_defs(cfg))
    return map_dicts(lambda _, spec: split_dim(spec), params, specs)


def _reduce_over_data(grads, loss, aux):
    """Under a process mesh, the mean of every gradient and of the loss
    over the data axes, one reduction per dtype an axis; ``aux`` becomes
    the value of data coordinate 0, as the reference's ``shard_map`` over
    the batch returns its first shard's balance loss (while its gradient
    is the shards' mean: ROADMAP §3 note (w))."""
    axes = data_axes() if _in_processes(grads) else []
    if not axes:
        return grads, loss, aux
    flat = list(leaves(grads))
    for _, idx, n, group in axes:
        out = all_reduce_flat(
            flat + [loss, aux if idx == 0 else torch.zeros_like(aux)], group)
        # the sums are views of one buffer a dtype: divided in place
        flat, loss, aux = [g.div_(n) for g in out[:-2]], out[-2].div_(n), \
            out[-1]
    it = iter(flat)
    return map_dicts(lambda _: next(it), grads), loss, aux


def _global_norm(grads, split) -> torch.Tensor:
    """‖g‖ over every leaf; a leaf the model axis splits (``split``) adds
    its sum of squares over the axis's group."""
    dims = list(leaves(split)) if split is not None else []
    if all(f is None for f in dims):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves(grads)))
    parts = [torch.sum(torch.square(g.float())) for g in leaves(grads)]
    whole = sum(p for p, f in zip(parts, dims) if f is None)
    blocks = sum(p for p, f in zip(parts, dims) if f is not None)
    _, group = model_coord()
    return torch.sqrt(whole + all_reduce(blocks, group, "sum"))


def init_sketch_state(tsc: TrainStepConfig, params, opt: Optimizer,
                      device="cuda", split=None):
    """The DS-FD integration state for this config (or None), on the card
    unless ``device`` names the CPU.  Under a model axis ``split``
    (:func:`_model_split`) gives each leaf's split dimension: a block's
    error feedback has the block's shape."""
    del opt
    if tsc.sketch is None and tsc.compress is None:
        return None
    dev = resolve_device(device)
    sk = {}
    if tsc.compress is not None:
        sk["compress"] = compress_init(tsc.compress, params, dev, split)
    if tsc.sketch is not None:
        sk["monitor"] = sketch_init(tsc.sketch, dev)
    return sk


def pick_optimizer_name(cfg: ModelConfig) -> str:
    """AdamW up to 50B parameters, factored Adafactor beyond."""
    return "adafactor" if count_params(api.param_defs(cfg)) > BIG_PARAMS \
        else "adamw"
