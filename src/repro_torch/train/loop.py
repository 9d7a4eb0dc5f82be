"""Training loop: the train step, periodic async checkpoints, elastic
resume (another mesh is fine), a straggler watchdog, and the DS-FD sketch
integrations wired through.

Counterpart of ``repro/train/loop.py``.  Without a mesh the job runs on
one device.  Under a ("data", "model") mesh of processes
(``launch/mesh.py::make_process_mesh``: gloo, so processes may share one
card) each process holds its block of the experts and, in the transformer
families, of the heads, the FFN and the vocabulary (tensor parallelism;
the dense part whole where the step carries a gradient sketch:
:func:`train_rules`), trains on its data coordinate's slice of the batch, and the train step reduces over the mesh's groups
(``train/train_step.py``); the reference's ``device_put`` by
``param_pspecs``/``opt_state_pspecs`` becomes each process keeping its
block.  The parameters are drawn by ``models/params.py::init_params``
from a ``torch.Generator`` seeded by ``loop.seed`` (each process draws the
whole tree and keeps its block), and checkpoints of ``(params, opt_state,
step)`` with the pipeline's ``data_state`` and the mesh's shape go through
``train/checkpoint.py`` in the reference's layout of full arrays, so
either package resumes the other's run on any mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import api
from repro_torch import convert
from repro_torch.launch.mesh import default_store, process_runtime
from repro_torch.models.params import (abstract_params, init_params,
                                       param_pspecs)
from repro_torch.parallel.sharding import (TP_AXES, axis_rules, make_rules,
                                           mesh_shape, split_dim)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (Optimizer, get_optimizer,
                                         opt_state_pspecs)
from repro_torch.train.train_step import (
    TrainStepConfig, _model_split, build_train_step, init_sketch_state)

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    # straggler watchdog: warn when a step exceeds `straggler_factor` ×
    # the rolling median of the last `straggler_window` steps
    straggler_factor: float = 3.0
    straggler_window: int = 32


class StragglerWatchdog:
    def __init__(self, cfg: LoopConfig):
        self.cfg = cfg
        self.times: list = []
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        ts = self.times
        ts.append(dt)
        if len(ts) > self.cfg.straggler_window:
            ts.pop(0)
        if len(ts) >= 8:
            med = float(np.median(ts))
            if dt > self.cfg.straggler_factor * med:
                self.flagged += 1
                log.warning("straggler step: %.3fs vs median %.3fs",
                            dt, med)
                return True
        return False


TP_FAMILIES = ("dense", "moe")              # models/transformer.py's


def train_rules(cfg: ModelConfig, mesh, *,
                sketched: bool = False) -> Dict[str, object]:
    """The logical-axis rules of a train step over a process mesh: the
    reference's table for ``mesh`` (``parallel/sharding.py::make_rules``)
    with the batch on the data axes, the experts (and 'expert_ff', where
    the table puts it there) on the model axis and, for the transformer
    families (``TP_FAMILIES``), 'heads', 'kv', 'ff' and 'vocab' where the
    table puts them on it: Megatron's tensor parallelism
    (``models/transformer.py``).  Every other rule is None, so each
    process holds those leaves whole: 'seq_attn' and 'kv_seq' (a model
    whose heads do not divide the axis keeps its attention whole), 'lru',
    'inner' and 'embed'.

    A step that carries a gradient sketch (``sketched``: the monitor, FD
    compression or Sketchy) keeps the dense part whole and splits only the
    experts: the sketches' FD over rows split by columns is not ported
    (ROADMAP §1, 'The gradient sketches over column-split leaves').  This
    is a layout, not a fallback: the step computes the same function."""
    with axis_rules(mesh, {}):       # the experts' count at this model size
        rules = make_rules(mesh, api.sharding_dims(cfg))
    keep = ("batch", "experts", "expert_ff")
    if cfg.family in TP_FAMILIES and not sketched:
        keep += TP_AXES
    return {k: (v if k in keep else None) for k, v in rules.items()}


def _layout_line(cfg: ModelConfig, shape, rules, sketched: bool) -> str:
    split = [k for k in TP_AXES + ("experts",) if rules.get(k) is not None]
    line = (f"{cfg.name} on mesh {dict(shape)}: "
            + (f"{', '.join(split)} split over 'model'" if split
               else "every leaf whole on each process"))
    if sketched and cfg.family in TP_FAMILIES:
        line += ("; the dense part whole on each process, since the step "
                 "carries a gradient sketch (ROADMAP §1, 'The gradient "
                 "sketches over column-split leaves')")
    return line


def _coords(mesh) -> Dict[str, int]:
    """This process's coordinate on each axis of ``mesh``: a mesh of
    processes (``launch/mesh.py::make_process_mesh``), or a plain shape
    of one process."""
    if hasattr(mesh, "get_group"):
        return convert.mesh_coords(mesh)
    shape = mesh_shape(mesh)
    if any(int(n) > 1 for n in shape.values()):
        raise ValueError(f"a {dict(shape)} mesh has more than one process: "
                         "build it over a process group "
                         "(launch/mesh.py::make_process_mesh)")
    return {a: 0 for a in shape}


def _aligned(tree, specs) -> list:
    """The spec of every leaf of ``tree`` in leaf order (that of
    ``train/checkpoint.py::leaves_with_paths``), from ``specs``, a tree of
    the same containers whose leaves are spec tuples."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _aligned(tree[k], specs[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _aligned(getattr(tree, f), getattr(specs, f))]
    if isinstance(tree, (list, tuple)):
        return [x for t, sp in zip(tree, specs) for x in _aligned(t, sp)]
    return [tuple(specs)]


def _state_layout(defs, opt: Optimizer, rules, mesh, coords, param_dtype):
    """(full shapes, this process's blocks) of every leaf of the train
    state ``(params, opt_state, step)`` in leaf order: a leaf whose spec
    names the model axis is a block, any other is held whole."""
    pspecs = param_pspecs(defs, rules)
    aparams = abstract_params(defs, param_dtype)
    astate = opt.init(aparams)
    ospecs = opt_state_pspecs(opt, pspecs, aparams, astate, by_field=True)
    atree = (aparams, astate, torch.zeros((), device="meta"))
    specs = _aligned(atree, (pspecs, ospecs, ()))
    shapes = [tuple(x.shape) for _, x in ckpt.leaves_with_paths(atree)]
    blocks = [convert.block_of(sh, sp, mesh, coords)
              if split_dim(sp) is not None else None
              for sh, sp in zip(shapes, specs)]
    return shapes, blocks


def train(cfg: ModelConfig, mesh=None, *, device="cuda",
          loop: LoopConfig = LoopConfig(),
          tsc: TrainStepConfig = TrainStepConfig(),
          opt: Optional[Optimizer] = None,
          pipeline: Optional[TokenPipeline] = None,
          seq_len: int = 128, global_batch: int = 8,
          param_dtype=torch.float32,
          hooks: Optional[Dict[str, Callable]] = None) -> Dict[str, Any]:
    """Run (or resume) a training job on ``device`` (the card unless it
    names the CPU).  Returns the final state and metrics.

    With ``mesh`` (a ("data", "model") mesh of processes from
    ``launch/mesh.py``, or the plain shape of one process) the job runs
    under :func:`train_rules`: this process draws its block of the seeded
    parameters, trains on its data coordinate's slice of each global
    batch, saves its part of every checkpoint (full arrays on disk, the
    mesh's shape in the manifest) and resumes a checkpoint saved on any
    mesh.  The returned parameters and optimizer states are this
    process's blocks."""
    dev = resolve_device(device)
    hooks = hooks or {}
    opt = opt or get_optimizer("adamw", lr=1e-3, warmup=20)
    pipeline = pipeline or TokenPipeline(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=loop.seed)
    shape, coords, rules = {}, {}, None
    if mesh is not None:
        shape, coords = dict(mesh_shape(mesh)), _coords(mesh)
        sketched = (tsc.sketch is not None or tsc.compress is not None
                    or opt.name.startswith("sketchy"))
        rules = train_rules(cfg, mesh, sketched=sketched)
        log.info("layout: %s", _layout_line(cfg, shape, rules, sketched))
    split = int(shape.get("model", 1)) > 1
    d_idx, d_n = 0, 1          # this process's slice of the global batch
    for a in ("pod", "data"):
        if a in shape:
            d_idx, d_n = d_idx * int(shape[a]) + coords[a], d_n * int(shape[a])
    mesh_dims = tuple(int(n) for n in shape.values()) or None

    with (axis_rules(mesh, rules) if mesh is not None
          else contextlib.nullcontext()):
        defs = api.param_defs(cfg)
        gen = torch.Generator(device=dev).manual_seed(loop.seed)
        params = init_params(
            defs, gen, param_dtype, dev,
            local=(lambda d: convert.local_block(d, rules, mesh, coords))
            if split else None)
        opt_state = opt.init(params)
        step = torch.zeros((), dtype=torch.int32, device=dev)
        data_state = pipeline.init_state()
        sketch_state = init_sketch_state(tsc, params, opt, dev,
                                         _model_split(cfg, params))

        saver = None
        if loop.ckpt_dir:
            state = (params, opt_state, step)
            if split:
                shapes, blocks = _state_layout(defs, opt, rules, mesh, coords,
                                               param_dtype)
            else:
                shapes = [tuple(x.shape)
                          for _, x in ckpt.leaves_with_paths(state)]
                blocks = [None] * len(shapes)
            world, rank = process_runtime()
            layout = None
            if hasattr(mesh, "get_group") and world > 1:
                layout = ckpt.Layout(shapes=tuple(shapes),
                                     blocks=tuple(blocks), writer=d_idx == 0,
                                     rank=rank, world=world,
                                     store=default_store())
            saver = ckpt.AsyncCheckpointer(loop.ckpt_dir, layout=layout)
            if ckpt.latest_step(loop.ckpt_dir) is not None:
                (params, opt_state, step), manifest = ckpt.restore(
                    loop.ckpt_dir, state, device=dev,
                    blocks=lambda i, _: blocks[i])
                data_state = manifest.get("data_state") or data_state
                log.info("resumed from step %s (saved on mesh %s)",
                         manifest["step"], manifest.get("mesh_shape"))

        fn = build_train_step(cfg, opt, tsc)
        watchdog = StragglerWatchdog(loop)
        history = []
        t_start = time.time()
        start_step = int(step)
        for it in range(start_step, loop.steps):
            data_state, batch = pipeline.next_batch(data_state)
            if d_n > 1:
                batch = pipeline.shard_slice(batch, d_idx, d_n)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            t0 = time.time()
            if sketch_state is None:
                params, opt_state, step, metrics = fn(params, opt_state,
                                                      step, batch)
            else:
                params, opt_state, step, metrics, sketch_state = fn(
                    params, opt_state, step, batch, sketch_state)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            watchdog.observe(dt)
            history.append(metrics)
            if it % loop.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", it, metrics["loss"],
                         dt)
            if "on_step" in hooks:
                hooks["on_step"](it, metrics)
            if saver and (it + 1) % loop.ckpt_every == 0:
                saver.save(int(step), (params, opt_state, step),
                           data_state=data_state, mesh_shape=mesh_dims)
        if saver:
            saver.save(int(step), (params, opt_state, step),
                       data_state=data_state, mesh_shape=mesh_dims)
            saver.wait()

    return {
        "params": params, "opt_state": opt_state, "step": int(step),
        "history": history, "stragglers": watchdog.flagged,
        "sketch_state": sketch_state,
        "steps_per_s": (loop.steps - start_step)
        / max(time.time() - t_start, 1e-9),
    }
