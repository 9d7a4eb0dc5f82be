"""Training loop: the train step, periodic async checkpoints, resume, a
straggler watchdog, and the DS-FD sketch integrations wired through.

Counterpart of ``repro/train/loop.py`` on one device: there is no mesh
(the reference's logical-axis sharding rules wait for the model slice
that needs several cards), the parameters are drawn by
``models/params.py::init_params`` from a ``torch.Generator`` seeded by
``loop.seed``, and checkpoints of ``(params, opt_state, step)`` with the
pipeline's ``data_state`` go through ``train/checkpoint.py`` in the
reference's layout, so either package resumes the other's run.
"""

from __future__ import annotations

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
from repro_torch.models.params import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import Optimizer, get_optimizer
from repro_torch.train.train_step import (TrainStepConfig, build_train_step,
                                          init_sketch_state)

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


def train(cfg: ModelConfig, *, device="cuda",
          loop: LoopConfig = LoopConfig(),
          tsc: TrainStepConfig = TrainStepConfig(),
          opt: Optional[Optimizer] = None,
          pipeline: Optional[TokenPipeline] = None,
          seq_len: int = 128, global_batch: int = 8,
          param_dtype=torch.float32,
          hooks: Optional[Dict[str, Callable]] = None) -> Dict[str, Any]:
    """Run (or resume) a training job on ``device`` (the card unless it
    names the CPU).  Returns the final state and metrics."""
    dev = resolve_device(device)
    hooks = hooks or {}
    opt = opt or get_optimizer("adamw", lr=1e-3, warmup=20)
    pipeline = pipeline or TokenPipeline(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=loop.seed)

    gen = torch.Generator(device=dev).manual_seed(loop.seed)
    params = init_params(api.param_defs(cfg), gen, param_dtype, dev)
    opt_state = opt.init(params)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    data_state = pipeline.init_state()
    sketch_state = init_sketch_state(tsc, params, opt, dev)

    saver = None
    if loop.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(loop.ckpt_dir)
        if ckpt.latest_step(loop.ckpt_dir) is not None:
            (params, opt_state, step), manifest = ckpt.restore(
                loop.ckpt_dir, (params, opt_state, step), device=dev)
            data_state = manifest.get("data_state") or data_state
            log.info("resumed from step %s", manifest["step"])

    fn = build_train_step(cfg, opt, tsc)
    watchdog = StragglerWatchdog(loop)
    history = []
    t_start = time.time()
    start_step = int(step)
    for it in range(start_step, loop.steps):
        data_state, batch = pipeline.next_batch(data_state)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        t0 = time.time()
        if sketch_state is None:
            params, opt_state, step, metrics = fn(params, opt_state, step,
                                                  batch)
        else:
            params, opt_state, step, metrics, sketch_state = fn(
                params, opt_state, step, batch, sketch_state)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        watchdog.observe(dt)
        history.append(metrics)
        if it % loop.log_every == 0:
            log.info("step %d loss %.4f (%.2fs)", it, metrics["loss"], dt)
        if "on_step" in hooks:
            hooks["on_step"](it, metrics)
        if saver and (it + 1) % loop.ckpt_every == 0:
            saver.save(int(step), (params, opt_state, step),
                       data_state=data_state)
    if saver:
        saver.save(int(step), (params, opt_state, step),
                   data_state=data_state)
        saver.wait()

    return {
        "params": params, "opt_state": opt_state, "step": int(step),
        "history": history, "stragglers": watchdog.flagged,
        "sketch_state": sketch_state,
        "steps_per_s": (loop.steps - start_step)
        / max(time.time() - t_start, 1e-9),
    }
