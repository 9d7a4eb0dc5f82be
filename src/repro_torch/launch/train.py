"""Training launcher: ``PYTHONPATH=src python -m repro_torch.launch.train
--arch smollm-135m --steps 100 [--mesh host] [--sketch] [--compress]``.

Counterpart of ``repro/launch/train.py``, with the same flags plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain versions of the
kernels).  Without ``--full`` the model is the config's ``reduced()``
form; ``--full`` trains the full config on the card.  Weights are random,
from the loop's seed 0, under the reference's init law.

``--mesh host`` (the default) puts this process's group on 'data': under
torchrun (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` set)
the processes meet through ``launch/mesh.py::init_distributed`` (gloo, so
they may share one card) and train data-parallel; otherwise one process
trains alone.  ``pod`` and ``multipod`` are the reference's 256- and
512-device meshes, which no host here has: they raise, and the dry-run
(``launch/dryrun.py``) traces them.
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="the full config (on the card)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--sketch", action="store_true",
                    help="enable the DS-FD gradient monitor")
    ap.add_argument("--compress", action="store_true",
                    help="enable FD gradient compression (EF)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgdm", "sketchy"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                         shutdown)
    from repro_torch.parallel.sharding import mesh_shape
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.train_step import TrainStepConfig

    dev = resolve_device(args.device)
    if args.mesh != "host":
        raise ValueError(
            f"--mesh {args.mesh} needs {512 if args.mesh == 'multipod' else 256}"
            " ranks; trace it with repro_torch.launch.dryrun instead")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()

    tsc_kw = {}
    if args.sketch:
        from repro_torch.sketch import SketchConfig
        tsc_kw["sketch"] = SketchConfig(d=128, eps=0.125, window=128)
    if args.compress:
        from repro_torch.sketch import CompressConfig
        tsc_kw["compress"] = CompressConfig(rank=8, eps=0.125, window=32,
                                            min_size=4096)
    opt = None
    if args.optimizer == "sketchy":
        from repro_torch.sketch import SketchyConfig, sketchy_dsfd
        opt = sketchy_dsfd(SketchyConfig())
    elif args.optimizer != "adamw":
        from repro_torch.train.optimizer import get_optimizer
        opt = get_optimizer(args.optimizer)

    env = os.environ
    joined = all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                    "MASTER_PORT"))
    if joined:
        init_distributed(int(env["RANK"]), int(env["WORLD_SIZE"]),
                         env["MASTER_ADDR"], int(env["MASTER_PORT"]))
    try:
        mesh = make_host_mesh(dev)
        res = train(cfg, mesh, device=dev,
                    loop=LoopConfig(steps=args.steps,
                                    ckpt_dir=args.ckpt_dir),
                    tsc=TrainStepConfig(**tsc_kw), opt=opt,
                    seq_len=args.seq_len, global_batch=args.global_batch)
    finally:
        if joined:
            shutdown()
    print(f"final loss {res['history'][-1]['loss']:.4f} | "
          f"{res['steps_per_s']:.2f} steps/s | "
          f"stragglers flagged: {res['stragglers']} | on {dev} | mesh "
          f"{dict(mesh_shape(mesh))}")
    return res


if __name__ == "__main__":
    main()
