"""Training launcher: ``PYTHONPATH=src python -m repro_torch.launch.train
--arch smollm-135m --steps 100 [--sketch] [--compress]``.

Counterpart of ``repro/launch/train.py``, with the same flags but
``--mesh`` (the port runs on one device) plus ``--device`` (``cuda`` by
default; ``cpu`` runs the plain versions of the kernels).  Without
``--full`` the model is the config's ``reduced()`` form; ``--full`` trains
the full config on the card.  Weights are random, from the loop's seed 0,
under the reference's init law.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="the full config (on the card)")
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
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.train_step import TrainStepConfig

    dev = resolve_device(args.device)
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

    res = train(cfg, device=dev,
                loop=LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir),
                tsc=TrainStepConfig(**tsc_kw), opt=opt,
                seq_len=args.seq_len, global_batch=args.global_batch)
    print(f"final loss {res['history'][-1]['loss']:.4f} | "
          f"{res['steps_per_s']:.2f} steps/s | "
          f"stragglers flagged: {res['stragglers']} | on {dev}")
    return res


if __name__ == "__main__":
    main()
