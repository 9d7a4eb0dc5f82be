"""Serving launcher: ``PYTHONPATH=src python -m repro_torch.launch.serve
--arch qwen1.5-0.5b --requests 16`` — runs the continuous-batching engine
over synthetic requests and reports latency and throughput.

Counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain versions of the
kernels).  Without ``--full`` the model is the config's ``reduced()``
form; weights are random, from seed 0, under the reference's init law.
Like the reference's, it sends only tokens, so ``--arch qwen2-vl-2b`` and
``--arch whisper-large-v3`` raise the ``ValueError`` of their missing
M-RoPE ids or frames.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.models import api
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(api.param_defs(cfg), gen, device=dev)
    eng = ServeEngine(cfg, params,
                      EngineConfig(slots=args.slots, s_max=args.s_max,
                                   prefill_buckets=(16, 32)), device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        plen = int(rng.integers(4, 24))
        eng.submit(Request(uid=uid,
                           prompt=rng.integers(0, cfg.vocab,
                                               plen).astype(np.int32),
                           max_new=args.max_new))
    done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done.values())
    lat = [r.latency_s for r in done.values()]
    print(f"{len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s) on {dev} | p50 latency "
          f"{np.median(lat):.2f}s p95 {np.percentile(lat, 95):.2f}s | "
          f"engine ticks {eng.ticks}")


if __name__ == "__main__":
    main()
