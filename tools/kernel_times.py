#!/usr/bin/env python3
"""Time one checkout's hand-written kernel on the card, at the sizes its
path launches it with.

    python3 tools/kernel_times.py KERNEL [--src DIR]

``KERNEL`` is ``power_iter``, ``gram_power`` or ``fused_krylov_step``;
``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's).  Two versions of a kernel are compared by running
the script once for each tree, in turns (parent, change, change, parent),
each in a process of its own: every tree builds and binds its own
``csrc`` through its own wrapper.  The inputs are unit-norm rows from
seed 0, 24 power steps:

- ``power_iter``: K = X Xᵀ of X (S, 256, 300), the fine fleet's m, at
  S = 25 (the median streams of its launches) and 256 (the fleet);
- ``gram_power``: D (S, 64, 300), the krylov fleet's m, at S = 354, 450
  and 2036 (the median, 90th percentile and most streams of its launches
  in ``chip_smoke.py``'s krylov phase) and 1024 (the fleet);
- ``fused_krylov_step``: the same D with λ̂, û from the plain gram_power,
  at S = 11, 20 and 36 (its launches' median, p90 and most) and 1024.

At each S the script holds the kernel's outputs to the tree's plain
version (λ̂ within 1e-4 + 1e-4·|λ̂|, every other output within 1e-4), then
times it by CUDA events (median of 5 rounds of 10 calls) and by device
time (``chip_smoke.device_ms``: the kernels' own time under
``torch.profiler``, null where the profiler's sessions disagree).  It
prints one JSON line: the card's name and power limit (as ``nvidia-smi``
gives them), the kernel, the tree, and the ms a call at each S.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ITERS = 24
SIZES = {"power_iter": (256, 300, (25, 256)),
         "gram_power": (64, 300, (354, 450, 2036, 1024)),
         "fused_krylov_step": (64, 300, (11, 20, 36, 1024))}
TOL = 1e-4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(SIZES))
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_times.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.src.resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch.kernels.fused_tick import kernel as fk, ref as fr
    from repro_torch.kernels.power_iter import kernel as pk, ref as pr

    m, d, streams = SIZES[args.kernel]
    rng = np.random.default_rng(0)
    ms, dev = {}, {}
    for S in streams:
        x = rng.standard_normal((S, m, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        D = torch.from_numpy(x).cuda()
        if args.kernel == "power_iter":
            K = D @ D.mT
            call = lambda: pk.power_iter_cuda(K, ITERS)          # noqa: E731
            want = pr.power_iter_ref(K, ITERS)
        elif args.kernel == "gram_power":
            call = lambda: fk.gram_power_cuda(D, ITERS)          # noqa: E731
            want = fr.gram_power_ref(D, ITERS)
        else:
            lam, u = fr.gram_power_ref(D, ITERS)
            call = lambda: fk.fused_krylov_step_cuda(            # noqa: E731
                D, lam, u, ITERS)
            want = fr.fused_krylov_step_ref(D, lam, u, ITERS)
        for i, (g, w) in enumerate(zip(call(), want)):
            tol = TOL + (TOL * float(w.abs().max()) if g.dim() == 1 else 0.)
            err = float((g - w).abs().max())
            if not err <= tol:
                raise AssertionError(f"{args.kernel} at S = {S}: output {i} "
                                     f"max |kernel − plain| {err:.3e} > "
                                     f"{tol:.1e}")
        ms[str(S)] = chip_smoke.time_in_turns({"k": call})["k"]
        dev[str(S)] = chip_smoke.device_ms(call)
    print(json.dumps({"gpu": chip_smoke.gpu_line(), "kernel": args.kernel,
                      "src": str(args.src), "m": m, "d": d, "iters": ITERS,
                      "ms": ms, "device_ms": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
