#!/usr/bin/env python3
"""Time one checkout's power_iter kernel on the card.

    python3 tools/power_iter_times.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's).  Two versions of the kernel are compared by
running the script once for each tree, in turns (parent, change, change,
parent), each in a process of its own: every tree builds and binds its
own ``csrc/power_iter.cu`` through its own wrapper.  At the fine fleet's
m = 256 and 24 steps, for S = 25 (the median streams of its launches) and
256 (the fleet), the script makes K = X Xᵀ of unit-norm rows X (S, m, 300)
from seed 0, holds the kernel's û within 1e-4 of the tree's plain
version, and times the kernel by CUDA events (median of 5 rounds of 10
calls).  It prints one JSON line: the card's name and power limit (as
``nvidia-smi`` gives them), the tree, and the ms a call at each S.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
M, D, ITERS, STREAMS = 256, 300, 24, (25, 256)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("power_iter_times.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.power_iter import kernel, ref

    rng = np.random.default_rng(0)
    ms = {}
    for S in STREAMS:
        x = rng.standard_normal((S, M, D)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        X = torch.from_numpy(x).cuda()
        K = X @ X.mT

        def call():
            return kernel.power_iter_cuda(K, ITERS)

        got, want = call()[1], ref.power_iter_ref(K, ITERS)[1]
        err = float((got - want).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"power_iter at S = {S}: max |û − plain| "
                                 f"{err:.3e} > 1e-4")
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        rounds = []
        for _ in range(5):
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            rounds.append(start.elapsed_time(end) / 10)
        ms[str(S)] = float(np.median(rounds))
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu": gpu, "src": str(args.src), "m": M,
                      "iters": ITERS, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
