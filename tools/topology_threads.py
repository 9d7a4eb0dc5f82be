#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s topology phase with the two processes' CPU
threads split and unsplit.

    python3 tools/topology_threads.py [--ticks 160]

``launch/mesh.py::init_distributed`` gives each of the pair's processes
an even share of the host's cores unless ``OMP_NUM_THREADS`` is set.  The
script builds the kernels, runs the history phase once (the history
pair's answers are held to it), then runs the whole topology phase twice,
every check of it included: first with ``OMP_NUM_THREADS`` set to all the
host's cores in both children, then with the split.  Each run also times
one process at the same S on the same feed.  Last, one process alone
drives the first half of the fleet (users [0, 128) of the same feed, the
card to itself): what a process of the pair would take unshared.  It
prints the card's name and power limit (as ``nvidia-smi`` gives them)
and, last, one JSON line: each run's threads, the pair's ms per tick per
process, one process's ms per tick, and the half fleet's alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("topology_threads.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    import chip_smoke
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import host_threads

    gpu = chip_smoke.gpu_line()
    dispatch.build()
    hist = chip_smoke.run_history(
        chip_smoke.WINDOW // chip_smoke.BLOCK + 512 // chip_smoke.BLOCK,
        args.seed + 600)
    runs = []
    for label, env in (("unsplit", str(host_threads(1))), ("split", None)):
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
        out = chip_smoke.run_topology(args.ticks, hist, args.seed + 700)
        runs.append({"run": label, "threads": out["threads"],
                     "ms_tick": out["ms_tick"], "ms_one": out["ms_one"]})
    os.environ.pop("OMP_NUM_THREADS", None)

    from repro_torch.serve.engine import SketchFleetEngine

    half = chip_smoke.TOPO_STREAMS // 2
    eng = SketchFleetEngine(
        "dsfd", d=chip_smoke.D, streams=half, eps=chip_smoke.TOPO_EPS,
        window=chip_smoke.WINDOW, block=chip_smoke.BLOCK, mode="krylov",
        use_kernel=True, ingest="async", device="cuda")
    feed = chip_smoke._mixed_feed(chip_smoke.TOPO_STREAMS, args.ticks,
                                     args.seed + 700, 0, half)
    ms_half = chip_smoke._drive_fleet(eng, feed, 0, half)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"gpu": gpu, "ticks": args.ticks, "runs": runs,
                      "ms_half_alone": ms_half}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
