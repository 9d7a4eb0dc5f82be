#!/usr/bin/env python3
"""Split one launch of each fused krylov-tick kernel into its phases, by
the SM's cycle counter, on the card.

    python3 tools/fused_tick_phases.py [--streams 11 354]

The script copies this checkout's ``repro_torch`` into
``build/fused_tick_phases/`` with ``clock64()`` reads added at the phase
boundaries of ``csrc/fused_tick.cu`` (the copy builds its own library;
the checkout's kernel is not touched), launches ``gram_power`` and the
krylov step once at each number of streams (m = 64, d = 300, 24 power
steps, unit-norm rows from seed 0), and prints, for the first and the last
CTA of each launch, the cycles of each phase as the CTA's thread 0 saw
them: gram_power's Gram (the copy pipeline included), K's store and the
power steps; the step's copy of D, v-extraction, p = Dv with D′, Gram,
the slices' sums with K's store, and the power steps.  The counts include
the reads of the counter and the printf's bookkeeping; they split a
launch, and are no measure of its length.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "fused_tick_phases"

# (anchor in csrc/fused_tick.cu, text added after it, times it occurs)
GRAM_POWER = "PHASES gram_power block %d of %d: gram %lld, store %lld, power %lld"
STEP = ("PHASES step block %d of %d: load %lld, v %lld, p and D' %lld, "
        "gram %lld, gather and store %lld, power %lld")
TAIL = """  init_power(a.K, a.x, m, ldk);
  __syncthreads();
  power_cta(a.K, a.x, m, ldk, rt, iters, floor_norm, lam_out + b,
            u_out + b * m);
}"""


def probe_tail(fmt: str, marks: int) -> str:
    stamps = ", ".join(f"T{k + 1} - T{k}" for k in range(marks))
    return f"""  init_power(a.K, a.x, m, ldk);
  __syncthreads();
  long long T{marks - 1} = clock64();
  power_cta(a.K, a.x, m, ldk, rt, iters, floor_norm, lam_out + b,
            u_out + b * m);
  __syncthreads();
  long long T{marks} = clock64();
  if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1))
    printf("{fmt}\\n", (int)blockIdx.x, (int)gridDim.x, {stamps});
}}"""


def instrument(src: str) -> str:
    def after(anchor: str, text: str, count: int = 1) -> None:
        nonlocal src
        if src.count(anchor) != count:
            raise SystemExit(f"fused_tick_phases.py: the kernel source no "
                             f"longer has {anchor!r} {count} time(s); "
                             "update the anchors")
        src = src.replace(anchor, anchor + text)

    src = src.replace("#include <stdint.h>\n",
                      "#include <stdint.h>\n#include <stdio.h>\n", 1)
    after("  extern __shared__ __align__(16) float smem[];\n",
          "  long long T0 = clock64();\n", 2)
    after("    __syncthreads();  // this panel is free for chunk ch + 2 "
          "(or for K)\n  }\n", "  long long T1 = clock64();\n")
    if src.count(TAIL) != 2:
        raise SystemExit("fused_tick_phases.py: update the anchors")
    src = src.replace(TAIL, probe_tail(GRAM_POWER, 3), 1)
    after('  asm volatile("cp.async.wait_all;" ::: "memory");\n'
          "  __syncthreads();\n", "  long long T1 = clock64();\n")
    after("    snap[b * d + j] = sigma * vj;\n  }\n  __syncthreads();\n",
          "  long long T2 = clock64();\n")
    after("          if (k + 3 < d) g[3] = x.w;\n        }\n      }\n    }\n"
          "  }\n  __syncthreads();\n", "  long long T3 = clock64();\n")
    after("  g.add(sD, ldd, nu, m, slices);\n  __syncthreads();  // D′ is "
          "read; the partial sums and K go over it\n",
          "  long long T4 = clock64();\n")
    src = src.replace(TAIL, probe_tail(STEP, 6), 1)
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, nargs="+", default=[11, 354])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fused_tick_phases.py: no CUDA device", file=sys.stderr)
        return 2
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "src" / "repro_torch" / "csrc" / "fused_tick.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(COPY / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.fused_tick import kernel, ref

    rng = np.random.default_rng(0)
    for S in args.streams:
        x = rng.standard_normal((S, 64, 300)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        D = torch.from_numpy(x).cuda()
        lam, u = ref.gram_power_ref(D, 24)
        for _ in range(2):      # the first launch of each loads the library
            kernel.gram_power_cuda(D, 24)
            torch.cuda.synchronize()
            kernel.fused_krylov_step_cuda(D, lam, u, 24)
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
