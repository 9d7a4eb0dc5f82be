#!/usr/bin/env python3
"""Time one checkout's hand-written kernel on the card, at the sizes its
path launches it with.

    python3 tools/kernel_times.py KERNEL [--src DIR]

``KERNEL`` is ``power_iter``, ``gram_power``, ``fused_krylov_step``,
``flash_fwd`` or ``flash_bwd``; ``--src`` is the ``src`` directory whose
``repro_torch`` is timed (by default this checkout's).  Two versions of a
kernel are compared by running the script once for each tree, in turns
(parent, change, change, parent), each in a process of its own: every tree
builds and binds its own ``csrc`` through its own wrapper.  The inputs are
made from seed 0:

- ``power_iter``: K = X Xᵀ of unit-norm rows X (S, 256, 300), the fine
  fleet's m, at S = 25 (the median streams of its launches) and 256 (the
  fleet), 24 power steps;
- ``gram_power``: D (S, 64, 300), the krylov fleet's m, at S = 354, 450
  and 2036 (the median, 90th percentile and most streams of its launches
  in ``chip_smoke.py``'s krylov phase) and 1024 (the fleet);
- ``fused_krylov_step``: the same D with λ̂, û from the plain gram_power,
  at S = 11, 20 and 36 (its launches' median, p90 and most) and 1024;
- ``flash_fwd``: standard normal q, k, v, causal, in f32 at smollm-135m's
  training shape (B, S, H, Hkv, dh) = (8, 1024, 9, 3, 64) and llama3-8b's
  f32 prefill (1, 512, 32, 8, 128), in bf16 at grok-1's bucket 512
  (1, 512, 48, 8, 128);
- ``flash_bwd``: the backward on the forward kernel's o and lse and a
  standard normal dO, in f32 at the training shape, in bf16 at grok-1's
  train step (4, 512, 48, 8, 128) and at the training shape.

At each size the script holds the kernel's outputs to the tree's plain
version (λ̂ within 1e-4 + 1e-4·|λ̂|, lse within 1e-3, every other f32
output within 1e-4, a bf16 one within 2e-2 + 2e-2·|plain|: one bf16
rounding), then times it by CUDA events (median of 5 rounds of 10
calls) and by device time (``chip_smoke.device_ms``: the kernels' own time
under ``torch.profiler``, null where the profiler's sessions disagree).
It prints one JSON line: the card's name and power limit (as
``nvidia-smi`` gives them), the kernel, the tree, the ms a call at each
size, and, from the kernel's library, each ``__global__`` function's
registers and spills (the build's ``-Xptxas -v`` log) and the tensor-core
opcodes of its SASS (``cuobjdump -sass``).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ITERS = 24
# (m, d, S at each timed size) of the sketch kernels
SIZES = {"power_iter": (256, 300, (25, 256)),
         "gram_power": (64, 300, (354, 450, 2036, 1024)),
         "fused_krylov_step": (64, 300, (11, 20, 36, 1024))}
# (label, B, S, H, Hkv, dh, dtype) of the flash kernels, causal
TRAIN = ("train", 8, 1024, 9, 3, 64, "float32")
PREFILL = ("llama3-8b f32 prefill", 1, 512, 32, 8, 128, "float32")
GROK_PREFILL = ("grok-1 bf16 bucket 512", 1, 512, 48, 8, 128, "bfloat16")
GROK_TRAIN = ("grok-1 bf16 train", 4, 512, 48, 8, 128, "bfloat16")
TRAIN_BF16 = ("train bf16", 8, 1024, 9, 3, 64, "bfloat16")
FLASH_SIZES = {"flash_fwd": (TRAIN, PREFILL, GROK_PREFILL),
               "flash_bwd": (TRAIN, GROK_TRAIN, TRAIN_BF16)}
LIBRARY = {"power_iter": "power_iter", "gram_power": "fused_tick",
           "fused_krylov_step": "fused_tick", "flash_fwd": "flash_attn",
           "flash_bwd": "flash_attn_bwd"}
TOL, LSE_TOL, BF16_TOL = 1e-4, 1e-3, 2e-2
TENSOR_CORE = re.compile(r"\b(HMMA|HGMMA|IMMA|IGMMA|QGMMA|DMMA)\b")


def build_report(lib: Path) -> dict:
    """{function: {"ptxas": its ptxas lines of registers and spills,
    "tensor_core": the tensor-core opcodes of its SASS}} of ``lib``."""
    out, name = {}, None
    log = lib.with_name(lib.name + ".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"function '(_Z\w+)'", line)
        if m:
            name = m.group(1)
        if name and re.search(r"registers|spill", line):
            out.setdefault(name, {"ptxas": [], "tensor_core": []})[
                "ptxas"].append(line.split(":", 1)[-1].strip())
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    for block in sass.split("Function : ")[1:]:
        out.setdefault(block.split()[0], {"ptxas": []})["tensor_core"] = \
            sorted(set(TENSOR_CORE.findall(block)))
    return out


def _held(what: str, got, want, tols) -> None:
    """Raise unless every output lies within its (atol, rtol) of ``tols``:
    |kernel − plain| ≤ atol + rtol·|plain|."""
    for i, (g, w, (tol, rtol)) in enumerate(zip(got, want, tols)):
        g, w = g.float(), w.float()
        err = float((g - w).abs().max())
        if not bool(((g - w).abs() <= tol + rtol * w.abs()).all()):
            raise AssertionError(f"{what}: output {i} max |kernel − plain| "
                                 f"{err:.3e} beyond {tol:.1e} + "
                                 f"{rtol:.1e}·|plain|")


def sketch_calls(kernel: str):
    """(size label, call, check) of a sketch kernel at each timed size."""
    import torch

    from repro_torch.kernels.fused_tick import kernel as fk, ref as fr
    from repro_torch.kernels.power_iter import kernel as pk, ref as pr

    m, d, streams = SIZES[kernel]
    rng = np.random.default_rng(0)
    for S in streams:
        x = rng.standard_normal((S, m, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        D = torch.from_numpy(x).cuda()
        if kernel == "power_iter":
            K = D @ D.mT
            call = lambda: pk.power_iter_cuda(K, ITERS)          # noqa: E731
            want = pr.power_iter_ref(K, ITERS)
        elif kernel == "gram_power":
            call = lambda: fk.gram_power_cuda(D, ITERS)          # noqa: E731
            want = fr.gram_power_ref(D, ITERS)
        else:
            lam, u = fr.gram_power_ref(D, ITERS)
            call = lambda: fk.fused_krylov_step_cuda(            # noqa: E731
                D, lam, u, ITERS)
            want = fr.fused_krylov_step_ref(D, lam, u, ITERS)
        tols = [(TOL + (TOL * float(w.abs().max()) if w.dim() == 1 else 0.),
                 0.0) for w in want]
        yield str(S), call, lambda c=call, w=want, t=tols, s=S: _held(
            f"{kernel} at S = {s}", c(), w, t)


def flash_calls(kernel: str):
    """(size label, call, check) of a flash kernel at each timed size."""
    import torch

    from repro_torch.kernels.flash_attn import kernel as fa, ref

    rng = np.random.default_rng(0)
    for label, B, S, H, Hkv, dh, dtype in FLASH_SIZES[kernel]:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (B * h, S, dh)).astype(np.float32)).cuda().to(
                getattr(torch, dtype)) for h in (H, Hkv, Hkv, H))
        tol = (BF16_TOL, BF16_TOL) if dtype == "bfloat16" else (TOL, 0.0)
        if kernel == "flash_fwd":
            call = lambda: fa.flash_fwd(q, k, v, True)           # noqa: E731
            want = ref.flash_ref(q, k, v, causal=True)
            tols = (tol, (LSE_TOL, 0.0))
        else:
            o, lse = fa.flash_fwd(q, k, v, True)
            call = lambda: fa.flash_bwd(q, k, v, o, lse, do,     # noqa: E731
                                        True)
            want = ref.flash_bwd_ref(q, k, v, o, lse, do, causal=True)
            tols = (tol,) * 3
        yield label, call, lambda c=call, w=want, t=tols, s=label: _held(
            f"{kernel} at {s}", c(), w, t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(LIBRARY))
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
    from repro_torch.kernels import dispatch

    lib = LIBRARY[args.kernel]
    report = build_report(dispatch.build([lib])[lib])
    calls = (flash_calls if args.kernel.startswith("flash")
             else sketch_calls)(args.kernel)
    ms, dev = {}, {}
    for size, call, check in calls:
        check()
        ms[size] = chip_smoke.time_in_turns({"k": call})["k"]
        dev[size] = chip_smoke.device_ms(call)
    print(json.dumps({"gpu": chip_smoke.gpu_line(), "kernel": args.kernel,
                      "src": str(args.src), "ms": ms, "device_ms": dev,
                      "build": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
