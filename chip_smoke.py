#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--ticks 160] [--fast-ticks 12]
                          [--fine-ticks 160] [--layered-ticks 160]
                          [--time-ticks 160] [--score-ticks 64]
                          [--history-ticks 192] [--topology-ticks 128]
                          [--train-steps 30] [--train-extra-steps 2]

Phases, each printing its seconds on a line of its own:

1. build   — compile every kernel source under ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together).
2. kernels — hold each CUDA kernel against its plain PyTorch version on
   the card and time both in turns with CUDA events: the fused-tick
   kernels at the krylov path's shape (S=1024, m=64, d=300), at an
   unaligned shape (m=10, d=37) and on an all-zero slab; gram,
   rank1_downdate and power_iter at the fine path's shape (S=256, m=256,
   d=300), power_iter also over 8 and 1 streams (clusters of 8 CTAs) and
   at m = 40 and 512, under both norm floors and on an all-zero K, with
   its cluster plans logged (all of K on chip up to m = 512), window_gram
   at the fine phase's window (S=256, N=1024, d=300) and at d = 301, each
   at an unaligned shape (3, 10, 37) and gram, rank1_downdate and
   window_gram in bf16 too, gram and rank1_downdate also at (4, 200, 301)
   (m and d past a tile), beside ``torch.bmm`` and ``torch.linalg.eigh``
   as the library yardsticks (window_gram and power_iter also by device
   time under ``torch.profiler``); the flash forward at llama3-8b's
   prefill shapes (buckets 512 and 256, bf16, and the 2-layer f32
   prefill's), grok-1's (buckets 512 and 256, bf16, G = 6), the train
   phase's f32 shape (B=8, S=1024, H=9, Hkv=3, dh=64), smollm's (G=3,
   dh=64, bf16), qwen1.5's (G=1, f32), one non-causal case and a 64-row
   query tail (S=192, bf16), the bucket-512 (llama3-8b and grok-1),
   f32-prefill and train shapes timed beside
   ``scaled_dot_product_attention``, with the device times of both; and
   how far the bf16 kernel's o lies from the plain version's on inputs
   scaled ×8, against a single bf16 rounding of p; the flash backward at
   the train phase's shape (B=8, S=1024, H=9, Hkv=3, dh=64, causal) in
   f32 and bf16 and at dh = 128 in both, against ``flash_bwd_ref`` on the
   forward kernel's residuals, the f32 case timed beside SDPA's backward
   on the same inputs, with the GFLOP the kernel executes (seven products
   over the tiles it visits) beside the bound's five.
3. krylov  — the sketch fleet at full width:
   ``SketchFleetEngine("dsfd", d=300, streams=1024, eps=1/32,
   window=1024, block=8, mode="krylov", use_kernel=True)``, fed by
   ``submit_many`` with 8 unit-norm rows per user per tick for 1.25·N
   rows per user.  Both fused kernels' launch counts must be > 0 and the split
   kernels' 0; every one of the 1024 users is held to Theorem 3.1
   (‖A_WᵀA_W − BᵀB‖₂ ≤ 4εN) against the exact window Gram from
   ``window_gram`` on the card (the script keeps every user's last N rows
   on the device, 1.26 GB), and 8 of them against float64 Grams on the
   host as a cross-check; ``query_global`` must be finite with Frobenius
   mass ≤ Σ‖A_W‖_F².  The run records how many streams each dump-step
   launch took (median, p90, max).  Then the cohort queries of the cached
   merge tree: the cold ``query_global`` must cost S − 1 = 1023 merges,
   4 random contiguous cohorts ≤ 2⌈log₂S⌉ = 20 each and their repeats
   none, and 8 users given a row at the same clock must make the ALL
   query merge only their paths again; every answer within 1e-4 relative
   Frobenius of a from-scratch fold.  Then 8 more ticks split where their
   time goes (SVD, each kernel, other) on the host clock.
4. fast    — a short ``mode="fast"`` run (the users' default) at the same
   width, checked (every user too) and split the same way.
5. fine    — the krylov fleet at ε = 1/128 (m = 256, whose D and K do not
   fit one CTA): ``SketchFleetEngine("dsfd", d=300, streams=256,
   eps=1/128, window=1024, block=8, mode="krylov", use_kernel=True)``,
   fed as phase 3.  gram, power_iter and rank1_downdate must launch and
   the fused kernels must not; every one of the 256 users is held to
   Theorem 3.1 against the exact window Gram from ``window_gram`` on the
   card (the script keeps every user's last N rows on the device), and 8
   of them against float64 Grams on the host as a cross-check.  Then the
   same split of 8 more ticks.
6. layered — Seq-DS-FD at full width:
   ``SketchFleetEngine("seq-dsfd", d=300, streams=128, eps=1/32,
   window=1024, block=8, mode="krylov", R=64)`` (7 levels, θⱼ = 32·2ʲ)
   for 160 ticks, rows as phase 3's scaled to ‖a‖² log-uniform on [1, R]
   with 2 % at 0.99·R; then Time-DS-FD, ``("time-dsfd", streams=32,
   R=16)`` (10 levels, θⱼ = 2ʲ) for 160 ticks, half its users idle every
   other 4 ticks.  Every user of both is held to βε‖A_W‖_F² (β = 4,
   Theorem 4.1 / Corollary 5.1) through ``window_gram`` on the card; the
   fused kernels must launch and the split ones not; the heavy-row bypass
   must run at exactly the levels whose θ the rows reach; the selected
   levels are printed.
7. score   — ``SketchFleetEngine("dsfd", d=300, streams=256, eps=1/32,
   window=1024, block=8, mode="krylov", score=True)`` for 64 ticks, each
   user's rows in its own 10-dimensional subspace; at tick 48, 8 users
   move to fresh subspaces and ``anomalies()`` must name all 8.  The same
   rows without scoring give the tick's cost of scoring; the score's
   ``gram`` kernel and ``eigh`` are timed at its shape.
8. history — ``SketchFleetEngine("dsfd", d=300, streams=32, eps=1/32,
   window=1024, block=8, mode="krylov", use_kernel=True, history=True,
   history_hot_nodes=256, history_dir=<a temporary directory>)`` for
   192 ticks of phase 3's rows, the k = 10 users the odd ones (512
   units retire; S cut from 1024 since
   every node is an (S, 2ℓ, d) tensor, 2.46 MB at S = 32).  Checks: (a)
   exactly the units that left the window retired and nodes spilled;
   (b) six intervals (one unit, [1, 513), four random), for ALL and the
   cohort [3, 17), each within ‖A_IᵀA_I − BᵀB‖₂ ≤ ‖A_I‖_F²/ℓ of the
   exact interval Gram (``window_gram`` on the card over the raw rows
   the script keeps on the device) and within 1e-4 relative Frobenius of
   a from-scratch fold of the canonical schedule written here from
   ``fd_compress``; (c) the cold pass faults nodes back from disk, its
   warm repeat faults none and an ALL query costs at most
   2⌈log₂(t2 − t1)⌉ merges; (d) engine A runs 160 ticks, checkpoints
   with a slab staged and a tick queued and is deleted, B restored from
   the checkpoint on the card runs the last 32, and B equals the
   uninterrupted run bit for bit (clock, rows, every ``query_user``,
   ``query_global``, the six intervals).  The same rows without history
   give the plane's cost a tick.
9. topology — a fleet across two processes that share the card: the
   krylov fleet at S = 256 in one process for its ms/tick, then two
   children (``chip_smoke.py --topology-child PID PORT DIR``) that meet
   through ``launch/mesh.py::init_distributed`` (gloo, a ``TCPStore`` on
   127.0.0.1) and each hold 128 of the same fleet's users on ``cuda:0``
   (the odd users at k = 10, so both own users that dump) for 128 ticks,
   each tick's rows made before the timed ticks, each child only its
   own users'; each child's intra-op CPU threads are its share of the
   host's cores (``init_distributed``).  Both must launch the fused
   kernels, answer four cohorts collectively
   (ALL, [64, 192), [0, 100), {5, 200}) within the spine budget
   ``cohorts·(2⌈log₂S⌉ + 2(P − 1))``, and write a shard checkpoint.  The
   shards restored as one engine on the card (2 → 1) must answer the
   four cohorts as the pair did, bit for bit, and hold every user to
   Theorem 3.1 through ``window_gram``.  Then the history pair: the
   history phase's engine (S = 32) split 16 + 16 on its feed, whose six
   intervals for ALL and the cohort, answered collectively, must be the
   history phase's bit for bit, and each child must launch the fused
   kernels there too.  The restored engine must count the fleet's rows
   (``ticks·S·block``).  The path's launches are the children's and the
   restore's; the one-process run's are printed apart.  A child that
   fails, times out or exits nonzero fails the phase.
10. serve  — the dense serving path at full width: llama3-8b (32 layers,
   bf16 weights from a seeded ``torch.Generator`` on the card) with
   ``use_flash=True`` in ``ServeEngine(slots=4, s_max=1024,
   prefill_buckets=(256, 512))``, 8 greedy requests of 200-512 prompt
   tokens and 16 new tokens.  Every request must finish with 17 tokens in
   [0, vocab), the flash kernel must launch exactly 32 × 8 times, and the
   last-position logits must be finite.  Then a 2-layer f32 model at full
   width prefills one 512-token prompt through the kernel and through its
   plain version: the last-position logits must agree within 1e-4
   relative (Frobenius).
11. moe    — the MoE family serving at full width, depth cut: grok-1
   (2 of 64 layers, d_model 6144, 48/8 heads, 8 experts top-2, d_expert
   32768; ~23 GB of seeded bf16 weights) with ``use_flash=True`` through
   the serve phase's ``ServeEngine`` and traffic (8 greedy requests of
   200-512 prompt tokens, 16 new tokens): its prefills go through the
   bf16 flash kernel at (1, S, 48, 8, 128), group size 6, 2 × 8 launches.
   Then, grok's weights freed, kimi-k2 (1 of 61 layers, d_model 7168,
   64/8 heads, dh 112, 384 experts top-8, d_expert 2048; ~38.6 GB): one
   512-token prompt and 8 decode ticks, its attention on the one-shot
   torch path (dh 112 fails the flash gate, as in the reference), no
   flash launch.  Each prints ms per prefill by bucket and per decode
   tick, tokens/s, peak memory, the (token, choice) pairs the capacity
   dropped at each token count with its C, and the decode tick beside
   the bytes it must read (every expert of every layer: the dispatch
   multiplies every expert's buffer) over 3.35 TB/s.  Then grok-1 and
   kimi-k2 reduced (2 layers, f32) on the card and on the CPU: prefill
   logits within 1e-4, greedy tokens identical.
12. train  — the training path at full width: ``train()`` (the
   launcher's code path) on smollm-135m (30 layers, d_model 576, 9/3
   heads, dh 64, vocab 49152) with ``use_flash=True``, ``remat="full"``,
   f32 parameters (bf16 activations promote to f32 at the first
   projection, so the flash runs in f32), seq 1024, batch 8, seeded
   weights: AdamW with the DS-FD gradient monitor for 30 steps (finite
   losses, the last 5's mean below the first 5's by 0.1), then two steps
   with ``--compress``'s FD gradient compression (cut from three: a step
   is ~1 minute of ``fd_compress``) and one with Sketchy (cut from three
   to two, then to one: a step is ~1.5 minutes).  Every run must end with
   finite losses and parameters and, where it has two steps or more, its
   last loss (computed after the first update) apart from its first; the
   compression's last step must project every compressed leaf onto a
   nonzero basis learned from the first step, with a finite
   error-feedback accumulator; Sketchy's momenta and window sketches must
   be finite and its momenta nonzero.  Each run counts the flash
   launches from 0: forward
   2 × 30 layers a step (full remat), backward 30.  Then a 2-layer f32
   train step at full width through the flash kernels against the same
   step through their plain versions: loss and every gradient within
   1e-4 relative.
13. launch sizes — in a fresh process (``--launch-sizes``), each
   dump-step kernel of the krylov and fine phases timed at the fewest,
   the median, the 90th-percentile and the most streams its launches
   took, by CUDA events and by device time, beside its bound there, to
   sum the time it loses over its bound on the path.

Then it prints one JSON line of per-kernel numbers (``launches`` on the
path that carries the kernel, ``launches_by_path`` on every path that ran
it, each counted from 0 just before that path), the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure
exits nonzero before the last line.  Without a CUDA device, or run outside
a checkout of the repository, it exits nonzero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MAIN_SHAPE = (1024, 64, 300)     # S streams, m = 2ℓ rows, d (the main path)
ITERS = 24
# f32 tolerances of kernel vs plain version.  Both run the same f32
# arithmetic in another summation order (the kernel splits sums across
# threads); at these unit-scale inputs that moves results by ~1e-6, and 24
# power steps on a gapped spectrum do not amplify it past 1e-4.
RTOL_LAM, ATOL = 1e-4, 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 non-tensor rate,
# dense bf16 tensor-core rate
PEAK_BYTES_S, PEAK_F32_FLOPS, PEAK_BF16_FLOPS = 3.35e12, 67e12, 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _time_ms(fn, reps: int = 10) -> float:
    import torch

    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(fn, calls: int, warm: int) -> dict:
    """{name: (count, µs)} of the device work (kernels, copies) that
    ``calls`` calls of ``fn`` recorded under ``torch.profiler``, after a
    warm-up batch of ``warm`` calls in the same session: once a session
    has profiled thousands of kernels (eigh's), a session without warm-up
    recorded 16 of 20 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    out = {}

    def ready(prof):
        out.update((e.key, (e.count, e.self_device_time_total))
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for n in (warm, calls):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return out


def device_ms(fn, reps: int = 20, tries: int = 3):
    """Mean device time (ms) of one call of ``fn``: the sum of its
    kernels' own times under ``torch.profiler``, free of the host's launch
    cost that ``time_in_turns`` sees when a call is shorter than it.  Two
    sessions each record ``reps`` calls.  A kernel (or copy) name counts
    if both sessions saw it about ``c`` times a call for the same whole
    c ≥ 1, with at least c·reps − 1 records: the profiler sometimes loses
    records (a single-call session came back empty; 20-call sessions held
    4, 14, 15 or 19 of 20 launches), and names the calls did not launch
    round to c = 0.  The time is then Σ c × (the mean time of
    one record of the name over both sessions).  Sessions that disagree
    on the names or on c are run again; after ``tries`` pairs the time is
    None, "not measured"."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        a = _device_events(fn, reps, reps)
        b = _device_events(fn, reps, reps)
        per_call = {k: round(n / reps) for k, (n, _) in {**a, **b}.items()}
        per_call = {k: c for k, c in per_call.items() if c >= 1}
        if per_call and all(
                k in a and k in b and round(a[k][0] / reps) == c
                and round(b[k][0] / reps) == c
                and min(a[k][0], b[k][0]) >= c * reps - 1
                for k, c in per_call.items()):
            return sum(c * (a[k][1] + b[k][1]) / (a[k][0] + b[k][0])
                       for k, c in per_call.items()) / 1e3
        log(f"device_ms: sessions disagree: {_counts(a)} and {_counts(b)} "
            f"records of {reps} calls")
    return None


def _counts(events: dict) -> dict:
    return {k[:40]: n for k, (n, _) in events.items()}


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def time_in_turns(fns: dict, rounds: int = 5, reps: int = 10) -> dict:
    """Median per-call ms of each function, timed in alternating turns of
    ``reps`` calls each."""
    for fn in fns.values():                       # warm up
        fn()
    samples = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            samples[k].append(_time_ms(fns[k], reps))
    return {k: float(np.median(v)) for k, v in samples.items()}


def unit_rows(rng, shape, dtype: str = "float32"):
    """A CUDA tensor of unit-norm rows (the scale of the engine's rows)."""
    import torch

    x = rng.standard_normal(shape).astype(np.float32)
    x /= np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    return torch.from_numpy(x).to("cuda", getattr(torch, dtype))


def roofline(nbytes: float, flops: float):
    """(bound_ms, bound_by) of work that moves ``nbytes`` and does ``flops``
    f32 operations."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def kernel_bounds(S: int, m: int, d: int, iters: int) -> dict:
    """Least time (ms) for each kernel's work at (S, m, d): every input
    read once, every output written once, over HBM bandwidth; the f32
    operations the function needs over the f32 peak (K = DDᵀ is
    symmetric, so its Gram needs m(m+1)/2 dot products of length d).
    Returns {name: (bound_ms, bound_by)}."""
    power = (iters + 1) * 2 * m * m + iters * 3 * m + 2 * m
    gram = m * (m + 1) * d
    bytes_gp = 4 * S * (m * d + 1 + m)
    flops_gp = S * (gram + power)
    bytes_st = 4 * S * ((m * d + 1 + m) + (d + m * d + 1 + m))
    flops_st = S * (2 * m * d + 3 * d + 2 * m * d + 2 * m * d + gram + power)
    return {"gram_power": roofline(bytes_gp, flops_gp),
            "fused_krylov_step": roofline(bytes_st, flops_st)}


def check_kernels(rng) -> dict:
    import torch

    from repro_torch.kernels.fused_tick import kernel, ref

    dev = torch.device("cuda")
    errs = {"gram_power": 0.0, "fused_krylov_step": 0.0}
    shapes = [("main", MAIN_SHAPE), ("unaligned", (7, 10, 37)),
              ("zeros", (4, 64, 300))]
    for label, (S, m, d) in shapes:
        D = (torch.zeros((S, m, d), device=dev) if label == "zeros"
             else unit_rows(rng, (S, m, d)))
        # both norm floors: fused (Σw²) and the reference's inline (‖w‖)
        outs = {"gram_power": [], "fused_krylov_step": []}
        for fl in (False, True):
            lam_k, u_k = kernel.gram_power_cuda(D, ITERS, fl)
            lam_p, u_p = ref.gram_power_ref(D, ITERS, fl)
            got = kernel.fused_krylov_step_cuda(D, lam_p, u_p, ITERS, fl)
            want = ref.fused_krylov_step_ref(D, lam_p, u_p, ITERS, fl)
            outs["gram_power"] += [(lam_k, lam_p), (u_k, u_p)]
            outs["fused_krylov_step"] += list(zip(got, want))
        torch.cuda.synchronize()
        for name, pairs in outs.items():
            for i, (g, w) in enumerate(pairs):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{name} {label}: output {i} "
                                         "not finite")
                err = float((g - w).abs().max()) if g.numel() else 0.0
                is_lam = g.dim() == 1
                tol = ATOL + (RTOL_LAM * float(w.abs().max()) if is_lam
                              else 0.0)
                if err > tol:
                    raise AssertionError(
                        f"{name} {label} {tuple(D.shape)}: output {i} "
                        f"max |kernel − plain| = {err:.3e} > {tol:.1e}")
                errs[name] = max(errs[name], err)
        log(f"kernels {label} S,m,d={S},{m},{d}: gram_power err "
            f"{errs['gram_power']:.3e}, fused_krylov_step err "
            f"{errs['fused_krylov_step']:.3e}")

    S, m, d = MAIN_SHAPE
    D = unit_rows(rng, (S, m, d))
    lam, u = ref.gram_power_ref(D, ITERS)
    t_gp = time_in_turns({
        "kernel": lambda: kernel.gram_power_cuda(D, ITERS),
        "plain": lambda: ref.gram_power_ref(D, ITERS)})
    # the yardstick: one library call for the top eigenpairs of DDᵀ
    # (cuSOLVER loops over the batch: ~0.8 s a call, so fewer calls)
    t_gp.update(time_in_turns(
        {"library": lambda: torch.linalg.eigh(D @ D.mT)}, rounds=3, reps=1))
    t_st = time_in_turns({
        "kernel": lambda: kernel.fused_krylov_step_cuda(D, lam, u, ITERS),
        "plain": lambda: ref.fused_krylov_step_ref(D, lam, u, ITERS)})
    # the FD shrink's library SVD (the port keeps cuSOLVER's default
    # driver); gesvda, an approximate batched driver, as a yardstick
    t_svd = time_in_turns({
        drv or "default": (lambda drv=drv: torch.linalg.svd(
            D, full_matrices=False, driver=drv))
        for drv in (None, "gesvda")}, rounds=1, reps=1)
    dev = {"gram_power": device_ms(lambda: kernel.gram_power_cuda(D, ITERS)),
           "fused_krylov_step": device_ms(
               lambda: kernel.fused_krylov_step_cuda(D, lam, u, ITERS))}
    bounds = kernel_bounds(S, m, d, ITERS)
    for name, t in (("gram_power", t_gp), ("fused_krylov_step", t_st)):
        log(f"kernels time {name} S,m,d={S},{m},{d}: kernel_ms "
            f"{t['kernel']:.4f} plain_ms {t['plain']:.4f} library_ms "
            f"{t.get('library', float('nan')):.4f} bound_ms "
            f"{bounds[name][0]:.4f} ({bounds[name][1]}); device time "
            f"(torch.profiler) kernel {fmt_ms(dev[name])} ms")
    for drv, t in t_svd.items():
        log(f"kernels time torch.linalg.svd driver={drv} S,m,d={S},{m},{d}: "
            f"{t:.3f} ms")
    return {
        "gram_power": dict(
            max_abs_err=errs["gram_power"], ms=t_gp["kernel"],
            plain_ms=t_gp["plain"], bound_ms=bounds["gram_power"][0],
            bound_by=bounds["gram_power"][1], library_ms=t_gp["library"],
            device_ms=dev["gram_power"]),
        "fused_krylov_step": dict(
            max_abs_err=errs["fused_krylov_step"], ms=t_st["kernel"],
            plain_ms=t_st["plain"],
            bound_ms=bounds["fused_krylov_step"][0],
            bound_by=bounds["fused_krylov_step"][1], library_ms=None,
            device_ms=dev["fused_krylov_step"]),
    }


# ---------------------------------------------------------------------------
# phase 2 (cont.): the split dump step's kernels and the window Gram
# ---------------------------------------------------------------------------

SPLIT_SHAPE = (256, 256, 300)     # S, m = 2ℓ at ε = 1/128, d (the fine path)
WINDOW_SHAPE = (256, 1024, 300)   # S, n = N, d (the fine phase's window)
UNALIGNED = (3, 10, 37)
PAST_A_TILE = (4, 200, 301)       # m, d past a gram tile, rows 4-byte aligned
# bf16: the reference's own kernel tests (tests/kernels/test_kernels.py:22-24
# for gram and rank1_downdate, :78-87 for window_gram), as (rtol, atol)
BF16_TOL = {"gram": (2e-2, 2e-2), "rank1_downdate": (2e-2, 2e-2),
            "window_gram": (5e-2, 5e-1)}


def split_bounds(S: int, m: int, d: int, n: int, iters: int) -> dict:
    """Least time (ms) of each unfused kernel's work in f32: gram and
    window_gram count the m(m+1)/2 (d(d+1)/2) dot products a symmetric
    result needs; power_iter reads K once."""
    return {
        "gram": roofline(4 * S * (m * d + m * m), S * m * (m + 1) * d),
        "power_iter": roofline(
            4 * S * (m * m + 1 + m),
            S * ((iters + 1) * 2 * m * m + iters * 3 * m + 2 * m)),
        "rank1_downdate": roofline(4 * S * (2 * m * d + d), S * 4 * m * d),
        "window_gram": roofline(4 * S * (n * d + d * d), S * d * (d + 1) * n),
    }


def _held(name: str, label: str, got, want, rtol: float, atol: float) -> float:
    """max |kernel − plain|; raises unless finite and within
    atol + rtol·|plain| everywhere."""
    import torch

    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name} {label}: output not finite")
    if not g.numel():
        return 0.0
    err = float((g - w).abs().max())
    excess = float(((g - w).abs() - (atol + rtol * w.abs())).max())
    if excess > 0:
        raise AssertionError(f"{name} {label}: max |kernel − plain| = "
                             f"{err:.3e} beyond atol {atol:.0e} + rtol "
                             f"{rtol:.0e}·|plain|")
    return err


def check_split_kernels(rng) -> dict:
    """The kernels of the split dump step (gram, power_iter,
    rank1_downdate) and of the exact-window check (window_gram) against
    their plain versions on the card, then timed in turns with the plain
    version and the library call that computes the same function."""
    import torch

    from repro_torch.kernels.gram import kernel as gk, ref as gr
    from repro_torch.kernels.power_iter import kernel as pk, ref as pr
    from repro_torch.kernels.rank1_downdate import kernel as rk, ref as rr
    from repro_torch.kernels.window_gram import kernel as wk, ref as wr

    errs = dict.fromkeys(("gram", "power_iter", "rank1_downdate",
                          "window_gram"), 0.0)
    bf16 = dict.fromkeys(BF16_TOL, 0.0)

    def held(name, label, got, want, dtype="float32"):
        if dtype == "bfloat16":
            bf16[name] = max(bf16[name], _held(name, label, got, want,
                                               *BF16_TOL[name]))
        else:       # as phase 2's fused kernels: rtol on λ̂ only
            rtol = RTOL_LAM if got.dim() == 1 else 0.0
            errs[name] = max(errs[name], _held(name, label, got, want,
                                               rtol, ATOL))

    for label, (S, m, d) in (("path", SPLIT_SHAPE), ("unaligned", UNALIGNED),
                             ("past a tile", PAST_A_TILE)):
        for dtype in ("float32", "bfloat16"):
            X = unit_rows(rng, (S, m, d), dtype)
            held("gram", f"{label} {dtype}", gk.gram_cuda(X), gr.gram_ref(X),
                 dtype)
            v = unit_rows(rng, (S, d))
            held("rank1_downdate", f"{label} {dtype}",
                 rk.rank1_downdate_cuda(X, v), rr.rank1_downdate_ref(X, v),
                 dtype)
    # f32 copies 16-byte at d = 300, 4-byte at d = 301 and 37; bf16 8-byte
    # at d = 300, 4-byte at 301's even neighbour, plain loads at odd d
    for label, (S, n, d) in (("path", WINDOW_SHAPE),
                             ("unaligned", UNALIGNED),
                             ("d=301", (2, 1024, 301))):
        for dtype in ("float32", "bfloat16"):
            A = unit_rows(rng, (S, n, d), dtype)
            held("window_gram", f"{label} {dtype}", wk.window_gram_cuda(A),
                 wr.window_gram_ref(A), dtype)
    # power_iter on the Grams the path gives it (K = DDᵀ of unit rows),
    # at m = 40, 256 (the path) over 256 streams and over the few a dump
    # launch takes (clusters of 2 and 8 CTAs), 512 and an unaligned m,
    # under both floors, and on an all-zero K
    for label, (S, m, d) in (("m=40", (256, 40, 300)),
                             ("path", SPLIT_SHAPE), ("S=8", (8, 256, 300)),
                             ("S=1", (1, 256, 300)),
                             ("m=512", (64, 512, 300)),
                             ("unaligned", UNALIGNED),
                             ("zeros", (4, 256, 300))):
        X = (torch.zeros((S, m, d), device="cuda") if label == "zeros"
             else unit_rows(rng, (S, m, d)))
        K = gr.gram_ref(X)
        for fl in (False, True):
            lam, u = pk.power_iter_cuda(K, ITERS, fl)
            lam_p, u_p = pr.power_iter_ref(K, ITERS, fl)
            held("power_iter", f"{label} floor_norm={fl} λ̂", lam, lam_p)
            held("power_iter", f"{label} floor_norm={fl} û", u, u_p)
        if label == "zeros" and bool(lam.any() or u.any()):
            raise AssertionError("power_iter: an all-zero K must give 0, 0")
    torch.cuda.synchronize()
    log(f"kernels split f32 max |kernel − plain|: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {ATOL:.0e}, "
        f"+ {RTOL_LAM:.0e}·|λ̂|); bf16: " + ", ".join(
        f"{k} {v:.3e} (rtol {BF16_TOL[k][0]:.0e}, atol {BF16_TOL[k][1]:.0e})"
        for k, v in bf16.items()))
    for S, m in ((SPLIT_SHAPE[0], SPLIT_SHAPE[1]), (8, 256), (1, 256),
                 (64, 512)):
        c, rows, resident = pk.plan(m, S, X.device)
        held_rows = min(m, c * resident)
        log(f"kernels power_iter plan (S, m) = ({S}, {m}): a cluster of {c} "
            f"CTAs a stream, {rows} rows of K a CTA, {held_rows} of {m} rows "
            f"of K held on chip")
        if held_rows < m:
            raise AssertionError(f"power_iter: K at m = {m} not held on chip")

    S, m, d = SPLIT_SHAPE
    X, v = unit_rows(rng, (S, m, d)), unit_rows(rng, (S, d))
    K = gr.gram_ref(X)
    A = unit_rows(rng, WINDOW_SHAPE)
    times = {
        "gram": time_in_turns({
            "kernel": lambda: gk.gram_cuda(X),
            "plain": lambda: gr.gram_ref(X),
            "library": lambda: torch.bmm(X, X.mT)}),
        "power_iter": time_in_turns({
            "kernel": lambda: pk.power_iter_cuda(K, ITERS),
            "plain": lambda: pr.power_iter_ref(K, ITERS)}),
        "rank1_downdate": time_in_turns({
            "kernel": lambda: rk.rank1_downdate_cuda(X, v),
            "plain": lambda: rr.rank1_downdate_ref(X, v)}),
        "window_gram": time_in_turns({
            "kernel": lambda: wk.window_gram_cuda(A),
            "plain": lambda: wr.window_gram_ref(A),
            "library": lambda: torch.bmm(A.mT, A)}),
    }
    # the top eigenpairs of K from cuSOLVER (it loops over the batch)
    times["power_iter"].update(time_in_turns(
        {"library": lambda: torch.linalg.eigh(K)}, rounds=3, reps=1))
    times["rank1_downdate"]["library"] = None
    # device times (torch.profiler) beside the events of the two kernels
    # redesigned for the card, and of their library calls.  eigh is not
    # profiled: cuSOLVER's Jacobi sweeps launch a different number of
    # kernels from call to call (~31,100 at this shape), so no session of
    # it can be checked to hold every launch, and its time is "not
    # measured"; each of its calls takes over a second, far past the host
    # cost a device time removes.
    device = {
        "window_gram": (device_ms(lambda: wk.window_gram_cuda(A)),
                        device_ms(lambda: torch.bmm(A.mT, A))),
        "power_iter": (device_ms(lambda: pk.power_iter_cuda(K, ITERS)),
                       None),
    }
    bounds = split_bounds(S, m, d, WINDOW_SHAPE[1], ITERS)
    out = {}
    for name, t in times.items():
        shape = WINDOW_SHAPE if name == "window_gram" else SPLIT_SHAPE
        lib_ms = t["library"]
        dev = (f"; device time (torch.profiler) kernel "
               f"{fmt_ms(device[name][0])} ms, library "
               f"{fmt_ms(device[name][1])} ms" if name in device else "")
        log(f"kernels time {name} {shape}: kernel_ms {t['kernel']:.4f} "
            f"plain_ms {t['plain']:.4f} library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms "
            f"{bounds[name][0]:.4f} ({bounds[name][1]}){dev}")
        out[name] = dict(max_abs_err=errs[name], ms=t["kernel"],
                         plain_ms=t["plain"], bound_ms=bounds[name][0],
                         bound_by=bounds[name][1], library_ms=lib_ms)
        if name in device:
            out[name].update(device_ms=device[name][0],
                             library_device_ms=device[name][1])
    return out


# ---------------------------------------------------------------------------
# phase 2 (cont.): the flash-attention forward
# ---------------------------------------------------------------------------

# (label, B, S, H, Hkv, dh, dtype, causal); those in FLASH_TIMED are
# timed: llama3-8b's bucket 512 in the kernels line, the f32 prefill's (the
# 2-layer f32 prefill's shape), the train phase's f32 shape and grok-1's
# bucket 512 (the moe phase's, G = 6) beside it
FLASH_SHAPES = [
    ("llama3-8b bucket 512", 1, 512, 32, 8, 128, "bfloat16", True),
    ("llama3-8b bucket 256", 1, 256, 32, 8, 128, "bfloat16", True),
    ("grok-1 bucket 512", 1, 512, 48, 8, 128, "bfloat16", True),
    ("grok-1 bucket 256", 1, 256, 48, 8, 128, "bfloat16", True),
    ("llama3-8b f32 prefill", 1, 512, 32, 8, 128, "float32", True),
    ("train f32", 8, 1024, 9, 3, 64, "float32", True),
    ("smollm G=3", 2, 256, 9, 3, 64, "bfloat16", True),
    ("qwen1.5 G=1", 1, 512, 16, 16, 64, "float32", True),
    ("non-causal", 1, 512, 32, 8, 128, "bfloat16", False),
    ("query tail S=192", 1, 192, 32, 8, 128, "bfloat16", True),
]
# o: one rounding to bf16 of outputs of unit scale (~4e-3 relative; the
# reference's own kernel test allows 2e-2); f32: the same arithmetic in
# another summation order.  lse is f32 in both types.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_TOL = 1e-3
# timed shapes and their keys in the kernels line's flash_fwd entry
FLASH_TIMED = {"llama3-8b bucket 512": None, "llama3-8b f32 prefill": "f32",
               "train f32": "f32_train", "grok-1 bucket 512": "grok"}


def flash_bound(B, S, H, Hkv, dh, dtype, causal):
    """Least time (ms) of the flash forward: q, k, v read once and o, lse
    written once over HBM bandwidth; 4·dh FLOPs per (query, key) pair that
    the mask keeps over the peak rate of the inputs' type."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (2 * B * H * S * dh + 2 * B * Hkv * S * dh) + 4 * B * H * S
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * dh * H * pairs * B
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / peak * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def _ratio(kernel_ms, library_ms) -> str:
    return (f": the kernel {kernel_ms / library_ms:.3f}× the library's"
            if kernel_ms and library_ms else "")


def check_flash(rng) -> dict:
    """The forward kernel against ``flash_ref`` at each shape of
    ``FLASH_SHAPES``; those in ``FLASH_TIMED`` timed beside their bound,
    their plain version and SDPA (``enable_gqa``; at f32 also SDPA's
    memory-efficient kernel on K and V expanded to H heads, which
    ``enable_gqa`` does not reach)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attn import kernel, ref

    dev = torch.device("cuda")
    worst = 0.0
    timed = {}
    for label, B, S, H, Hkv, dh, dtype, causal in FLASH_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B * h, S, dh)).astype(np.float32)).to(dev, getattr(torch, dtype))
            for h in (H, Hkv, Hkv))
        o, lse = kernel.flash_fwd(q, k, v, causal)
        o_p, lse_p = ref.flash_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(o).all())
                and bool(torch.isfinite(lse).all())):
            raise AssertionError(f"flash_fwd {label}: output not finite")
        err = float((o.float() - o_p.float()).abs().max())
        err_lse = float((lse - lse_p).abs().max())
        if err > FLASH_TOL[dtype] or err_lse > LSE_TOL:
            raise AssertionError(
                f"flash_fwd {label}: max |kernel − plain| o {err:.3e} "
                f"(tol {FLASH_TOL[dtype]:.0e}), lse {err_lse:.3e} "
                f"(tol {LSE_TOL:.0e})")
        worst = max(worst, err)
        log(f"kernels flash_fwd {label} (B,S,H,Hkv,dh)=({B},{S},{H},{Hkv},"
            f"{dh}) {dtype} causal={causal}: o err {err:.3e}, lse err "
            f"{err_lse:.3e}")
        if label not in FLASH_TIMED:
            continue
        q4, k4, v4 = (t.view(B, t.shape[0] // B, S, dh) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal,
                                                  enable_gqa=True)
        lib_err = float((library().reshape_as(o).float()
                         - o_p.float()).abs().max())
        t = time_in_turns({
            "kernel": lambda: kernel.flash_fwd(q, k, v, causal),
            "plain": lambda: ref.flash_ref(q, k, v, causal=causal),
            "library": library})
        bound, by = flash_bound(B, S, H, Hkv, dh, dtype, causal)
        dev_k = device_ms(lambda: kernel.flash_fwd(q, k, v, causal))
        dev_lib = device_ms(library)
        log(f"kernels time flash_fwd {label}: kernel_ms {t['kernel']:.4f} "
            f"plain_ms {t['plain']:.4f} library_ms (sdpa) "
            f"{t['library']:.4f} bound_ms {bound:.4f} ({by}); sdpa vs "
            f"plain max err {lib_err:.3e}; device time (torch.profiler) "
            f"kernel {fmt_ms(dev_k)} ms, sdpa {fmt_ms(dev_lib)} ms"
            f"{_ratio(dev_k, dev_lib)}")
        # the CUDA-event times of both calls are the host's at the bf16
        # shapes; the device times are what the kernel is judged on
        timed[FLASH_TIMED[label]] = dict(
            ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound,
            bound_by=by, library_ms=t["library"], device_ms=dev_k,
            library_device_ms=dev_lib)
        if dtype == "float32":
            ke, ve = (x.repeat_interleave(H // Hkv, 1) for x in (k4, v4))

            def expanded():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(q4, ke, ve,
                                                          is_causal=causal)
            exp_err = float((expanded().reshape_as(o) - o_p).abs().max())
            dev_exp = device_ms(expanded)
            log(f"kernels time flash_fwd {label}: sdpa's memory-efficient "
                f"kernel on k, v expanded to {H} heads (outside the call): "
                f"device {fmt_ms(dev_exp)} ms{_ratio(dev_k, dev_exp)}, vs "
                f"plain max err {exp_err:.3e}")
            timed[FLASH_TIMED[label]]["library_expanded_device_ms"] = dev_exp
    main = timed.pop(None)
    return dict(max_abs_err=worst, **main, **timed)


def p_rounding(rng) -> None:
    """How far the bf16 flash kernel's o lies from the plain version's, and
    how far it would with p rounded to bf16 once instead of split in two
    (hi + lo): at llama3-8b's bucket-512 shape, on inputs scaled ×8 (a
    peaked softmax).  The single rounding is a torch model of the kernel's
    arithmetic (bf16 q·kᵀ in f32, scaled after; f32 softmax; bf16(p)·v in
    f32; o rounded to bf16).  Prints max |Δo| and the share of o's bf16
    values that differ from the plain version's."""
    import torch

    from repro_torch.kernels.flash_attn import kernel, ref

    S, H, Hkv, dh = 512, 32, 8, 128
    q, k, v = (torch.from_numpy(8 * rng.standard_normal((h, S, dh)).astype(
        np.float32)).to("cuda", torch.bfloat16) for h in (H, Hkv, Hkv))
    o_p, _ = ref.flash_ref(q, k, v, causal=True)
    o_k, _ = kernel.flash_fwd(q, k, v, True)
    kr, vr = (t.repeat_interleave(H // Hkv, 0).float() for t in (k, v))
    s = (q.float() @ kr.mT) * (1 / math.sqrt(dh))
    keep = torch.ones((S, S), dtype=torch.bool, device="cuda").tril()
    s = torch.where(keep, s, torch.full_like(s, ref.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o_1 = ((p.to(torch.bfloat16).float() @ vr)
           / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    for label, o in (("kernel, p split in two", o_k),
                     ("model, p rounded to bf16 once", o_1)):
        log(f"kernels flash p rounding at ×8 inputs ({label}): max |o − "
            f"plain| {float((o.float() - o_p.float()).abs().max()):.4e}, "
            f"bf16 values that differ {float((o != o_p).float().mean()):.4f}")


# (label, B, S, H, Hkv, dh, dtype, causal): the train phase's shape
# (smollm-135m at seq 1024, batch 8; it runs f32, see run_train) timed
# first, then bf16 at the same shape and dh = 128 in both types
FLASH_BWD_SHAPES = [
    ("train f32", 8, 1024, 9, 3, 64, "float32", True),
    ("train bf16", 8, 1024, 9, 3, 64, "bfloat16", True),
    ("dh=128 f32", 2, 1024, 8, 2, 128, "float32", True),
    ("dh=128 bf16", 2, 1024, 8, 2, 128, "bfloat16", True),
]
# f32: the same identities in f32, another summation order (measured
# ~1e-5 at gradients of ~10); bf16: each gradient rounded once to bf16
# from f32 sums in another order, one bf16 step (2⁻⁸ relative) at most
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def flash_bwd_executed_gflop(B, S, H, Hkv, dh, causal):
    """GFLOP the backward kernel executes: seven products of 2·dh
    operations per (query, key) pair of the tiles it visits (S and dP in
    both roles; dQ, dK and dV once).  dQ visits, per query tile, the
    64-key tiles up to the diagonal; dK/dV, per key tile, the 64-row query
    tiles from the diagonal down (tiles of ``kernel.bwd_plan``)."""
    from repro_torch.kernels.flash_attn import kernel

    rows = kernel.bwd_plan(dh, S, B * H, B * Hkv)[1]
    n = S // kernel.STREAM
    dq_pairs = dkv_pairs = 0
    for t in range(-(-S // rows)):
        lo, hi = t * rows, min(S, (t + 1) * rows)
        # the kept tile's rows are padded to `rows`
        dq_pairs += rows * kernel.STREAM * (
            -(-hi // kernel.STREAM) if causal else n)
        dkv_pairs += rows * kernel.STREAM * (
            n - lo // kernel.STREAM if causal else n)
    return 2 * dh * B * H * (3 * dq_pairs + 4 * dkv_pairs) / 1e9


def flash_bwd_bound(B, S, H, Hkv, dh, dtype, causal):
    """Least time (ms) of the flash backward: q, o, dO read and dq written
    (B·H rows), k, v read and dk, dv written (B·Hkv rows), lse read, once
    each, over HBM bandwidth; five products (S, dP, dV, dQ, dK) of 2·dh
    operations per (query, key) pair the mask keeps, over the peak rate of
    the inputs' type."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * 4 * B * S * dh * (H + Hkv) + 4 * B * H * S
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 10 * dh * pairs * B * H
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / peak * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def check_flash_bwd(rng) -> dict:
    """The backward kernel against ``flash_bwd_ref`` on the forward
    kernel's residuals and a random dO, at each shape of
    ``FLASH_BWD_SHAPES``; the first is timed beside its bound, its plain
    version and SDPA's backward on the same inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attn import kernel, ref

    dev = torch.device("cuda")
    worst, timed = 0.0, None
    for label, B, S, H, Hkv, dh, dtype, causal in FLASH_BWD_SHAPES:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (B * h, S, dh)).astype(np.float32)).to(dev, getattr(torch, dtype))
            for h in (H, Hkv, Hkv, H))
        o, lse = kernel.flash_fwd(q, k, v, causal)
        got = kernel.flash_bwd(q, k, v, o, lse, do, causal)
        want = ref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        tol = FLASH_BWD_TOL[dtype]
        errs = [_held("flash_bwd", f"{label} d{n}", a, b, tol, tol)
                for n, a, b in zip("qkv", got, want)]
        worst = max(worst, max(errs))
        log(f"kernels flash_bwd {label} (B,S,H,Hkv,dh)=({B},{S},{H},{Hkv},"
            f"{dh}) {dtype} causal={causal}: dq/dk/dv err "
            + "/".join(f"{e:.3e}" for e in errs))
        if timed is not None:
            continue
        del want
        q4, k4, v4 = (t.view(B, t.shape[0] // B, S, dh).requires_grad_(True)
                      for t in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                            enable_gqa=True)
        do4 = do.view_as(o4)

        def library():
            return torch.autograd.grad(o4, (q4, k4, v4), do4,
                                       retain_graph=True)
        t = time_in_turns({
            "kernel": lambda: kernel.flash_bwd(q, k, v, o, lse, do, causal),
            "plain": lambda: ref.flash_bwd_ref(q, k, v, o, lse, do,
                                               causal=causal),
            "library": library}, rounds=3, reps=5)
        bound, by = flash_bwd_bound(B, S, H, Hkv, dh, dtype, causal)
        dev_k = device_ms(lambda: kernel.flash_bwd(q, k, v, o, lse, do,
                                                   causal), reps=10)
        dev_lib = device_ms(library, reps=10)
        # SDPA's memory-efficient kernel, which enable_gqa does not reach:
        # K and V expanded to H heads outside the call, so its dK and dV
        # are per query head (the group sum not included)
        qe, ke, ve = (x.detach().repeat_interleave(H // x.shape[1], 1)
                      .requires_grad_(True) for x in (q4, k4, v4))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            oe = F.scaled_dot_product_attention(qe, ke, ve, is_causal=causal)
        dev_exp = device_ms(lambda: torch.autograd.grad(
            oe, (qe, ke, ve), do4, retain_graph=True), reps=10)
        pairs = (S * (S + 1) // 2 if causal else S * S) * B * H
        gflop = 10 * dh * pairs / 1e9
        done = flash_bwd_executed_gflop(B, S, H, Hkv, dh, causal)
        log(f"kernels time flash_bwd {label}: kernel_ms {t['kernel']:.4f} "
            f"plain_ms {t['plain']:.4f} library_ms (sdpa backward) "
            f"{t['library']:.4f} bound_ms {bound:.4f} ({by}); device time "
            f"(torch.profiler) kernel {fmt_ms(dev_k)} ms, sdpa backward "
            f"{fmt_ms(dev_lib)} ms{_ratio(dev_k, dev_lib)}; sdpa's "
            f"memory-efficient backward on k, v expanded to {H} heads "
            f"{fmt_ms(dev_exp)} ms{_ratio(dev_k, dev_exp)}; executed "
            f"{done:.2f} GFLOP (7 products over the tiles visited) for the "
            f"bound's {gflop:.2f} (5)")
        timed = dict(ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound,
                     bound_by=by, library_ms=t["library"], device_ms=dev_k,
                     library_device_ms=dev_lib,
                     library_expanded_device_ms=dev_exp, shape=label)
        del q4, k4, v4, o4, qe, ke, ve, oe
    return dict(max_abs_err=worst, **timed)


# ---------------------------------------------------------------------------
# phases krylov, fast and fine: the sketch fleet at full width
# ---------------------------------------------------------------------------

D, WINDOW, BLOCK = 300, 1024, 8


@dataclasses.dataclass(frozen=True)
class Cell:
    """One fleet configuration the script drives, and what its run must
    show: the kernels it must launch and those it must not, the users held
    to Theorem 3.1 in float64 on the host (a cross-check), and whether
    every user is held to it through ``window_gram`` on the card."""
    label: str
    mode: str
    streams: int
    eps: float
    checked: tuple
    launched: tuple = ()
    idle: tuple = ()
    every_user: bool = False
    cohorts: bool = False

    @property
    def split(self) -> bool:
        return "rank1_downdate" in self.launched


FUSED = ("gram_power", "fused_krylov_step")
SPLIT = ("gram", "power_iter", "rank1_downdate")
# ε = 1/32: m = 64, whose D and K fit one CTA (the fused kernels); every
# user held to Theorem 3.1 (a 1.26 GB window slab on the card), so the dump
# loop's λ̂ ≥ θ decisions through the fused kernels are checked end to end
KRYLOV = Cell("krylov", "krylov", 1024, 1 / 32,
              (0, 170, 341, 511, 512, 682, 853, 1023),
              launched=FUSED + ("window_gram",), idle=SPLIT, every_user=True,
              cohorts=True)
FAST = Cell("fast", "fast", 1024, 1 / 32, KRYLOV.checked,
            launched=("window_gram",), every_user=True)
# ε = 1/128: m = 256, 575,696 B for D and K, past one CTA (the split path)
FINE = Cell("fine", "krylov", 256, 1 / 128,
            (0, 43, 85, 127, 128, 170, 213, 255),
            launched=SPLIT + ("window_gram",), idle=FUSED, every_user=True)


def launch_counters() -> dict:
    """The counted wrapper of every kernel, by name."""
    from repro_torch.kernels.flash_attn import kernel as fa
    from repro_torch.kernels.fused_tick import kernel as ft
    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.kernels.power_iter import kernel as pk
    from repro_torch.kernels.rank1_downdate import kernel as rk
    from repro_torch.kernels.window_gram import kernel as wk

    return {"gram_power": ft.gram_power_cuda,
            "fused_krylov_step": ft.fused_krylov_step_cuda,
            "gram": gk.gram_cuda, "power_iter": pk.power_iter_cuda,
            "rank1_downdate": rk.rank1_downdate_cuda,
            "window_gram": wk.window_gram_cuda, "flash_fwd": fa.flash_fwd}


@contextlib.contextmanager
def launch_sizes(names):
    """The number of streams S of every launch of the named dump-step
    kernels while the context is open: {name: [S, ...]}.  The engine
    reaches each through one entry (``core/dsfd.py`` the fused kernels,
    the split route of ``kernels/fused_tick/ops.py`` the others), one
    launch a call with S > 0; each entry is wrapped in a recorder that
    passes the call on.  The kernels' wrappers are not touched."""
    from repro_torch.core import dsfd
    from repro_torch.kernels.fused_tick import ops as ft_ops

    sizes = {n: [] for n in names}
    saved = {n: getattr(dsfd if n in FUSED else ft_ops, n) for n in names}

    def recorder(fn, out):
        def call(x, *a, **k):
            if x.shape[0]:
                out.append(x.shape[0])
            return fn(x, *a, **k)
        return call

    try:
        for n in names:
            setattr(dsfd if n in FUSED else ft_ops, n,
                    recorder(saved[n], sizes[n]))
        yield sizes
    finally:
        for n, fn in saved.items():
            setattr(dsfd if n in FUSED else ft_ops, n, fn)


def run_engine(cell: Cell, ticks: int, seed: int, device: str = "cuda",
               **hyper) -> dict:
    """Feed the engine ``ticks`` ticks of 8 rows per user and check it."""
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    from repro_torch.core import dsfd, errors
    from repro_torch.data.streams import SyntheticSource
    from repro_torch.serve.engine import SketchFleetEngine

    S, eps = cell.streams, cell.eps
    eng = SketchFleetEngine("dsfd", d=D, streams=S, eps=eps, window=WINDOW,
                            block=BLOCK, mode=cell.mode, ingest="async",
                            device=device, **hyper)
    # the first half of the users: the paper's SYNTHETIC set (signal
    # dimension k = d); the second half: the same model with k = 10, whose
    # top directions exceed εN in a window and so are dumped into snapshots
    half = S // 2
    srcs = (SyntheticSource(D, seed=seed),
            SyntheticSource(D, k=10, seed=seed + 1))
    users = np.repeat(np.arange(S), BLOCK)
    kept = {u: [] for u in cell.checked}
    # every user's last N rows on the device, a ring of WINDOW // BLOCK
    # ticks (the Gram does not depend on the rows' order)
    win = (torch.zeros((S, WINDOW, D), device=device) if cell.every_user
           else None)
    fed = [0]

    def next_tick():
        rows = np.concatenate([s.rows(half * BLOCK) for s in srcs])
        for u in cell.checked:
            kept[u].append(rows[u * BLOCK:(u + 1) * BLOCK])
            kept[u] = kept[u][-(WINDOW // BLOCK):]
        if win is not None:
            slot = fed[0] % (WINDOW // BLOCK) * BLOCK
            slab = torch.from_numpy(rows.reshape(S, BLOCK, D))
            if device == "cuda":
                slab = slab.pin_memory()
            win[:, slot:slot + BLOCK].copy_(slab, non_blocking=True)
        fed[0] += 1
        return rows

    counters = launch_counters()
    eng.submit_many(users, next_tick())         # one tick ahead: async
    for fn in counters.values():
        fn.launches = 0
    dsfd.host_indices.count = 0
    sync()
    t0 = time.perf_counter()
    with launch_sizes([n for n in cell.launched if n in FUSED + SPLIT]) \
            as sizes:
        for tick in range(ticks):
            if tick + 1 < ticks:
                eng.submit_many(users, next_tick())
            if eng.step() != S * BLOCK:
                raise AssertionError(f"tick {tick} ingested a partial slab")
        sync()
    elapsed = time.perf_counter() - t0
    syncs = dsfd.host_indices.count
    if eng.backlog or eng.rows_ingested != ticks * S * BLOCK:
        raise AssertionError(f"{eng.backlog} rows left; ingested "
                             f"{eng.rows_ingested}")
    log(f"{cell.label} engine: {ticks} ticks, {eng.rows_ingested} rows in "
        f"{elapsed:.3f} s: {eng.rows_ingested / elapsed:.1f} rows/s, "
        f"{elapsed / ticks * 1e3:.3f} ms/tick, "
        f"{syncs / ticks:.2f} host syncs/tick")

    n_win = min(eng.t, WINDOW)
    bound = 4 * eps * n_win
    worst, host_err = 0.0, {}
    for u in cell.checked:
        A = np.concatenate(kept[u]).astype(np.float64)[-WINDOW:]
        B = eng.query_user(u).astype(np.float64)
        if not np.isfinite(B).all():
            raise AssertionError(f"user {u}: query not finite")
        err = float(np.max(np.abs(np.linalg.eigvalsh(A.T @ A - B.T @ B))))
        host_err[u] = err
        worst = max(worst, err / (eps * n_win))
        if err > bound:
            raise AssertionError(f"user {u}: ‖A_WᵀA_W − BᵀB‖₂ = {err:.3f} "
                                 f"> 4εN = {bound:.1f}")
    log(f"{cell.label} Theorem 3.1 on users {cell.checked} (float64, host): "
        f"worst error {worst:.4f}·εN (bound 4·εN)")
    if win is not None:
        # every user: the exact window Gram from window_gram on the card,
        # every user's query in one batch, batched eigvalsh
        t1 = time.perf_counter()
        G = errors.window_gram(win)
        B = eng.base.query(eng.state, eng.t)
        err_all = errors.cova_error_gram(G, B).cpu().numpy()
        t_chk = time.perf_counter() - t1
        if not np.isfinite(err_all).all():
            raise AssertionError("every-user check: error not finite")
        over = np.flatnonzero(err_all > bound)
        if over.size:
            raise AssertionError(
                f"users {over[:8].tolist()}: ‖A_WᵀA_W − BᵀB‖₂ up to "
                f"{err_all.max():.3f} > 4εN = {bound:.1f}")
        diff = max(abs(host_err[u] - float(err_all[u])) for u in host_err)
        log(f"{cell.label} Theorem 3.1 on all {S} users (window_gram on the "
            f"card, f32): worst error {err_all.max() / (eps * n_win):.4f}·εN"
            f" (bound 4·εN), {t_chk:.3f} s; largest |float64 host − f32 "
            f"card| error over the {len(host_err)} host-checked users "
            f"{diff:.3e} (εN = {eps * n_win:.1f})")
    sync()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"{cell.label} launches {launches}")
    spread = {}
    for name, v in sizes.items():
        if v:
            spread[name] = dict(median=float(np.median(v)),
                                p90=float(np.percentile(v, 90)), max=max(v))
            log(f"{cell.label} {name} streams per launch over {len(v)} "
                f"launches: median {spread[name]['median']:g}, p90 "
                f"{spread[name]['p90']:g}, max {spread[name]['max']}")
    for name in cell.launched:
        if launches[name] <= 0:
            raise AssertionError(f"{cell.label}: {name} was never launched "
                                 "on its path")
    for name in cell.idle:
        if launches[name]:
            raise AssertionError(f"{cell.label}: {name} launched "
                                 f"{launches[name]} times off its path")
    live = eng.state.main.snap_valid.sum(dim=1).cpu().numpy()
    log(f"{cell.label} live snapshots at the end: users [0, {half}) (k = d) "
        f"{int(live[:half].sum())}, users [{half}, {S}) (k = 10) "
        f"{int(live[half:].sum())}")

    m0 = eng.tree.merges
    t1 = time.perf_counter()
    g = eng.query_global()
    t_q = time.perf_counter() - t1
    cold = eng.tree.merges - m0
    mass = float(np.sum(g.astype(np.float64) ** 2))
    total = S * n_win * (1 + 1e-4)              # unit-norm rows
    if not np.isfinite(g).all() or mass > total:
        raise AssertionError(f"query_global: finite={np.isfinite(g).all()}"
                             f" mass {mass:.1f} > Σ‖A_W‖² {total:.1f}")
    log(f"{cell.label} query_global: {t_q:.3f} s, {cold} merges, ‖B‖_F² "
        f"{mass:.1f} ≤ {total:.1f}")
    cohorts = (cohort_queries(eng, cold, t_q, np.random.default_rng(seed + 3))
               if cell.cohorts and device == "cuda" else None)
    if device == "cuda":
        breakdown(eng, cell, BREAKDOWN_TICKS, lambda: (users, next_tick()))
    # the launch sizes, for time_at_launch_sizes in a process of its own
    timing = dict(m=int(eng.state.main.buf.shape[1]), sizes=sizes,
                  launches=launches, seed=seed + 1)
    return {"launches": launches, "elapsed": elapsed, "syncs": syncs,
            "launch_streams": spread, "timing": timing, "cohorts": cohorts}


BREAKDOWN_TICKS = 8


def breakdown(eng, cell: Cell, ticks: int, feed) -> None:
    """Where a tick's time goes, on the host clock: ``ticks`` more ticks
    (after the checks, outside the counted run) with the SVDs and the
    kernels of the cell's krylov route timed between device
    synchronisations.  The syncs add a little time of their own; ``other``
    is everything else (small ops, host syncs, ingest; on the split route
    also the v-extraction)."""
    import torch

    from repro_torch.core import dsfd
    from repro_torch.kernels.fused_tick import ops as ft_ops

    names = [(dsfd, "fd_shrink", "svd"), (dsfd, "fd_rotate", "svd")]
    names += ([(ft_ops, n, n) for n in SPLIT] if cell.split
              else [(dsfd, n, n) for n in FUSED])
    spent = {key: 0.0 for _, _, key in names}
    calls = dict.fromkeys(spent, 0)
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in names]

    def timed(fn, key):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            calls[key] += 1
            return out
        return wrapper

    try:
        for (mod, n, fn), (_, _, key) in zip(saved, names):
            setattr(mod, n, timed(fn, key))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.submit_many(*feed())
            eng.step()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    parts = ", ".join(f"{k} {v:.3f} s ({100 * v / wall:.1f}%, {calls[k]} "
                      f"calls)" for k, v in spent.items())
    other = wall - sum(spent.values())
    log(f"{cell.label} breakdown: {ticks} ticks, wall {wall:.3f} s: {parts}, "
        f"other {other:.3f} s ({100 * other / wall:.1f}%)")


CELLS = {c.label: c for c in (KRYLOV, FAST, FINE)}
RESULT = "launch-size times: "   # the child's result line starts so


def time_launch_sizes_apart(runs: dict) -> dict:
    """``time_at_launch_sizes`` for each run ({cell label: run_engine's
    ``timing``}) in a fresh process (``chip_smoke.py --launch-sizes``,
    the runs on its standard input): after the engine phases,
    ``torch.profiler`` sessions in this process lost records at half the
    sizes; a fresh process loses fewer, and ``device_ms`` runs again the
    sessions that did.  Returns {label:
    {kernel: its numbers at the median}} and logs the child's lines."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--launch-sizes"],
        input=json.dumps(runs), capture_output=True, text=True, timeout=900)
    out = None
    for line in proc.stdout.splitlines():
        if line.startswith(RESULT):
            out = json.loads(line[len(RESULT):])
        else:
            log(line)
    if proc.returncode or out is None:
        raise AssertionError(f"launch-size timings exited {proc.returncode}:"
                             f" {proc.stderr[-3000:]}")
    return out


def launch_sizes_main() -> int:
    """The child of :func:`time_launch_sizes_apart`."""
    runs = json.load(sys.stdin)
    out = {label: time_at_launch_sizes(
        CELLS[label], r["m"], r["sizes"], r["launches"],
        np.random.default_rng(r["seed"])) for label, r in runs.items()}
    print(RESULT + json.dumps(out), flush=True)
    return 0


def time_at_launch_sizes(cell: Cell, m: int, sizes: dict, launches: dict,
                         rng) -> dict:
    """Each dump-step kernel of the cell's route timed at the numbers of
    streams its launches took in the counted run (the fewest, the median,
    the 90th percentile, the most), by CUDA events and by device time,
    beside its bound there.  The time it loses over its bound on the path
    is the sum over its launches of (time − bound), interpolated in S
    between those sizes (device time where the profiler gave one; which
    clock each size's gap came from is kept as ``gap_from``)."""
    import torch

    from repro_torch.kernels.fused_tick import kernel as ft, ref as fr
    from repro_torch.kernels.gram import kernel as gk, ref as gr
    from repro_torch.kernels.power_iter import kernel as pk
    from repro_torch.kernels.rank1_downdate import kernel as rk

    def call(name, S):
        """The kernel's call at S streams, on fresh inputs, and its
        bound."""
        X = unit_rows(rng, (S, m, D))
        if name in FUSED:
            lam, u = fr.gram_power_ref(X, ITERS)
            return ((lambda: ft.gram_power_cuda(X, ITERS))
                    if name == "gram_power" else
                    (lambda: ft.fused_krylov_step_cuda(X, lam, u, ITERS)),
                    kernel_bounds(S, m, D, ITERS)[name])
        v, K = unit_rows(rng, (S, D)), gr.gram_ref(X)
        return ({"gram": lambda: gk.gram_cuda(X),
                 "rank1_downdate": lambda: rk.rank1_downdate_cuda(X, v),
                 "power_iter": lambda: pk.power_iter_cuda(K, ITERS)}[name],
                split_bounds(S, m, D, WINDOW, ITERS)[name])

    out = {}
    for name, v in sizes.items():
        if not v:
            continue
        v = np.asarray(v)
        med = int(round(float(np.median(v))))
        points = sorted({int(v.min()), med,
                         int(round(float(np.percentile(v, 90)))),
                         int(v.max())})
        gaps, gap_from = [], {}
        for S in points:
            fn, bound = call(name, S)
            ms = time_in_turns({"kernel": fn})["kernel"]
            dev = device_ms(fn)
            gaps.append((ms if dev is None else dev) - bound[0])
            gap_from[str(S)] = "events" if dev is None else "device"
            plan = (f", a cluster of {pk.plan(m, S, torch.device('cuda'))[0]}"
                    f" CTAs a stream" if name == "power_iter" else "")
            log(f"{cell.label} {name} at S = {S} (m = {m}{plan}): kernel_ms "
                f"{ms:.4f}, device_ms {fmt_ms(dev)}, bound_ms {bound[0]:.4f} "
                f"({bound[1]})")
            if S == med:
                out[name] = dict(streams=S, ms=ms, device_ms=dev,
                                 bound_ms=bound[0])
        loss = float(np.interp(v, points, gaps).sum()) / 1e3
        out[name].update(over_bound_s=loss, gap_from=gap_from)
        log(f"{cell.label} {name}: Σ over its {launches[name]} launches of "
            f"(time − bound), interpolated in S between the timed sizes: "
            f"{loss:.3f} s")
    return out


# ---------------------------------------------------------------------------
# the krylov fleet's cohort queries: the cached merge tree
# ---------------------------------------------------------------------------

COHORT_RTOL = 1e-4   # same association, same SVD inputs: rounding only
# query_global of the krylov fleet (S = 1024) through the uncached
# midpoint fold the port had before the node cache, on an NVIDIA H100
# 80GB HBM3 at 700.00 W
FOLD_BEFORE_CACHE_S = 3.123


def _sketch_gram(eng, g):
    """BᵀB (float64) of the compressed sketch of a merged S = 1 state."""
    B = eng.base.query(g, eng.t)[0].double()
    return B.mT @ B


def _from_scratch(eng, state, cohort, got, what: str) -> float:
    """``got`` (a merged state) against a fresh tree's answer for the same
    cohort (every node merged anew, the same association): the relative
    Frobenius distance of their Grams; raises past COHORT_RTOL."""
    import torch

    from repro_torch.sketch.query import AggTree

    want = AggTree(eng.base, eng.S).query(state, cohort, eng.t)
    a, b = _sketch_gram(eng, got), _sketch_gram(eng, want)
    rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    if not rel <= COHORT_RTOL:
        raise AssertionError(f"cohort {what}: relative Frobenius distance "
                             f"{rel:.3e} from the from-scratch fold > "
                             f"{COHORT_RTOL:.0e}")
    return rel


def _path_nodes(S: int, users) -> set:
    """The internal tree nodes holding any of ``users``."""
    out = set()
    for u in users:
        lo, hi = 0, S
        while hi - lo > 1:
            out.add((lo, hi))
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if u < mid else (mid, hi)
    return out


def cohort_queries(eng, cold_merges: int, t_cold: float, rng) -> dict:
    """The krylov fleet's query plane after its counted run: the cold ALL
    query (``query_global``, just made) cost S − 1 merges; warm random
    contiguous cohorts cost ≤ 2⌈log₂S⌉ each and a repeated one nothing;
    8 users given a row at the same clock make ALL merge only their
    paths again; each answer equals a from-scratch fold.  Last, one engine
    tick over the same 8 users moves the clock, so every node is stale."""
    import torch

    from repro_torch.sketch.query import ALL, Cohort, full_reduce_streams
    from repro_torch.tree import take, tree_map

    S, t, tree = eng.S, eng.t, eng.tree
    budget = 2 * math.ceil(math.log2(S))
    if cold_merges != S - 1:
        raise AssertionError(f"cold ALL took {cold_merges} merges, not "
                             f"S − 1 = {S - 1}")
    g = tree.query(eng.state, ALL, t)
    rel_all = _from_scratch(eng, eng.state, ALL, g, "ALL")
    full = full_reduce_streams(eng.fleet, eng.state, t)
    a, b = _sketch_gram(eng, g), _sketch_gram(eng, full)
    rel_full = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    log(f"krylov cohort ALL cold: {cold_merges} merges (S − 1), {t_cold:.3f}"
        f" s (the uncached fold before the cache: {FOLD_BEFORE_CACHE_S} s); "
        f"vs a from-scratch fold {rel_all:.3e} relative Frobenius; vs "
        f"full_reduce_streams (another association) {rel_full:.3e}")

    spent, walls, rels = [], [], []
    for _ in range(4):
        lo = int(rng.integers(0, S - 1))
        c = Cohort.range(lo, int(rng.integers(lo + 1, S + 1)))
        m0 = tree.merges
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = tree.query(eng.state, c, t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        spent.append(tree.merges - m0)
        if spent[-1] > budget:
            raise AssertionError(f"warm cohort {c}: {spent[-1]} merges > "
                                 f"2⌈log₂S⌉ = {budget}")
        m0 = tree.merges
        if tree.query(eng.state, c, t) is not got or tree.merges != m0:
            raise AssertionError(f"repeated cohort {c} was not free")
        rels.append(_from_scratch(eng, eng.state, c, got, repr(c)))
    log(f"krylov cohort warm: 4 random ranges took {spent} merges (budget "
        f"{budget}), {max(walls):.3f} s at most; repeats 0 merges; vs "
        f"from-scratch folds ≤ {max(rels):.3e} relative Frobenius")

    users = np.sort(rng.choice(S, 8, replace=False))
    idx = torch.from_numpy(users).to(eng.device)
    rows = unit_rows(rng, (8, 1, D))
    one = eng.base.update_block(take(eng.state, idx), rows,
                                torch.full((1,), t, dtype=torch.int32,
                                           device=eng.device))
    state2 = tree_map(lambda x, y: x.index_copy(0, idx, y), eng.state, one)
    paths = _path_nodes(S, users.tolist())
    tree.advance(state2, users.tolist())
    m0 = tree.merges
    g2 = tree.query(state2, ALL, t)
    touched = tree.merges - m0
    if touched != len(paths):
        raise AssertionError(f"ALL after 8 users moved: {touched} merges, "
                             f"their paths hold {len(paths)} nodes")
    rel8 = _from_scratch(eng, state2, ALL, g2, "ALL after 8 users moved")

    for u in users:
        eng.submit(int(u), rows[list(users).index(u), 0].cpu().numpy())
    eng.step()
    m0 = tree.merges
    eng.query_cohort(None)
    ticked = tree.merges - m0
    log(f"krylov cohort after 8 users {users.tolist()} moved at the same "
        f"clock: ALL merged {touched} nodes, their paths' {len(paths)}; vs "
        f"a from-scratch fold {rel8:.3e}; after an engine tick over them "
        f"(the clock moves, so every node is stale): {ticked} merges")
    return {"cold_merges": cold_merges, "cold_s": t_cold,
            "warm_merges": spent, "touched_merges": touched,
            "tick_merges": ticked}


# ---------------------------------------------------------------------------
# phase layered: Seq-DS-FD and Time-DS-FD at full width
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layered:
    """One layered fleet the script drives: ``blink`` makes half the users
    alternate 4 busy and 4 idle ticks (Time-DS-FD's shared clock ages an
    idle user's window out)."""
    label: str
    streams: int
    R: float
    blink: bool = False


SEQ = Layered("seq-dsfd", 128, 64.0)
TIME = Layered("time-dsfd", 32, 16.0, blink=True)
LAYERED_EPS, BETA, HEAVY_SHARE = 1 / 32, 4.0, 0.02


@contextlib.contextmanager
def bypass_calls():
    """The sketch indices of every heavy-row bypass (``core/dsfd.py``
    ``_bypass``) while the context is open, as device tensors (read after
    the run: no host read in the loop)."""
    from repro_torch.core import dsfd

    calls, saved = [], dsfd._bypass

    def record(P, idx, rows, now):
        calls.append(idx)
        return saved(P, idx, rows, now)

    dsfd._bypass = record
    try:
        yield calls
    finally:
        dsfd._bypass = saved


def run_layered(cell: Layered, ticks: int, seed: int,
                device: str = "cuda") -> dict:
    """Feed a layered engine ``ticks`` ticks of 8 rows per busy user with
    ‖a‖² log-uniform on [1, R] (2 % at 0.99·R) and check every user
    against Theorem 4.1 / Corollary 5.1 through ``window_gram``."""
    import torch

    from repro_torch.core import dsfd, errors, seq_dsfd
    from repro_torch.data.streams import SyntheticSource
    from repro_torch.serve.engine import SketchFleetEngine

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    S, eps = cell.streams, LAYERED_EPS
    eng = SketchFleetEngine(cell.label, d=D, streams=S, eps=eps,
                            window=WINDOW, block=BLOCK, mode="krylov",
                            R=cell.R, ingest="async", device=device)
    cfg = eng.base.meta["cfg"]
    L, thetas = cfg.levels, np.asarray(cfg.thetas)
    log(f"{cell.label}: S = {S}, R = {cell.R:g}, {L} levels, θ = "
        f"{thetas[0]:g}..{thetas[-1]:g}, ℓ = {cfg.base.ell}, m = "
        f"{cfg.base.m}, cap = {cfg.base.cap}")
    half = S // 2
    srcs = (SyntheticSource(D, seed=seed),
            SyntheticSource(D, k=10, seed=seed + 1))
    rng = np.random.default_rng(seed + 2)
    win = torch.zeros((S, WINDOW, D), device=device)
    heavy_rows = np.zeros(L, np.int64)       # rows with ‖a‖² ≥ θⱼ
    fed = [0]

    def next_tick():
        tick = fed[0]
        rows = np.concatenate([s.rows(half * BLOCK) for s in srcs])
        norm2 = np.exp(rng.uniform(0.0, np.log(cell.R), rows.shape[0]))
        norm2[rng.random(rows.shape[0]) < HEAVY_SHARE] = 0.99 * cell.R
        slab = (rows * np.sqrt(norm2)[:, None]).astype(np.float32).reshape(
            S, BLOCK, D)
        busy = np.ones(S, bool)
        if cell.blink and (tick // 4) % 2:
            busy[half:] = False
            slab[half:] = 0.0
        e = np.sum(slab.astype(np.float64) ** 2, axis=2)[busy]
        heavy_rows[:] += (e[..., None] >= thetas).sum(axis=(0, 1))
        slot = tick % (WINDOW // BLOCK) * BLOCK
        host = torch.from_numpy(slab)
        if device == "cuda":
            host = host.pin_memory()
        win[:, slot:slot + BLOCK].copy_(host, non_blocking=True)
        fed[0] += 1
        users = np.repeat(np.flatnonzero(busy), BLOCK)
        return users, slab[busy].reshape(-1, D)

    # each tick's rows are submitted just before its step: submitted a tick
    # ahead, an idle user's empty slab would be topped up with its next
    # tick's rows (the async pipeline's contract), and the window ring
    # would no longer be the engine's
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    dsfd.host_indices.count = 0
    sync()
    t0 = time.perf_counter()
    with bypass_calls() as calls:
        for tick in range(ticks):
            users, rows = next_tick()
            eng.submit_many(users, rows)
            if eng.step() != users.size:
                raise AssertionError(f"{cell.label} tick {tick} ingested a "
                                     "partial slab")
        sync()
    elapsed = time.perf_counter() - t0
    syncs = dsfd.host_indices.count
    log(f"{cell.label} engine: {ticks} ticks, {eng.rows_ingested} rows in "
        f"{elapsed:.3f} s: {eng.rows_ingested / elapsed:.1f} rows/s, "
        f"{elapsed / ticks * 1e3:.3f} ms/tick, {syncs / ticks:.2f} host "
        f"syncs/tick")

    # the bypass: per level, one ring append in main and aux per heavy row
    flat = (torch.cat(calls) if calls else torch.zeros(0, dtype=torch.long,
                                                       device=device))
    by_level = torch.bincount(flat % (S * L) % L, minlength=L).cpu().numpy()
    log(f"{cell.label} bypass appends by level {by_level.tolist()}; 2 × the "
        f"rows with ‖a‖² ≥ θⱼ {(2 * heavy_rows).tolist()}")
    if not by_level[0] or np.any((by_level > 0) != (heavy_rows > 0)):
        raise AssertionError(f"{cell.label}: the bypass ran at levels "
                             f"{np.flatnonzero(by_level).tolist()}, the rows "
                             f"reach {np.flatnonzero(heavy_rows).tolist()}")

    t1 = time.perf_counter()
    G = errors.window_gram(win)
    fro = torch.diagonal(G, dim1=1, dim2=2).sum(dim=1)
    B = eng.base.query(eng.state, eng.t)
    err = errors.cova_error_gram(G, B)
    ratio = (err / (BETA * eps * fro)).cpu().numpy()
    t_chk = time.perf_counter() - t1
    if not np.isfinite(ratio).all():
        raise AssertionError(f"{cell.label}: error not finite")
    over = np.flatnonzero(ratio > 1.0)
    if over.size:
        raise AssertionError(
            f"{cell.label} users {over[:8].tolist()}: ‖A_WᵀA_W − BᵀB‖₂ up "
            f"to {ratio.max():.3f}·βε‖A_W‖_F² (β = {BETA:g})")
    diff = 0.0
    for u in (0, S - 1):
        A = win[u].double().cpu().numpy()
        Bu = B[u].double().cpu().numpy()
        e64 = float(np.max(np.abs(np.linalg.eigvalsh(A.T @ A - Bu.T @ Bu))))
        diff = max(diff, abs(e64 - float(err[u])) / float(fro[u]))
    sel = seq_dsfd.layered_select(cfg, eng.state, eng.t)
    hist = torch.bincount(sel, minlength=L).cpu().numpy()
    log(f"{cell.label} {'Corollary 5.1' if cell.blink else 'Theorem 4.1'} "
        f"on all {S} users (window_gram on the card, f32): worst error "
        f"{ratio.max():.4f}·βε‖A_W‖_F² (bound 1, β = {BETA:g}), "
        f"{t_chk:.3f} s; users 0 and {S - 1} in float64 on the host within "
        f"{diff:.3e}·‖A_W‖_F²; selected levels {hist.tolist()}")
    sync()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"{cell.label} launches {launches}")
    for name in FUSED + ("window_gram",):
        if launches[name] <= 0:
            raise AssertionError(f"{cell.label}: {name} never launched")
    for name in SPLIT:
        if launches[name]:
            raise AssertionError(f"{cell.label}: {name} launched "
                                 f"{launches[name]} times off its path")
    return {"launches": launches, "elapsed": elapsed,
            "ms_tick": elapsed / ticks * 1e3}


# ---------------------------------------------------------------------------
# phase score: the scoring plane at full width
# ---------------------------------------------------------------------------

SCORE_STREAMS, SCORE_SWITCH, SCORE_SWITCHED, SCORE_K = 256, 48, 8, 10


def _score_feed(S: int, ticks: int, seed: int):
    """Per tick the (users, rows) of 8 unit rows per user in the user's
    own k = 10 subspace; at tick SCORE_SWITCH, 8 users move to fresh
    subspaces.  Returns the feed and the switched users."""
    rng = np.random.default_rng(seed)

    def bases(n):
        q, _ = np.linalg.qr(rng.standard_normal((n, D, SCORE_K)))
        return q.transpose(0, 2, 1).astype(np.float32)     # (n, k, d)

    sub = bases(S)
    switched = np.linspace(0, S - 1, SCORE_SWITCHED).round().astype(int)
    fresh = bases(SCORE_SWITCHED)
    users = np.repeat(np.arange(S), BLOCK)
    feed = []
    for tick in range(ticks):
        if tick == SCORE_SWITCH:
            sub[switched] = fresh
        c = rng.standard_normal((S, BLOCK, SCORE_K)).astype(np.float32)
        rows = np.einsum("sbk,skd->sbd", c, sub)
        rows /= np.linalg.norm(rows, axis=2, keepdims=True)
        feed.append((users, rows.reshape(-1, D)))
    return feed, switched


def run_score(ticks: int, seed: int, device: str = "cuda") -> dict:
    """The krylov fleet with ``score=True`` and without, on the same rows;
    the scored run must flag every switched user; then the score's Gram
    kernel and ``eigh`` timed at its shape."""
    import torch

    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.serve.engine import SketchFleetEngine

    S = SCORE_STREAMS
    feed, switched = _score_feed(S, ticks, seed)
    counters = launch_counters()
    out = {}
    for scored in (True, False):
        eng = SketchFleetEngine("dsfd", d=D, streams=S, eps=1 / 32,
                                window=WINDOW, block=BLOCK, mode="krylov",
                                score=scored, ingest="async", device=device)
        eng.submit_many(*feed[0])
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tick in range(ticks):
            if tick + 1 < ticks:
                eng.submit_many(*feed[tick + 1])
            eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / ticks * 1e3
        out["ms_scored" if scored else "ms_plain"] = ms
        if not scored:
            break
        launches = {k: fn.launches for k, fn in counters.items()}
        flagged = eng.anomalies()
        missed = sorted(set(switched.tolist()) - set(flagged.tolist()))
        others = len(set(flagged.tolist()) - set(switched.tolist()))
        log(f"score engine: {ticks} ticks with scoring, {ms:.3f} ms/tick; "
            f"flagged {len(flagged)} users: "
            f"{SCORE_SWITCHED - len(missed)} of the {SCORE_SWITCHED} "
            f"switched at tick {SCORE_SWITCH} and {others} others; "
            f"launches {launches}")
        if missed:
            raise AssertionError(f"score: switched users {missed} not "
                                 "flagged")
        for name in ("gram",) + FUSED:
            if launches[name] <= 0:
                raise AssertionError(f"score: {name} never launched")
        out["launches"] = launches
        rows = eng.base.query_rows(eng.state, eng.t)
        K = gk.gram_cuda(rows)
        out.update(time_in_turns({
            "gram": lambda: gk.gram_cuda(rows),
            "eigh": lambda: torch.linalg.eigh(K.double())}, rounds=3,
            reps=1))
        del eng
    log(f"score: {out['ms_scored']:.3f} ms/tick with scoring, "
        f"{out['ms_plain']:.3f} without; at the score's shape "
        f"{tuple(rows.shape)}: gram {out['gram']:.4f} ms, eigh "
        f"{out['eigh']:.3f} ms a call (f64, as the path)")
    return out


# ---------------------------------------------------------------------------
# phase history: the history plane at full width, and a kill and resume
# ---------------------------------------------------------------------------

HISTORY_STREAMS, HISTORY_EPS, HISTORY_HOT, HISTORY_RESUMED = 32, 1 / 32, 256, 32
HISTORY_COHORT = (3, 17)
HISTORY_RTOL = 1e-4   # the same schedule, another batching of the merges


class ScheduleFold:
    """The canonical dyadic schedule (``sketch/history.py``) written out
    from ``fd_compress`` alone, over the raw rows (S, T, d) on the device:
    unit u is column u − 1; nodes merge per stream, a cohort's segments
    fold by the midpoint recursion one pair at a time, nodes fold left in
    time; empty nodes are identities.  Memoized by node and segment."""

    def __init__(self, raw, ell: int):
        self.raw, self.ell = raw, ell
        self.nodes, self.segs = {}, {}

    def _compress(self, mat):
        from repro_torch.core.fd import fd_compress

        return fd_compress(mat, self.ell)

    def _merge(self, a, b):
        import torch

        return self._compress(torch.cat([a, b], dim=1))

    def node(self, L: int, i: int):
        if (L, i) not in self.nodes:
            if L == 0:
                col = (self.raw[:, i - 1] if 1 <= i <= self.raw.shape[1]
                       else None)
                v = (None if col is None or not bool(col.ne(0).any()) else
                     self._compress(col[:, None]))
            else:
                a, b = self.node(L - 1, 2 * i), self.node(L - 1, 2 * i + 1)
                v = b if a is None else a if b is None else self._merge(a, b)
            self.nodes[(L, i)] = v
        return self.nodes[(L, i)]

    def seg(self, L: int, i: int, lo: int, hi: int):
        key = (L, i, lo, hi)
        if key not in self.segs:
            if hi - lo == 1:
                v = self.node(L, i)[lo:hi]
            else:
                mid = (lo + hi) // 2
                v = self._merge(self.seg(L, i, lo, mid),
                                self.seg(L, i, mid, hi))
            self.segs[key] = v
        return self.segs[key]

    def interval(self, t1: int, t2: int, lo: int, hi: int):
        from repro_torch.sketch.history import dyadic_cover
        from repro_torch.sketch.query import canonical_cover

        segs = []
        canonical_cover(0, self.raw.shape[0], lo, hi, segs)
        acc = None
        for L, i in dyadic_cover(t1, t2):
            if self.node(L, i) is None:
                continue
            v = None
            for a, b in segs:
                sv = self.seg(L, i, a, b)
                v = sv if v is None else self._merge(v, sv)
            acc = v if acc is None else self._merge(acc, v)
        return acc[0]


def _mixed_feed(S: int, ticks: int, seed: int, lo: int = 0,
                hi=None) -> list:
    """Each tick's rows of users [lo, hi) (all by default), user-major,
    all made before a timed run: the SYNTHETIC set (k = d) for the even
    users, k = 10 for the odd ones, so every process of a split owns users
    that dump.  A user's rows do not depend on [lo, hi)."""
    from repro_torch.data.streams import SyntheticSource

    hi = S if hi is None else hi
    half = S // 2
    srcs = (SyntheticSource(D, seed=seed), SyntheticSource(D, k=10,
                                                           seed=seed + 1))
    feed = []
    for _ in range(ticks):
        rows = np.empty((S, BLOCK, D), np.float32)
        rows[0::2] = srcs[0].rows(half * BLOCK).reshape(half, BLOCK, D)
        rows[1::2] = srcs[1].rows(half * BLOCK).reshape(half, BLOCK, D)
        feed.append(rows[lo:hi].reshape((hi - lo) * BLOCK, D))
    return feed


def _drive_history(eng, feed, lo: int, hi: int, ahead: int) -> None:
    """Step ticks [lo, hi), submitting tick k + ``ahead``'s rows before
    tick k's step (rows one tick ahead, as served)."""
    S = eng.S
    users = np.repeat(np.arange(S), BLOCK)
    for tick in range(lo, hi):
        if tick + ahead < len(feed):
            eng.submit_many(users, feed[tick + ahead])
        if eng.step() != S * BLOCK:
            raise AssertionError(f"history tick {tick} ingested a partial "
                                 "slab")


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def run_history(ticks: int, seed: int, device: str = "cuda") -> dict:
    """The krylov fleet with ``history=True`` at full width and S = 32:
    every retired interval within the FD bound of the exact interval Gram
    (``window_gram`` on the card) and equal to a from-scratch fold of the
    schedule; cold queries fault, warm ones stay in the merge budget; an
    engine killed after a checkpoint and restored on the card answers
    bit for bit as one that never stopped."""
    import tempfile

    import torch

    from repro_torch.core import errors
    from repro_torch.serve.engine import SketchFleetEngine
    from repro_torch.sketch.history import interval_merge_budget

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    S, eps, kill = HISTORY_STREAMS, HISTORY_EPS, ticks - HISTORY_RESUMED
    feed = _mixed_feed(S, ticks, seed)
    raw = torch.from_numpy(np.stack(feed).reshape(ticks, S, BLOCK, D)
                           .transpose(1, 0, 2, 3).reshape(S, -1, D)).to(device)
    tmp = tempfile.TemporaryDirectory()
    kw = dict(d=D, streams=S, eps=eps, window=WINDOW, block=BLOCK,
              mode="krylov", use_kernel=True, ingest="async", device=device)

    def engine(history: bool, spill: str = ""):
        if not history:
            return SketchFleetEngine("dsfd", **kw)
        return SketchFleetEngine("dsfd", history=True,
                                 history_hot_nodes=HISTORY_HOT,
                                 history_dir=f"{tmp.name}/{spill}", **kw)

    def timed_run(eng) -> float:
        eng.submit_many(np.repeat(np.arange(S), BLOCK), feed[0])
        sync()
        t0 = time.perf_counter()
        _drive_history(eng, feed, 0, ticks, 1)
        sync()
        return (time.perf_counter() - t0) / ticks * 1e3

    # C: the uninterrupted run, the phase's main path
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    C = engine(True, "C")
    ms_hist = timed_run(C)
    h = C.history
    ell = h.ell
    # (a) exactly the units that left the window retired, once each
    if not (h.retired_through == C.t - WINDOW and h.retired_units
            == C.t - WINDOW and h.store.spills > 0):
        raise AssertionError(
            f"history: retired_through {h.retired_through}, retired_units "
            f"{h.retired_units} (clock − window = {C.t - WINDOW}), spills "
            f"{h.store.spills}")
    sp = h.space()
    log(f"history engine: S = {S}, ℓ = {ell}, {ticks} ticks with history "
        f"{ms_hist:.3f} ms/tick; retired {h.retired_units} units, "
        f"{h.consolidations} merges; nodes hot {sp['hot_nodes']} "
        f"({sp['hot_bytes']} bytes on the card), cold {sp['cold_nodes']}, "
        f"empty {sp['empty_nodes']}; {h.store.spills} spills, "
        f"{sp['spill_bytes']} spill bytes")

    # (b) six intervals, for ALL and a cohort: the FD bound over the exact
    # interval Gram, and a from-scratch fold of the schedule
    rng = np.random.default_rng(seed + 7)
    top = h.retired_through + 1
    u = int(rng.integers(1, top))
    intervals = [(u, u + 1), (1, top)]
    for _ in range(4):
        t1 = int(rng.integers(0, top - 1))
        intervals.append((t1, int(rng.integers(t1 + 1, top + 1))))
    cohorts = {"ALL": (0, S), "cohort": HISTORY_COHORT}
    fold = ScheduleFold(raw, ell)
    f0 = h.store.faults
    cold_ms, warm_ms, worst_fd, worst_fold, answers = [], [], 0.0, 0.0, {}
    for t1, t2 in intervals:
        for label, (lo, hi) in cohorts.items():
            sync()
            t0 = time.perf_counter()
            got = C.fleet.query_interval(C.state, t1, t2,
                                         range(lo, hi)).clone()
            sync()
            cold_ms.append((time.perf_counter() - t0) * 1e3)
            answers[(label, t1, t2)] = got.cpu().numpy()
            if not torch.isfinite(got).all():
                raise AssertionError(f"interval [{t1}, {t2}) {label}: not "
                                     "finite")
            A = raw[lo:hi, max(t1, 1) - 1:t2 - 1]
            G = errors.window_gram(A.contiguous()).sum(dim=0)
            fro = float(torch.diagonal(G).sum())
            err = float(errors.cova_error_gram(G[None], got[None])[0])
            worst_fd = max(worst_fd, err * ell / max(fro, 1e-30))
            if err > fro / ell:
                raise AssertionError(
                    f"interval [{t1}, {t2}) {label}: ‖A_IᵀA_I − BᵀB‖₂ = "
                    f"{err:.4f} > ‖A_I‖_F²/ℓ = {fro / ell:.4f}")
            want = fold.interval(t1, t2, lo, hi).double()
            a, b = got.double().mT @ got.double(), want.mT @ want
            rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
            worst_fold = max(worst_fold, rel)
            if not rel <= HISTORY_RTOL:
                raise AssertionError(
                    f"interval [{t1}, {t2}) {label}: {rel:.3e} relative "
                    f"Frobenius from the schedule's fold > {HISTORY_RTOL}")
    faults = h.store.faults - f0
    # (c) the cold pass faulted; its warm repeat faults nothing and an ALL
    # query costs at most 2⌈log₂(t2 − t1)⌉ merges
    if faults <= 0:
        raise AssertionError("history: the cold pass faulted no node")
    f1, warm_merges = h.store.faults, []
    for t1, t2 in intervals:
        for label, (lo, hi) in cohorts.items():
            m0 = h.merges
            sync()
            t0 = time.perf_counter()
            C.fleet.query_interval(C.state, t1, t2, range(lo, hi))
            sync()
            warm_ms.append((time.perf_counter() - t0) * 1e3)
            warm_merges.append(h.merges - m0)
            if label == "ALL" and h.merges - m0 > \
                    interval_merge_budget(t1, t2):
                raise AssertionError(
                    f"warm [{t1}, {t2}): {h.merges - m0} merges > "
                    f"{interval_merge_budget(t1, t2)}")
    if h.store.faults != f1:
        raise AssertionError(f"history: the warm repeat faulted "
                             f"{h.store.faults - f1} nodes")
    sync()
    launches = {k: fn.launches for k, fn in counters.items()}
    for name in FUSED + ("window_gram",):
        if launches[name] <= 0:
            raise AssertionError(f"history: {name} never launched")
    for name in SPLIT:
        if launches[name]:
            raise AssertionError(f"history: {name} launched "
                                 f"{launches[name]} times off its path")
    log(f"history intervals {intervals} for ALL and cohort "
        f"[{HISTORY_COHORT[0]}, {HISTORY_COHORT[1]}): worst FD error "
        f"{worst_fd:.4f}·‖A_I‖_F²/ℓ (bound 1, exact Grams by window_gram "
        f"on the card); vs the schedule's from-scratch fold ≤ "
        f"{worst_fold:.3e} relative Frobenius; cold pass {faults} faults, "
        f"{np.mean(cold_ms):.3f} ms a query (max {max(cold_ms):.3f}); warm "
        f"repeat 0 faults, merges {warm_merges}, {np.mean(warm_ms):.3f} ms "
        f"a query; launches {launches}")

    # the same rows without history: the tick's cost of the plane
    plain = engine(False)
    ms_plain = timed_run(plain)
    del plain
    log(f"history ms/tick at S = {S}: with history {ms_hist:.3f}, without "
        f"{ms_plain:.3f}")

    # (d) kill and resume: A checkpoints with a slab staged and a tick
    # queued and is deleted; B, restored on the card, runs the rest
    A = engine(True, "A")
    A.submit_many(np.repeat(np.arange(S), BLOCK), feed[0])
    _drive_history(A, feed, 0, kill, 1)
    A.submit_many(np.repeat(np.arange(S), BLOCK), feed[kill + 1])
    staged, queued = A.pipe.staged_rows, A.queue.backlog
    if not (staged and queued):
        raise AssertionError(f"history: {staged} rows staged, {queued} "
                             "queued at the checkpoint")
    sync()
    t0 = time.perf_counter()
    path = A.checkpoint(f"{tmp.name}/ckpt")
    save_s = time.perf_counter() - t0
    nbytes = _dir_bytes(path)
    del A
    gc.collect()
    t0 = time.perf_counter()
    B = SketchFleetEngine.from_checkpoint(f"{tmp.name}/ckpt", device=device)
    sync()
    restore_s = time.perf_counter() - t0
    _drive_history(B, feed, kill, ticks, 2)
    if (B.t, B.rows_ingested) != (C.t, C.rows_ingested):
        raise AssertionError(f"resumed t, rows {B.t, B.rows_ingested} != "
                             f"{C.t, C.rows_ingested}")
    for user in range(S):
        if not np.array_equal(B.query_user(user), C.query_user(user)):
            raise AssertionError(f"resumed query_user({user}) differs")
    if not np.array_equal(B.query_global(), C.query_global()):
        raise AssertionError("resumed query_global differs")
    for (label, t1, t2), want in answers.items():
        if label == "ALL" and not np.array_equal(
                B.query_interval(None, t1, t2), want):
            raise AssertionError(f"resumed query_interval [{t1}, {t2}) "
                                 "differs")
    log(f"history kill and resume: checkpoint after {kill} ticks with "
        f"{staged} rows staged and {queued} queued, {nbytes} bytes, save "
        f"{save_s:.3f} s, restore {restore_s:.3f} s; after {ticks - kill} "
        f"more ticks t, rows_ingested, all {S} query_user, query_global and "
        f"the {len(intervals)} intervals bit for bit equal to the "
        f"uninterrupted run")
    del B, C
    tmp.cleanup()
    return {"launches": launches, "ms_tick": ms_hist, "ms_plain": ms_plain,
            "ckpt_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "spill_bytes": sp["spill_bytes"], "cold_ms": cold_ms,
            "warm_ms": warm_ms, "intervals": intervals,
            "answers": answers, "ticks": ticks, "seed": seed}


# ---------------------------------------------------------------------------
# phase topology: a fleet across two processes that share the card
# ---------------------------------------------------------------------------

TOPO_STREAMS, TOPO_EPS = 256, 1 / 32
TOPO_COHORTS = ("ALL", "[64, 192)", "[0, 100)", "{5, 200}")
TOPO_CHILD_S = 600       # each child's limit; a child that passes it fails
TOPO_TRANSPORT_S = 300   # each remote fetch's limit (a timeout raises)


def _topo_cohorts():
    from repro_torch.sketch.query import ALL, Cohort

    return dict(zip(TOPO_COHORTS, (ALL, Cohort.range(64, 192),
                                   Cohort.range(0, 100), Cohort.of(5, 200))))


def _drive_fleet(eng, feed: list, lo: int, hi: int) -> float:
    """Feed users [lo, hi) their rows of each tick (``feed[k]``: tick k's
    rows of these users, made beforehand), one tick ahead (async ingest,
    as served); returns ms per tick."""
    import torch

    def sync():
        if eng.device.type == "cuda":
            torch.cuda.synchronize()

    ticks = len(feed)
    users = np.repeat(np.arange(lo, hi), BLOCK)
    eng.submit_many(users, feed[0])
    sync()
    t0 = time.perf_counter()
    for tick in range(ticks):
        if tick + 1 < ticks:
            eng.submit_many(users, feed[tick + 1])
        if eng.step() != (hi - lo) * BLOCK:
            raise AssertionError(f"tick {tick} ingested a partial slab")
    sync()
    return (time.perf_counter() - t0) / ticks * 1e3


def _spine_budget(S: int, P: int, queries: int) -> int:
    return queries * (2 * math.ceil(math.log2(S)) + 2 * (P - 1))


def topology_child(pid: int, port: int, root: str) -> int:
    """One process of the pair (``chip_smoke.py --topology-child PID PORT
    DIR``): meet the other through ``launch.mesh.init_distributed``, run
    the krylov pair (S = 256, this process's half on the card) and the
    history pair (S = 32), write the answers and a JSON of numbers under
    ``DIR``.  Any failure, a transport timeout included, raises."""
    import torch

    from repro_torch.launch import mesh
    from repro_torch.parallel.topology import FleetTopology
    from repro_torch.serve.engine import SketchFleetEngine

    plan = json.loads((Path(root) / "plan.json").read_text())
    mesh.init_distributed(pid, 2, "127.0.0.1", port,
                          timeout_s=TOPO_TRANSPORT_S)
    out = {"device": None, "threads": torch.get_num_threads()}
    counters = launch_counters()

    def pair_launches(pair: str) -> dict:
        """The counts since the last reset; each fused-tick kernel must
        have launched in this pair."""
        got = {k: fn.launches for k, fn in counters.items()}
        for name in FUSED:
            if got[name] <= 0:
                raise AssertionError(f"process {pid}: {name} never "
                                     f"launched in the {pair} pair")
        return got

    try:
        # the krylov pair: this process's users' rows only, made before
        # the timed ticks
        S = TOPO_STREAMS
        topo = FleetTopology(S, namespace="krylov",
                             timeout_s=TOPO_TRANSPORT_S)
        feed = _mixed_feed(S, plan["ticks"], plan["seed"], topo.lo,
                           topo.hi)
        eng = SketchFleetEngine(
            "dsfd", d=D, streams=S, eps=TOPO_EPS, window=WINDOW,
            block=BLOCK, mode="krylov", use_kernel=True, ingest="async",
            topology=topo, device=plan["device"])
        out["device"] = str(eng.device)
        for fn in counters.values():
            fn.launches = 0
        out["ms_tick"] = _drive_fleet(eng, feed, topo.lo, topo.hi)
        del feed
        tree = eng.tree
        t0 = time.perf_counter()
        answers = {label: eng.query_cohort(c)
                   for label, c in _topo_cohorts().items()}
        out["query_s"] = time.perf_counter() - t0
        budget = _spine_budget(S, topo.P, len(answers))
        out.update(fetches=tree.remote_fetches, spine=tree.spine_merges,
                   published=tree.published, budget=budget)
        if tree.remote_fetches > budget or tree.spine_merges > 2 * budget:
            raise AssertionError(
                f"process {pid}: {tree.remote_fetches} fetches, "
                f"{tree.spine_merges} spine merges over the budget {budget}")
        np.savez(Path(root) / f"krylov_{pid}.npz",
                 *(answers[label] for label in TOPO_COHORTS))
        t0 = time.perf_counter()
        shard = eng.checkpoint(str(Path(root) / "krylov_ckpt"))
        out["save_s"] = time.perf_counter() - t0
        out["shard_bytes"] = _dir_bytes(shard)
        topo.barrier("krylov-ckpt")
        del eng, tree
        gc.collect()
        torch.cuda.empty_cache()

        out["krylov_launches"] = pair_launches("krylov")

        # the history pair: the history phase's feed and intervals
        S = HISTORY_STREAMS
        topo = FleetTopology(S, namespace="history",
                             timeout_s=TOPO_TRANSPORT_S)
        feed = _mixed_feed(S, plan["history_ticks"], plan["history_seed"],
                           topo.lo, topo.hi)
        eng = SketchFleetEngine(
            "dsfd", d=D, streams=S, eps=HISTORY_EPS, window=WINDOW,
            block=BLOCK, mode="krylov", use_kernel=True, ingest="async",
            history=True, history_hot_nodes=HISTORY_HOT,
            history_dir=str(Path(root) / f"spill_{pid}"), topology=topo,
            device=plan["device"])
        for fn in counters.values():
            fn.launches = 0
        out["history_ms_tick"] = _drive_fleet(eng, feed, topo.lo, topo.hi)
        lo, hi = HISTORY_COHORT
        got = {}
        t0 = time.perf_counter()
        for t1, t2 in plan["intervals"]:
            for label, users in (("ALL", None), ("cohort", range(lo, hi))):
                got[f"{label}_{t1}_{t2}"] = eng.query_interval(users, t1,
                                                               t2)
        out["history_query_s"] = time.perf_counter() - t0
        h = eng.history
        out.update(history_fetches=h.remote_fetches,
                   history_published=h.published,
                   history_spills=h.store.spills)
        np.savez(Path(root) / f"history_{pid}.npz", **got)
        topo.barrier("history-done")
        out["history_launches"] = pair_launches("history")
    finally:
        mesh.shutdown()
    (Path(root) / f"child_{pid}.json").write_text(json.dumps(out))
    print(f"topology child {pid}: {json.dumps(out)}", flush=True)
    return 0


def _spawn_topology_children(root: str) -> list:
    """Start both children on one free port, wait for both; any nonzero
    exit or a child past its limit fails the phase (and both are
    stopped)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--topology-child",
         str(pid), str(port), root], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        deadline = time.monotonic() + TOPO_CHILD_S
        for p in procs:
            text, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            outs.append(text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if line.startswith("topology child") or "Error" in line:
                log(f"  [{pid}] {line[:2000]}")
        if p.returncode != 0:
            raise AssertionError(f"topology child {pid} exited "
                                 f"{p.returncode}:\n{text[-6000:]}")
    return [json.loads((Path(root) / f"child_{pid}.json").read_text())
            for pid in range(2)]


def run_topology(ticks: int, hist: dict, seed: int,
                 device: str = "cuda") -> dict:
    """The fleet across two processes on the one card: the krylov pair and
    the history pair (see :func:`topology_child`), the one-process krylov
    fleet of the same S on the same feed for its ms/tick, the pair's
    shards restored as one engine (2 → 1) whose cohorts must be the pair's
    bit for bit and whose every user must hold Theorem 3.1 (through
    ``window_gram``), and the history pair's intervals bit for bit the
    history phase's."""
    import tempfile

    import torch

    from repro_torch.core import errors
    from repro_torch.serve.engine import SketchFleetEngine

    S, eps = TOPO_STREAMS, TOPO_EPS
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    (Path(root) / "plan.json").write_text(json.dumps({
        "device": device, "ticks": ticks, "seed": seed,
        "history_ticks": hist["ticks"],
        "history_seed": hist["seed"], "intervals": hist["intervals"]}))
    counters = launch_counters()

    # one process, the same S and feed: the ms/tick beside the pair's (its
    # launches are its own, not the topology path's)
    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    feed = _mixed_feed(S, ticks, seed)
    one = SketchFleetEngine("dsfd", d=D, streams=S, eps=eps, window=WINDOW,
                            block=BLOCK, mode="krylov", use_kernel=True,
                            ingest="async", device=device)
    for fn in counters.values():
        fn.launches = 0
    ms_one = _drive_fleet(one, feed, 0, S)
    one_answers = {label: one.query_cohort(c)
                   for label, c in _topo_cohorts().items()}
    one_launches = {k: fn.launches for k, fn in counters.items()}
    del one
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the topology path: both children, then the parent's 2 -> 1 restore
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    kids = _spawn_topology_children(root)
    pair_s = time.perf_counter() - t0
    pair = []
    for pid in range(2):
        with np.load(Path(root) / f"krylov_{pid}.npz") as z:
            pair.append({label: z[f"arr_{i}"]
                         for i, label in enumerate(TOPO_COHORTS)})
    for label in TOPO_COHORTS:
        if not np.array_equal(pair[0][label], pair[1][label]):
            raise AssertionError(f"topology: the processes' {label} "
                                 "answers differ")
    log(f"topology krylov pair: S = {S} ({S // 2} + {S // 2}) on "
        f"{kids[0]['device']} and {kids[1]['device']} ({kids[0]['threads']} "
        f"and {kids[1]['threads']} CPU threads), {ticks} ticks: "
        f"{kids[0]['ms_tick']:.3f} and {kids[1]['ms_tick']:.3f} ms/tick "
        f"(one process, same S and feed: {ms_one:.3f}, launches "
        f"{one_launches}, not counted in the path's); launches "
        f"{kids[0]['krylov_launches']} and {kids[1]['krylov_launches']}")
    log(f"topology cohorts {TOPO_COHORTS}: remote fetches "
        f"{kids[0]['fetches']} and {kids[1]['fetches']}, spine merges "
        f"{kids[0]['spine']} and {kids[1]['spine']} (budget "
        f"{kids[0]['budget']}, spine 2×), published {kids[0]['published']}"
        f" and {kids[1]['published']}, {kids[0]['query_s']:.3f} and "
        f"{kids[1]['query_s']:.3f} s; shards {kids[0]['shard_bytes']} and "
        f"{kids[1]['shard_bytes']} bytes, saved in {kids[0]['save_s']:.3f} "
        f"and {kids[1]['save_s']:.3f} s; the pair's wall {pair_s:.3f} s")
    diff = max(float(np.max(np.abs(one_answers[k] - pair[0][k])))
               for k in TOPO_COHORTS)
    log(f"topology: the one-process fleet's cohorts vs the pair's: largest "
        f"|difference| {diff:.3e}")

    # 2 -> 1: the pair's shards as one engine on the card
    sync()
    t0 = time.perf_counter()
    eng = SketchFleetEngine.from_checkpoint(str(Path(root) / "krylov_ckpt"),
                                            device=device)
    sync()
    restore_s = time.perf_counter() - t0
    if (eng.t, eng.S, eng.rows_ingested) != (ticks * BLOCK, S,
                                             ticks * S * BLOCK):
        raise AssertionError(f"restored t, S, rows_ingested = "
                             f"{eng.t, eng.S, eng.rows_ingested}")
    for label, c in _topo_cohorts().items():
        if not np.array_equal(eng.query_cohort(c), pair[0][label]):
            raise AssertionError(f"topology: the restored engine's {label} "
                                 "differs from the pair's")
    # every user within Theorem 3.1, against the exact window Gram
    win = torch.zeros((S, WINDOW, D), device=device)
    for tick, rows in enumerate(feed):
        if tick >= ticks - WINDOW // BLOCK:
            slot = (tick - (ticks - WINDOW // BLOCK)) * BLOCK
            win[:, slot:slot + BLOCK].copy_(torch.from_numpy(
                rows.reshape(S, BLOCK, D)))
    n_win = min(eng.t, WINDOW)
    err = errors.cova_error_gram(errors.window_gram(win),
                                 eng.base.query(eng.state, eng.t))
    err = err.cpu().numpy()
    if not np.isfinite(err).all() or err.max() > 4 * eps * n_win:
        raise AssertionError(f"topology: restored users up to "
                             f"{err.max():.3f} > 4εN = {4 * eps * n_win}")
    live = eng.state.main.snap_valid.sum(dim=1).cpu().numpy()
    log(f"topology 2 → 1: the shards restored as one engine in "
        f"{restore_s:.3f} s, rows_ingested {eng.rows_ingested} (the "
        f"fleet's); its {len(TOPO_COHORTS)} cohorts bit for bit the "
        f"pair's; all {S} users within Theorem 3.1 (window_gram on the "
        f"card): worst {err.max() / (eps * n_win):.4f}·εN (bound 4·εN); live "
        f"snapshots even users {int(live[0::2].sum())}, odd users "
        f"{int(live[1::2].sum())}")
    del eng, win, feed
    gc.collect()

    # the history pair against the history phase
    mine = []
    for pid in range(2):
        with np.load(Path(root) / f"history_{pid}.npz") as z:
            mine.append({k: z[k] for k in z.files})
    for (label, t1, t2), want in hist["answers"].items():
        key = f"{label}_{t1}_{t2}"
        for pid in range(2):
            got = mine[pid][key]
            if not np.array_equal(got, want):
                rel = float(np.linalg.norm(got.astype(np.float64) - want)
                            / max(np.linalg.norm(want), 1e-30))
                raise AssertionError(
                    f"topology history pair: process {pid} {label} "
                    f"[{t1}, {t2}) differs from the history phase's "
                    f"(relative Frobenius {rel:.3e})")
    half = HISTORY_STREAMS // 2
    log(f"topology history pair: S = {HISTORY_STREAMS} ({half} + {half}), "
        f"{hist['ticks']} ticks: {kids[0]['history_ms_tick']:.3f} and "
        f"{kids[1]['history_ms_tick']:.3f} ms/tick (one process, the "
        f"history phase: {hist['ms_tick']:.3f}); {len(hist['answers'])} "
        f"intervals bit for bit the history phase's; launches "
        f"{kids[0]['history_launches']} and {kids[1]['history_launches']}; "
        f"remote fetches "
        f"{kids[0]['history_fetches']} and {kids[1]['history_fetches']}, "
        f"published {kids[0]['history_published']} and "
        f"{kids[1]['history_published']}, spills "
        f"{kids[0]['history_spills']} and {kids[1]['history_spills']}; the "
        f"queries {kids[0]['history_query_s']:.3f} and "
        f"{kids[1]['history_query_s']:.3f} s")
    launches = {k: fn.launches + sum(kid[pair][k] for kid in kids
                                     for pair in ("krylov_launches",
                                                  "history_launches"))
                for k, fn in counters.items()}
    tmp.cleanup()
    return {"launches": launches, "ms_tick": [k["ms_tick"] for k in kids],
            "threads": [k["threads"] for k in kids], "ms_one": ms_one,
            "restore_s": restore_s}


# ---------------------------------------------------------------------------
# phase 5: the dense serving path at full width
# ---------------------------------------------------------------------------

SERVE_ARCH, SERVE_REQUESTS, SERVE_MAX_NEW = "llama3-8b", 8, 16
SERVE_ENGINE = dict(slots=4, s_max=1024, prefill_buckets=(256, 512))
PLAIN_RTOL = 1e-4   # f32 throughout, TF32 off: only summation order differs


def run_serve(seed: int, device: str = "cuda") -> dict:
    """ServeEngine over 8 requests at llama3-8b's full width; returns the
    flash launches of the run."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    dev = torch.device(device)
    cfg = dataclasses.replace(get_config(SERVE_ARCH), use_flash=True)
    params = init_params(api.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(seed),
                         dtype=torch.bfloat16, device=dev)
    eng = ServeEngine(cfg, params, EngineConfig(**SERVE_ENGINE), device=dev)
    rng = np.random.default_rng(seed)
    for uid, n in enumerate(rng.integers(200, 513, SERVE_REQUESTS)):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, int(n)).astype(np.int32), max_new=SERVE_MAX_NEW))
    run = timed_engine_run(eng)
    launches = run["launches"]
    n_prefills = sum(len(v) for v in run["prefill_ms"].values())
    want = cfg.n_layers * SERVE_REQUESTS
    if launches != want or n_prefills != SERVE_REQUESTS:
        raise AssertionError(f"flash_fwd launched {launches} times in "
                             f"{n_prefills} prefills; expected {want}")
    check_served(cfg, run, SERVE_REQUESTS, SERVE_MAX_NEW)
    log_served("serve", run)
    serve_breakdown(eng, params)
    del eng, params
    return {"launches": launches}


def timed_engine_run(eng) -> dict:
    """``eng.run()`` with host-clock timers (synchronised) around each
    prefill and decode step and CUDA events around each flash call, the
    flash launches counted from 0 and the peak memory; the last-position
    logits of every step are kept."""
    import torch

    from repro_torch.kernels.flash_attn import kernel, ops
    from repro_torch.models import api

    prefill_ms, decode_ms, flash_events, last_logits = {}, [], [], []
    saved = {"prefill": api.forward_prefill, "decode": api.forward_decode,
             "flash": ops.flash_forward}

    def timed(name):
        def wrapper(cfg_, params_, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, caches = saved[name](cfg_, params_, *args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if name == "prefill":
                prefill_ms.setdefault(args[0]["tokens"].shape[1],
                                      []).append(ms)
            else:
                decode_ms.append(ms)
            last_logits.append(lg[:, -1])
            return lg, caches
        return wrapper

    def flash_timed(*a, **k):
        ev = torch.cuda.Event(True), torch.cuda.Event(True)
        ev[0].record()
        out = saved["flash"](*a, **k)
        ev[1].record()
        flash_events.append(ev)
        return out

    kernel.flash_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        api.forward_prefill, api.forward_decode = (timed("prefill"),
                                                   timed("decode"))
        ops.flash_forward = flash_timed
        done = eng.run()
        torch.cuda.synchronize()
    finally:
        api.forward_prefill, api.forward_decode = (saved["prefill"],
                                                   saved["decode"])
        ops.flash_forward = saved["flash"]
    wall = time.perf_counter() - t0
    return dict(done=done, launches=kernel.flash_fwd.launches, wall=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                prefill_ms=prefill_ms, decode_ms=decode_ms,
                flash_ms=sum(a.elapsed_time(b) for a, b in flash_events),
                slots=eng.ecfg.slots, last_logits=last_logits)


def check_served(cfg, run: dict, requests: int, max_new: int) -> None:
    """Every request done with its ``max_new + 1`` tokens in [0, vocab),
    every last-position logit finite."""
    import torch

    done = run["done"]
    if sorted(done) != list(range(requests)):
        raise AssertionError(f"requests done: {sorted(done)}")
    for uid, r in done.items():
        toks = np.asarray(r.out_tokens)
        if len(toks) != max_new + 1 or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            raise AssertionError(f"request {uid}: {len(toks)} tokens, range "
                                 f"[{toks.min()}, {toks.max()}]")
    if not all(bool(torch.isfinite(lg).all()) for lg in run["last_logits"]):
        raise AssertionError("last-position logits not finite")


def log_served(label: str, run: dict) -> None:
    """ms per prefill by bucket, ms per decode tick, tokens/s, the flash
    kernel's share of the prefills, peak memory."""
    prefill_ms, decode_ms, wall = (run["prefill_ms"], run["decode_ms"],
                                   run["wall"])
    pre_total = sum(sum(v) for v in prefill_ms.values())
    tokens = sum(len(r.out_tokens) for r in run["done"].values())
    for b, v in sorted(prefill_ms.items()):
        log(f"{label} prefill bucket {b}: {len(v)} prefills, "
            f"{float(np.median(v)):.3f} ms median ({min(v):.3f}-"
            f"{max(v):.3f})")
    log(f"{label} decode: {len(decode_ms)} ticks of {run['slots']} slots, "
        f"{float(np.median(decode_ms)):.3f} ms median per tick "
        f"({min(decode_ms):.3f}-{max(decode_ms):.3f})")
    log(f"{label} {len(run['done'])} requests, {tokens} tokens in "
        f"{wall:.3f} s: {tokens / wall:.1f} generated tokens/s; flash "
        f"{run['flash_ms']:.3f} ms of {pre_total:.3f} ms prefill "
        f"({100 * run['flash_ms'] / pre_total:.2f}%); flash launches "
        f"{run['launches']}; peak memory {run['peak_gib']:.2f} GiB")


def serve_breakdown(eng, params) -> None:
    """Where a decode tick and a 512-token prefill spend their time, after
    the counted run, on a warm engine whose slots hold the last requests'
    caches: each is timed once on the host clock, then run once under
    ``torch.profiler``.  Prints both walls, the device's busy time (the sum
    of the kernels' own times), its idle share of the unprofiled wall, and
    the kernels that take most of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    toks = torch.zeros((1, 512), dtype=torch.int32, device=eng.device)
    for label, fn in (
            ("decode tick", lambda: eng._decode(eng.params, eng.tokens,
                                                eng.caches)),
            ("prefill 512", lambda: eng._prefill_b1(params,
                                                    {"tokens": toks}))):
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_prof = (time.perf_counter() - t) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        parts = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}"
                          f" ms ({e.count}x)" for e in top)
        flash = [e for e in kernels if "flash_fwd" in e.key]
        log(f"serve breakdown {label}: wall {wall:.3f} ms ({wall_prof:.3f} "
            f"ms profiled), device busy {busy:.3f} ms, idle "
            f"{100 * (1 - busy / wall):.1f}%; flash "
            f"{sum(e.self_device_time_total for e in flash) / 1e3:.3f} ms "
            f"({sum(e.count for e in flash)}x); top kernels: {parts}")


def check_plain_prefill(seed: int, device: str = "cuda") -> None:
    """Full width, 2 layers, f32: one 512-token prefill through the flash
    kernel and through its plain version."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attn import kernel, ops, ref
    from repro_torch.models import api
    from repro_torch.models.params import init_params

    dev = torch.device(device)
    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=2,
                              use_flash=True, param_dtype="float32",
                              act_dtype="float32")
    params = init_params(api.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(seed + 1),
                         dtype=torch.float32, device=dev)
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (1, 512)).astype(np.int32)).to(dev)
    n0 = kernel.flash_fwd.launches
    lg_kernel, _ = api.forward_prefill(cfg, params, {"tokens": toks})
    fwd = ops.flash_forward
    ops.flash_forward = ref.flash_ref          # the plain version, by name
    try:
        lg_plain, _ = api.forward_prefill(cfg, params, {"tokens": toks})
    finally:
        ops.flash_forward = fwd
    torch.cuda.synchronize()
    n = kernel.flash_fwd.launches - n0
    if n != cfg.n_layers:
        raise AssertionError(f"{n} flash launches in a {cfg.n_layers}-layer "
                             "prefill and its plain twin")
    rel = float(torch.linalg.norm(lg_kernel - lg_plain)
                / torch.linalg.norm(lg_plain))
    if not rel <= PLAIN_RTOL:
        raise AssertionError(f"2-layer f32 prefill: kernel vs plain "
                             f"relative error {rel:.3e} > {PLAIN_RTOL:.0e}")
    log(f"serve 2-layer f32 prefill at full width, S=512: kernel vs plain "
        f"last-position logits relative error {rel:.3e} (tol "
        f"{PLAIN_RTOL:.0e})")


# ---------------------------------------------------------------------------
# phase moe: the MoE family serving at full width
# ---------------------------------------------------------------------------

# (arch, layers kept, requests, prompt lengths, new tokens): grok-1 as the
# dense serve phase's traffic; kimi-k2 one 512-token prompt (its one layer
# alone is 33.8 GB of bf16 experts) and 8 decode ticks
MOE_RUNS = (("grok-1-314b", 2, SERVE_REQUESTS, (200, 512), SERVE_MAX_NEW),
            ("kimi-k2-1t-a32b", 1, 1, (512, 512), 8))
MOE_CHECKED = ("grok-1-314b", "kimi-k2-1t-a32b")
MOE_LOGIT_TOL = 1e-4    # f32 throughout, TF32 off: only summation order


def param_bytes(params) -> int:
    from repro_torch.tree import leaves

    return sum(x.numel() * x.element_size() for x in leaves(params))


def decode_bytes(cfg, params) -> int:
    """The bytes one decode tick must read: every parameter but the
    embedding table (the buffer-centric dispatch multiplies every
    expert's buffer, so every expert is read), of which one row a slot."""
    emb = params["embed"]
    return (param_bytes(params) - emb.numel() * emb.element_size()
            + SERVE_ENGINE["slots"] * cfg.d_model * emb.element_size())


def run_moe(seed: int, device: str = "cuda") -> dict:
    """grok-1 (2 of 64 layers) and kimi-k2 (1 of 61) at full width,
    seeded bf16 weights, ``use_flash=True``, through ``ServeEngine`` with
    the dense serve phase's engine; grok's weights are freed before kimi's
    are drawn.  Counts the (token, choice) pairs the capacity drops (by
    wrapping ``models/layers/moe.py::route``; the counts stay on the card
    until the run ends) and the flash launches: grok's prefills pass the
    flash gate (dh 128, G = 6), kimi's (dh 112) take the one-shot path.
    Returns grok's flash launches."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models.layers import moe
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    dev = torch.device(device)
    out = {}
    saved_route = moe.route
    for arch, layers, requests, (lo, hi), max_new in MOE_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  use_flash=True)
        t = time.perf_counter()
        params = init_params(api.param_defs(cfg),
                             torch.Generator(device=dev).manual_seed(seed),
                             dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        eng = ServeEngine(cfg, params, EngineConfig(**SERVE_ENGINE),
                          device=dev)
        rng = np.random.default_rng(seed)
        for uid, n in enumerate(rng.integers(lo, hi + 1, requests)):
            eng.submit(Request(uid=uid, prompt=rng.integers(
                0, cfg.vocab, int(n)).astype(np.int32), max_new=max_new))
        drops = {}                   # tokens → [(dropped, pairs, C)]

        def route_seen(moe_cfg, xf, wr):
            slot, w, aux, C = saved_route(moe_cfg, xf, wr)
            drops.setdefault(xf.shape[0], []).append(
                ((slot == moe_cfg.n_experts * C).sum(), slot.numel(), C))
            return slot, w, aux, C

        moe.route = route_seen
        try:
            run = timed_engine_run(eng)
        finally:
            moe.route = saved_route
        check_served(cfg, run, requests, max_new)
        n_prefills = sum(len(v) for v in run["prefill_ms"].values())
        gated = cfg.dh in (64, 128)
        want = cfg.n_layers * requests if gated else 0
        if run["launches"] != want or n_prefills != requests:
            raise AssertionError(f"moe {arch}: flash_fwd launched "
                                 f"{run['launches']} times in {n_prefills} "
                                 f"prefills; expected {want}")
        label = (f"moe {arch} ({layers} of {get_config(arch).n_layers} "
                 "layers)")
        log(f"{label}: {eng.ecfg}, {requests} requests of {lo}-{hi} prompt "
            f"tokens and {max_new} new; bf16 weights "
            f"{param_bytes(params) / 1e9:.2f} GB drawn in {init_s:.3f} s; "
            "attention "
            + (f"through the flash kernel (dh {cfg.dh}, G = "
               f"{cfg.n_heads // cfg.n_kv})" if gated else
               f"on the one-shot torch path: dh {cfg.dh} fails the flash "
               "gate (dh in 64, 128), as in the reference"))
        log_served(label, run)
        for T, rows in sorted(drops.items()):
            dropped = sum(int(d) for d, _, _ in rows)
            pairs = sum(n for _, n, _ in rows)
            log(f"{label} capacity at {T} tokens: C = {rows[0][2]} of "
                f"{cfg.moe.n_experts} experts, top-{cfg.moe.top_k}; "
                f"{dropped} of {pairs} (token, choice) pairs dropped "
                f"({100 * dropped / pairs:.2f}%) over {len(rows)} calls")
        nbytes = decode_bytes(cfg, params)
        bound = nbytes / PEAK_BYTES_S * 1e3
        tick = float(np.median(run["decode_ms"]))
        log(f"{label} decode tick: {tick:.3f} ms median against its bytes "
            f"bound {bound:.3f} ms ({nbytes / 1e9:.2f} GB of weights read "
            f"a tick at 3.35 TB/s: {100 * bound / tick:.1f}% of it)")
        serve_breakdown(eng, params)
        out[arch] = {"launches": run["launches"]}
        del eng, params, run
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": out["grok-1-314b"]["launches"]}


def check_moe_reduced(seed: int, device: str = "cuda") -> None:
    """grok-1 and kimi-k2 reduced (2 layers, f32) on the card and on the
    CPU from the same weights: a prefill's logits within 1e-4 and a short
    ServeEngine run's greedy tokens identical."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    for arch in MOE_CHECKED:
        cfg = get_config(arch).reduced()
        cpu = init_params(api.param_defs(cfg),
                          torch.Generator().manual_seed(seed), device="cpu")
        card = {k: ({n: w.to(device) for n, w in v.items()}
                    if isinstance(v, dict) else v.to(device))
                for k, v in cpu.items()}
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
        prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
                   for n in rng.integers(10, 33, 3)]
        logits, tokens = {}, {}
        for dev, params in (("cpu", cpu), (device, card)):
            with torch.no_grad():
                lg, _ = api.forward_prefill(
                    cfg, params, {"tokens": torch.from_numpy(toks).to(dev)})
            logits[dev] = lg.float().cpu()
            eng = ServeEngine(cfg, params, EngineConfig(
                slots=2, s_max=64, prefill_buckets=(16, 32)), device=dev)
            for uid, p in enumerate(prompts):
                eng.submit(Request(uid=uid, prompt=p, max_new=4))
            tokens[dev] = {u: r.out_tokens for u, r in eng.run().items()}
        err = float((logits[device] - logits["cpu"]).abs().max())
        if not err <= MOE_LOGIT_TOL or tokens[device] != tokens["cpu"]:
            raise AssertionError(
                f"moe reduced {arch}: card vs CPU logits max err {err:.3e} "
                f"(tol {MOE_LOGIT_TOL:.0e}); tokens {tokens[device]} vs "
                f"{tokens['cpu']}")
        log(f"moe reduced {arch} (2 layers, f32): card vs CPU prefill "
            f"logits max err {err:.3e} (tol {MOE_LOGIT_TOL:.0e}); greedy "
            f"tokens of 3 requests identical")


# ---------------------------------------------------------------------------
# phase train: the training path at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH = "smollm-135m", 1024, 8
TRAIN_SKETCH = dict(d=128, eps=0.125, window=128)            # as --sketch
TRAIN_COMPRESS = dict(rank=8, eps=0.125, window=32, min_size=4096)
TRAIN_DROP = 0.1       # mean of the last 5 losses below the first 5 by this
# Sketchy's steps: ~85 s each of fd_compress, so one, to keep the script
# within its limit (its momenta and windows show that the step updated)
SKETCHY_STEPS = 1


def _train_runs(steps: int, extra: int):
    """(label, steps, TrainStepConfig, optimizer or None) of the phase."""
    from repro_torch.sketch import CompressConfig, SketchConfig, \
        SketchyConfig, sketchy_dsfd
    from repro_torch.train.train_step import TrainStepConfig

    return [("adamw+monitor", steps,
             TrainStepConfig(sketch=SketchConfig(**TRAIN_SKETCH)), None),
            ("adamw+compress", extra,
             TrainStepConfig(compress=CompressConfig(**TRAIN_COMPRESS)),
             None),
            ("sketchy", SKETCHY_STEPS, TrainStepConfig(),
             sketchy_dsfd(SketchyConfig()))]


def _finite(tensors) -> bool:
    import torch

    return all(bool(torch.isfinite(x).all()) for x in tensors)


def _check_train_state(label: str, res: dict, n: int, lows: list) -> None:
    """The state a train run ends in: finite parameters; for the
    compression, the first step's projections zero (the empty sketch's
    basis) and the last step's nonzero (a learned basis) for every
    compressed leaf, finite error-feedback accumulators and sketches; for
    Sketchy, finite sketches, finite nonzero momenta and a nonzero
    window in every sketched leaf."""
    from repro_torch.tree import leaves, map_dicts

    def tensors(tree):
        return [x for x in leaves(tree) if x is not None]

    if not _finite(tensors(res["params"])):
        raise AssertionError(f"train {label}: non-finite parameters")
    if label == "adamw+compress":
        per = len(lows) // n
        if per == 0 or len(lows) != per * n:
            raise AssertionError(f"train {label}: {len(lows)} projections "
                                 f"in {n} steps")
        first = [float(x) for x in lows[:per]]
        last = [float(x) for x in lows[-per:]]
        if any(x != 0.0 for x in first) or not all(
                np.isfinite(x) and x > 0.0 for x in last):
            raise AssertionError(
                f"train {label}: ‖low‖ per compressed leaf {first} at the "
                f"first step (want 0: empty sketch), {last} at the last "
                "(want finite and > 0: a learned basis)")
        if not _finite(tensors(res["sketch_state"]["compress"])):
            raise AssertionError(f"train {label}: non-finite compression "
                                 "state")
        log(f"train {label}: {per} compressed leaves; ‖low‖ at the last "
            f"step {min(last):.4e} to {max(last):.4e} (0 at the first)")
    elif label == "sketchy":
        import torch

        from repro_torch.sketch import SketchyConfig

        st = res["opt_state"]
        mom = tensors(st.mom)
        if not (_finite(tensors(st.sketch)) and _finite(mom)
                and all(bool((m != 0).any()) for m in mom)):
            raise AssertionError(f"train {label}: Sketchy state not finite "
                                 "or a momentum all zero")
        # every sketched leaf's curvature window holds the steps' rows
        energy = []
        map_dicts(lambda p, sk: sk is None or energy.append(float(torch.sum(
            SketchyConfig().sketch(p.shape[-1], p.device).query_rows(sk)
            ** 2))), res["params"], st.sketch)
        if not energy or min(energy) <= 0.0:
            raise AssertionError(f"train {label}: a sketched leaf's window "
                                 f"is empty ({energy})")
        log(f"train {label}: {len(energy)} sketched leaves, window energy "
            f"{min(energy):.4f} to {max(energy):.4f}")


def run_train(steps: int, extra: int, seed: int,
              device: str = "cuda") -> dict:
    """``train()`` — the launcher's code path — on smollm-135m at full
    width with the flash gate and full remat, f32 parameters and bf16
    activations, seq 1024, batch 8: AdamW with the DS-FD monitor for
    ``steps`` steps (the loss must fall), then ``extra`` steps with FD
    gradient compression and ``SKETCHY_STEPS`` with Sketchy.  Every run
    must end with finite losses and parameters and, with two steps or
    more, a last loss apart from its first (each step's loss precedes its
    update); the compression's first step
    must project onto the empty sketch's zero basis and its last onto a
    learned one (nonzero ``low`` for every compressed leaf), with finite
    error-feedback accumulators and sketches; Sketchy's momenta and
    sketches must be finite and its momenta nonzero.  Each run counts the flash launches from 0 (fwd = 2·layers·steps under full
    remat, bwd = layers·steps), records the dtype the flash ran in, the
    host-clock time of each step (each ends in a host read of its
    metrics), its FD-compression time and the peak memory.  Returns the
    AdamW run's launches."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attn import kernel, ops
    from repro_torch.sketch import compress, sketchy
    from repro_torch.train.loop import LoopConfig, train

    dev = torch.device(device)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), use_flash=True,
                              remat="full")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    saved = {"flash": ops.flash_forward, "compress": compress.fd_compress,
             "sketchy": sketchy.fd_compress,
             "project": compress.project_rank_r}
    flash_dtypes, fd_s, lows = set(), [], []

    def flash_seen(q, *a, **k):
        flash_dtypes.add(str(q.dtype).replace("torch.", ""))
        return saved["flash"](q, *a, **k)

    def fd_timed(name):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = saved[name](*a, **k)
            torch.cuda.synchronize()
            fd_s.append(time.perf_counter() - t)
            return out
        return wrapper

    def project_seen(X, V):
        coef, low = saved["project"](X, V)
        lows.append(torch.linalg.vector_norm(low))
        return coef, low

    out = {}
    for label, n, tsc, opt in _train_runs(steps, extra):
        stamps, fd_s[:], lows[:] = [], [], []
        flash_dtypes.clear()
        kernel.flash_fwd.launches = kernel.flash_bwd.launches = 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            ops.flash_forward = flash_seen
            compress.fd_compress = fd_timed("compress")
            sketchy.fd_compress = fd_timed("sketchy")
            compress.project_rank_r = project_seen
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = train(cfg, device=dev,
                        loop=LoopConfig(steps=n, seed=seed,
                                        log_every=10 ** 9),
                        tsc=tsc, opt=opt, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH,
                        hooks={"on_step": lambda it, m: stamps.append(
                            time.perf_counter())})
        finally:
            ops.flash_forward = saved["flash"]
            compress.fd_compress = saved["compress"]
            sketchy.fd_compress = saved["sketchy"]
            compress.project_rank_r = saved["project"]
        fwd, bwd = kernel.flash_fwd.launches, kernel.flash_bwd.launches
        losses = [h["loss"] for h in res["history"]]
        if len(losses) != n or not np.isfinite(losses).all() \
                or (n > 1 and losses[-1] == losses[0]):
            raise AssertionError(f"train {label}: losses {losses} (finite, "
                                 "the last apart from the first)")
        if (fwd, bwd) != (2 * cfg.n_layers * n, cfg.n_layers * n):
            raise AssertionError(
                f"train {label}: flash launches fwd {fwd} bwd {bwd}, "
                f"expected {2 * cfg.n_layers * n} and {cfg.n_layers * n}")
        if flash_dtypes != {"float32"}:
            raise AssertionError(f"train {label}: flash ran in "
                                 f"{flash_dtypes}, expected float32")
        step_s = np.diff([t0] + stamps)
        med = float(np.median(step_s[1:] if n > 1 else step_s))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fd_share = sum(fd_s) / float(step_s.sum())
        log(f"train {label}: {n} steps, losses {losses[0]:.4f} → "
            f"{losses[-1]:.4f}; first step {1e3 * step_s[0]:.3f} ms, then "
            f"median {1e3 * med:.3f} ms/step ({tokens / med:.1f} tokens/s); "
            f"FD compression {sum(fd_s):.3f} s of {float(step_s.sum()):.3f}"
            f" s ({100 * fd_share:.1f}%, {len(fd_s)} calls); flash "
            f"launches fwd {fwd} bwd {bwd} ({cfg.n_layers} layers × {n} "
            f"steps × 2 and × 1), in {sorted(flash_dtypes)}; peak memory "
            f"{peak:.2f} GiB; stragglers {res['stragglers']}")
        _check_train_state(label, res, n, lows)
        if label.startswith("adamw+monitor"):
            first, last = np.mean(losses[:5]), np.mean(losses[-5:])
            if not last < first - TRAIN_DROP:
                raise AssertionError(
                    f"train {label}: mean of the last 5 losses {last:.4f} "
                    f"not below the first 5's {first:.4f} by {TRAIN_DROP}")
            mon = res["history"][-1]
            log(f"train {label}: last 5 mean {last:.4f} vs first 5 "
                f"{first:.4f}; monitor sketch/top_energy "
                f"{mon['sketch/top_energy']:.4f}, window_norm2 "
                f"{mon['sketch/window_norm2']:.4f}")
            out = {"launches": {"flash_fwd": fwd, "flash_bwd": bwd}}
        del res
    return out


def check_plain_train_step(seed: int, device: str = "cuda") -> None:
    """Full width, 2 layers, f32: one train step's loss and every
    gradient through the flash kernels and through their plain versions
    on the card (seq 1024, batch 2)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attn import kernel, ops, ref
    from repro_torch.models import api
    from repro_torch.models.params import init_params
    from repro_torch.train.train_step import loss_fn
    from repro_torch.tree import leaves

    dev = torch.device(device)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2,
                              use_flash=True, remat="full")
    params = init_params(api.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(seed + 2),
                         dtype=torch.float32, device=dev)
    grad_of = [p.requires_grad_(True) for p in leaves(params)]
    _, batch = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                             global_batch=2, seed=seed).next_batch(
        {"step": 0})
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def step():
        tot, _ = loss_fn(cfg, params, batch)
        return tot.detach(), torch.autograd.grad(tot, grad_of)

    n0 = kernel.flash_fwd.launches, kernel.flash_bwd.launches
    loss_k, grads_k = step()
    saved = ops.flash_forward, ops.flash_backward
    ops.flash_forward, ops.flash_backward = ref.flash_ref, ref.flash_bwd_ref
    try:
        loss_p, grads_p = step()
    finally:
        ops.flash_forward, ops.flash_backward = saved
    torch.cuda.synchronize()
    n = (kernel.flash_fwd.launches - n0[0], kernel.flash_bwd.launches - n0[1])
    if n != (2 * cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"flash launches {n} in a {cfg.n_layers}-layer "
                             "train step and its plain twin")
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    rel = max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
              for a, b in zip(grads_k, grads_p))
    if not (rel_loss <= PLAIN_RTOL and rel <= PLAIN_RTOL):
        raise AssertionError(f"2-layer f32 train step: kernel vs plain loss "
                             f"{rel_loss:.3e}, worst gradient {rel:.3e} "
                             f"(relative, tol {PLAIN_RTOL:.0e})")
    log(f"train 2-layer f32 step at full width, S={TRAIN_SEQ}: kernel vs "
        f"plain loss relative error {rel_loss:.3e}, worst gradient "
        f"(relative Frobenius, {len(grad_of)} leaves) {rel:.3e} (tol "
        f"{PLAIN_RTOL:.0e})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int,
                    default=5 * WINDOW // (4 * BLOCK))
    ap.add_argument("--fast-ticks", type=int, default=12)
    ap.add_argument("--fine-ticks", type=int,
                    default=math.ceil(1.25 * WINDOW / BLOCK))
    ap.add_argument("--layered-ticks", type=int,
                    default=math.ceil(1.25 * WINDOW / BLOCK))
    ap.add_argument("--time-ticks", type=int, default=160)
    ap.add_argument("--score-ticks", type=int, default=64)
    ap.add_argument("--history-ticks", type=int,
                    default=WINDOW // BLOCK + 512 // BLOCK)
    ap.add_argument("--topology-ticks", type=int, default=128)
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--train-extra-steps", type=int, default=2)
    ap.add_argument("--launch-sizes", action="store_true",
                    help="internal: time the dump-step kernels at the "
                    "launch sizes given on standard input")
    ap.add_argument("--topology-child", nargs=3, metavar=("PID", "PORT",
                                                          "DIR"),
                    help="internal: one process of the topology phase's "
                    "pair")
    args = ap.parse_args(argv)
    if args.train_steps < 10:
        ap.error("--train-steps must give 10 losses: the first and the "
                 "last 5 are compared")
    if args.train_extra_steps < 2:
        ap.error("--train-extra-steps must be 2 or more: the compression's "
                 "first step projects onto an empty sketch")
    if args.score_ticks <= SCORE_SWITCH:
        ap.error(f"--score-ticks must pass the switch at tick {SCORE_SWITCH}")
    if args.history_ticks <= max(WINDOW // BLOCK, HISTORY_RESUMED):
        ap.error(f"--history-ticks must pass the window "
                 f"({WINDOW // BLOCK} ticks) and the {HISTORY_RESUMED} "
                 "ticks a resumed engine runs")

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.launch_sizes:
        return launch_sizes_main()
    if args.topology_child:
        pid, port, root = args.topology_child
        return topology_child(int(pid), int(port), root)
    from repro_torch.kernels import dispatch

    rng = np.random.default_rng(args.seed)
    gpu = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    libs = dispatch.build()
    for name, lib in libs.items():
        for line in lib.with_name(lib.name + ".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")
    log(f"phase build: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    stats = check_kernels(rng)
    stats.update(check_split_kernels(rng))
    stats["flash_fwd"] = check_flash(rng)
    p_rounding(rng)
    stats["flash_bwd"] = check_flash_bwd(rng)
    log(f"phase kernels: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    kry = run_engine(KRYLOV, args.ticks, args.seed, use_kernel=True)
    log(f"phase krylov: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    run_engine(FAST, args.fast_ticks, args.seed + 100)
    log(f"phase fast: {time.perf_counter() - t:.3f} s")

    gc.collect()                       # the fleets' tensors
    torch.cuda.empty_cache()
    t = time.perf_counter()
    fine = run_engine(FINE, args.fine_ticks, args.seed + 200,
                      use_kernel=True)
    log(f"phase fine: {time.perf_counter() - t:.3f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    seq = run_layered(SEQ, args.layered_ticks, args.seed + 300)
    gc.collect()
    torch.cuda.empty_cache()
    tds = run_layered(TIME, args.time_ticks, args.seed + 400)
    log(f"phase layered: {time.perf_counter() - t:.3f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    sco = run_score(args.score_ticks, args.seed + 500)
    log(f"phase score: {time.perf_counter() - t:.3f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    hist = run_history(args.history_ticks, args.seed + 600)
    log(f"phase history: {time.perf_counter() - t:.3f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    topo = run_topology(args.topology_ticks, hist, args.seed + 700)
    log(f"phase topology: {time.perf_counter() - t:.3f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    srv = run_serve(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    check_plain_prefill(args.seed)
    log(f"phase serve: {time.perf_counter() - t:.3f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    mix = run_moe(args.seed)
    check_moe_reduced(args.seed)
    log(f"phase moe: {time.perf_counter() - t:.3f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    trn = run_train(args.train_steps, args.train_extra_steps, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    check_plain_train_step(args.seed)
    log(f"phase train: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    at = time_launch_sizes_apart({"krylov": kry["timing"],
                                  "fine": fine["timing"]})
    log(f"phase launch sizes: {time.perf_counter() - t:.3f} s")

    # each kernel's launches on the path that runs it, and for the dump
    # step's kernels the streams a launch took and their time at the median
    launches = {n: kry["launches"][n] for n in FUSED}
    launches.update({n: fine["launches"][n] for n in FINE.launched})
    launches["flash_fwd"] = srv["launches"]
    launches["flash_bwd"] = trn["launches"]["flash_bwd"]
    for label, run in (("krylov", kry), ("fine", fine)):
        for name, spread in run["launch_streams"].items():
            stats[name].update(launch_streams=spread,
                               at_median=at[label][name])
    where = {
        "gram_power": ("fused_tick.cu", "fused_tick/kernel.py:66"),
        "fused_krylov_step": ("fused_tick.cu", "fused_tick/kernel.py:110"),
        "gram": ("gram.cu", "gram/kernel.py:39"),
        "power_iter": ("power_iter.cu", "power_iter/kernel.py:42"),
        "rank1_downdate": ("rank1_downdate.cu", "rank1_downdate/kernel.py:43"),
        "window_gram": ("window_gram.cu", "window_gram/kernel.py:34"),
        "flash_fwd": ("flash_attn.cu", "flash_attn/kernel.py:86"),
        "flash_bwd": ("flash_attn_bwd.cu", "flash_attn/ops.py:58"),
    }
    # and the launches of every path that ran it, each counted from 0
    paths = {"krylov": kry["launches"], "fine": fine["launches"],
             "seq-dsfd": seq["launches"], "time-dsfd": tds["launches"],
             "score": sco["launches"], "history": hist["launches"],
             "topology": topo["launches"],
             "serve": {"flash_fwd": srv["launches"]},
             "moe": {"flash_fwd": mix["launches"]},
             "train": trn["launches"]}
    rows = [dict(name=name, route="cuda",
                 source=f"src/repro_torch/csrc/{src}",
                 replaces=f"src/repro/kernels/{tpu}",
                 launches=launches[name],
                 launches_by_path={p: n[name] for p, n in paths.items()
                                   if n.get(name)},
                 **stats[name])
            for name, (src, tpu) in where.items()]
    print(json.dumps({"kernels": rows}))
    print(f"gpu: {gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
