#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--ticks 320] [--fast-ticks 16]

Phases, each printing its seconds on a line of its own:

1. build   — compile every kernel source under ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together).
2. kernels — hold each CUDA kernel against its plain PyTorch version on
   the card and time both in turns with CUDA events: the fused-tick
   kernels at the krylov path's shape (S=1024, m=64, d=300), at an
   unaligned shape (m=10, d=37) and on an all-zero slab; the flash
   forward at llama3-8b's prefill shapes (buckets 512 and 256, bf16),
   smollm's (G=3, dh=64, bf16), qwen1.5's (G=1, f32) and one non-causal
   case, beside ``scaled_dot_product_attention`` as the library yardstick.
3. krylov  — the sketch fleet at full width:
   ``SketchFleetEngine("dsfd", d=300, streams=1024, eps=1/32,
   window=1024, block=8, mode="krylov", use_kernel=True)``, fed by
   ``submit_many`` with 8 unit-norm rows per user per tick for 2.5·N rows
   per user.  Both kernels' launch counts must be > 0; Theorem 3.1
   (‖A_WᵀA_W − BᵀB‖₂ ≤ 4εN) is checked for 8 users against float64 Grams
   of their windows on the host; ``query_global`` must be finite with
   Frobenius mass ≤ Σ‖A_W‖_F².  Then 8 more ticks split where their time
   goes (SVD, each kernel, other) on the host clock.
4. fast    — a short ``mode="fast"`` run (the users' default) at the same
   width, checked and split the same way.
5. serve   — the dense serving path at full width: llama3-8b (32 layers,
   bf16 weights from a seeded ``torch.Generator`` on the card) with
   ``use_flash=True`` in ``ServeEngine(slots=4, s_max=1024,
   prefill_buckets=(256, 512))``, 8 greedy requests of 200-512 prompt
   tokens and 16 new tokens.  Every request must finish with 17 tokens in
   [0, vocab), the flash kernel must launch exactly 32 × 8 times, and the
   last-position logits must be finite.  Then a 2-layer f32 model at full
   width prefills one 512-token prompt through the kernel and through its
   plain version: the last-position logits must agree within 1e-4
   relative (Frobenius).

Then it prints one JSON line of per-kernel numbers, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failure
exits nonzero before the last line.  Without a CUDA device, or run outside
a checkout of the repository, it exits nonzero at once.
"""

from __future__ import annotations

import argparse
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
    out = {}
    for name, b, f in (("gram_power", bytes_gp, flops_gp),
                       ("fused_krylov_step", bytes_st, flops_st)):
        tb, tf = b / PEAK_BYTES_S * 1e3, f / PEAK_F32_FLOPS * 1e3
        out[name] = (max(tb, tf), "bytes" if tb >= tf else "operations")
    return out


def check_kernels(rng) -> dict:
    import torch

    from repro_torch.kernels.fused_tick import kernel, ref

    dev = torch.device("cuda")
    errs = {"gram_power": 0.0, "fused_krylov_step": 0.0}
    shapes = [("main", MAIN_SHAPE), ("unaligned", (7, 10, 37)),
              ("zeros", (4, 64, 300))]
    for label, (S, m, d) in shapes:
        if label == "zeros":
            D = torch.zeros((S, m, d), device=dev)
        else:
            # unit-norm rows, the scale of the engine's buffers
            Dn = rng.standard_normal((S, m, d)).astype(np.float32)
            Dn /= np.linalg.norm(Dn, axis=2, keepdims=True)
            D = torch.from_numpy(Dn).to(dev)
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
    Dn = rng.standard_normal((S, m, d)).astype(np.float32)
    Dn /= np.linalg.norm(Dn, axis=2, keepdims=True)
    D = torch.from_numpy(Dn).to(dev)
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
    bounds = kernel_bounds(S, m, d, ITERS)
    for name, t in (("gram_power", t_gp), ("fused_krylov_step", t_st)):
        log(f"kernels time {name} S,m,d={S},{m},{d}: kernel_ms "
            f"{t['kernel']:.4f} plain_ms {t['plain']:.4f} library_ms "
            f"{t.get('library', float('nan')):.4f} bound_ms "
            f"{bounds[name][0]:.4f} ({bounds[name][1]})")
    for drv, t in t_svd.items():
        log(f"kernels time torch.linalg.svd driver={drv} S,m,d={S},{m},{d}: "
            f"{t:.3f} ms")
    return {
        "gram_power": dict(
            max_abs_err=errs["gram_power"], ms=t_gp["kernel"],
            plain_ms=t_gp["plain"], bound_ms=bounds["gram_power"][0],
            bound_by=bounds["gram_power"][1], library_ms=t_gp["library"]),
        "fused_krylov_step": dict(
            max_abs_err=errs["fused_krylov_step"], ms=t_st["kernel"],
            plain_ms=t_st["plain"],
            bound_ms=bounds["fused_krylov_step"][0],
            bound_by=bounds["fused_krylov_step"][1], library_ms=None),
    }


# ---------------------------------------------------------------------------
# phase 2 (cont.): the flash-attention forward
# ---------------------------------------------------------------------------

# (label, B, S, H, Hkv, dh, dtype, causal); the first is the timed one
FLASH_SHAPES = [
    ("llama3-8b bucket 512", 1, 512, 32, 8, 128, "bfloat16", True),
    ("llama3-8b bucket 256", 1, 256, 32, 8, 128, "bfloat16", True),
    ("smollm G=3", 2, 256, 9, 3, 64, "bfloat16", True),
    ("qwen1.5 G=1", 1, 512, 16, 16, 64, "float32", True),
    ("non-causal", 1, 512, 32, 8, 128, "bfloat16", False),
]
# o: one rounding to bf16 of outputs of unit scale (~4e-3 relative; the
# reference's own kernel test allows 2e-2); f32: the same arithmetic in
# another summation order.  lse is f32 in both types.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_TOL = 1e-3


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


def check_flash(rng) -> dict:
    import torch
    import torch.nn.functional as F

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
        if not label.startswith("llama3-8b"):
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
        log(f"kernels time flash_fwd {label}: kernel_ms {t['kernel']:.4f} "
            f"plain_ms {t['plain']:.4f} library_ms (sdpa) "
            f"{t['library']:.4f} bound_ms {bound:.4f} ({by}); sdpa vs "
            f"plain max err {lib_err:.3e}")
        timed.setdefault("row", dict(
            ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound,
            bound_by=by, library_ms=t["library"]))
    return dict(max_abs_err=worst, **timed["row"])


# ---------------------------------------------------------------------------
# phases 3-4: the engine at full width
# ---------------------------------------------------------------------------

S_FLEET, D, EPS, WINDOW, BLOCK = 1024, 300, 1 / 32, 1024, 8
CHECKED = (0, 170, 341, 511, 512, 682, 853, 1023)


def run_engine(mode: str, ticks: int, seed: int, device: str = "cuda",
               **hyper) -> dict:
    """Feed the engine ``ticks`` ticks of 8 rows per user and check it."""
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    from repro_torch.core import dsfd
    from repro_torch.data.streams import SyntheticSource
    from repro_torch.kernels.fused_tick import kernel
    from repro_torch.serve.engine import SketchFleetEngine

    eng = SketchFleetEngine("dsfd", d=D, streams=S_FLEET, eps=EPS,
                            window=WINDOW, block=BLOCK, mode=mode,
                            ingest="async", device=device, **hyper)
    # users [0, 512): the paper's SYNTHETIC set (signal dimension k = d);
    # users [512, 1024): the same model with k = 10, whose top directions
    # exceed εN in a window and so are dumped into snapshots
    half = S_FLEET // 2
    srcs = (SyntheticSource(D, seed=seed),
            SyntheticSource(D, k=10, seed=seed + 1))
    users = np.repeat(np.arange(S_FLEET), BLOCK)
    kept = {u: [] for u in CHECKED}

    def next_tick():
        rows = np.concatenate([s.rows(half * BLOCK) for s in srcs])
        for u in CHECKED:
            kept[u].append(rows[u * BLOCK:(u + 1) * BLOCK])
            kept[u] = kept[u][-(WINDOW // BLOCK):]
        return rows

    eng.submit_many(users, next_tick())         # one tick ahead: async
    kernel.gram_power_cuda.launches = 0
    kernel.fused_krylov_step_cuda.launches = 0
    dsfd.host_indices.count = 0
    sync()
    t0 = time.perf_counter()
    for tick in range(ticks):
        if tick + 1 < ticks:
            eng.submit_many(users, next_tick())
        if eng.step() != S_FLEET * BLOCK:
            raise AssertionError(f"tick {tick} ingested a partial slab")
    sync()
    elapsed = time.perf_counter() - t0
    launches = {"gram_power": kernel.gram_power_cuda.launches,
                "fused_krylov_step": kernel.fused_krylov_step_cuda.launches}
    syncs = dsfd.host_indices.count
    if eng.backlog or eng.rows_ingested != ticks * S_FLEET * BLOCK:
        raise AssertionError(f"{eng.backlog} rows left; ingested "
                             f"{eng.rows_ingested}")
    log(f"{mode} engine: {ticks} ticks, {eng.rows_ingested} rows in "
        f"{elapsed:.3f} s: {eng.rows_ingested / elapsed:.1f} rows/s, "
        f"{elapsed / ticks * 1e3:.3f} ms/tick, "
        f"{syncs / ticks:.2f} host syncs/tick, launches {launches}")

    bound = 4 * EPS * min(eng.t, WINDOW)
    worst = 0.0
    for u in CHECKED:
        A = np.concatenate(kept[u]).astype(np.float64)[-WINDOW:]
        B = eng.query_user(u).astype(np.float64)
        if not np.isfinite(B).all():
            raise AssertionError(f"user {u}: query not finite")
        err = float(np.max(np.abs(np.linalg.eigvalsh(A.T @ A - B.T @ B))))
        worst = max(worst, err / (EPS * min(eng.t, WINDOW)))
        if err > bound:
            raise AssertionError(f"user {u}: ‖A_WᵀA_W − BᵀB‖₂ = {err:.3f} "
                                 f"> 4εN = {bound:.1f}")
    log(f"{mode} Theorem 3.1 on users {CHECKED}: worst error "
        f"{worst:.4f}·εN (bound 4·εN)")
    live = eng.state.main.snap_valid.sum(dim=1).cpu().numpy()
    log(f"{mode} live snapshots at the end: users [0, {half}) (k = d) "
        f"{int(live[:half].sum())}, users [{half}, {S_FLEET}) (k = 10) "
        f"{int(live[half:].sum())}")

    t1 = time.perf_counter()
    g = eng.query_global()
    t_q = time.perf_counter() - t1
    mass = float(np.sum(g.astype(np.float64) ** 2))
    total = S_FLEET * min(eng.t, WINDOW) * (1 + 1e-4)   # unit-norm rows
    if not np.isfinite(g).all() or mass > total:
        raise AssertionError(f"query_global: finite={np.isfinite(g).all()}"
                             f" mass {mass:.1f} > Σ‖A_W‖² {total:.1f}")
    log(f"{mode} query_global: {t_q:.3f} s, ‖B‖_F² {mass:.1f} ≤ "
        f"{total:.1f}")
    if device == "cuda":
        breakdown(eng, mode, BREAKDOWN_TICKS, lambda: (users, next_tick()))
    return {"launches": launches, "elapsed": elapsed, "syncs": syncs}


BREAKDOWN_TICKS = 8


def breakdown(eng, mode: str, ticks: int, feed) -> None:
    """Where a tick's time goes, on the host clock: ``ticks`` more ticks
    (after the checks, outside the counted run) with the SVDs and the two
    kernels timed between device synchronisations.  The syncs add a little
    time of their own; ``other`` is everything else (small ops, host
    syncs, ingest)."""
    import torch

    from repro_torch.core import dsfd

    spent = {"svd": 0.0, "gram_power": 0.0, "fused_krylov_step": 0.0}
    calls = dict.fromkeys(spent, 0)
    names = {"fd_shrink": "svd", "fd_rotate": "svd",
             "gram_power": "gram_power",
             "fused_krylov_step": "fused_krylov_step"}
    saved = {n: getattr(dsfd, n) for n in names}

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
        for n, key in names.items():
            setattr(dsfd, n, timed(saved[n], key))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.submit_many(*feed())
            eng.step()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(dsfd, n, fn)
    parts = ", ".join(f"{k} {v:.3f} s ({100 * v / wall:.1f}%, {calls[k]} "
                      f"calls)" for k, v in spent.items())
    other = wall - sum(spent.values())
    log(f"{mode} breakdown: {ticks} ticks, wall {wall:.3f} s: {parts}, "
        f"other {other:.3f} s ({100 * other / wall:.1f}%)")


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
    from repro_torch.kernels.flash_attn import kernel, ops
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

    # host-clock timers around each model step (synchronised), CUDA events
    # around each flash call; the last-position logits are kept
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
    launches = kernel.flash_fwd.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    n_prefills = sum(len(v) for v in prefill_ms.values())
    want = cfg.n_layers * SERVE_REQUESTS
    if launches != want or n_prefills != SERVE_REQUESTS:
        raise AssertionError(f"flash_fwd launched {launches} times in "
                             f"{n_prefills} prefills; expected {want}")
    if sorted(done) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"requests done: {sorted(done)}")
    for uid, r in done.items():
        toks = np.asarray(r.out_tokens)
        if len(toks) != SERVE_MAX_NEW + 1 or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            raise AssertionError(f"request {uid}: {len(toks)} tokens, range "
                                 f"[{toks.min()}, {toks.max()}]")
    if not all(bool(torch.isfinite(lg).all()) for lg in last_logits):
        raise AssertionError("last-position logits not finite")
    flash_ms = sum(a.elapsed_time(b) for a, b in flash_events)
    pre_total = sum(sum(v) for v in prefill_ms.values())
    tokens = sum(len(r.out_tokens) for r in done.values())
    for b, v in sorted(prefill_ms.items()):
        log(f"serve prefill bucket {b}: {len(v)} prefills, "
            f"{float(np.median(v)):.3f} ms median ({min(v):.3f}-"
            f"{max(v):.3f})")
    log(f"serve decode: {len(decode_ms)} ticks of {SERVE_ENGINE['slots']} "
        f"slots, {float(np.median(decode_ms)):.3f} ms median per tick "
        f"({min(decode_ms):.3f}-{max(decode_ms):.3f})")
    log(f"serve {SERVE_REQUESTS} requests, {tokens} tokens in {wall:.3f} s:"
        f" {tokens / wall:.1f} generated tokens/s; flash {flash_ms:.3f} ms "
        f"of {pre_total:.3f} ms prefill ({100 * flash_ms / pre_total:.2f}%); "
        f"flash launches {launches}; peak memory {peak_gib:.2f} GiB")
    serve_breakdown(eng, params)
    del eng, params
    return {"launches": launches}


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
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        parts = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}"
                          f" ms ({e.count}x)" for e in top)
        log(f"serve breakdown {label}: wall {wall:.3f} ms ({wall_prof:.3f} "
            f"ms profiled), device busy {busy:.3f} ms, idle "
            f"{100 * (1 - busy / wall):.1f}%; top kernels: {parts}")


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int,
                    default=math.ceil(2.5 * WINDOW / BLOCK))
    ap.add_argument("--fast-ticks", type=int, default=16)
    args = ap.parse_args(argv)

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
    stats["flash_fwd"] = check_flash(rng)
    log(f"phase kernels: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    kry = run_engine("krylov", args.ticks, args.seed, use_kernel=True)
    for name, n in kry["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")
    log(f"phase krylov: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    run_engine("fast", args.fast_ticks, args.seed + 100)
    log(f"phase fast: {time.perf_counter() - t:.3f} s")

    gc.collect()                       # the fleets' tensors
    torch.cuda.empty_cache()
    t = time.perf_counter()
    srv = run_serve(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    check_plain_prefill(args.seed)
    log(f"phase serve: {time.perf_counter() - t:.3f} s")

    launches = dict(kry["launches"], flash_fwd=srv["launches"])
    where = {
        "gram_power": ("fused_tick.cu", "fused_tick/kernel.py:66"),
        "fused_krylov_step": ("fused_tick.cu", "fused_tick/kernel.py:110"),
        "flash_fwd": ("flash_attn.cu", "flash_attn/kernel.py:86"),
    }
    rows = [dict(name=name, route="cuda",
                 source=f"src/repro_torch/csrc/{src}",
                 replaces=f"src/repro/kernels/{tpu}",
                 launches=launches[name], **stats[name])
            for name, (src, tpu) in where.items()]
    print(json.dumps({"kernels": rows}))
    print(f"gpu: {gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
