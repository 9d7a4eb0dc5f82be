"""DS-FD — Dump-Snapshot FrequentDirections over sliding windows, batched
over streams (Algorithms 1-4 and the fast/krylov cadences of §3.1).

Counterpart of ``repro/core/dsfd.py``.  The reference is written for one
sketch and gets a fleet from ``jax.vmap``, which turns every ``lax.cond``
into a select and runs the krylov ``while_loop`` until no stream's
condition holds.  Here every tensor carries the stream axis S first and
the batching is written out:

* each cond is a masked update over S, in the reference's priority order:
  a full buffer goes to the SVD merge, otherwise a hot one (σ̂₁² ≥ θ) to
  the dump path (``dsfd.py:307-310``);
* the expensive branches (SVD, krylov) run only on the streams that take
  them: the per-stream decisions of a row are read to the host in one
  transfer, and the branch gathers its streams by index;
* the krylov loop is bounded by m and keeps a per-stream active mask
  ``lam ≥ θ``; each iteration is one dump step over the active streams
  (one fused launch, or the split route's three where a buffer outgrows
  one CTA);
* the main and auxiliary sketch of every stream absorb the same row, so a
  block update stacks them into one batch of 2S sketches;
* θ and the swap energy are one value per stream, so a batch can stack
  sketches of different thresholds (the levels of Seq- and Time-DS-FD,
  ``core/seq_dsfd.py``, run as one batch of S·L sketches); a scalar is
  the same for every stream.

``update`` functions do not modify the state they are given: a block
update copies the state once (into the stacked 2S batch) and then updates
that copy in place.  Timestamps are int32 with ``_NEG = -(2**30)`` for
empty slots, as in the reference.  ``bypass=True`` takes Seq-DS-FD's
heavy-row shortcut (Algorithm 6 lines 4-6), and ``dsfd_score`` gives the
residual anomaly scores of rows against the window's sketch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.fd import fd_absorb, fd_compress, fd_init, fd_rotate, \
    fd_shrink
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.fused_tick.ops import fused_krylov_step, gram_power
from repro_torch.tree import take, tree_map

_NEG = -(2 ** 30)
MODES = ("exact", "fast", "krylov")


@dataclasses.dataclass(frozen=True)
class DSFDConfig:
    """Static configuration of one DS-FD sketch pair (per stream).

    d:           row dimension.
    ell:         sketch rows ℓ = min(⌈1/ε⌉, d).
    window:      sliding window length N (timestamps).
    cap:         snapshot ring capacity (Theorem 4.1: 2(1+4/β)/ε).
    mode:        'exact' | 'fast' | 'krylov'.
    power_iters: power-iteration steps for mode='krylov'.
    use_kernel:  the counterpart of the reference's ``use_pallas``: the
                 krylov dump step of the fused kernels, whose norm floors
                 are on Σw²; False takes the reference's inline step,
                 whose floors are on ‖w‖.  Both run through
                 ``kernels/fused_tick``, so a CUDA tensor launches the
                 hand-written kernels either way and a CPU tensor runs
                 their plain versions.
    """

    d: int
    ell: int
    window: int
    cap: int
    mode: str = "fast"
    power_iters: int = 24
    use_kernel: bool = True

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        # a dump writes up to m rows into distinct ring slots at once
        if self.cap < self.m:
            raise ValueError(f"snapshot ring cap={self.cap} < m={self.m}")

    @property
    def m(self) -> int:  # buffer rows
        return 2 * self.ell


def make_config(d: int, eps: float, window: int, *, mode: str = "fast",
                beta: float = 4.0, use_kernel: bool = True) -> DSFDConfig:
    ell = int(min(max(round(1.0 / eps), 1), d))
    cap = int(2 * (1.0 + 4.0 / beta) / eps) + 4
    return DSFDConfig(d=d, ell=ell, window=int(window), cap=cap, mode=mode,
                      use_kernel=use_kernel)


class SketchState(NamedTuple):
    """FD sketches + snapshot rings (the paper's (Ĉ, S) pair), per stream."""

    buf: torch.Tensor         # (S, m, d) residual rows
    nbuf: torch.Tensor        # (S,) int32 occupied rows
    sig1: torch.Tensor        # (S,) f32 upper bound on σ₁²(buf)
    energy: torch.Tensor      # (S,) f32 Σ‖a‖² absorbed since init
    start_t: torch.Tensor     # (S,) int32 first timestamp seen
    last_t: torch.Tensor      # (S,) int32 dump time of the newest snapshot
    cov_start: torch.Tensor   # (S,) int32 coverage start
    snap_v: torch.Tensor      # (S, cap, d) snapshot vectors σ·v
    snap_s: torch.Tensor      # (S, cap) coverage-start timestamps
    snap_t: torch.Tensor      # (S, cap) dump timestamps
    snap_valid: torch.Tensor  # (S, cap) bool
    snap_next: torch.Tensor   # (S,) int32 ring write cursor


class DSFDState(NamedTuple):
    main: SketchState
    aux: SketchState


def _sketch_init(cfg: DSFDConfig, t0: torch.Tensor) -> SketchState:
    """Fresh sketches starting at the (S,) int32 timestamps ``t0``."""
    S, dev = t0.shape[0], t0.device
    i32 = dict(dtype=torch.int32, device=dev)
    return SketchState(
        buf=torch.zeros((S, cfg.m, cfg.d), device=dev),
        nbuf=torch.zeros((S,), **i32),
        sig1=torch.zeros((S,), device=dev),
        energy=torch.zeros((S,), device=dev),
        start_t=t0.clone(),
        last_t=t0 - 1,
        cov_start=t0.clone(),
        snap_v=torch.zeros((S, cfg.cap, cfg.d), device=dev),
        snap_s=torch.full((S, cfg.cap), _NEG, **i32),
        snap_t=torch.full((S, cfg.cap), _NEG, **i32),
        snap_valid=torch.zeros((S, cfg.cap), dtype=torch.bool, device=dev),
        snap_next=torch.zeros((S,), **i32),
    )


def dsfd_init(cfg: DSFDConfig, t0: int = 1, streams: int = 1, *,
              device="cuda") -> DSFDState:
    t = torch.full((int(streams),), int(t0), dtype=torch.int32,
                   device=resolve_device(device))
    return DSFDState(main=_sketch_init(cfg, t), aux=_sketch_init(cfg, t))


def _times(t, S: int, device) -> torch.Tensor:
    """A scalar or (S,) timestamp as an (S,) int32 tensor."""
    t = torch.as_tensor(t, dtype=torch.int32, device=device)
    return t.expand(S).contiguous() if t.dim() == 0 else t


def host_indices(mask: torch.Tensor) -> np.ndarray:
    """Indices where a small bool tensor holds, read to the host.  On the
    card every call is one device→host sync; ``host_indices.count`` counts
    them so a run can report syncs per tick."""
    host_indices.count += 1
    return np.flatnonzero(mask.cpu().numpy())


host_indices.count = 0


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(idx).to(device)


# ---------------------------------------------------------------------------
# Snapshot rings
# ---------------------------------------------------------------------------


def _expire(sk: SketchState, now: torch.Tensor, window: int) -> SketchState:
    """Drop snapshots with t + N ≤ now (Algorithm 2 lines 6-7)."""
    dead = sk.snap_valid & (sk.snap_t + window <= now[:, None])
    t_dead = torch.where(dead, sk.snap_t, _NEG).amax(dim=1)
    cov = torch.maximum(sk.cov_start,
                        torch.where(dead.any(dim=1), t_dead + 1, _NEG))
    return sk._replace(snap_valid=sk.snap_valid & ~dead, cov_start=cov)


def _ring_append(sk: SketchState, idx: torch.Tensor, rows: torch.Tensor,
                 count: torch.Tensor, first_s: torch.Tensor,
                 now: torch.Tensor) -> None:
    """Append ``rows[i, :count[i]]`` to the ring of sketch ``idx[i]``, in
    place: the first row covers from ``first_s``, the others from ``now``.

    The reference appends one row at a time; the k ≤ cap rows of one call
    land in distinct slots, so writing them at once is the same, and the
    coverage start advances past every valid slot they evict."""
    n, k, _ = rows.shape
    cap = sk.snap_v.shape[1]
    j = torch.arange(k, device=rows.device)
    slots = (sk.snap_next[idx].long()[:, None] + j) % cap
    r = idx[:, None].expand(n, k)
    w = j[None, :] < count[:, None]
    old_valid = sk.snap_valid[r, slots]
    old_t = sk.snap_t[r, slots]
    evicted = torch.where(w & old_valid, old_t + 1, _NEG).amax(dim=1)
    sk.cov_start[idx] = torch.maximum(sk.cov_start[idx], evicted)
    sk.snap_v[r, slots] = torch.where(w[..., None], rows, sk.snap_v[r, slots])
    s = torch.where(j[None, :] == 0, first_s[:, None], now[:, None])
    sk.snap_s[r, slots] = torch.where(w, s, sk.snap_s[r, slots])
    sk.snap_t[r, slots] = torch.where(w, now[:, None], old_t)
    sk.snap_valid[r, slots] = old_valid | w
    sk.snap_next[idx] = sk.snap_next[idx] + count
    sk.last_t[idx] = torch.where(count > 0, now, sk.last_t[idx])


def _dump_sorted_rows(sk: SketchState, idx: torch.Tensor, rows: torch.Tensor,
                      nrows: torch.Tensor, now: torch.Tensor,
                      theta: torch.Tensor) -> None:
    """Given SVD-sorted rows of sketches ``idx``, dump every row with
    ‖row‖² ≥ θ (``theta`` (n,), one per sketch) into the ring (Algorithm 2
    lines 9-11), then compact the remaining rows to the top of the
    buffer, in place."""
    m = rows.shape[1]
    ndump = (torch.sum(rows * rows, dim=2) >= theta[:, None]).sum(dim=1) \
        .to(torch.int32)                                    # sorted ⇒ prefix
    _ring_append(sk, idx, rows, ndump, sk.last_t[idx] + 1, now)
    ar = torch.arange(m, device=rows.device)
    src = (ar[None, :] + ndump[:, None]) % m                # roll by −ndump
    kept = torch.gather(rows, 1, src[..., None].expand_as(rows))
    nkeep = torch.clamp(nrows - ndump, min=0)
    kept = torch.where((ar[None, :] < nkeep[:, None])[..., None], kept, 0.0)
    sk.buf[idx] = kept
    sk.nbuf[idx] = nkeep.to(torch.int32)
    sk.sig1[idx] = torch.sum(kept[:, 0] * kept[:, 0], dim=1)


# ---------------------------------------------------------------------------
# Krylov (power-iteration) dump path — probabilistic Fast-DS-FD
# ---------------------------------------------------------------------------


def _krylov_dumps(cfg: DSFDConfig, sk: SketchState, idx: torch.Tensor,
                  now: torch.Tensor, theta: torch.Tensor) -> None:
    """While σ₁²(buf) ≥ θ: extract v₁ = u₁ᵀD/σ₁, snapshot σ₁·v₁, downdate
    (Algorithm 3 lines 14-22 with power iteration, §3.1), for the sketches
    ``idx`` (``theta`` (n,), one per sketch), in place.

    The loop entry is one ``gram_power`` call and each iteration one
    ``fused_krylov_step`` call over the sketches still active: one launch
    of the fused kernel where a buffer fits one CTA, else the split route's
    launches of ``rank1_downdate``, ``gram`` and ``power_iter``
    (``kernels/fused_tick/ops.py::route``).  ``cfg.use_kernel`` picks only
    the norm floor, for either route.  The loop runs at most m
    iterations, like the reference's ``while_loop`` under vmap: a sketch
    leaves it when ``lam < θ`` and its state stays as it was then."""
    buf = sk.buf[idx]
    floor_norm = not cfg.use_kernel
    lam, u = gram_power(buf, iters=cfg.power_iters, floor_norm=floor_norm)
    first_s = sk.last_t[idx] + 1
    active = lam >= theta
    for it in range(cfg.m):
        a = host_indices(active)
        if a.size == 0:
            break
        a = _index(a, buf.device)
        snap, D2, lam2, u2 = fused_krylov_step(
            buf[a], lam[a], u[a], iters=cfg.power_iters,
            floor_norm=floor_norm)
        s = first_s[a] if it == 0 else now[a]
        _ring_append(sk, idx[a], snap[:, None, :],
                     torch.ones_like(s), s, now[a])
        buf[a], lam[a], u[a] = D2, lam2, u2
        active[a] = lam2 >= theta[a]
    sk.buf[idx] = buf
    sk.sig1[idx] = lam


# ---------------------------------------------------------------------------
# Absorb (main and aux stacked as 2S sketches)
# ---------------------------------------------------------------------------


def _svd_merge(cfg, sk, idx, now, theta) -> None:
    """Buffer full → FD shrink, then the dump check on the sorted rows."""
    rows, _, _ = fd_shrink(sk.buf[idx], cfg.ell)
    nrows = torch.full((idx.numel(),), cfg.ell - 1, dtype=torch.int32,
                       device=rows.device)
    _dump_sorted_rows(sk, idx, rows, nrows, now, theta)


def _rotate_dump(cfg, sk, idx, now, theta) -> None:
    """θ-trigger between merges → lossless rotate + dump (no shrink)."""
    rows, _ = fd_rotate(sk.buf[idx])
    nrows = torch.clamp(sk.nbuf[idx], max=min(cfg.m, cfg.d))
    _dump_sorted_rows(sk, idx, rows, nrows, now, theta)


def _swap(cfg, P: SketchState, S: int, idx: torch.Tensor,
          now: torch.Tensor) -> None:
    """Promote the auxiliary sketches of streams ``idx`` and start fresh
    auxiliaries at ``now`` (restart-every-N, generalised to energy)."""
    fresh = _sketch_init(cfg, now)
    for x, f in zip(P, fresh):
        x[idx] = x[S + idx]
        x[S + idx] = f


def _insert(P: SketchState, rows, light, e) -> SketchState:
    """Write each light sketch's row at its ``nbuf`` (FastFD buffering)."""
    n, m = P.buf.shape[0], P.buf.shape[1]
    ar = torch.arange(n, device=rows.device)
    slot = P.nbuf.long().clamp(max=m - 1)
    P.buf[ar, slot] = torch.where(light[:, None], rows, P.buf[ar, slot])
    return P._replace(
        nbuf=torch.where(light, P.nbuf + 1, P.nbuf),
        sig1=torch.where(light, P.sig1 + e, P.sig1),
        energy=torch.where(light, P.energy + e, P.energy))


def _bypass(P: SketchState, idx: torch.Tensor, rows: torch.Tensor,
            now: torch.Tensor) -> None:
    """Heavy rows (‖a‖² ≥ θ) of the sketches ``idx`` go straight into their
    rings as one snapshot each, covering from ``last_t + 1`` (Algorithm 6
    lines 4-6), in place; the buffers and energies are not touched."""
    _ring_append(P, idx, rows[idx][:, None],
                 torch.ones_like(idx, dtype=torch.int32), P.last_t[idx] + 1,
                 now[idx])


def _update_pair(cfg: DSFDConfig, P: SketchState, S: int, row, now, theta,
                 swap_energy, bypass: bool) -> SketchState:
    """One sliding-window update of every stream, on the stacked pair
    P = [main; aux] (2S sketches); ``row`` (S, d), ``now``, ``theta`` and
    ``swap_energy`` (S,).  A row is heavy with ``bypass`` and ‖a‖² ≥ θ,
    else light if ‖a‖² > 0, else idle (expiry and swap only)."""
    dev = row.device
    now2, theta2 = torch.cat([now, now]), torch.cat([theta, theta])
    P = _expire(P, now2, cfg.window)
    swap = P.energy[S:] >= swap_energy
    e = torch.sum(row * row, dim=1)
    heavy = (e >= theta) if bypass else torch.zeros_like(swap)
    light_s = (e > 0.0) & ~heavy
    light, e2 = torch.cat([light_s, light_s]), torch.cat([e, e])
    rows2 = torch.cat([row, row])

    def swap_and_bypass(sw, hv):
        if sw.size:
            si = _index(sw, dev)
            _swap(cfg, P, S, si, now[si])
        if hv.size:
            hi = _index(np.concatenate([hv, hv + S]), dev)
            _bypass(P, hi, rows2, now2)

    if cfg.mode == "exact":
        flags = host_indices(torch.cat([swap, heavy]))
        swap_and_bypass(flags[flags < S], flags[flags >= S] - S)
        P = _insert(P, rows2, light, e2)
        lit = host_indices(light)
        if lit.size:
            li = _index(lit, dev)
            _rotate_dump(cfg, P, li, now2[li], theta2[li])
            full = host_indices(P.nbuf[li] >= cfg.m)
            if full.size:
                fi = li[_index(full, dev)]
                _svd_merge(cfg, P, fi, now2[fi], theta2[fi])
        return P
    # Decide every branch from the small per-stream fields first, so the
    # row costs one device→host read: the swap, the heavy rows, then which
    # sketches will be full or hot once the row is in.
    nb, s1 = P.nbuf, P.sig1
    nb = torch.cat([torch.where(swap, nb[S:], nb[:S]),
                    torch.where(swap, 0, nb[S:])])
    s1 = torch.cat([torch.where(swap, s1[S:], s1[:S]),
                    torch.where(swap, 0.0, s1[S:])])
    nb = torch.where(light, nb + 1, nb)
    s1 = torch.where(light, s1 + e2, s1)
    full = light & (nb >= cfg.m)
    hot = light & ~full & (s1 >= theta2)
    flags = host_indices(torch.cat([swap, full, hot, heavy]))
    fu = flags[(flags >= S) & (flags < 3 * S)] - S
    ho = flags[(flags >= 3 * S) & (flags < 5 * S)] - 3 * S
    swap_and_bypass(flags[flags < S], flags[flags >= 5 * S] - 5 * S)
    P = _insert(P, rows2, light, e2)
    if fu.size:
        fi = _index(fu, dev)
        _svd_merge(cfg, P, fi, now2[fi], theta2[fi])
    if ho.size:
        hi = _index(ho, dev)
        if cfg.mode == "krylov":
            _krylov_dumps(cfg, P, hi, now2[hi], theta2[hi])
        else:
            _rotate_dump(cfg, P, hi, now2[hi], theta2[hi])
    return P


# ---------------------------------------------------------------------------
# Public update / query (plain DS-FD, Problem 1.1)
# ---------------------------------------------------------------------------


def _thresholds(cfg, theta, swap_energy, S: int, device):
    """θ and the swap energy as (S,) f32 tensors.  A scalar (by default
    εN = N/ℓ, and ℓθ) holds for every stream; an (S,) array gives each
    stream its own."""
    f32 = dict(dtype=torch.float32, device=device)
    theta = torch.as_tensor(cfg.window / cfg.ell if theta is None else theta,
                            **f32)
    swap_energy = (theta * (1.0 * cfg.ell) if swap_energy is None else
                   torch.as_tensor(swap_energy, **f32))
    return theta.expand(S).contiguous(), swap_energy.expand(S).contiguous()


def dsfd_update_block(cfg: DSFDConfig, state: DSFDState, rows, ts,
                      theta=None, swap_energy=None,
                      bypass: bool = False) -> DSFDState:
    """Absorb a block of rows: ``rows`` (S, B, d) at timestamps ``ts``
    ((B,) shared by every stream, or (S, B)).  Equal to B calls of
    ``dsfd_update``.  ``theta`` (a scalar or (S,)) defaults to εN = N/ℓ
    (Problem 1.1) and ``swap_energy`` to ℓθ; ``bypass`` sends rows with
    ‖a‖² ≥ θ straight into both rings (Seq-DS-FD, Algorithm 6)."""
    dev = state.main.buf.device
    rows = torch.as_tensor(rows, dtype=torch.float32).to(dev)
    S, B = rows.shape[0], rows.shape[1]
    ts = torch.as_tensor(ts, dtype=torch.int32).to(dev)
    ts = ts.expand(S, B) if ts.dim() == 1 else ts
    theta, swap_energy = _thresholds(cfg, theta, swap_energy, S, dev)
    P = tree_map(lambda a, b: torch.cat([a, b]), state.main, state.aux)
    for b in range(B):
        P = _update_pair(cfg, P, S, rows[:, b], ts[:, b].contiguous(), theta,
                         swap_energy, bypass)
    return DSFDState(main=take(P, slice(0, S)), aux=take(P, slice(S, 2 * S)))


def dsfd_update(cfg: DSFDConfig, state: DSFDState, row, now, theta=None,
                swap_energy=None, bypass: bool = False) -> DSFDState:
    """One sliding-window update (Algorithm 2 / 3, or 6 with ``bypass``)
    of every stream: ``row`` (S, d) at ``now`` (a scalar or (S,)
    timestamps)."""
    row = torch.as_tensor(row, dtype=torch.float32)
    now = _times(now, row.shape[0], row.device)
    return dsfd_update_block(cfg, state, row[:, None], now[:, None],
                             theta=theta, swap_energy=swap_energy,
                             bypass=bypass)


def dsfd_query_rows(cfg: DSFDConfig, state: DSFDState,
                    now=None) -> torch.Tensor:
    """(S, cap + m, d) stacks of live snapshots + residual rows.

    Invalid slots are zero rows.  Passing ``now`` re-applies expiry for
    queries issued between updates."""
    sk = state.main
    valid = sk.snap_valid
    if now is not None:
        now = _times(now, valid.shape[0], valid.device)
        valid = valid & (sk.snap_t + cfg.window > now[:, None])
    snaps = torch.where(valid[..., None], sk.snap_v, 0.0)
    return torch.cat([snaps, sk.buf], dim=1)


def dsfd_query(cfg: DSFDConfig, state: DSFDState) -> torch.Tensor:
    return fd_compress(dsfd_query_rows(cfg, state), cfg.ell)


def dsfd_score(cfg: DSFDConfig, state: DSFDState, X,
               now=None) -> torch.Tensor:
    """(S, n) residual anomaly scores of the rows of ``X`` ((n, d) for
    every stream, or (S, n, d)) against each stream's window sketch: the
    energy outside the span of its live snapshots ∪ residual,
    ``‖x‖² − ‖x Vᵀ‖²`` clamped at 0 (``sketch/basis.py``).  ``now``
    re-applies expiry first, as in ``dsfd_query_rows``."""
    # imported here: ``sketch/`` builds on this module
    from repro_torch.sketch.basis import residual_scores
    return residual_scores(dsfd_query_rows(cfg, state, now=now), X)


def dsfd_merge(cfg: DSFDConfig, s1: DSFDState, s2: DSFDState,
               now=None) -> DSFDState:
    """Merge two batches of DS-FD sketches stream by stream (FD
    mergeability, Liberty 2013): the live rows of both sides are unioned
    and FD-re-compressed to 2ℓ rows, so

        err(merged) ≤ err(s1) + err(s2) + ‖B₁;B₂‖_F²/ℓ .

    The merged rings restart empty; coverage is the intersection of the
    two sides.  ``now`` re-applies expiry to both sides first."""
    rows = torch.cat([dsfd_query_rows(cfg, s1, now=now),
                      dsfd_query_rows(cfg, s2, now=now)], dim=1)
    S = rows.shape[0]
    fd = fd_absorb(fd_init(cfg.ell, cfg.d, S, device=rows.device), rows,
                   ell=cfg.ell)
    m1, m2 = s1.main, s2.main
    merged = _sketch_init(cfg, torch.minimum(m1.start_t, m2.start_t))
    last_t = torch.maximum(m1.last_t, m2.last_t)
    merged = merged._replace(
        buf=fd.buf,
        nbuf=fd.nbuf,
        # Frobenius mass is a safe σ₁² upper bound for the trigger logic
        sig1=torch.sum(fd.buf * fd.buf, dim=(1, 2)),
        energy=m1.energy + m2.energy,
        last_t=last_t,
        cov_start=torch.maximum(m1.cov_start, m2.cov_start),
    )
    return DSFDState(main=merged, aux=_sketch_init(cfg, last_t + 1))


def dsfd_run_stream(cfg: DSFDConfig, rows, query_every: int = 0, *,
                    device="cuda"):
    """Run whole streams through DS-FD at timestamps 1..n.

    ``rows`` is (n, d) for one stream or (S, n, d).  Returns the final
    state and, if ``query_every`` > 0, an (n, S, cap + m, d) tensor holding
    the B_W rows at every ``query_every``-th step (zeros elsewhere), as
    the reference's scan emits them."""
    dev = resolve_device(device)
    rows = torch.as_tensor(rows, dtype=torch.float32).to(dev)
    if rows.dim() == 2:
        rows = rows[None]
    S, n, _ = rows.shape
    state = dsfd_init(cfg, 1, S, device=dev)
    outs = None
    step = n
    if query_every:
        outs = torch.zeros((n, S, cfg.cap + cfg.m, cfg.d), device=dev)
        step = query_every
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        ts = torch.arange(lo + 1, hi + 1, dtype=torch.int32, device=dev)
        state = dsfd_update_block(cfg, state, rows[:, lo:hi], ts)
        if query_every and hi % query_every == 0:
            outs[hi - 1] = dsfd_query_rows(cfg, state)
    return state, outs
