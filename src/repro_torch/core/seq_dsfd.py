"""Seq-DS-FD (unnormalized rows ‖a‖² ∈ [1, R], Problem 1.2, §4) and
Time-DS-FD (time-based windows, §5), batched over streams.

Counterpart of ``repro/core/seq_dsfd.py``.  A stack of L DS-FD levels
with dump thresholds θⱼ rising by powers of two; rows with ‖a‖² ≥ θⱼ
bypass straight into level j's snapshot rings (Algorithm 6); the query
answers from the lowest level whose rings still span the window
(Algorithm 7).

The reference vmaps one DS-FD update over the levels.  Here the levels
are a second batch axis: a state's tensors are (S, L, …), and an update
runs on the free (S·L, …) view in ONE ``dsfd_update_block`` call whose
per-sketch θ and swap energy repeat the levels' over S.  A row then costs
one device→host read for all levels (the branch decisions of
``core/dsfd.py``), not L.

The reference's layered configs leave ``use_pallas`` at False
(``repro/core/seq_dsfd.py:45,57``), so its krylov levels run the inline
dump step, whose norm floor is on ‖w‖.  The port's layered configs set
``use_kernel=False`` for the same floor; the dump step still runs through
``kernels/fused_tick`` (the hand-written kernels on the card, with
``floor_norm=True``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core.dsfd import DSFDConfig, DSFDState, _times, dsfd_init, \
    dsfd_merge, dsfd_query_rows, dsfd_update_block
from repro_torch.core.fd import fd_compress
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class LayeredConfig:
    """Static configuration of a stack of DS-FD levels (Seq- or
    Time-DS-FD): the per-stream ``base`` and each level's dump threshold
    (ascending) and swap energy."""

    base: DSFDConfig
    thetas: Tuple[float, ...]
    swap_energies: Tuple[float, ...]

    @property
    def levels(self) -> int:
        return len(self.thetas)


def _base(d: int, eps: float, window: int, beta: float,
          mode: str) -> DSFDConfig:
    ell = int(min(max(round(1.0 / eps), 1), d))
    cap = int(2 * (1.0 + 4.0 / beta) / eps) + 4
    return DSFDConfig(d=d, ell=ell, window=int(window), cap=cap, mode=mode,
                      use_kernel=False)


def make_seq_config(d: int, eps: float, window: int, R: float, *,
                    beta: float = 4.0, mode: str = "fast") -> LayeredConfig:
    """Problem 1.2: θⱼ = 2ʲ εN for j = 0..⌈log₂R⌉ (Algorithm 5)."""
    L = max(int(math.ceil(math.log2(max(R, 1.0)))), 0)
    base = _base(d, eps, window, beta, mode)
    thetas = tuple((2.0 ** j) * eps * window for j in range(L + 1))
    swaps = tuple(base.ell * th for th in thetas)  # aux promotes at ℓθ
    return LayeredConfig(base=base, thetas=thetas, swap_energies=swaps)


def make_time_config(d: int, eps: float, window: int, R: float, *,
                     beta: float = 4.0, mode: str = "fast") -> LayeredConfig:
    """Problems 1.3/1.4 (§5): θⱼ = 2ʲ for j = 0..⌈log₂(εNR)⌉."""
    L = max(int(math.ceil(math.log2(max(eps * window * max(R, 1.0), 2.0)))),
            1)
    base = _base(d, eps, window, beta, mode)
    thetas = tuple(2.0 ** j for j in range(L + 1))
    swaps = tuple(base.ell * th for th in thetas)
    return LayeredConfig(base=base, thetas=thetas, swap_energies=swaps)


def _flat(state: DSFDState) -> DSFDState:
    """The (S·L, …) view of an (S, L, …) layered state."""
    return tree_map(lambda x: x.reshape(-1, *x.shape[2:]), state)


def _stacked(state: DSFDState, L: int) -> DSFDState:
    """The (S, L, …) view of an (S·L, …) state."""
    return tree_map(lambda x: x.reshape(-1, L, *x.shape[1:]), state)


def layered_init(cfg: LayeredConfig, t0: int = 1, streams: int = 1, *,
                 device="cuda") -> DSFDState:
    """Fresh stacks of ``cfg.levels`` levels for ``streams`` streams."""
    dev = resolve_device(device)
    return _stacked(dsfd_init(cfg.base, t0, int(streams) * cfg.levels,
                              device=dev), cfg.levels)


def _level_thresholds(cfg: LayeredConfig, S: int, device):
    """θ and the swap energy of every sketch of the (S·L) view."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(cfg.thetas, **f32).repeat(S),
            torch.tensor(cfg.swap_energies, **f32).repeat(S))


def layered_update_block(cfg: LayeredConfig, state: DSFDState, rows,
                         ts) -> DSFDState:
    """Feed a block of rows to every level (Algorithm 6): ``rows``
    (S, B, d) at ``ts`` ((B,) or (S, B)).  Equal to B calls of
    ``layered_update``.  Zero rows (idle time-based ticks) only advance
    expiry and swaps."""
    dev = state.main.buf.device
    rows = torch.as_tensor(rows, dtype=torch.float32).to(dev)
    S, B, d = rows.shape
    L = cfg.levels
    ts = torch.as_tensor(ts, dtype=torch.int32).to(dev)
    ts = ts.expand(S, B) if ts.dim() == 1 else ts
    theta, swap = _level_thresholds(cfg, S, dev)
    flat = dsfd_update_block(
        cfg.base, _flat(state),
        rows[:, None].expand(S, L, B, d).reshape(S * L, B, d),
        ts[:, None].expand(S, L, B).reshape(S * L, B),
        theta=theta, swap_energy=swap, bypass=True)
    return _stacked(flat, L)


def layered_update(cfg: LayeredConfig, state: DSFDState, row,
                   now) -> DSFDState:
    """Feed one row per stream (``row`` (S, d)) at ``now`` (a scalar or
    (S,)) to every level."""
    row = torch.as_tensor(row, dtype=torch.float32)
    now = _times(now, row.shape[0], row.device)
    return layered_update_block(cfg, state, row[:, None], now[:, None])


def layered_covered(cfg: LayeredConfig, state: DSFDState,
                    now) -> torch.Tensor:
    """(S, L) bool: do level j's rings ∪ residual span the window
    [now − N + 1, now]?"""
    now = _times(now, state.main.nbuf.shape[0], state.main.buf.device)
    return state.main.cov_start <= (now - cfg.base.window + 1)[:, None]


def layered_select(cfg: LayeredConfig, state: DSFDState,
                   now) -> torch.Tensor:
    """(S,) index of each stream's lowest covered level, the top level
    where none is (Algorithm 7 line 1)."""
    cov = layered_covered(cfg, state, now)
    idx = torch.arange(cfg.levels, device=cov.device)
    return torch.where(cov, idx, cfg.levels - 1).amin(dim=1)


def layered_query_rows(cfg: LayeredConfig, state: DSFDState,
                       now) -> torch.Tensor:
    """(S, cap + m, d) B_W rows of each stream's selected level."""
    j = layered_select(cfg, state, now)
    ar = torch.arange(j.shape[0], device=j.device)
    level = tree_map(lambda x: x[ar, j], state)
    return dsfd_query_rows(cfg.base, level, now=now)


def layered_query(cfg: LayeredConfig, state: DSFDState, now) -> torch.Tensor:
    return fd_compress(layered_query_rows(cfg, state, now), cfg.base.ell)


def layered_merge(cfg: LayeredConfig, s1: DSFDState, s2: DSFDState,
                  now=None) -> DSFDState:
    """Merge two batches of layered states stream by stream, level by
    level: level j of both runs θⱼ, so the DS-FD merge applies per level,
    and the merged ``cov_start`` (the later of the two) keeps Algorithm 7's
    selection sound."""
    if now is not None:
        now = torch.as_tensor(now, dtype=torch.int32)
        if now.dim():
            now = now.repeat_interleave(cfg.levels)
    return _stacked(dsfd_merge(cfg.base, _flat(s1), _flat(s2), now=now),
                    cfg.levels)


def layered_run_stream(cfg: LayeredConfig, rows, ts, query_every: int = 0,
                       *, device="cuda"):
    """Run whole streams through the layered sketch at explicit int32
    timestamps ``ts`` (n,) — repeated or skipped timestamps are both
    legal (time-based streams).

    ``rows`` is (n, d) for one stream or (S, n, d).  Returns the final
    state and, if ``query_every`` > 0, an (n, S, cap + m, d) tensor whose
    row i holds the B_W rows after row i where ``ts[i]`` is a multiple of
    ``query_every`` (zeros elsewhere), as the reference's scan emits
    them."""
    dev = resolve_device(device)
    rows = torch.as_tensor(rows, dtype=torch.float32).to(dev)
    if rows.dim() == 2:
        rows = rows[None]
    S, n, _ = rows.shape
    ts = torch.as_tensor(ts, dtype=torch.int32).to(dev)
    state = layered_init(cfg, 1, S, device=dev)
    outs, emit, cuts = None, [], [n]
    if query_every:
        outs = torch.zeros((n, S, cfg.base.cap + cfg.base.m, cfg.base.d),
                           device=dev)
        emit = torch.nonzero(ts % query_every == 0).flatten().tolist()
        cuts = sorted(set(i + 1 for i in emit) | {n})
    lo = 0
    for hi in cuts:
        if hi > lo:
            state = layered_update_block(cfg, state, rows[:, lo:hi],
                                         ts[lo:hi])
        if query_every and hi - 1 in emit:
            outs[hi - 1] = layered_query_rows(cfg, state, ts[hi - 1])
        lo = hi
    return state, outs


def layered_space(state: DSFDState) -> torch.Tensor:
    """(S,) live rows of each stream summed over its levels: snapshots and
    buffer rows of the main and auxiliary sketches."""
    return sum(sk.snap_valid.sum(dim=(1, 2)) + sk.nbuf.sum(dim=1)
               for sk in (state.main, state.aux))

