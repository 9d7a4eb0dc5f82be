"""FrequentDirections (Liberty 2013; Ghashami et al. 2016), batched over streams.

Counterpart of ``repro/core/fd.py``, fixed and adaptive rank.  The sketch is a ``(2ℓ, d)`` row buffer per stream; rows
``[0, nbuf)`` hold data.  Incoming rows fill free slots and a full buffer
is shrunk with one SVD that subtracts ``σ_ℓ²`` from every squared singular
value.  Guarantee (``ε = 1/ℓ``)::

    ‖AᵀA − BᵀB‖₂ ≤ ‖A‖_F² / ℓ        and        BᵀB ⪯ AᵀA .

Every tensor of a state carries the stream axis S first; one sketch is
S = 1.  The reference is pure; here the update functions write into the
buffers of the state they are given (a shrink touches only the full
streams' rows) and return the updated state — clone a state first to keep
the old one.  The SVD is ``torch.linalg.svd``, as the reference's is
``jnp.linalg.svd``; it runs only for the streams whose buffer is full.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device


class FDState(NamedTuple):
    """buf (S, m, d) with m = 2ℓ and rows ≥ nbuf zero; nbuf (S,) int32;
    shed (S,) f32, the cumulative Σ σ_ℓ² discarded by shrinks."""

    buf: torch.Tensor
    nbuf: torch.Tensor
    shed: torch.Tensor


def fd_init(ell: int, d: int, streams: int = 1, *, device="cuda",
            dtype=torch.float32) -> FDState:
    dev = resolve_device(device)
    m = 2 * int(min(ell, d))
    return FDState(
        buf=torch.zeros((streams, m, d), dtype=dtype, device=dev),
        nbuf=torch.zeros((streams,), dtype=torch.int32, device=dev),
        shed=torch.zeros((streams,), dtype=dtype, device=dev),
    )


def _svd_rows(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SVD of each (m, d) buffer: (rows = Σ·Vᵀ padded to (m, d), σ²)."""
    n, m, d = buf.shape
    _, s, vt = torch.linalg.svd(buf, full_matrices=False)
    rows = s[..., None] * vt                       # (n, r, d), sorted desc
    if rows.shape[1] < m:                          # pad when d < m
        pad = m - rows.shape[1]
        rows = torch.cat([rows, rows.new_zeros((n, pad, d))], dim=1)
        s = torch.cat([s, s.new_zeros((n, pad))], dim=1)
    return rows, s * s


def fd_rotate(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lossless re-orthogonalisation: rows become σᵢ·vᵢᵀ sorted by σ."""
    return _svd_rows(buf)


def fd_shrink(buf: torch.Tensor, ell: int):
    """The FD shrink of each buffer: (rows, σ²_after, σ_ℓ² discarded)."""
    rows, s2 = _svd_rows(buf)
    delta = s2[:, ell - 1]
    s2n = torch.clamp(s2 - delta[:, None], min=0.0)
    scale = torch.sqrt(s2n / torch.clamp(s2, min=1e-30))
    return rows * scale[..., None], s2n, delta


def _shrink_full(buf, nbuf, shed, ell: int):
    """Shrink the streams whose buffer is full (nbuf ≥ m), in place."""
    idx = torch.nonzero(nbuf >= buf.shape[1]).flatten()
    if idx.numel():
        rows, _, delta = fd_shrink(buf.index_select(0, idx), ell)
        buf.index_copy_(0, idx, rows)
        nbuf = nbuf.index_fill(0, idx, ell - 1)
        shed = shed.index_add(0, idx, delta)
    return buf, nbuf, shed


def fd_update(state: FDState, row: torch.Tensor, *, ell: int) -> FDState:
    """Absorb one row per stream (``row`` (S, d)); FastFD cadence: shrink
    only when the buffer fills.  Zero rows are inserted like any other."""
    buf, nbuf, shed = state
    S, m, _ = buf.shape
    ar = torch.arange(S, device=buf.device)
    buf[ar, nbuf.long().clamp(max=m - 1)] = row.to(buf.dtype)
    buf, nbuf, shed = _shrink_full(buf, nbuf + 1, shed, ell)
    return FDState(buf, nbuf, shed)


def fd_absorb(state: FDState, rows: torch.Tensor, *, ell: int) -> FDState:
    """Absorb a block of rows per stream (``rows`` (S, n, d)), skipping
    all-zero rows as the reference's scan does.

    Equal to n calls of ``fd_update`` on the nonzero rows: each round
    fills every stream's free slots from its own queue of nonzero rows,
    then shrinks the streams that are full, so a stream shrinks after the
    same rows as it would row by row."""
    buf, nbuf, shed = state
    S, n, d = rows.shape
    m = buf.shape[1]
    if n == 0:
        return state
    rows = rows.to(buf.dtype)
    nz = torch.sum(rows * rows, dim=2) > 0.0
    order = torch.argsort((~nz).to(torch.int8), dim=1, stable=True)
    rows = torch.gather(rows, 1, order[..., None].expand(S, n, d))
    count = nz.sum(dim=1)
    pos = torch.zeros_like(count)                   # next row to take
    nb = nbuf.long()
    ar_m = torch.arange(m, device=buf.device)
    while True:
        take = torch.clamp(torch.minimum(count - pos, m - nb), min=0)
        if not bool(torch.any(take > 0)):
            break
        src = (pos[:, None] + ar_m[None, :] - nb[:, None]).clamp(0, n - 1)
        put = (ar_m[None, :] >= nb[:, None]) \
            & (ar_m[None, :] < (nb + take)[:, None])
        new = torch.gather(rows, 1, src[..., None].expand(S, m, d))
        buf = torch.where(put[..., None], new, buf)
        nb, pos = nb + take, pos + take
        buf, nb, shed = _shrink_full(buf, nb, shed, ell)
    return FDState(buf, nb.to(torch.int32), shed)


def fd_compress(mat: torch.Tensor, ell: int) -> torch.Tensor:
    """Compress each (n, d) matrix of ``mat`` (S, n, d) to a (2ℓ, d) FD
    buffer.  Used by queries to merge snapshots with the residual."""
    S, _, d = mat.shape
    st = fd_init(ell, d, S, device=mat.device, dtype=mat.dtype)
    return fd_absorb(st, mat, ell=ell).buf


def fd_query(state: FDState) -> torch.Tensor:
    """The sketch matrices B (S, 2ℓ, d); trailing rows zero."""
    return state.buf


def fd_merge(a: FDState, b: FDState, *, ell: int) -> FDState:
    """Merge two FD sketches stream by stream (absorb b's rows into a)."""
    return fd_absorb(a, b.buf, ell=ell)


# ---------------------------------------------------------------------------
# Adaptive-rank FrequentDirections: the working rank ℓ grows or shrinks
# toward a target relative error (the reference's ``AdaptiveFDState``)
# ---------------------------------------------------------------------------


class AdaptiveFDState(NamedTuple):
    """FD state with an online working rank, per stream.

    buf (S, 2ℓ_max, d) — the capacity of the rank cap, so states of every
    working rank share one shape; only rows [0, nbuf) are live.  nbuf,
    ell (S,) int32.  shed (S,) — Σ σ_ℓ² discarded by shrinks, so
    ‖AᵀA − BᵀB‖₂ ≤ shed at every working rank; energy (S,) — ‖A‖_F² of
    everything absorbed; shed_mark / energy_mark (S,) — both at the last
    rank change, so (shed − shed_mark) / (energy − energy_mark) is the
    error rate of the current rank, the controller's signal (see the
    reference's docstring for why not the cumulative ratio)."""

    buf: torch.Tensor
    nbuf: torch.Tensor
    shed: torch.Tensor
    ell: torch.Tensor
    energy: torch.Tensor
    shed_mark: torch.Tensor
    energy_mark: torch.Tensor


def adaptive_fd_init(ell_max: int, d: int, streams: int = 1, *,
                     ell0=None, device="cuda",
                     dtype=torch.float32) -> AdaptiveFDState:
    dev = resolve_device(device)
    ell_max = int(min(ell_max, d))
    ell0 = ell_max if ell0 is None else int(min(max(ell0, 1), ell_max))
    S = int(streams)

    def zeros():
        return torch.zeros((S,), dtype=dtype, device=dev)

    return AdaptiveFDState(
        buf=torch.zeros((S, 2 * ell_max, d), dtype=dtype, device=dev),
        nbuf=torch.zeros((S,), dtype=torch.int32, device=dev),
        shed=zeros(),
        ell=torch.full((S,), ell0, dtype=torch.int32, device=dev),
        energy=zeros(), shed_mark=zeros(), energy_mark=zeros())


def adaptive_fd_update(state: AdaptiveFDState, row: torch.Tensor, *,
                       target: float, ell_min: int,
                       ell_max: int) -> AdaptiveFDState:
    """Absorb one row per stream (``row`` (S, d)); a stream whose buffer
    reaches 2ℓ shrinks at its own ℓ and re-aims ℓ at ``target``.

    After the shrink, the error rate of the current rank is compared to
    the target: above it ℓ grows by one; below half of it ℓ shrinks by one
    when the σ² rank ℓ−1 would start discarding (read off the same SVD)
    also fits half the target's budget.  Streams given an all-zero row are
    left as they were.  The SVD runs only for the streams that shrink (one
    device→host read a row to find them)."""
    buf, nbuf, shed, ell, energy, smark, emark = state
    S, cap, _ = buf.shape
    ar = torch.arange(S, device=buf.device)
    e = torch.sum(row * row, dim=1).to(energy.dtype)
    live = e > 0.0
    slot = nbuf.long().clamp(max=cap - 1)
    buf = buf.clone()
    buf[ar, slot] = torch.where(live[:, None], row.to(buf.dtype),
                                buf[ar, slot])
    nbuf = torch.where(live, nbuf + 1, nbuf)
    energy = torch.where(live, energy + e, energy)
    idx = torch.nonzero(live & (nbuf >= 2 * ell)).flatten()
    shed, ell, smark, emark = (x.clone() for x in (shed, ell, smark, emark))
    if idx.numel():
        rows, s2 = _svd_rows(buf[idx])
        k = s2.shape[1]
        el = ell[idx].long()
        br = torch.arange(idx.numel(), device=buf.device)
        delta = s2[br, el - 1]
        s2n = torch.clamp(s2 - delta[:, None], min=0.0)
        rows = rows * torch.sqrt(s2n / torch.clamp(s2, min=1e-30))[..., None]
        sh = shed[idx] + delta
        span = torch.clamp(energy[idx] - emark[idx], min=1e-30)
        err = (sh - smark[idx]) / span
        # what rank ℓ−1 would discard next (the reference indexes s2n at
        # ℓ−2, which wraps to the last entry at ℓ = 1; the clip below then
        # voids it)
        probe = s2n[br, (el - 2) % k] + delta
        down = (err < 0.5 * target) & (probe <= 0.5 * target * span)
        new = torch.clamp(el + (err > target).long() - down.long(),
                          ell_min, ell_max)
        changed = new != el
        buf[idx] = rows
        # occupancy: the rows the shrink left alive (a sorted prefix)
        nbuf[idx] = (s2n > 0.0).sum(dim=1).to(torch.int32)
        shed[idx] = sh
        smark[idx] = torch.where(changed, sh, smark[idx])
        emark[idx] = torch.where(changed, energy[idx], emark[idx])
        ell[idx] = new.to(torch.int32)
    return AdaptiveFDState(buf, nbuf, shed, ell, energy, smark, emark)


def adaptive_fd_absorb(state: AdaptiveFDState, rows: torch.Tensor, *,
                       target: float, ell_min: int,
                       ell_max: int) -> AdaptiveFDState:
    """Absorb a block of rows per stream (``rows`` (S, n, d)) one row at a
    time, as the reference's scan does."""
    for i in range(rows.shape[1]):
        state = adaptive_fd_update(state, rows[:, i], target=target,
                                   ell_min=ell_min, ell_max=ell_max)
    return state


def adaptive_fd_merge(a: AdaptiveFDState, b: AdaptiveFDState, *,
                      target: float, ell_min: int,
                      ell_max: int) -> AdaptiveFDState:
    """Merge stream by stream by absorbing b's buffer rows, then restore
    the stream accounting: energy and shed cover both input streams, and
    the current-rank measurement restarts at the merged totals."""
    st = adaptive_fd_absorb(a, b.buf, target=target, ell_min=ell_min,
                            ell_max=ell_max)
    absorbed = torch.sum(b.buf * b.buf, dim=(1, 2)).to(st.energy.dtype)
    energy = st.energy - absorbed + b.energy
    shed = st.shed + b.shed
    return st._replace(energy=energy, shed=shed, shed_mark=shed,
                       energy_mark=energy)
