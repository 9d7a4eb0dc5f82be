"""FrequentDirections (Liberty 2013; Ghashami et al. 2016), batched over streams.

Counterpart of ``repro/core/fd.py`` (fixed rank; adaptive rank is not
ported yet).  The sketch is a ``(2ℓ, d)`` row buffer per stream; rows
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
