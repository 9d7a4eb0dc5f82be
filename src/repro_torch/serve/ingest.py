"""Fleet ingest: bounded admission and double-buffered slab assembly.

This package's own copy of ``repro/serve/ingest.py`` (numpy admission is
unchanged), with the transfer to the card written for CUDA:

``AdmissionQueue``
    The only holder of not-yet-ingested rows: one flat structure-of-arrays
    pool in admission order (= per-user FIFO order).  ``submit`` /
    ``submit_many`` validate at admission and apply bounded backpressure
    (``False`` = deferred); ``take_block`` scatters every user's next rows
    into an (S, block, d) slab with one stable argsort, no per-row Python.

``SyncIngest``
    Packs a fresh host slab at dispatch time; the engine copies it to the
    device.

``AsyncIngest``
    Two host packing buffers alternate.  While the device runs tick k, the
    rows of tick k+1 are packed into the other buffer and copied to the
    device ahead of time.  On a CUDA device the buffers are pinned and
    the copy runs on a side stream (``SlabTransfer``): the compute stream
    waits on the copy's event before the update reads the slab, and a
    buffer is repacked only after its last copy has completed.

Tick/clock contract (what makes async equal to sync): a tick ingests, for
every user, the first ``min(block, pending_u)`` rows of that user's queue
as of the moment the tick's update is dispatched, at timestamps
``t+1 .. t+block``.  Rows submitted after a slab was staged are topped up
into it at the swap point, so both pipelines give the same fleet state for
the same interleaving of ``submit`` and ``step``.

Checkpoints serialize the queue alone (``snapshot`` / ``load``): a
pipeline first unwinds its staged slab back to the queue front
(``flush_to_queue``), so the on-disk format does not depend on the
pipeline.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["AdmissionQueue", "AsyncIngest", "IngestBacklogError",
           "SlabTransfer", "SyncIngest", "make_pipeline"]


class IngestBacklogError(RuntimeError):
    """``run(max_ticks)`` exhausted its tick budget with rows still
    pending; ``remaining`` is the backlog left behind."""

    def __init__(self, message: str, remaining: int):
        super().__init__(message)
        self.remaining = int(remaining)


class AdmissionQueue:
    """Bounded per-user FIFO admission of ``(d,)`` float32 rows.

    ``capacity`` bounds the admitted-but-not-ingested rows across all
    users, queued plus held in a staged slab (``reserved``); ``None`` is
    unbounded.  A full queue makes ``submit`` return ``False``; malformed
    submissions raise ``ValueError``.
    """

    def __init__(self, streams: int, d: int,
                 capacity: Optional[int] = None):
        self.S = int(streams)
        self.d = int(d)
        if capacity is not None and int(capacity) < 1:
            raise ValueError(f"queue capacity {capacity} must be >= 1 "
                             "(or None for unbounded)")
        self.capacity = None if capacity is None else int(capacity)
        # valid rows live at [_start, _len) in admission order
        self._ubuf = np.zeros((64,), np.int32)
        self._rbuf = np.zeros((64, self.d), np.float32)
        self._start = 0
        self._len = 0
        self._counts = np.zeros((self.S,), np.int64)  # pending per user
        self._live: set = set()                       # users with pending rows
        self.reserved = 0     # admitted rows held in a staged slab
        self.seq = 0          # bumped on every admission

    def _ensure(self, extra: int) -> None:
        """Room for ``extra`` appended rows: compact the consumed prefix
        away and double the pool until it fits (amortised O(1))."""
        if self._len + extra <= self._ubuf.shape[0]:
            return
        n = self._len - self._start
        cap = max(self._ubuf.shape[0], 64)
        while cap < n + extra:
            cap *= 2
        ubuf = np.zeros((cap,), np.int32)
        rbuf = np.zeros((cap, self.d), np.float32)
        ubuf[:n] = self._ubuf[self._start:self._len]
        rbuf[:n] = self._rbuf[self._start:self._len]
        self._ubuf, self._rbuf = ubuf, rbuf
        self._start, self._len = 0, n

    def _pending_views(self) -> Tuple[np.ndarray, np.ndarray]:
        return (self._ubuf[self._start:self._len],
                self._rbuf[self._start:self._len])

    def _validate(self, user, row) -> Tuple[int, np.ndarray]:
        if isinstance(user, bool) or not isinstance(user, (int, np.integer)):
            raise ValueError(
                f"user id must be an integer, got {type(user).__name__} "
                f"({user!r})")
        u = int(user)
        if not 0 <= u < self.S:
            raise ValueError(
                f"user id {u} outside the fleet's [0, {self.S}) stream "
                "range")
        arr = np.asarray(row)
        if arr.shape != (self.d,):
            raise ValueError(
                f"user {u}: row has shape {arr.shape}, expected a "
                f"({self.d},) float32 vector")
        if not (np.issubdtype(arr.dtype, np.floating)
                or np.issubdtype(arr.dtype, np.integer)):
            raise ValueError(
                f"user {u}: row dtype {arr.dtype} is not real-numeric — "
                f"expected a ({self.d},) float32 vector")
        return u, np.ascontiguousarray(arr, np.float32)

    def submit(self, user, row) -> bool:
        """Admit one row; ``True`` = accepted, ``False`` = deferred."""
        u, arr = self._validate(user, row)
        if self.capacity is not None \
                and self.backlog + self.reserved >= self.capacity:
            return False
        self._ensure(1)
        self._ubuf[self._len] = u
        self._rbuf[self._len] = arr
        self._len += 1
        self._counts[u] += 1
        self._live.add(u)
        self.seq += 1
        return True

    def submit_many(self, users, rows) -> np.ndarray:
        """Admit an ``(n,) users / (n, d) rows`` batch with one validation
        and one copy; per-user FIFO order is batch order.  Malformed input
        raises with nothing admitted; at capacity the longest fitting
        prefix is admitted.  Returns the (n,) bool acceptance mask."""
        ua = np.asarray(users)
        if ua.ndim != 1 or (ua.size and (
                ua.dtype == np.bool_
                or not np.issubdtype(ua.dtype, np.integer))):
            raise ValueError(
                f"users must be a 1-D integer array, got shape "
                f"{ua.shape} dtype {ua.dtype}")
        ra = np.asarray(rows)
        if ra.shape != (ua.size, self.d):
            raise ValueError(
                f"rows has shape {ra.shape}, expected "
                f"({ua.size}, {self.d}) to match {ua.size} user id(s)")
        if ua.size and not (np.issubdtype(ra.dtype, np.floating)
                            or np.issubdtype(ra.dtype, np.integer)):
            raise ValueError(
                f"rows dtype {ra.dtype} is not real-numeric — expected "
                f"float32 rows")
        if ua.size:
            bad = (ua < 0) | (ua >= self.S)
            if bad.any():
                raise ValueError(
                    f"user id {int(ua[bad][0])} outside the fleet's "
                    f"[0, {self.S}) stream range")
        n = int(ua.size)
        mask = np.zeros((n,), bool)
        if n == 0:
            return mask
        if self.capacity is None:
            k = n
        else:
            free = self.capacity - (self.backlog + self.reserved)
            k = max(0, min(n, free))
        if k == 0:
            return mask
        ua = ua[:k].astype(np.int32, copy=False)
        self._ensure(k)
        self._ubuf[self._len:self._len + k] = ua
        self._rbuf[self._len:self._len + k] = ra[:k]
        self._len += k
        self._counts += np.bincount(ua, minlength=self.S)
        self._live.update(int(u) for u in np.unique(ua))
        self.seq += 1
        mask[:k] = True
        return mask

    def push_front(self, user: int, rows: List[np.ndarray]) -> None:
        """Put rows back at the FRONT of a user's queue in their FIFO order
        (a staged slab unwound for a checkpoint).  Bypasses the capacity
        bound: these rows were admitted once."""
        k = len(rows)
        if not k:
            return
        if self._start < k:
            # no room before the pool's front: reopen some by repacking
            n = self._len - self._start
            cap = max(self._ubuf.shape[0], 64)
            while cap < n + 2 * k:
                cap *= 2
            ubuf = np.zeros((cap,), np.int32)
            rbuf = np.zeros((cap, self.d), np.float32)
            ubuf[k:k + n] = self._ubuf[self._start:self._len]
            rbuf[k:k + n] = self._rbuf[self._start:self._len]
            self._ubuf, self._rbuf = ubuf, rbuf
            self._start, self._len = k, k + n
        self._start -= k
        self._ubuf[self._start:self._start + k] = int(user)
        self._rbuf[self._start:self._start + k] = np.asarray(rows, np.float32)
        self._counts[user] += k
        self._live.add(int(user))
        self.seq += 1

    @property
    def backlog(self) -> int:
        return self._len - self._start

    def live_users(self) -> List[int]:
        """Users with pending rows, in user order."""
        return sorted(self._live)

    @property
    def queues(self) -> List[Deque[np.ndarray]]:
        """A per-user FIFO copy of the pending rows (read-only: changes to
        the deques are not seen by the queue)."""
        qs: List[Deque[np.ndarray]] = [deque() for _ in range(self.S)]
        users, rows = self._pending_views()
        for i in np.argsort(users, kind="stable"):
            qs[int(users[i])].append(rows[i].copy())
        return qs

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """Flat ``(pending_user, pending_rows)`` arrays, users in order and
        each user's rows in FIFO order (the engine checkpoint's format)."""
        users, rows = self._pending_views()
        if users.size == 0:
            return (np.zeros((0,), np.int32),
                    np.zeros((0, self.d), np.float32))
        order = np.argsort(users, kind="stable")
        return (np.ascontiguousarray(users[order], np.int32),
                np.ascontiguousarray(rows[order], np.float32))

    def load(self, users: np.ndarray, rows: np.ndarray) -> None:
        """Append a :meth:`snapshot` pair (checkpoint restore); bypasses
        the capacity bound, as these rows were admitted once."""
        ua = np.asarray(users, np.int32).reshape(-1)
        k = int(ua.size)
        if k:
            self._ensure(k)
            self._ubuf[self._len:self._len + k] = ua
            self._rbuf[self._len:self._len + k] = np.asarray(
                rows, np.float32).reshape(k, self.d)
            self._len += k
            self._counts += np.bincount(ua, minlength=self.S)
            self._live.update(int(u) for u in np.unique(ua))
        self.seq += 1

    def take_block(self, buf: np.ndarray, block: int,
                   base: Optional[np.ndarray] = None
                   ) -> Tuple[List[int], List[int], int]:
        """Scatter, for every user, their first ``min(block - base_u,
        pending_u)`` FIFO rows into ``buf[u, base_u:]`` (rows written are
        assumed zeroed).  Returns ``(touched, counts, nrows)``."""
        if self.backlog == 0:
            return [], [], 0
        if base is None:
            allow = np.full((self.S,), int(block), np.int64)
        else:
            allow = np.maximum(int(block) - np.asarray(base, np.int64), 0)
            # a fully staged slab takes nothing: skip the sort
            if not np.any(np.minimum(allow, self._counts) > 0):
                return [], [], 0
        users, rows = self._pending_views()
        # rank of each pending row within its user's FIFO
        order = np.argsort(users, kind="stable")
        su = users[order]
        starts = np.flatnonzero(np.r_[True, su[1:] != su[:-1]])
        sizes = np.diff(np.r_[starts, su.size])
        rank_sorted = np.arange(su.size) - np.repeat(starts, sizes)
        rank = np.empty((su.size,), np.int64)
        rank[order] = rank_sorted
        sel = rank < allow[users]
        nrows = int(np.count_nonzero(sel))
        if nrows == 0:
            return [], [], 0
        tu, tr = users[sel], rank[sel]
        if base is not None:
            tr = tr + np.asarray(base, np.int64)[tu]
        buf[tu, tr] = rows[sel]
        taken = np.bincount(tu, minlength=self.S)
        self._counts -= taken
        keep = ~sel
        nkeep = int(np.count_nonzero(keep))
        if nkeep:
            self._ubuf[:nkeep] = users[keep]
            self._rbuf[:nkeep] = rows[keep]
        self._start, self._len = 0, nkeep
        touched = np.flatnonzero(taken)
        # only users that lost rows this tick can have run dry
        exhausted = touched[self._counts[touched] == 0]
        self._live.difference_update(int(u) for u in exhausted)
        return ([int(u) for u in touched],
                [int(c) for c in taken[touched]], nrows)


class _DeviceSlab(NamedTuple):
    data: torch.Tensor
    copied: Optional[torch.cuda.Event]


class SlabTransfer:
    """Host→device copies of packed slabs for one device.

    ``buffer(key, shape)`` gives a host packing buffer (pinned on a CUDA
    device) as a numpy view; ``prefetch(key)`` starts its copy to the
    device and returns the slab; ``release(key)`` waits until the last
    copy out of that buffer has completed, so it may be repacked;
    ``to_compute(slab)`` hands the update a device tensor that the current
    (compute) stream may read."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)
        self._host: Dict[int, torch.Tensor] = {}
        self._copies: Dict[int, torch.cuda.Event] = {}

    def buffer(self, key: int, shape) -> np.ndarray:
        t = torch.zeros(shape, dtype=torch.float32, pin_memory=self._cuda)
        self._host[key] = t
        return t.numpy()

    def prefetch(self, key: int) -> _DeviceSlab:
        host = self._host[key]
        if not self._cuda:
            # a private copy: the packing buffer is repacked while the
            # update may still hold the slab
            return _DeviceSlab(host.clone(), None)
        with torch.cuda.stream(self._stream):
            data = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._copies[key] = ev
        return _DeviceSlab(data, ev)

    def release(self, key: int) -> None:
        ev = self._copies.pop(key, None)
        if ev is not None:
            ev.synchronize()

    def to_compute(self, slab) -> torch.Tensor:
        if isinstance(slab, _DeviceSlab):
            if slab.copied is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(slab.copied)
                slab.data.record_stream(cur)
            return slab.data
        return torch.from_numpy(slab).to(self.device)


class SyncIngest:
    """Assemble a fresh host slab at dispatch time (one vectorised
    scatter); the engine copies it to the device."""

    mode = "sync"

    def __init__(self, queue: AdmissionQueue, block: int,
                 transfer: SlabTransfer):
        del transfer                 # the copy happens at dispatch
        self.queue = queue
        self.block = int(block)

    @property
    def staged_rows(self) -> int:
        return 0

    def next_slab(self):
        q = self.queue
        if q.backlog == 0:            # idle tick: no slab, no allocation
            return None, [], [], 0
        slab = np.zeros((q.S, self.block, q.d), np.float32)
        touched, counts, nrows = q.take_block(slab, self.block)
        return slab, touched, counts, nrows

    def after_dispatch(self) -> None:
        pass

    def staged_snapshot(self) -> List[Tuple[int, List[np.ndarray]]]:
        return []

    def flush_to_queue(self) -> None:
        pass


class AsyncIngest:
    """Double-buffered admission pipeline (see the module docstring)."""

    mode = "async"

    def __init__(self, queue: AdmissionQueue, block: int,
                 transfer: SlabTransfer):
        self.queue = queue
        self.block = int(block)
        self.transfer = transfer
        shape = (queue.S, block, queue.d)
        self._bufs = [transfer.buffer(i, shape) for i in range(2)]
        # per buffer, the streams whose rows were written by its last pack
        self._dirty: List[np.ndarray] = [np.zeros((0,), np.int64)] * 2
        self._cur = 0                              # next buffer to pack
        # (buf index, device slab, touched, counts, nrows, queue seq at
        # staging time — an unchanged seq means the staged slab is exact)
        self._staged: Optional[Tuple] = None

    @property
    def staged_rows(self) -> int:
        return 0 if self._staged is None else self._staged[4]

    def _assemble(self, i: int) -> Tuple[List[int], List[int], int]:
        self.transfer.release(i)
        buf = self._bufs[i]
        if self._dirty[i].size:
            buf[self._dirty[i]] = 0.0
        touched, counts, nrows = self.queue.take_block(buf, self.block)
        self._dirty[i] = np.asarray(touched, np.int64)
        return touched, counts, nrows

    def next_slab(self):
        """The slab for THIS tick: the staged one (topped up with rows
        submitted since it was packed) or, cold, one assembled now."""
        if self._staged is None:
            i = self._cur
            touched, counts, nrows = self._assemble(i)
            if nrows == 0:
                return None, [], [], 0
            self._cur ^= 1
            return self.transfer.prefetch(i), touched, counts, nrows
        i, dev, touched, counts, nrows, seq = self._staged
        self._staged = None
        self.queue.reserved -= nrows
        self._cur = i ^ 1
        if self.queue.backlog and self.queue.seq != seq:
            # top-up: a synchronous tick would include rows submitted
            # after staging, up to `block` per user
            self.transfer.release(i)
            cnt = np.zeros((self.queue.S,), np.int64)
            cnt[touched] = counts
            t2, c2, extra = self.queue.take_block(self._bufs[i], self.block,
                                                  base=cnt)
            if extra:
                cnt[t2] += c2
                touched = [int(u) for u in np.flatnonzero(cnt)]
                counts = [int(cnt[u]) for u in touched]
                nrows += extra
                self._dirty[i] = np.asarray(touched, np.int64)
                # the staged copy is stale: copy the topped-up slab again
                dev = self.transfer.prefetch(i)
        return dev, touched, counts, nrows

    def after_dispatch(self) -> None:
        """Stage the next slab while the device runs the current one."""
        if self._staged is not None or self.queue.backlog == 0:
            return
        i = self._cur
        touched, counts, nrows = self._assemble(i)
        self._cur ^= 1
        self._staged = (i, self.transfer.prefetch(i), touched, counts, nrows,
                        self.queue.seq)
        self.queue.reserved += nrows       # staged rows still fill capacity

    def staged_snapshot(self) -> List[Tuple[int, List[np.ndarray]]]:
        """Copies of the staged slab's rows as ``(user, rows)`` pairs in
        user order, each user's rows in FIFO order; empty when nothing is
        staged.  Waits for the copy out of the staged buffer first."""
        if self._staged is None:
            return []
        i, _, touched, counts = self._staged[:4]
        self.transfer.release(i)
        buf = self._bufs[i]
        return [(u, [buf[u, b].copy() for b in range(k)])
                for u, k in zip(touched, counts)]

    def flush_to_queue(self) -> None:
        """Put the staged slab's rows back at the queue's front (FIFO kept)
        and drop the staged copy: checkpoints serialize the queue alone."""
        if self._staged is None:
            return
        rows = self.staged_snapshot()
        i, nrows = self._staged[0], self._staged[4]
        self._staged = None
        self.queue.reserved -= nrows   # the rows count as queued again
        self._cur = i                  # the unwound buffer packs next
        for u, user_rows in rows:
            self.queue.push_front(u, user_rows)


_PIPELINES: Dict[str, type] = {"sync": SyncIngest, "async": AsyncIngest}


def make_pipeline(mode: str, queue: AdmissionQueue, *, block: int,
                  transfer: SlabTransfer):
    """``"async"`` (double-buffered, the engine's default) or ``"sync"``."""
    cls: Optional[Callable] = _PIPELINES.get(mode)
    if cls is None:
        raise ValueError(
            f"unknown ingest mode {mode!r}; available: "
            f"{tuple(sorted(_PIPELINES))}")
    return cls(queue, block, transfer)
