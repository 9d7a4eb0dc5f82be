"""Fleet serving: S per-user sliding-window sketches on one device.

Counterpart of ``repro/serve/engine.py::SketchFleetEngine`` (admission,
ticks and the user and global queries; topology, history, scoring,
checkpoints and cohort queries come in later slices).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serve.ingest import AdmissionQueue, IngestBacklogError, \
    SlabTransfer, make_pipeline
from repro_torch.sketch.api import fleet_streams, make_sketch, query_all
from repro_torch.tree import take


class SketchFleetEngine:
    """S per-user sketches advanced together, one ``update_block`` a tick.

    ``submit(user, row)`` admits one row through a validating, optionally
    capacity-bounded ``AdmissionQueue`` and returns ``True`` (accepted) or
    ``False`` (deferred: the queue is at ``queue_capacity``).
    ``submit_many(users, rows)`` admits a whole ``(n,) / (n, d)`` batch
    with one validation and one copy::

        users = np.repeat(np.arange(S), 8)          # 8 rows per user
        accepted = eng.submit_many(users, rows)
        eng.run()

    Each ``step()`` takes an ``(S, block, d)`` slab from the ingest
    pipeline — users with nothing queued contribute zero rows, which DS-FD
    treats as idle (expiry and swap advance, nothing is absorbed) — and
    advances every stream with one ``update_block``.  With
    ``ingest="async"`` (the default) the next slab is packed and copied to
    the card while the current tick runs; ``"sync"`` packs at dispatch.
    Both give the same state for the same submit/step interleaving.

    The fleet runs one clock.  A tick in which no user has pending rows
    is clock-neutral (a no-op) unless ``advance_time=True``: polling an
    idle engine must not expire live windows.

    ``query_user(u)`` returns that user's compressed (2ℓ, d) window
    sketch; ``query_global()`` the merge of every user's window, folded
    with the association of the reference's ``AggTree.query(ALL)``.
    """

    def __init__(self, name: str = "dsfd", *, d: int, streams: int,
                 eps: float = 1 / 8, window: int = 1024, block: int = 8,
                 ingest: str = "async", queue_capacity: Optional[int] = None,
                 device="cuda", **hyper):
        self.device = resolve_device(device)
        self.base = make_sketch(name, d=d, eps=eps, window=window,
                                device=self.device, **hyper)
        self.fleet = fleet_streams(self.base, streams)
        self.S, self.d, self.block = int(streams), int(d), int(block)
        self.state = self.fleet.init()
        self.t = 0                                  # fleet clock (ticks)
        self.rows_ingested = 0
        self.queue = AdmissionQueue(self.S, self.d, capacity=queue_capacity)
        self.transfer = SlabTransfer(self.device)
        self.pipe = make_pipeline(ingest, self.queue, block=self.block,
                                  transfer=self.transfer)
        self._zero_slab = None         # lazy zero slab for idle ticks

    # -- admission ---------------------------------------------------------

    def submit(self, user: int, row: np.ndarray) -> bool:
        """Admit one row for ``user``; ``True`` accepted, ``False``
        deferred (drain with ``step``/``run`` and resubmit)."""
        return self.queue.submit(user, row)

    def submit_many(self, users, rows) -> np.ndarray:
        """Batched admission; returns the (n,) bool acceptance mask (at
        ``queue_capacity`` the longest fitting prefix is admitted)."""
        return self.queue.submit_many(users, rows)

    @property
    def backlog(self) -> int:
        """Admitted-but-not-ingested rows: queued + staged."""
        return self.queue.backlog + self.pipe.staged_rows

    # -- main loop ---------------------------------------------------------

    def step(self, *, advance_time: bool = False) -> int:
        """One engine tick; returns the number of rows ingested.

        A tick where NO user has pending rows is clock-neutral (a no-op)
        unless ``advance_time=True``."""
        slab, _, _, nrows = self.pipe.next_slab()
        if nrows == 0 and not advance_time:
            return 0
        if nrows == 0:
            if self._zero_slab is None:
                self._zero_slab = np.zeros((self.S, self.block, self.d),
                                           np.float32)
            slab = self._zero_slab
        rows = self.transfer.to_compute(slab)
        ts = torch.arange(self.t + 1, self.t + self.block + 1,
                          dtype=torch.int32, device=self.device)
        self.state = self.fleet.update_block(self.state, rows, ts)
        self.t += self.block
        self.rows_ingested += nrows
        # pack + copy the NEXT slab while the device runs this one
        self.pipe.after_dispatch()
        return nrows

    def run(self, max_ticks: int = 10_000, *,
            on_budget: str = "raise") -> int:
        """Drain every pending row; returns the ticks consumed.  If
        ``max_ticks`` runs out first, raise :class:`IngestBacklogError`
        (default) or warn with ``on_budget="warn"``."""
        if on_budget not in ("raise", "warn"):
            raise ValueError(
                f"on_budget must be 'raise' or 'warn', got {on_budget!r}")
        ticks = 0
        while self.backlog and ticks < max_ticks:
            self.step()
            ticks += 1
        if self.backlog:
            msg = (f"run() exhausted max_ticks={max_ticks} with "
                   f"{self.backlog} row(s) still pending — the drain did "
                   "NOT complete")
            if on_budget == "raise":
                raise IngestBacklogError(msg, self.backlog)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return ticks

    # -- queries -----------------------------------------------------------

    def query_user(self, user: int) -> np.ndarray:
        """That user's compressed (2ℓ, d) window sketch at the clock."""
        u = int(user)
        if not 0 <= u < self.S:
            raise ValueError(f"user id {u} outside the fleet's "
                             f"[0, {self.S}) stream range")
        one = take(self.state, slice(u, u + 1))
        return self.base.query(one, self.t)[0].cpu().numpy()

    def query_global(self) -> np.ndarray:
        """ONE compressed (2ℓ, d) sketch of every user's window."""
        g = query_all(self.fleet, self.state, self.t)
        return self.base.query(g, self.t)[0].cpu().numpy()
