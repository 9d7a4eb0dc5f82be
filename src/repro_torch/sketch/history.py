"""Persistent sketch plane: interval queries over retired window content.

Counterpart of ``repro/sketch/history.py`` on one device.  The sliding
window forgets everything older than ``window`` clock units; this plane
*retires* that content instead: every expired clock unit becomes a leaf
of a time-dyadic index of compressed (2ℓ, d) FD snapshots, so any
historical interval ``[t1, t2)`` is answered by merging the
``O(log(t2 − t1))`` maximal dyadic nodes that cover it, under the FD
mergeability guarantee.

Canonical dyadic schedule (the contract, the reference's)
---------------------------------------------------------
* **Units.** Clock unit ``u ≥ 1`` holds, per stream, the one row stamped
  ``ts == u`` (a stream with nothing queued gives the zero row).  The
  unit's snapshot is ``fd_compress(row, ell)``, a (2ℓ, d) buffer; the
  zero row compresses to the zero buffer.
* **Empty nodes** (no stream has a nonzero row in the span: idle
  ``advance_time`` ticks, unit 0) are identities: a parent with one empty
  child IS the other child (the same tensor), and the time fold skips
  them.
* **Time axis.** Node ``(L, i)`` spans units ``[i·2^L, (i+1)·2^L)``; a
  non-empty parent is ``fd_compress(cat(left[s], right[s]), ell)`` per
  stream s.
* **Stream axis.** A cohort folds a node's per-stream snapshots over the
  canonical segments of ``canonical_cover`` on ``[0, S)``, each reduced
  by splitting at ``mid = (lo + hi) // 2``, the segments folded left in
  cohort order.
* **Answer.** The cover nodes' cohort values folded left in time order,
  empties skipped; an all-empty interval is the zero (2ℓ, d) buffer.

The merges a cold query needs along the stream axis run one batched
``fd_compress`` per height of the midpoint recursion, over every node and
segment of the query, with the recursion's association; the counters
still count one merge per pair.

On the card nothing crosses to the host but a spill, a fault and one read
a tick: the pending units are device tensors, and ``observe_block`` finds
the slab's all-zero columns with one reduction and one read.  Nodes are
immutable, so the cold tier is write-once: the hot tier is an LRU of
(S, 2ℓ, d) device tensors; an evicted node is spilled to
``spill_dir/node_<L>_<idx>/`` through ``train/checkpoint.py`` (the
reference's layout, so either package faults the other's spills) and
faulted back on access.  Spill directories carry ``HISTORY_MARKER``,
which checkpoint retention never prunes.

``SketchFleetEngine(..., history=True)`` owns a plane: every ``step()``
that advances the clock observes the slab and retires the units that
just left the window; engine checkpoints carry the index.

Under a ``FleetTopology`` (``parallel/topology.py``) each process holds
its own stream range's snapshots, and ``query_interval`` is a collective,
the ``PartitionedAggTree``'s protocol: every process publishes, per cover
node, whether it is empty there and the values of its one-owner segments
(maximal canonical nodes inside its range), then fetches the others' and
folds the spine at the same midpoints, which gives the one-process
answer.  Keys carry no version: retired nodes never change, so a fetched
value is kept.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.fd import fd_compress
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.parallel.topology import pack_leaves, unpack_leaves
from repro_torch.sketch.query import ALL, as_cohort, canonical_cover
from repro_torch.train import checkpoint as ckpt

NodeKey = Tuple[int, int]        # (level L, index i): units [i·2^L, (i+1)·2^L)


# ---------------------------------------------------------------------------
# Dyadic time decomposition
# ---------------------------------------------------------------------------


def dyadic_cover(t1: int, t2: int) -> List[NodeKey]:
    """The maximal aligned dyadic nodes covering ``[t1, t2)``, left to
    right (at most ``2⌈log₂(t2 − t1)⌉`` of them)."""
    lo, hi = int(t1), int(t2)
    if not 0 <= lo < hi:
        raise ValueError(f"dyadic_cover needs 0 <= t1 < t2, got [{lo}, {hi})")
    out: List[NodeKey] = []
    t = lo
    while t < hi:
        L = 63 if t == 0 else (t & -t).bit_length() - 1
        while t + (1 << L) > hi:
            L -= 1
        out.append((L, t >> L))
        t += 1 << L
    return out


def interval_merge_budget(t1: int, t2: int) -> int:
    """The bound on a warm query's node merges: ``2⌈log₂(t2 − t1)⌉``."""
    length = int(t2) - int(t1)
    return 2 * math.ceil(math.log2(length)) if length > 1 else 0


def _merge(a: torch.Tensor, b: torch.Tensor, ell: int) -> torch.Tensor:
    """Pairwise merges ``fd_compress(cat(a[k], b[k]), ell)`` of (n, 2ℓ, d)
    stacks."""
    return fd_compress(torch.cat([a, b], dim=1), ell)


# ---------------------------------------------------------------------------
# Tiered node storage: hot LRU over a write-once cold spill
# ---------------------------------------------------------------------------


class _NodeStore:
    """Hot and cold tiers of the immutable (S, 2ℓ, d) node snapshots.

    ``hot`` is an LRU of device tensors; past ``hot_capacity`` nodes the
    least recently used one is spilled (once: re-evicting a spilled node
    costs nothing) and ``get`` faults it back.  Empty nodes are membership
    in ``empty`` and never touch the disk."""

    def __init__(self, hot_capacity: Optional[int], spill_dir: Optional[str],
                 device: torch.device):
        if hot_capacity is not None:
            hot_capacity = int(hot_capacity)
            if hot_capacity < 1:
                raise ValueError(
                    f"history hot capacity must be >= 1, got {hot_capacity}")
            if spill_dir is None:
                raise ValueError(
                    "a bounded history hot tier needs somewhere to spill: "
                    "pass history_dir (evicting without a cold tier would "
                    "silently DROP retired nodes), or leave the hot "
                    "capacity unbounded")
        self.device = device
        self.hot: "OrderedDict[NodeKey, torch.Tensor]" = OrderedDict()
        self.empty: Set[NodeKey] = set()
        self.on_disk: Set[NodeKey] = set()
        self.hot_capacity = hot_capacity
        self.spill_dir = (None if spill_dir is None
                          else os.path.abspath(spill_dir))
        self.spills = 0
        self.faults = 0
        self.evictions = 0
        if self.spill_dir is not None:
            self._mark(self.spill_dir)

    @staticmethod
    def _mark(path: str) -> None:
        """Create ``path`` with the marker checkpoint retention honours."""
        os.makedirs(path, exist_ok=True)
        marker = os.path.join(path, ckpt.HISTORY_MARKER)
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("sketch history spill tier — retention must "
                        "never prune or rename this directory\n")

    def _node_dir(self, key: NodeKey) -> str:
        return os.path.join(self.spill_dir,
                            f"node_{key[0]:02d}_{key[1]:08d}")

    def exists(self, key: NodeKey) -> bool:
        return (key in self.empty or key in self.hot
                or key in self.on_disk)

    def is_empty(self, key: NodeKey) -> bool:
        return key in self.empty

    def put(self, key: NodeKey, arr: Optional[torch.Tensor]) -> None:
        if self.exists(key):
            raise RuntimeError(
                f"history node {key} retired twice — each clock unit "
                "must be retired exactly once")
        if arr is None:
            self.empty.add(key)
            return
        self.hot[key] = arr
        self._evict_to_cap()

    def get(self, key: NodeKey) -> Optional[torch.Tensor]:
        """The node's (S, 2ℓ, d) snapshot (None if empty), faulted back
        from the cold tier if need be."""
        if key in self.empty:
            return None
        arr = self.hot.get(key)
        if arr is not None:
            self.hot.move_to_end(key)
            return arr
        if key not in self.on_disk:
            raise KeyError(f"history node {key} was never retired")
        tree, _ = ckpt.restore(self._node_dir(key), {"per_stream": 0},
                               device=self.device)
        arr = tree["per_stream"]
        self.faults += 1
        self.hot[key] = arr
        self._evict_to_cap()
        return arr

    def _evict_to_cap(self) -> None:
        if self.hot_capacity is None:
            return
        while len(self.hot) > self.hot_capacity:
            key, arr = self.hot.popitem(last=False)
            self.evictions += 1
            if key not in self.on_disk:
                node_dir = self._node_dir(key)
                self._mark(node_dir)
                ckpt.save(node_dir, 0, {"per_stream": arr}, keep=1)
                self.on_disk.add(key)
                self.spills += 1

    def hot_bytes(self) -> int:
        """Bytes the hot tier holds (a tensor two nodes share, once)."""
        seen = {a.data_ptr(): a.numel() * a.element_size()
                for a in self.hot.values()}
        return sum(seen.values())

    def spill_bytes(self) -> int:
        """On-disk footprint of the cold tier (0 without a spill dir)."""
        if self.spill_dir is None or not os.path.isdir(self.spill_dir):
            return 0
        total = 0
        for root, _, files in os.walk(self.spill_dir):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
        return total


# ---------------------------------------------------------------------------
# HistoryPlane — the persistent sketch plane
# ---------------------------------------------------------------------------


class HistoryPlane:
    """The time-dyadic index of retired window content (module docstring).

    With a ``topology`` this process holds the streams ``[topology.lo,
    topology.hi)`` (slabs of that many rows) and ``query_interval`` is a
    collective over ``topology.transport``.

    Counters: ``retired_units`` (level-0 insertions, once per expired
    clock unit), ``retire_events``, ``consolidations`` (parent merges,
    amortized one per unit), ``time_merges`` / ``stream_merges`` (query
    folds along each axis), the store's ``spills`` / ``faults`` /
    ``evictions``, and the collective's ``remote_fetches`` /
    ``published``."""

    def __init__(self, *, streams: int, d: int, ell: int, window: int,
                 hot_capacity: Optional[int] = None,
                 spill_dir: Optional[str] = None, topology=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.S = int(streams)
        self.topology = topology
        if topology is not None:
            if topology.S != self.S:
                raise ValueError(
                    f"topology covers {topology.S} streams but the history "
                    f"plane was asked for {self.S}")
            self.lo, self.hi = topology.lo, topology.hi
        else:
            self.lo, self.hi = 0, self.S
        self.S_local = self.hi - self.lo
        self.d, self.ell, self.window = int(d), int(ell), int(window)
        self.m = 2 * self.ell
        self.store = _NodeStore(hot_capacity, spill_dir, self.device)
        self._pending: Dict[int, torch.Tensor] = {}  # unit ts -> (S, d)
        self.retired_through = 0          # every unit <= this is retired
        self._max_unit = 0
        self.retired_units = 0
        self.retire_events = 0
        self.consolidations = 0
        self.time_merges = 0
        self.stream_merges = 0
        self.remote_fetches = 0
        self.published = 0
        self._published: Set[str] = set()
        # (key, lo, hi) -> the (2ℓ, d) value of a canonical stream segment
        # of one node; nodes are immutable, so entries never go stale
        self._reduced: Dict[Tuple[NodeKey, int, int], torch.Tensor] = {}
        # fetched remote segments and emptiness flags, kept for good
        self._remote: Dict[str, Any] = {}
        # unit 0 never carries a row (timestamps start at 1), but the index
        # is built over [0, ·): seed it empty so every carry chain is
        # anchored at the origin
        self.store.put((0, 0), None)

    # -- ingest side: observe live slabs, retire expired units --------------

    def observe_block(self, slab, first_ts: int) -> None:
        """Record one tick's slab (S, block, d), column j stamped
        ``first_ts + j``, for compression once the window expires it.
        All-zero columns are recorded by absence: they retire as empty
        nodes."""
        slab = torch.as_tensor(slab, dtype=torch.float32).to(self.device)
        if slab.dim() != 3 or slab.shape[0] != self.S_local \
                or slab.shape[2] != self.d:
            raise ValueError(
                f"slab shape {tuple(slab.shape)} does not match the "
                f"plane's (S_local={self.S_local}, ·, d={self.d})")
        if int(first_ts) <= self.retired_through:
            raise ValueError(
                f"unit {int(first_ts)} was already retired (retired_through"
                f"={self.retired_through}) — observe_block must run before "
                "the tick's retirement")
        live = slab.ne(0).any(dim=2).any(dim=0).cpu()   # the tick's one read
        cols = torch.nonzero(live).flatten().tolist()
        if cols:
            copy = slab.clone()
            for j in cols:
                self._pending[int(first_ts) + j] = copy[:, j]

    def retire_through(self, t: int) -> int:
        """Retire every unit ``<= t`` not yet retired (the engine passes
        ``t = clock − window``); idempotent.  Returns the units retired."""
        t = int(t)
        if t <= self.retired_through:
            return 0
        units = list(range(self.retired_through + 1, t + 1))
        live = [u for u in units if u in self._pending]
        snaps: Dict[int, torch.Tensor] = {}
        if live:                    # one batched compress for every unit
            stacked = torch.stack([self._pending[u] for u in live])
            out = fd_compress(stacked.reshape(-1, 1, self.d), self.ell)
            out = out.reshape(len(live), self.S_local, self.m, self.d)
            for k, u in enumerate(live):
                snaps[u] = out[k].clone()
        for u in units:
            self._pending.pop(u, None)
            self.store.put((0, u), snaps.get(u))
            self.retired_units += 1
            self._max_unit = u
            self._consolidate(u)
        self.retired_through = t
        self.retire_events += 1
        return len(units)

    def _consolidate(self, u: int) -> None:
        """Binary carry: whenever the node just inserted completes a
        sibling pair, build the parent (amortized one merge a unit)."""
        L, i = 0, u
        while i & 1:
            left, right = (L, i - 1), (L, i)
            if self.store.is_empty(left) and self.store.is_empty(right):
                parent = None
            elif self.store.is_empty(left):
                parent = self.store.get(right)      # identity: share the
            elif self.store.is_empty(right):        # non-empty child
                parent = self.store.get(left)
            else:
                parent = _merge(self.store.get(left), self.store.get(right),
                                self.ell)
                self.consolidations += 1
            self.store.put((L + 1, i >> 1), parent)
            L, i = L + 1, i >> 1

    # -- query side: interval folds -----------------------------------------

    def query_interval(self, t1: int, t2: int, cohort=ALL) -> torch.Tensor:
        """The (2ℓ, d) FD sketch of every row the ``cohort``'s streams
        ingested with a timestamp in ``[t1, t2)``, by the canonical
        schedule.  Only retired history is addressable (``t2 − 1 <=
        retired_through``).  A warm query (memoized segment values) costs
        ``len(cover) − 1 ≤ 2⌈log₂(t2 − t1)⌉`` merges; cold nodes fault in
        from the spill tier."""
        t1, t2 = int(t1), int(t2)
        if not 0 <= t1 < t2:
            raise ValueError(
                f"query_interval needs 0 <= t1 < t2, got [{t1}, {t2})")
        if t2 - 1 > self.retired_through:
            raise ValueError(
                f"interval [{t1}, {t2}) reaches into the live window: "
                f"only timestamps <= {self.retired_through} (engine clock "
                f"minus window={self.window}) have retired into history — "
                "query live content with query/query_cohort instead")
        segs: List[Tuple[int, int]] = []
        for lo, hi in as_cohort(cohort).resolve(self.S):
            canonical_cover(0, self.S, lo, hi, segs)
        if self.topology is not None and self.topology.P > 1:
            return self._query_collective(dyadic_cover(t1, t2), segs)
        keys = [k for k in dyadic_cover(t1, t2) if not self.store.is_empty(k)]
        values = self._reduce(keys, segs)
        return self._fold(keys, segs, values.__getitem__)

    def _fold(self, keys: List[NodeKey], segs: List[Tuple[int, int]],
              value) -> torch.Tensor:
        """The answer: each node's segment values ``value((key, lo, hi))``
        folded left in cohort order, the nodes folded left in time."""
        acc = None
        for key in keys:
            v = None
            for lo, hi in segs:
                sv = value((key, lo, hi))
                if v is None:
                    v = sv
                else:
                    v = self._merge2(v, sv)
                    self.stream_merges += 1
            if acc is None:
                acc = v
            else:
                acc = self._merge2(acc, v)
                self.time_merges += 1
        if acc is None:
            return torch.zeros((self.m, self.d), device=self.device)
        return acc

    def _reduce(self, keys: List[NodeKey], segs: List[Tuple[int, int]]
                ) -> Dict[Tuple[NodeKey, int, int], torch.Tensor]:
        """The value of every (node, segment) of a query, from the memo or
        by the midpoint recursion's merges, one batched merge a height;
        the new ones are memoized."""
        out = {(k, lo, hi): self._reduced.get((k, lo, hi))
               for k in keys for lo, hi in segs}
        todo = [key for key, v in out.items() if v is None]
        if not todo:
            return out
        arrs = {k: self.store.get(k) for k, _, _ in todo}
        vals: Dict[Tuple[NodeKey, int, int], torch.Tensor] = {}
        heights: Dict[int, List[Tuple[NodeKey, int, int]]] = {}

        def visit(k: NodeKey, a: int, b: int) -> int:
            if b - a == 1:
                vals[(k, a, b)] = arrs[k][a - self.lo]
                return 0
            mid = (a + b) // 2
            h = 1 + max(visit(k, a, mid), visit(k, mid, b))
            heights.setdefault(h, []).append((k, a, b))
            return h

        # the segments of one query are disjoint: no node is visited twice
        for k, lo, hi in todo:
            visit(k, lo, hi)
        for h in sorted(heights):
            nodes = heights[h]
            mids = [(a + b) // 2 for _, a, b in nodes]
            left = torch.stack([vals[(k, a, m)]
                                for (k, a, _), m in zip(nodes, mids)])
            right = torch.stack([vals[(k, m, b)]
                                 for (k, _, b), m in zip(nodes, mids)])
            merged = _merge(left, right, self.ell)
            self.stream_merges += len(nodes)
            for n, node in enumerate(nodes):
                vals[node] = merged[n]
        for key in todo:
            # a copy: a view would keep the whole node or batch alive
            out[key] = vals[key].clone()
            if len(self._reduced) >= 4096:      # bounded, like the AggTree's
                self._reduced.clear()
            self._reduced[key] = out[key]
        return out

    def _merge2(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _merge(a[None], b[None], self.ell)[0]

    # -- the collective query (a topology of several processes) -------------

    def _query_collective(self, cover: List[NodeKey],
                          segs: List[Tuple[int, int]]) -> torch.Tensor:
        """Publish before fetch: this process's emptiness flag of every
        cover node and the values of its one-owner segments (batched as
        in :meth:`_reduce`), then the one-process fold with the other
        processes' segments fetched and the spine merged at the same
        midpoints.  A node counts as empty only where it is empty on every
        process."""
        topo = self.topology
        owned = [(lo, hi) for seg in segs for lo, hi in topo.atoms(*seg)
                 if topo.owner_of_range(lo, hi) == topo.pid]
        values = self._reduce([k for k in cover
                               if not self.store.is_empty(k)], owned)
        for key in cover:
            self._publish(self._flag_key(key, topo.pid),
                          b"1" if self.store.is_empty(key) else b"0")
            for lo, hi in owned:
                k = self._atom_key(key, lo, hi)
                if k not in self._published:
                    self._publish(k, pack_leaves(
                        [self._owned(values, key, lo, hi).cpu().numpy()]))
                    self.published += 1
        keys = [k for k in cover if not self._global_empty(k)]
        return self._fold(keys, segs,
                          lambda ks: self._gseg(values, *ks))

    def _flag_key(self, key: NodeKey, pid: int) -> str:
        return (f"{self.topology.namespace}/hist/e{key[0]:02d}-"
                f"{key[1]:08d}/p{pid}")

    def _atom_key(self, key: NodeKey, lo: int, hi: int) -> str:
        return (f"{self.topology.namespace}/hist/n{key[0]:02d}-"
                f"{key[1]:08d}/{lo:06d}-{hi:06d}")

    def _publish(self, k: str, data: bytes) -> None:
        if k not in self._published:
            self.topology.transport.publish(k, data)
            self._published.add(k)

    def _owned(self, values, key: NodeKey, lo: int, hi: int) -> torch.Tensor:
        """An owned segment's value; a node empty here but not on every
        process holds only zero buffers here, and the zero buffer is a
        fixed point of the merge."""
        if self.store.is_empty(key):
            return torch.zeros((self.m, self.d), device=self.device)
        return values[(key, lo, hi)]

    def _global_empty(self, key: NodeKey) -> bool:
        """Empty on every process: local emptiness says nothing of the
        other owners' streams, so the flags are a vote (kept for good)."""
        topo = self.topology
        if not self.store.is_empty(key):
            return False
        for p in range(topo.P):
            if p == topo.pid:
                continue
            k = self._flag_key(key, p)
            if k not in self._remote:
                self._remote[k] = topo.transport.fetch(k, topo.timeout_s)
            if self._remote[k] != b"1":
                return False
        return True

    def _gseg(self, values, key: NodeKey, lo: int, hi: int) -> torch.Tensor:
        """A global segment's value: owned ranges from ``values``, the other
        processes' one-owner ranges fetched, spine ranges merged at the
        canonical midpoint."""
        topo = self.topology
        owner = topo.owner_of_range(lo, hi)
        if owner == topo.pid:
            return self._owned(values, key, lo, hi)
        k = self._atom_key(key, lo, hi)
        hit = self._remote.get(k)
        if hit is not None:
            return hit
        if owner is not None:
            tpl = [np.zeros((self.m, self.d), np.float32)]
            arr = unpack_leaves(topo.transport.fetch(k, topo.timeout_s),
                                tpl)[0]
            v = torch.from_numpy(arr).to(self.device)
            self.remote_fetches += 1
        else:
            mid = (lo + hi) // 2
            v = self._merge2(self._gseg(values, key, lo, mid),
                             self._gseg(values, key, mid, hi))
            self.stream_merges += 1
        self._remote[k] = v
        return v

    # -- accounting ---------------------------------------------------------

    @property
    def merges(self) -> int:
        """Query-side node merges (time + stream folds)."""
        return self.time_merges + self.stream_merges

    def space(self) -> Dict[str, int]:
        return {"hot_nodes": len(self.store.hot),
                "empty_nodes": len(self.store.empty),
                "cold_nodes": len(self.store.on_disk),
                "pending_units": len(self._pending),
                "hot_bytes": self.store.hot_bytes(),
                "spill_bytes": self.store.spill_bytes()}

    # -- persistence (rides inside the engine checkpoint) -------------------

    def state_dict(self) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """``(meta, arrays)``: the index as JSON and, as host arrays, the
        hot node snapshots (``hist_LL_IIIIIIII``) and the pending units
        (``hist_pending``, (U, S, d)) — the reference's names.  Cold nodes
        stay in the spill dir, which is part of the saved state (recorded
        by path)."""
        meta = {
            "scope": [self.lo, self.hi],
            "streams": self.S, "d": self.d, "ell": self.ell,
            "window": self.window,
            "retired_through": self.retired_through,
            "max_unit": self._max_unit,
            "retired_units": self.retired_units,
            "hot_capacity": self.store.hot_capacity,
            "spill_dir": self.store.spill_dir,
            "empty": sorted([L, i] for L, i in self.store.empty),
            "on_disk": sorted([L, i] for L, i in self.store.on_disk),
            "hot": [[L, i] for L, i in self.store.hot],   # LRU order
            "pending_ts": sorted(self._pending),
        }
        arrays = {f"hist_{L:02d}_{i:08d}": arr.cpu().numpy()
                  for (L, i), arr in self.store.hot.items()}
        if self._pending:
            arrays["hist_pending"] = torch.stack(
                [self._pending[u] for u in sorted(self._pending)]
            ).cpu().numpy()
        return meta, arrays

    @classmethod
    def from_state_dict(cls, meta: Dict[str, Any],
                        aux: Dict[str, np.ndarray], topology=None,
                        device="cuda") -> "HistoryPlane":
        """Rebuild a plane from :meth:`state_dict` output of either
        package, on ``device``.  The stream partition must be the saving
        one: retired snapshots are per-stream arrays, and resharding them
        is refused, as in the reference."""
        scope = ([topology.lo, topology.hi] if topology is not None
                 else [0, int(meta["streams"])])
        if list(meta["scope"]) != scope:
            raise ValueError(
                f"history restore needs the same stream partition: the "
                f"checkpoint holds scope {list(meta['scope'])} but this "
                f"process owns {scope} — restore with the saving "
                "topology (elastic resharding of retired history is not "
                "supported)")
        plane = cls(streams=int(meta["streams"]), d=int(meta["d"]),
                    ell=int(meta["ell"]), window=int(meta["window"]),
                    hot_capacity=meta.get("hot_capacity"),
                    spill_dir=meta.get("spill_dir"), topology=topology,
                    device=device)
        store = plane.store
        store.empty = {(int(L), int(i)) for L, i in meta["empty"]}
        store.on_disk = {(int(L), int(i)) for L, i in meta["on_disk"]}
        if store.on_disk and (store.spill_dir is None
                              or not os.path.isdir(store.spill_dir)):
            raise FileNotFoundError(
                f"the checkpoint's history index references "
                f"{len(store.on_disk)} cold node(s) under spill dir "
                f"{meta.get('spill_dir')!r}, which no longer exists — "
                "the spill directory is part of the persisted state")

        def tensor(arr) -> torch.Tensor:
            return torch.from_numpy(np.array(arr, np.float32)).to(
                plane.device)

        store.hot.clear()
        for L, i in meta["hot"]:               # keeps the LRU order
            store.hot[(int(L), int(i))] = tensor(
                aux[f"hist_{int(L):02d}_{int(i):08d}"])
        plane.retired_through = int(meta["retired_through"])
        plane._max_unit = int(meta["max_unit"])
        plane.retired_units = int(meta["retired_units"])
        pend_ts = [int(u) for u in meta.get("pending_ts", [])]
        if pend_ts:
            rows = tensor(aux["hist_pending"])
            for k, u in enumerate(pend_ts):
                plane._pending[u] = rows[k]
        return plane


# ---------------------------------------------------------------------------
# Protocol wiring
# ---------------------------------------------------------------------------


def install_query_interval(fleet, plane: HistoryPlane):
    """The fleet with a live ``query_interval(state, t1, t2,
    cohort=ALL)`` served by ``plane`` (``state`` is accepted for the
    protocol's sake: retired history lives in the plane) and
    ``meta['hist_box']`` holding the plane."""
    from repro_torch.sketch import capability

    def query_interval(state, t1, t2, cohort=ALL):
        return plane.query_interval(t1, t2, cohort)

    return capability.install_missing(capability.install(
        fleet, "query_interval", query_interval,
        hist_box={"plane": plane}))
