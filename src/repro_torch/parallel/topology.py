"""Fleet topology: a fleet split across processes along the AggTree.

Counterpart of ``repro/parallel/topology.py``.

``partition_streams(S, P)``
    P contiguous ``[lo, hi)`` ranges covering ``[0, S)``, each a canonical
    node of the global ``AggTree`` (the widest range is split at its
    midpoint until there are P, the tree's own ``mid = (lo + hi) // 2``
    descent).  Everything below a process's range is a subtree it answers
    alone; only the O(log S) nodes above the partition, the spine, involve
    another process.

``FleetTopology``
    The process's view: the range it owns (defaults from
    ``torch.distributed``'s world size and rank), ownership lookups for
    routing, and a transport that moves compressed node states between
    processes.

``PartitionedAggTree``
    The distributed query plane.  Each process runs a local
    :class:`~repro_torch.sketch.query.AggTree` over its ``[0, hi − lo)``,
    the global subtree shifted by ``lo`` (a canonical node's midpoint
    satisfies ``(lo + hi) // 2 − lo == (hi − lo) // 2``).  A query takes
    the cohort's ``canonical_cover``, serves owned nodes locally, fetches
    the other processes' nodes as (2ℓ, d) base-variant states and folds
    the spine in the one-fleet association order, so the answer is the
    one of the fleet nobody split.

Collective contract: ``query`` is a collective; every process issues the
same ``query`` / ``advance`` sequence.  A process publishes the owned
nodes a query needs before it fetches any, so matched collectives cannot
deadlock, and a mismatched schedule ends in a transport timeout, never in
a stale answer (keys carry the advance counter and the query time).

Transports publish and fetch immutable bytes by key: ``StoreTransport``
rides the ``torch.distributed`` store of ``launch/mesh.py`` (the host
bytes cross no device collective, so two processes may share a card),
``DirTransport`` a shared directory, ``MemTransport`` an in-process dict
for thread stand-ins.  The bytes are the reference's (:func:`pack_state`),
so either package decodes the other's.
"""

from __future__ import annotations

import bisect
import datetime
import io
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import convert
from repro_torch.launch.mesh import default_store
from repro_torch.sketch.query import ALL, AggTree, as_cohort, \
    canonical_cover
from repro_torch.tree import leaves, tree_map

__all__ = ["DirTransport", "FleetTopology", "MemTransport",
           "OwnershipError", "PartitionedAggTree", "StoreTransport",
           "pack_leaves", "pack_state", "partition_streams",
           "unpack_leaves", "unpack_state"]


class OwnershipError(ValueError):
    """A stream id was routed to a process that does not own it."""


# ---------------------------------------------------------------------------
# AggTree-aligned partitioning
# ---------------------------------------------------------------------------


def partition_streams(streams: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """Split ``[0, streams)`` into ``parts`` contiguous ranges, each a
    canonical node of the global AggTree: the widest range (leftmost on
    ties) is split at its midpoint until there are ``parts``.  Powers of
    two split evenly (``partition_streams(8, 2) == ((0, 4), (4, 8))``);
    otherwise widths differ by at most a factor of two."""
    S, P = int(streams), int(parts)
    if S < 1:
        raise ValueError(f"fleet size {streams} < 1")
    if not (1 <= P <= S):
        raise ValueError(
            f"cannot split {S} streams across {P} processes "
            f"(need 1 <= processes <= streams)")
    ranges: List[Tuple[int, int]] = [(0, S)]
    while len(ranges) < P:
        i = max(range(len(ranges)),
                key=lambda j: ranges[j][1] - ranges[j][0])
        lo, hi = ranges[i]
        mid = (lo + hi) // 2
        ranges[i:i + 1] = [(lo, mid), (mid, hi)]
    return tuple(ranges)


# ---------------------------------------------------------------------------
# Transports — publish/fetch of immutable bytes
# ---------------------------------------------------------------------------


def _timeout_msg(key: str, timeout: float) -> str:
    return (
        f"timed out after {timeout:.0f}s waiting for fleet node {key!r}. "
        "PartitionedAggTree queries are collectives: every process must "
        "issue the same query/advance sequence in the same order (and be "
        "alive).  A missing publisher usually means one process skipped a "
        "query, stepped its engine a different number of times, or died.")


class MemTransport:
    """In-process transport for threads standing in for processes (share
    one instance).  ``publish`` is first-write-wins: published values are
    the same on every process, so a duplicate is a no-op."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._cv = threading.Condition()

    def publish(self, key: str, data: bytes) -> None:
        with self._cv:
            self._data.setdefault(key, bytes(data))
            self._cv.notify_all()

    def fetch(self, key: str, timeout: float) -> bytes:
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._data,
                                     timeout=timeout):
                raise TimeoutError(_timeout_msg(key, timeout))
            return self._data[key]


class DirTransport:
    """Shared-directory transport: one file a key under ``root``, written
    to a temporary name and renamed, so a reader never sees part of one."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__"))

    def publish(self, key: str, data: bytes) -> None:
        path = self._path(key)
        if os.path.exists(path):
            return
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def fetch(self, key: str, timeout: float) -> bytes:
        path = self._path(key)
        deadline = time.monotonic() + timeout
        while True:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(_timeout_msg(key, timeout)) from None
                time.sleep(0.01)


class StoreTransport:
    """Transport over a ``torch.distributed`` store (the counterpart of the
    reference's ``CoordTransport``): ``publish`` is first-write-wins through
    ``compare_set(key, "", data)``, ``fetch`` waits for the key, then gets
    it.  The default store is the one ``launch/mesh.py::init_distributed``
    built; a multi-process ``FleetTopology`` uses it unless given another
    transport."""

    PREFIX = "repro-fleet"       # the store's other users keep other keys

    def __init__(self, store=None):
        self._store = default_store() if store is None else store
        self._seen: set = set()

    def _key(self, key: str) -> str:
        return f"{self.PREFIX}/{key}"

    def publish(self, key: str, data: bytes) -> None:
        if key in self._seen:
            return
        self._store.compare_set(self._key(key), "", bytes(data))
        self._seen.add(key)

    def fetch(self, key: str, timeout: float) -> bytes:
        k = self._key(key)
        try:
            self._store.wait([k], datetime.timedelta(seconds=timeout))
        except RuntimeError as e:           # DistStoreError: the wait timed out
            raise TimeoutError(_timeout_msg(key, timeout)) from e
        return bytes(self._store.get(k))


# ---------------------------------------------------------------------------
# Node-state serialization — the bytes that cross processes
# ---------------------------------------------------------------------------


def pack_leaves(arrays: Sequence[np.ndarray]) -> bytes:
    """The reference's wire format: an ``.npz`` of ``leaf_000``, … in leaf
    order."""
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i:03d}": np.asarray(x)
                     for i, x in enumerate(arrays)})
    return buf.getvalue()


def unpack_leaves(data: bytes, template: Sequence[np.ndarray]
                  ) -> List[np.ndarray]:
    """The leaves of :func:`pack_leaves` bytes, checked against
    ``template``'s shapes and dtypes: a remote node unlike the local
    sketch's is configuration skew between processes, not a cache miss."""
    out = []
    with np.load(io.BytesIO(data)) as z:
        for i, tl in enumerate(template):
            arr = z[f"leaf_{i:03d}"]
            if tuple(arr.shape) != tuple(tl.shape) or arr.dtype != tl.dtype:
                raise ValueError(
                    f"remote node leaf {i}: {arr.shape}/{arr.dtype} != "
                    f"local template {tl.shape}/{tl.dtype} — sketch config "
                    "skew between processes (every process must build the "
                    "fleet with identical make_sketch arguments)")
            out.append(arr)
    return out


def pack_state(base, state) -> bytes:
    """The bytes of one (S = 1) node state of the variant ``base``: the
    reference's leaves (its tree order and dtypes, no stream axis), as its
    ``pack_state`` writes them for the same node."""
    tree = convert.fleet_state_to_numpy(base, state)
    return pack_leaves([x[0] for x in leaves(tree)])


def state_template(base):
    """The numpy state of one stream of ``base`` in the reference's dtypes:
    the structure :func:`unpack_state` checks remote nodes against."""
    return convert.fleet_state_to_numpy(base, base.init())


def unpack_state(data: bytes, base, template=None, device=None):
    """The (S = 1) node state of ``base`` from :func:`pack_state` bytes of
    either package, on ``device`` (default the base sketch's).  Shape or
    dtype drift raises."""
    if template is None:
        template = state_template(base)
    got = iter(unpack_leaves(data, [x[0] for x in leaves(template)]))
    tree = tree_map(lambda _: next(got)[None], template)
    return convert.fleet_state_from_numpy(
        base, tree, base.meta["device"] if device is None else device)


# ---------------------------------------------------------------------------
# FleetTopology — the per-process view of the partition
# ---------------------------------------------------------------------------


def process_runtime() -> Tuple[int, int]:
    """(world size, rank) of ``torch.distributed``, (1, 0) without it."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class FleetTopology:
    """Assignment of a fleet's stream axis to processes, aligned to the
    AggTree: process ``p`` owns ``partition_streams(streams, P)[p]``.

    Defaults come from ``torch.distributed`` (world size and rank; one
    process, process 0, when it is not initialized), so after
    ``launch.mesh.init_distributed`` a bare ``FleetTopology(streams)`` on
    every process is a consistent topology whose transport is a
    :class:`StoreTransport` (a :class:`MemTransport` for one process).
    Threads standing in for processes pass ``num_processes``,
    ``process_id`` and one shared ``transport``.

    ``namespace`` keeps the keys of independent fleets on one transport
    apart; ``timeout_s`` bounds every remote fetch."""

    def __init__(self, streams: int, *, num_processes: Optional[int] = None,
                 process_id: Optional[int] = None, transport=None,
                 namespace: str = "fleet", timeout_s: float = 120.0):
        world, rank = process_runtime()
        self.S = int(streams)
        self.P = int(world if num_processes is None else num_processes)
        self.pid = int(rank if process_id is None else process_id)
        if not (0 <= self.pid < self.P):
            raise ValueError(
                f"process_id {self.pid} outside [0, {self.P})")
        self.ranges = partition_streams(self.S, self.P)
        self.lo, self.hi = self.ranges[self.pid]
        self.namespace = str(namespace)
        self.timeout_s = float(timeout_s)
        if transport is None:
            transport = MemTransport() if self.P == 1 else StoreTransport()
        self.transport = transport
        self._ag_seq: Dict[str, int] = {}

    # -- ownership ----------------------------------------------------------

    @property
    def local_size(self) -> int:
        return self.hi - self.lo

    def owner_of(self, stream: int) -> int:
        """The process owning ``stream`` (ValueError outside the fleet)."""
        s = int(stream)
        if not (0 <= s < self.S):
            raise ValueError(f"stream {s} outside fleet [0, {self.S})")
        return bisect.bisect_right([lo for lo, _ in self.ranges], s) - 1

    def owner_of_range(self, lo: int, hi: int) -> Optional[int]:
        """The one process owning all of ``[lo, hi)``, or ``None`` when the
        range crosses an ownership boundary (a spine range)."""
        p = self.owner_of(lo)
        return p if hi <= self.ranges[p][1] else None

    def atoms(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """A canonical range split at ownership boundaries: the maximal
        one-owner canonical nodes under it, in stream order."""
        if self.owner_of_range(lo, hi) is not None:
            return [(lo, hi)]
        mid = (lo + hi) // 2
        return self.atoms(lo, mid) + self.atoms(mid, hi)

    def is_local(self, stream: int) -> bool:
        return self.lo <= int(stream) < self.hi

    def to_local(self, stream: int) -> int:
        """A global stream id in this process's ``[0, local_size)``;
        ``OwnershipError`` naming the owner when it is not ours."""
        s = int(stream)
        if not self.is_local(s):
            owner = self.owner_of(s)
            raise OwnershipError(
                f"stream {s} is owned by process {owner} (range "
                f"{list(self.ranges[owner])}); this is process {self.pid} "
                f"owning [{self.lo}, {self.hi}) — route the request to its "
                "owner")
        return s - self.lo

    # -- transport collectives ----------------------------------------------

    def barrier(self, name: str) -> None:
        """Every process publishes its arrival under ``name`` and waits
        for all the others' (around checkpoint handoffs)."""
        self.transport.publish(
            f"{self.namespace}/barrier/{name}/{self.pid}", b"1")
        for p in range(self.P):
            if p != self.pid:
                self.transport.fetch(f"{self.namespace}/barrier/{name}/{p}",
                                     self.timeout_s)

    def allgather_array(self, name: str, arr: np.ndarray
                        ) -> List[np.ndarray]:
        """Every process's small host array, in process order (the same
        list on every process).  A collective: all processes call it with
        the same ``name`` sequence; a counter a name scopes the keys of
        repeated gathers."""
        seq = self._ag_seq.get(name, 0)
        self._ag_seq[name] = seq + 1
        buf = io.BytesIO()
        np.save(buf, np.asarray(arr))
        self.transport.publish(
            f"{self.namespace}/ag/{name}/{seq}/{self.pid}", buf.getvalue())
        out: List[np.ndarray] = []
        for p in range(self.P):
            data = self.transport.fetch(
                f"{self.namespace}/ag/{name}/{seq}/{p}", self.timeout_s)
            out.append(np.load(io.BytesIO(data), allow_pickle=False))
        return out

    def spec(self) -> Dict[str, Any]:
        """JSON description for checkpoint manifests."""
        return {"streams": self.S, "num_processes": self.P,
                "process_id": self.pid, "range": [self.lo, self.hi],
                "ranges": [[lo, hi] for lo, hi in self.ranges]}

    def __repr__(self) -> str:
        return (f"FleetTopology(S={self.S}, process {self.pid}/{self.P}, "
                f"owns [{self.lo}, {self.hi}))")


# ---------------------------------------------------------------------------
# PartitionedAggTree — the distributed query plane
# ---------------------------------------------------------------------------


class PartitionedAggTree:
    """The query plane of a topology fleet (module docstring).

    ``base`` is the per-stream sketch; ``state`` arguments are this
    process's local fleet state (``topology.local_size`` streams).
    ``query`` takes global cohorts and is a collective; ``advance`` takes
    local touched indices, as :meth:`AggTree.advance`, and bumps the
    version that scopes transport keys.

    Counters: ``remote_fetches`` (other processes' nodes fetched),
    ``spine_merges`` (merges above the partition, the cohort fold
    included) and ``published`` (owned nodes pushed)."""

    def __init__(self, base, topology: FleetTopology):
        self.base = base
        self.topo = topology
        self.S = topology.S
        self.local = AggTree(base, topology.local_size)
        self.version = 0
        self._template = None
        self._leaf_ids: Optional[Tuple[int, ...]] = None
        self._state = None                  # keeps leaf ids un-recycled
        # (lo, hi) -> (time tag, state): fetched remote and spine nodes
        self._nodes: Dict[Tuple[int, int], Tuple[Optional[int], Any]] = {}
        self._results: Dict[Tuple, Any] = {}
        self._published: set = set()
        self.remote_fetches = 0
        self.spine_merges = 0
        self.published = 0
        self.resets = 0

    # -- cache lifecycle ----------------------------------------------------

    def _adopt(self, state) -> None:
        self._leaf_ids = tuple(map(id, leaves(state)))
        self._state = state

    def _bump(self) -> None:
        self.version += 1
        self._nodes.clear()
        self._results.clear()
        self._published.clear()

    def _sync(self, state) -> None:
        """An unannounced state change starts a new version (sound, never
        stale)."""
        if self._leaf_ids is None:
            self._adopt(state)
        elif tuple(map(id, leaves(state))) != self._leaf_ids:
            self.resets += 1
            self._bump()
            self._adopt(state)

    def advance(self, state, touched=None) -> None:
        """Announce a local ingest step (local ``touched`` indices).  Part
        of the collective schedule: every process advances once a fleet
        tick, which keeps the versions in lockstep."""
        self._bump()
        self._adopt(state)
        self.local.advance(state, touched)

    def reset(self) -> None:
        self.resets += 1
        self._bump()
        self.local.reset()

    # -- the collective query -----------------------------------------------

    def query(self, state, cohort=ALL, t=None):
        """Merged S = 1 base state over a global ``cohort`` at ``t``, the
        one-process ``AggTree.query`` over the unsplit fleet.  A
        collective (module docstring)."""
        self._sync(state)
        ranges = as_cohort(cohort).resolve(self.S)
        tkey = None if t is None else int(t)
        rkey = (ranges, tkey)
        hit = self._results.get(rkey)
        if hit is not None:
            return hit
        segs: List[Tuple[int, int]] = []
        for lo, hi in ranges:
            canonical_cover(0, self.S, lo, hi, segs)
        # publish before fetch: push every owned atom this query needs,
        # then resolve the spine, so matched collectives cannot deadlock
        for lo, hi in (a for seg in segs for a in self.topo.atoms(*seg)):
            if self.topo.owner_of_range(lo, hi) == self.topo.pid:
                self._publish(state, lo, hi, t, tkey)
        acc = None
        for lo, hi in segs:
            node = self._node(state, lo, hi, t, tkey)
            acc = node if acc is None else self._merge2(acc, node, t)
        if len(self._results) >= 4096:
            self._results.clear()
        self._results[rkey] = acc
        return acc

    def _local_node(self, state, lo: int, hi: int, t):
        return self.local.node(state, lo - self.topo.lo, hi - self.topo.lo, t)

    def _node(self, state, lo: int, hi: int, t, tkey):
        owner = self.topo.owner_of_range(lo, hi)
        if owner == self.topo.pid:          # an owned subtree
            return self._local_node(state, lo, hi, t)
        ent = self._nodes.get((lo, hi))
        if ent is not None and ent[0] == tkey:
            return ent[1]
        if owner is not None:               # another process's subtree
            if self._template is None:
                self._template = state_template(self.base)
            node = unpack_state(
                self.topo.transport.fetch(self._key(lo, hi, tkey),
                                          self.topo.timeout_s),
                self.base, self._template, next(leaves(state)).device)
            self.remote_fetches += 1
        else:                               # the spine: split at the midpoint
            mid = (lo + hi) // 2
            node = self._merge2(self._node(state, lo, mid, t, tkey),
                                self._node(state, mid, hi, t, tkey), t)
        self._nodes[(lo, hi)] = (tkey, node)
        return node

    def _publish(self, state, lo: int, hi: int, t, tkey) -> None:
        key = self._key(lo, hi, tkey)
        if key in self._published:
            return
        node = self._local_node(state, lo, hi, t)
        self.topo.transport.publish(key, pack_state(self.base, node))
        self._published.add(key)
        self.published += 1

    def _merge2(self, a, b, t):
        self.spine_merges += 1
        return self.base.merge(a, b, t)

    def _key(self, lo: int, hi: int, tkey) -> str:
        return (f"{self.topo.namespace}/v{self.version}/t{tkey}/"
                f"{lo:06d}-{hi:06d}")

    # -- accounting ---------------------------------------------------------

    @property
    def merges(self) -> int:
        """Node merges of this process (local and spine)."""
        return self.local.merges + self.spine_merges

    @property
    def cached_nodes(self) -> int:
        return self.local.cached_nodes + len(self._nodes)

    def space(self) -> int:
        """Live rows of the cached local, remote and spine nodes."""
        return self.local.space() + sum(
            int(self.base.space(s).sum()) for _, s in self._nodes.values())
