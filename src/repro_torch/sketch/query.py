"""Query plane for sketch fleets: cohort algebra and a cached merge tree.

Counterpart of ``repro/sketch/query.py``.

``Cohort``
    A frozen, normalized union of half-open ``[lo, hi)`` ranges over a
    fleet's stream axis (``Cohort.of(3, 7, 8)``, ``Cohort.range(0, 64)``,
    ``ALL``), composed with ``|``; equal index sets compare and hash
    equal, so a cohort is a cache key.

``AggTree``
    A segment tree of partial merges over the stream axis ``[0, S)``:
    node ``[lo, hi)`` is the base sketch's ``merge(node[lo, mid),
    node[mid, hi), t)`` with ``mid = (lo + hi) // 2``, pad-free for any
    S.  Internal nodes are cached with the query time they were merged at
    and reused only at that time; a query decomposes its cohort into at
    most ``2⌈log₂S⌉`` canonical nodes per contiguous range and folds them
    left to right, so a warm query costs O(log S) merges and a cold
    whole-fleet query S−1.  ``advance(state, touched)`` dirties only the
    root-to-leaf paths of the streams an ingest touched; an unannounced
    state change resets the cache.  ``state_dict`` / ``load_state_dict``
    carry the materialized nodes through engine checkpoints, in the
    reference's aux names and per-stream shapes.

The reference merges one node at a time through one jitted merge.  Here
every merge is an ``fd_absorb`` with SVDs, so the nodes a query misses are
built bottom-up, all missing nodes of one height in ONE batched ``merge``
call with the same midpoint association; ``merges`` still counts nodes.
Leaves are views of the current fleet state, never cached.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, take, tree_map


def canonical_cover(lo: int, hi: int, qlo: int, qhi: int,
                    out: List[Tuple[int, int]]) -> None:
    """Canonical segment-tree cover of ``[qlo, qhi)`` within the
    midpoint-split node ``[lo, hi)``: at most ``2⌈log₂S⌉`` nodes, appended
    to ``out`` in stream order."""
    if qlo <= lo and hi <= qhi:
        out.append((lo, hi))
        return
    mid = (lo + hi) // 2
    if qlo < mid:
        canonical_cover(lo, mid, qlo, min(qhi, mid), out)
    if qhi > mid:
        canonical_cover(mid, hi, max(qlo, mid), qhi, out)


# ---------------------------------------------------------------------------
# Cohort algebra
# ---------------------------------------------------------------------------


class Cohort:
    """A frozen, normalized union of half-open stream-index ranges.

    Normal form: sorted, disjoint, non-empty, non-adjacent ranges (touching
    ranges coalesce), so two cohorts of the same index set are equal and
    hash equal.  ``ALL`` is the whole fleet; its extent is resolved
    against the fleet size at query time."""

    __slots__ = ("_ranges",)

    def __init__(self, ranges: Iterable[Tuple[int, Optional[int]]] = ()):
        self._ranges = self._normalize(ranges)

    @staticmethod
    def _normalize(ranges) -> Tuple[Tuple[int, Optional[int]], ...]:
        concrete: List[Tuple[int, int]] = []
        unbounded_lo: Optional[int] = None        # smallest lo with hi=None
        for lo, hi in ranges:
            lo = int(lo)
            if lo < 0:
                raise ValueError(f"stream index {lo} is negative")
            if hi is None:
                unbounded_lo = lo if unbounded_lo is None \
                    else min(unbounded_lo, lo)
                continue
            hi = int(hi)
            if hi <= lo:
                raise ValueError(f"empty/inverted range [{lo}, {hi})")
            concrete.append((lo, hi))
        concrete.sort()
        merged: List[List[int]] = []
        for lo, hi in concrete:
            if merged and lo <= merged[-1][1]:    # overlap or adjacency
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        out: List[Tuple[int, Optional[int]]] = [(lo, hi)
                                                for lo, hi in merged]
        if unbounded_lo is not None:
            # an open-ended tail swallows every bounded range at/after it
            while out and out[-1][1] is not None \
                    and out[-1][1] >= unbounded_lo:
                unbounded_lo = min(unbounded_lo, out.pop()[0])
            out.append((unbounded_lo, None))
        return tuple(out)

    @classmethod
    def of(cls, *indices: int) -> "Cohort":
        """Cohort of explicit stream indices: ``Cohort.of(3, 7, 8, 9)``.
        A single iterable argument is also accepted."""
        if len(indices) == 1 and not isinstance(indices[0], (int, np.integer)):
            indices = tuple(indices[0])
        return cls((int(i), int(i) + 1) for i in indices)

    @classmethod
    def range(cls, lo: int, hi: int) -> "Cohort":
        """Contiguous cohort ``[lo, hi)`` over the stream axis."""
        return cls([(lo, hi)])

    def __or__(self, other: "Cohort") -> "Cohort":
        if not isinstance(other, Cohort):
            return NotImplemented
        return Cohort(self._ranges + other._ranges)

    def union(self, other: "Cohort") -> "Cohort":
        return self | other

    @property
    def ranges(self) -> Tuple[Tuple[int, Optional[int]], ...]:
        return self._ranges

    @property
    def is_all(self) -> bool:
        return self._ranges == ((0, None),)

    def resolve(self, streams: int) -> Tuple[Tuple[int, int], ...]:
        """Concrete ``(lo, hi)`` ranges for a fleet of ``streams`` streams
        (bounds-checked; open-ended tails close at ``streams``)."""
        S = int(streams)
        out = []
        for lo, hi in self._ranges:
            hi = S if hi is None else hi
            if hi > S or lo >= S:
                raise ValueError(
                    f"cohort range [{lo}, {hi}) exceeds fleet size {S}")
            out.append((lo, hi))
        if not out:
            raise ValueError("empty cohort")
        return tuple(out)

    def indices(self, streams: Optional[int] = None) -> Tuple[int, ...]:
        if streams is None and any(hi is None for _, hi in self._ranges):
            raise TypeError(
                "indices() of an unresolved ALL/open-ended cohort — pass "
                "the fleet size: cohort.indices(S)")
        ranges = self.resolve(streams) if streams is not None \
            else self._ranges
        return tuple(i for lo, hi in ranges for i in range(lo, hi))

    def __contains__(self, i: int) -> bool:
        return any(lo <= int(i) and (hi is None or int(i) < hi)
                   for lo, hi in self._ranges)

    def __len__(self) -> int:
        if any(hi is None for _, hi in self._ranges):
            raise TypeError("len() of an unresolved ALL-cohort; use "
                            "len(cohort.indices(S)) or resolve(S) first")
        return sum(hi - lo for lo, hi in self._ranges)

    def __bool__(self) -> bool:
        return bool(self._ranges)

    def __eq__(self, other) -> bool:
        return isinstance(other, Cohort) and self._ranges == other._ranges

    def __hash__(self) -> int:
        return hash(self._ranges)

    def __repr__(self) -> str:
        if self.is_all:
            return "Cohort.ALL"
        parts = ", ".join(f"[{lo}, {'S' if hi is None else hi})"
                          for lo, hi in self._ranges)
        return f"Cohort({parts})"


#: The whole-fleet cohort.
ALL = Cohort([(0, None)])


def as_cohort(users) -> Cohort:
    """Coerce ``None`` / a Cohort / an int / an iterable of ints."""
    if users is None:
        return ALL
    if isinstance(users, Cohort):
        return users
    if isinstance(users, (int, np.integer)):
        return Cohort.of(int(users))
    return Cohort.of(users)


# ---------------------------------------------------------------------------
# AggTree — the cached merge tree
# ---------------------------------------------------------------------------


def _cat(states: List[Any]) -> Any:
    return tree_map(lambda *xs: torch.cat(xs), *states)


class AggTree:
    """Segment tree of partial merges over a fleet's stream axis.

    ``base`` is the per-stream sketch (its ``merge`` and ``space`` are
    stream-wise), ``streams`` the fleet size S.  A node's entry is
    ``(time tag, merged S = 1 state, its live rows)``."""

    def __init__(self, base, streams: int):
        if base.meta.get("backend") != "torch":
            raise ValueError(
                f"AggTree needs a torch-backed base sketch, got "
                f"{base.name!r} (backend={base.meta.get('backend')!r})")
        self.base = base
        self.S = int(streams)
        if self.S < 1:
            raise ValueError(f"fleet size {streams} < 1")
        self._nodes: Dict[Tuple[int, int], Tuple[Optional[int], Any, int]] \
            = {}
        # (resolved ranges, t_tag) -> composed result state
        self._results: Dict[Tuple, Any] = {}
        self._leaf_ids: Optional[Tuple[int, ...]] = None
        self._state = None                     # keeps leaf ids un-recycled
        self._last_tkey = None                 # most recent query time tag
        self.merges = 0                        # cumulative node merges
        self.resets = 0                        # wholesale invalidations
        self.evicted_nodes = 0                 # nodes dropped by advance/dirty

    # -- cache lifecycle ----------------------------------------------------

    @staticmethod
    def _ids(state) -> Tuple[int, ...]:
        return tuple(map(id, leaves(state)))

    def _adopt(self, state) -> None:
        self._leaf_ids = self._ids(state)
        self._state = state

    def _sync(self, state) -> None:
        """An unannounced state change invalidates everything (the tree
        cannot know which streams moved)."""
        if self._leaf_ids != self._ids(state):
            if self._leaf_ids is not None:
                self.resets += 1
            self._nodes.clear()
            self._results.clear()
            self._adopt(state)

    def advance(self, state, touched: Optional[Iterable[int]] = None) -> None:
        """Announce a fleet-state transition from ingest: only the
        root-to-leaf paths of the ``touched`` streams are dirtied (``None``:
        all).  Nodes whose time tag is not the latest query's can never be
        served again under a forward clock and are dropped here too."""
        self._results.clear()
        if touched is None:
            self.evicted_nodes += len(self._nodes)
            self._nodes.clear()
        else:
            self.dirty(touched)
            stale = [k for k, v in self._nodes.items()
                     if v[0] != self._last_tkey]
            for k in stale:
                del self._nodes[k]
            self.evicted_nodes += len(stale)
        self._adopt(state)

    def dirty(self, streams: Iterable[int]) -> int:
        """Evict every cached node whose range holds one of ``streams``;
        returns the number evicted."""
        touched = sorted({int(s) for s in streams})
        if not touched:
            return 0
        evict = [k for k in self._nodes
                 if bisect.bisect_left(touched, k[0])
                 < bisect.bisect_left(touched, k[1])]
        for k in evict:
            del self._nodes[k]
        self._results.clear()
        self.evicted_nodes += len(evict)
        return len(evict)

    def reset(self) -> None:
        self._nodes.clear()
        self._results.clear()
        self.resets += 1

    # -- queries ------------------------------------------------------------

    def query(self, state, cohort=ALL, t=None):
        """Merged S = 1 base state over ``cohort`` at query
        time ``t``: the cohort's canonical nodes, built where missing and
        folded left to right."""
        self._sync(state)
        ranges = as_cohort(cohort).resolve(self.S)
        tkey = None if t is None else int(t)
        self._last_tkey = tkey
        rkey = (ranges, tkey)
        hit = self._results.get(rkey)
        if hit is not None:
            return hit
        segs: List[Tuple[int, int]] = []
        for lo, hi in ranges:
            canonical_cover(0, self.S, lo, hi, segs)
        self._build(segs, t, tkey)
        acc = None
        for lo, hi in segs:
            node = self._get(lo, hi)
            acc = node if acc is None else self._merge2(acc, node, t)
        if len(self._results) >= 4096:         # bounded result memo
            self._results.clear()
        self._results[rkey] = acc
        return acc

    def build(self, state, t=None):
        """Materialize every internal node (S−1 merges when cold); returns
        the root, as ``query(state, ALL, t)``."""
        return self.query(state, ALL, t)

    def node(self, state, lo: int, hi: int, t=None):
        """Merged S = 1 base state of the single range ``[lo, hi)`` at
        query time ``t``, cached like any other node."""
        lo, hi = int(lo), int(hi)
        if not (0 <= lo < hi <= self.S):
            raise ValueError(f"node range [{lo}, {hi}) outside fleet "
                             f"[0, {self.S})")
        self._sync(state)
        tkey = None if t is None else int(t)
        self._last_tkey = tkey
        self._build([(lo, hi)], t, tkey)
        return self._get(lo, hi)

    def _get(self, lo: int, hi: int):
        if hi - lo == 1:                       # leaf: a free view, not cached
            return take(self._state, slice(lo, lo + 1))
        return self._nodes[(lo, hi)][1]

    def _build(self, roots: List[Tuple[int, int]], t, tkey) -> None:
        """Build every node under ``roots`` not cached at ``tkey``, bottom
        up: one batched merge per height of the missing sub-forest."""
        heights: Dict[int, List[Tuple[int, int]]] = {}

        def visit(lo: int, hi: int) -> int:
            ent = self._nodes.get((lo, hi))
            if hi - lo == 1 or (ent is not None and ent[0] == tkey):
                return 0
            mid = (lo + hi) // 2
            h = 1 + max(visit(lo, mid), visit(mid, hi))
            heights.setdefault(h, []).append((lo, hi))
            return h

        for lo, hi in roots:
            visit(lo, hi)
        for h in sorted(heights):
            nodes = heights[h]
            mids = [(lo + hi) // 2 for lo, hi in nodes]
            merged = self.base.merge(
                _cat([self._get(lo, m) for (lo, _), m in zip(nodes, mids)]),
                _cat([self._get(m, hi) for (_, hi), m in zip(nodes, mids)]),
                t)
            self.merges += len(nodes)
            rows = self.base.space(merged).tolist()
            for k, node in enumerate(nodes):
                self._nodes[node] = (tkey, take(merged, slice(k, k + 1)),
                                     int(rows[k]))

    def _merge2(self, a, b, t):
        self.merges += 1
        return self.base.merge(a, b, t)

    # -- accounting ---------------------------------------------------------

    @property
    def cached_nodes(self) -> int:
        return len(self._nodes)

    def space(self) -> int:
        """Live rows held by the cached internal nodes."""
        return sum(rows for _, _, rows in self._nodes.values())

    # -- persistence (engine checkpoints) -----------------------------------

    AUX_PREFIX = "aggnode"

    def state_dict(self, t=...):
        """``(meta, arrays)`` of the materialized nodes: ``meta`` (node
        ranges, time tags, leaf count) is JSON; ``arrays`` maps
        ``aggnode_{lo:06d}_{hi:06d}_{j:03d}`` to leaf j of the node's state
        without its stream axis, as the reference writes it.  ``t``: keep
        only the nodes tagged with it (engines pass their clock); default
        all."""
        nodes = sorted(self._nodes)
        if t is not ...:
            tkey = None if t is None else int(t)
            nodes = [k for k in nodes if self._nodes[k][0] == tkey]
        meta = {"streams": self.S,
                "nodes": [[lo, hi, self._nodes[(lo, hi)][0]]
                          for lo, hi in nodes],
                "n_leaves": None}
        arrays: Dict[str, np.ndarray] = {}
        for lo, hi in nodes:
            node = list(leaves(self._nodes[(lo, hi)][1]))
            meta["n_leaves"] = len(node)
            for j, leaf in enumerate(node):
                arrays[f"{self.AUX_PREFIX}_{lo:06d}_{hi:06d}_{j:03d}"] = \
                    leaf[0].cpu().numpy()
        return meta, arrays

    def load_state_dict(self, meta, arrays, state) -> bool:
        """Install checkpointed nodes against the restored fleet ``state``;
        True on success.  Any mismatch (fleet size, leaf count, a missing
        array, a shape or dtype unlike the base sketch's state) leaves the
        cache empty, to be rebuilt at the next query, and never fails the
        restore."""
        self._nodes.clear()
        self._results.clear()
        self._adopt(state)
        if not meta:
            return False
        template = self.base.init()
        t_leaves = list(leaves(template))
        try:
            if int(meta["streams"]) != self.S \
                    or int(meta["n_leaves"]) != len(t_leaves):
                raise ValueError("fleet/template mismatch")
            for lo, hi, ttag in meta["nodes"]:
                lo, hi = int(lo), int(hi)
                if not (0 <= lo < hi <= self.S):
                    raise ValueError(f"node [{lo}, {hi}) out of range")
                got = []
                for j, tl in enumerate(t_leaves):
                    arr = np.asarray(arrays[
                        f"{self.AUX_PREFIX}_{lo:06d}_{hi:06d}_{j:03d}"])
                    want = tl[0].cpu().numpy()
                    if arr.shape != want.shape or arr.dtype != want.dtype:
                        raise ValueError(
                            f"leaf {j} of node [{lo}, {hi}): "
                            f"{arr.shape}/{arr.dtype} != "
                            f"{want.shape}/{want.dtype}")
                    got.append(torch.from_numpy(arr.copy())[None].to(
                        tl.device))
                it = iter(got)
                node = tree_map(lambda _: next(it), template)
                rows = int(self.base.space(node).sum())
                self._nodes[(lo, hi)] = (None if ttag is None else int(ttag),
                                         node, rows)
        except (KeyError, TypeError, ValueError):
            self._nodes.clear()                # rebuild at the next query
            return False
        return True


# ---------------------------------------------------------------------------
# Uncached full reduction — the from-scratch baseline
# ---------------------------------------------------------------------------


def full_reduce_streams(fleet, state, t=None):
    """Reduce a whole fleet to ONE (S = 1) state from scratch: ⌈log₂S⌉
    rounds of batched pairwise merges of the first half with the second,
    an odd tail carried, no cache.  Its answers differ from
    ``query_cohort(ALL)`` only in the merge association (both obey the
    additive FD bound)."""
    base = fleet.meta.get("base")
    if base is None:
        raise ValueError(f"full_reduce_streams needs a fleet from "
                         f"fleet_streams, got {fleet.name!r}")
    n = int(fleet.meta["streams"])
    while n > 1:
        half = n // 2
        merged = base.merge(take(state, slice(0, half)),
                            take(state, slice(half, 2 * half)), t)
        if n % 2:                   # odd stream count: carry the last one
            state = _cat([merged, take(state, slice(2 * half, n))])
            n = half + 1
        else:
            state, n = merged, half
    return state
