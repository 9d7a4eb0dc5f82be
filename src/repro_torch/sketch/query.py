"""The whole-fleet merge fold.  Subset of ``repro/sketch/query.py``.

The reference's ``AggTree`` answers ``query(ALL)`` from the root of a
segment tree over the stream axis: node ``[lo, hi)`` is
``merge(node[lo, mid), node[mid, hi), t)`` with ``mid = (lo + hi) // 2``,
pad-free for any S (``query.py:431-441``).  :func:`merge_all` computes the
same node with the same association, so its answer matches the
reference's up to floating point.  The merges of all nodes of one height
are batched into one call of the stream-wise ``merge``.  The node cache
and cohorts come in a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.tree import leaves, take, tree_map


def _heights(lo: int, hi: int, out: Dict[int, List[Tuple[int, int]]]) -> int:
    if hi - lo == 1:
        return 0
    mid = (lo + hi) // 2
    h = 1 + max(_heights(lo, mid, out), _heights(mid, hi, out))
    out.setdefault(h, []).append((lo, hi))
    return h


def merge_all(merge: Callable, state, t=None):
    """Merge every stream of ``state`` into one (S = 1) state, folding the
    midpoint tree bottom-up, one batched ``merge`` per tree height."""
    first = next(leaves(state))
    S, dev = int(first.shape[0]), first.device
    levels: Dict[int, List[Tuple[int, int]]] = {}
    _heights(0, S, levels)
    pos = {(i, i + 1): i for i in range(S)}     # node → row of the pool
    pool = state
    for h in sorted(levels):
        nodes = levels[h]
        left = torch.tensor([pos[(lo, (lo + hi) // 2)] for lo, hi in nodes],
                            device=dev)
        right = torch.tensor([pos[((lo + hi) // 2, hi)] for lo, hi in nodes],
                             device=dev)
        merged = merge(take(pool, left), take(pool, right), t)
        base = int(next(leaves(pool)).shape[0])
        for k, node in enumerate(nodes):
            pos[node] = base + k
        pool = tree_map(lambda a, b: torch.cat([a, b]), pool, merged)
    root = pos[(0, S)]
    return take(pool, slice(root, root + 1))

