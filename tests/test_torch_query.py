"""The port's query plane (``repro_torch.sketch.query``: ``Cohort``,
``canonical_cover``, ``AggTree``) held against the reference's
(``repro.sketch.query``) on the CPU at small size.

Cohort algebra and the canonical cover are pure Python in both packages
and must agree exactly.  Cohort answers are compared from the same fleet
state: the reference's, carried into the port through
``repro_torch.convert``, so the two trees merge the same inputs with the
same association and only float32 rounding separates them (the merged
states' compressed Grams within 1e-4 absolute; their integer bookkeeping
exactly).  The merge budget and the cache's invalidation are the
reference tests' (``tests/sketch/test_query.py``).
"""

import math
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.sketch import api as RA
from repro.sketch import query as RQ
from repro_torch import convert
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.sketch import api as PA
from repro_torch.sketch import query as PQ
from repro_torch.sketch.capability import capabilities
from repro_torch.tree import leaves, take, tree_map

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

TOL = 1e-4


def _streams(S, n, d, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S, n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=2, keepdims=True)
    return X


def _fleet(S, n, d, N, seed=3, name="dsfd", **hyper):
    """A port fleet and its state after n rows per stream at 1..n."""
    sk = PA.make_sketch(name, d=d, eps=0.25, window=N, device="cpu", **hyper)
    fleet = PA.fleet_streams(sk, S)
    state = fleet.update_block(fleet.init(), torch.from_numpy(
        _streams(S, n, d, seed)), torch.arange(1, n + 1, dtype=torch.int32))
    return sk, fleet, state


def _random_ranges(rng, S, k):
    out = []
    for _ in range(k):
        lo = int(rng.integers(0, S - 1))
        out.append((lo, int(rng.integers(lo + 1, S + 1))))
    return out


def test_canonical_cover_matches_reference():
    rng = np.random.default_rng(0)
    for S in (1, 2, 5, 6, 8, 37, 1024):
        for lo, hi in _random_ranges(rng, S, 20) if S > 1 else [(0, 1)]:
            a, b = [], []
            PQ.canonical_cover(0, S, lo, hi, a)
            RQ.canonical_cover(0, S, lo, hi, b)
            assert a == b
            assert len(a) <= max(2 * math.ceil(math.log2(S)), 1)


def test_cohort_algebra_matches_reference():
    rng = np.random.default_rng(1)
    for _ in range(50):
        idx = rng.integers(0, 40, int(rng.integers(1, 12))).tolist()
        ranges = [(lo, hi) for lo, hi in _random_ranges(rng, 40, 3)]
        tail = int(rng.integers(0, 40))
        for make in (lambda m: m.Cohort.of(*idx),
                     lambda m: m.Cohort.of(np.asarray(idx)),
                     lambda m: m.Cohort(ranges),
                     lambda m: m.Cohort(ranges) | m.Cohort.of(*idx),
                     lambda m: m.Cohort(ranges + [(tail, None)]),
                     lambda m: m.as_cohort(idx[0]),
                     lambda m: m.as_cohort(None)):
            p, r = make(PQ), make(RQ)
            assert p.ranges == r.ranges and p.is_all == r.is_all
            assert hash(p) == hash(PQ.Cohort(r.ranges)) and p == \
                PQ.Cohort(r.ranges)
            assert p.resolve(40) == r.resolve(40)
            assert p.indices(40) == r.indices(40)
            assert repr(p) == repr(r)
            assert (7 in p) == (7 in r)
    assert PQ.ALL.is_all and PQ.as_cohort(None) is PQ.ALL


@pytest.mark.parametrize("bad", [lambda m: m.Cohort([(3, 3)]),
                                 lambda m: m.Cohort([(-1, 2)]),
                                 lambda m: m.Cohort.range(2, 9).resolve(8),
                                 lambda m: m.Cohort().resolve(8),
                                 lambda m: len(m.ALL),
                                 lambda m: m.ALL.indices()])
def test_cohort_errors_match_reference(bad):
    with pytest.raises((ValueError, TypeError)) as rerr:
        bad(RQ)
    with pytest.raises(rerr.type):
        bad(PQ)


def _ref_fleet_state(name, S, n, d, N, seed, **hyper):
    sk = RA.make_sketch(name, d=d, eps=0.25, window=N, **hyper)
    fleet = RA.vmap_streams(sk, S)
    state = fleet.update_block(fleet.init(), jnp.asarray(
        _streams(S, n, d, seed)), jnp.arange(1, n + 1, dtype=jnp.int32))
    return sk, fleet, state


@pytest.mark.parametrize("S", [5, 6, 8])
@pytest.mark.parametrize("name,hyper", [("dsfd", {}),
                                        ("time-dsfd", {"R": 4.0})])
def test_query_cohort_matches_reference(S, name, hyper):
    n, d, N = 40, 6, 16
    rsk, rfleet, rstate = _ref_fleet_state(name, S, n, d, N, S, **hyper)
    psk = PA.make_sketch(name, d=d, eps=0.25, window=N, device="cpu",
                         **hyper)
    pfleet = PA.fleet_streams(psk, S)
    ref_np = jax.tree.map(np.asarray, rstate)
    cfg = psk.meta["cfg"]
    pstate = (convert.dsfd_state_from_numpy(cfg, ref_np, device="cpu")
              if name == "dsfd" else
              convert.layered_state_from_numpy(cfg, ref_np, device="cpu"))
    rng = np.random.default_rng(17)
    cohorts = [RQ.ALL]
    for lo, hi in _random_ranges(rng, S, 3):
        cohorts += [RQ.Cohort.range(lo, hi),
                    RQ.Cohort.range(lo, hi) | RQ.Cohort.of(
                        int(rng.integers(0, S)))]
    for c in cohorts:
        g_r = RA.query_cohort(rfleet, rstate, c, n)
        g_p = PA.query_cohort(pfleet, pstate, PQ.Cohort(c.ranges), n)
        q_r = np.asarray(rsk.query(g_r, n), np.float64)
        q_p = psk.query(g_p, n)[0].numpy().astype(np.float64)
        np.testing.assert_allclose(q_p.T @ q_p, q_r.T @ q_r, atol=TOL,
                                   err_msg=f"{name} S={S} {c}")
        np.testing.assert_array_equal(g_p.main.nbuf[0].numpy(),
                                      np.asarray(g_r.main.nbuf))
        np.testing.assert_array_equal(g_p.main.cov_start[0].numpy(),
                                      np.asarray(g_r.main.cov_start))
    assert PA.agg_tree(pfleet).merges == RA.agg_tree(rfleet).merges


def test_warm_cohort_query_merge_budget():
    S, n, d, N = 256, 12, 6, 8
    _, fleet, state = _fleet(S, n, d, N, seed=2)
    tree = PA.agg_tree(fleet)
    g = PA.query_cohort(fleet, state, PA.ALL, n)
    assert tree.merges == S - 1 and tree.cached_nodes == S - 1
    budget = 2 * int(math.log2(S))
    rng = np.random.default_rng(0)
    for lo, hi in _random_ranges(rng, S, 8):
        before = tree.merges
        PA.query_cohort(fleet, state, PA.Cohort.range(lo, hi), n)
        spent = tree.merges - before
        assert spent <= budget, f"[{lo},{hi}): {spent} > {budget}"
        before = tree.merges
        PA.query_cohort(fleet, state, PA.Cohort.range(lo, hi), n)
        assert tree.merges == before            # the result memo
    before = tree.merges
    assert PA.query_cohort(fleet, state, PA.ALL, n) is g
    assert tree.merges == before


def test_warm_answer_equals_a_cold_tree():
    """A warm tree's answer (cached nodes folded) equals a fresh tree's
    (every node built in this query) on the same state."""
    S, n, d, N = 37, 12, 6, 8
    sk, fleet, state = _fleet(S, n, d, N, seed=9)
    tree = PA.agg_tree(fleet)
    tree.build(state, n)
    for c in (PA.Cohort.range(3, 30), PA.Cohort.of(0, 5, 36),
              PA.Cohort.range(10, 11)):
        warm = tree.query(state, c, n)
        cold = PQ.AggTree(sk, S).query(state, c, n)
        for a, b in zip(leaves(warm), leaves(cold)):
            torch.testing.assert_close(a, b, rtol=0, atol=TOL)


def _splice(sk, state, user, row, t):
    """``state`` with stream ``user`` alone given ``row`` at ``t``: every
    other stream's tensors are the same values (new tensor objects, as
    after a fleet update)."""
    one = sk.update_block(take(state, slice(user, user + 1)),
                          torch.from_numpy(row)[None, None],
                          torch.tensor([t], dtype=torch.int32))
    return tree_map(lambda a, b: torch.cat([a[:user], b, a[user + 1:]]),
                    state, one)


def test_advance_dirties_only_touched_paths():
    S, n, d, N = 8, 20, 5, 12
    sk, fleet, state = _fleet(S, n, d, N, seed=6)
    tree = PA.agg_tree(fleet)
    tree.query(state, PA.ALL, n)
    assert sorted(tree._nodes) == [(0, 2), (0, 4), (0, 8), (2, 4), (4, 6),
                                   (4, 8), (6, 8)]
    state2 = _splice(sk, state, 3, _streams(1, 1, d, seed=7)[0, 0], n)
    tree.advance(state2, touched=[3])
    assert sorted(tree._nodes) == [(0, 2), (4, 6), (4, 8), (6, 8)]
    assert tree.resets == 0 and tree.evicted_nodes == 3
    # at the same query time only the dirty path is merged again
    before = tree.merges
    got = tree.query(state2, PA.ALL, n)
    assert tree.merges - before == 3
    want = PQ.AggTree(sk, S).query(state2, PA.ALL, n)
    for a, b in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)
    # at a later time every node is merged again (a node serves only the
    # time it was merged for)
    before = tree.merges
    tree.query(state2, PA.ALL, n + 1)
    assert tree.merges - before == S - 1
    # a later query retags its own path; the next advance drops nodes the
    # forward clock left behind
    tree.query(state2, PA.Cohort.range(0, 2), n + 2)
    state3 = fleet.update_block(state2, torch.from_numpy(
        _streams(S, 1, d, seed=8)), torch.tensor([n + 2], dtype=torch.int32))
    tree.advance(state3, touched=[7])
    assert sorted(tree._nodes) == [(0, 2)]


def test_unannounced_state_change_resets_cache():
    S, n, d, N = 8, 20, 5, 12
    sk, fleet, state = _fleet(S, n, d, N, seed=1)
    PA.query_cohort(fleet, state, PA.ALL, n)
    tree = PA.agg_tree(fleet)
    assert tree.cached_nodes == S - 1 and tree.resets == 0
    state2 = fleet.update_block(state, torch.from_numpy(_streams(S, n, d)),
                                torch.arange(n + 1, 2 * n + 1,
                                             dtype=torch.int32))
    got = PA.query_cohort(fleet, state2, PA.Cohort.range(2, 7), 2 * n)
    assert tree.resets == 1
    want = PQ.AggTree(sk, S).query(state2, PA.Cohort.range(2, 7), 2 * n)
    for a, b in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)


def test_fleet_space_reports_cache_rows():
    S, n, d, N = 6, 24, 5, 12
    sk, fleet, state = _fleet(S, n, d, N, seed=4)
    sp = fleet.space(state)
    assert isinstance(sp, PA.FleetSpace) and sp.cache_rows == 0
    per = sp.per_stream.numpy()
    assert per.shape == (S,) and int(sp.total) == int(per.sum())
    assert sp.ranks is None
    PA.query_cohort(fleet, state, PA.ALL, n)
    sp2 = fleet.space(state)
    assert 0 < sp2.cache_rows <= (S - 1) * 2 * sk.meta["ell"]
    assert int(sp2.total) == int(per.sum()) + sp2.cache_rows
    # every cached node holds what its merged state says
    tree = PA.agg_tree(fleet)
    assert sp2.cache_rows == sum(int(sk.space(s)) for _, s, _ in
                                 tree._nodes.values())


def test_merge_streams_is_a_deprecated_alias():
    S, n, d, N = 5, 30, 6, 12
    _, fleet, state = _fleet(S, n, d, N)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        merged = PA.merge_streams(fleet, state, n)
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and dep[0].filename == __file__
    assert "query_cohort" in str(dep[0].message)
    assert merged is PA.query_cohort(fleet, state, PA.ALL, n)


def test_full_reduce_streams_bound_and_errors():
    S, n, d, N = 7, 60, 8, 20
    sk, fleet, state = _fleet(S, n, d, N, seed=5)
    g = PQ.full_reduce_streams(fleet, state, n)
    B = sk.query(g, n)[0].numpy().astype(np.float64)
    X = _streams(S, n, d, seed=5)
    union = np.vstack([X[s, n - N:] for s in range(S)]).astype(np.float64)
    err = np.linalg.norm(union.T @ union - B.T @ B, 2) / np.sum(union ** 2)
    assert err <= 4 * 0.25
    with pytest.raises(ValueError, match="fleet_streams"):
        PQ.full_reduce_streams(sk, state, n)
    with pytest.raises(ValueError, match="< 1"):
        PQ.AggTree(sk, 0)
    with pytest.raises(ValueError, match="outside fleet"):
        PA.agg_tree(fleet).node(state, 3, 9, n)


def test_single_sketch_query_cohort_raises():
    sk = PA.make_sketch("dsfd", d=8, eps=0.25, window=16, device="cpu")
    info = capabilities(sk)["query_cohort"]
    assert not info.available and "fleet_streams" in info.reason
    with pytest.raises(ValueError, match="fleet_streams"):
        PA.query_cohort(sk, sk.init(), PA.ALL, 1)
    with pytest.raises(ValueError, match="fleet_streams"):
        PA.agg_tree(sk)
