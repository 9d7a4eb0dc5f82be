"""The port's history plane (``repro_torch.sketch.history``) on the CPU.

The reference's acceptance suite (``tests/sketch/test_history.py``) run
against the port: ``query_interval`` over retired content is bit-identical
to an oracle of the canonical dyadic schedule written here (scalar
``fd_compress`` calls and explicit recursion, no code of the plane), hot
only, cold-faulted and after a checkpoint; warm queries stay within
``2⌈log₂(t2 − t1)⌉`` merges.  Against the reference: the dyadic cover and
budget are equal, a plane fed the same slabs holds the same keys and
counters with Grams within 1e-4, and an engine checkpoint with history,
written by either package, restores in the other and answers the same
intervals.
"""

import os

import numpy as np
import pytest
import torch

from repro.serve.engine import SketchFleetEngine as RefEngine
from repro.sketch import history as RH
from repro_torch.core.fd import fd_compress
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.parallel.topology import FleetTopology, MemTransport
from repro_torch.serve.engine import SketchFleetEngine
from repro_torch.sketch import api as PA
from repro_torch.sketch.history import HistoryPlane, dyadic_cover, \
    install_query_interval, interval_merge_budget
from repro_torch.sketch.query import Cohort, as_cohort, canonical_cover
from repro_torch.train.checkpoint import HISTORY_MARKER

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

S, D, ELL, W, BLOCK, N = 8, 12, 4, 16, 4, 48
EPS = 0.25                       # -> ell = 4 for dsfd
TOL = 1e-4


def _rows(seed=0, n=N, idle_ticks=()):
    """(S, n, d) rows; row j of a stream is stamped j + 1.  ``idle_ticks``:
    ticks whose block of units is zero (an ``advance_time`` idle tick)."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(S, n, D)).astype(np.float32)
    for k in idle_ticks:
        rows[:, k * BLOCK:(k + 1) * BLOCK, :] = 0.0
    return rows


def _drive(eng, rows):
    for k in range(rows.shape[1] // BLOCK):
        blk = rows[:, k * BLOCK:(k + 1) * BLOCK]
        if blk.any():
            u = np.repeat(np.arange(S), BLOCK)
            assert eng.submit_many(u, blk.reshape(-1, D)).all()
            eng.step()
        else:
            eng.step(advance_time=True)
    return eng


def _engine(rows, **kw):
    return _drive(SketchFleetEngine("dsfd", d=D, streams=S, eps=EPS,
                                    window=W, block=BLOCK, history=True,
                                    device="cpu", **kw), rows)


def _ref_engine(rows, **kw):
    return _drive(RefEngine("dsfd", d=D, streams=S, eps=EPS, window=W,
                            block=BLOCK, history=True, **kw), rows)


# ---------------------------------------------------------------------------
# The oracle: the canonical dyadic schedule, written out again
# ---------------------------------------------------------------------------


class Oracle:
    """From-scratch compression of the raw rows through the schedule, one
    ``fd_compress`` call a matrix."""

    def __init__(self, rows, ell=ELL):
        self.rows, self.ell, self.memo = rows, ell, {}

    def _compress(self, mat):
        return fd_compress(torch.from_numpy(mat)[None], self.ell)[0].numpy()

    def _merge2(self, a, b):
        return self._compress(np.concatenate([a, b], axis=0))

    def node(self, L, i):
        key = (L, i)
        if key in self.memo:
            return self.memo[key]
        if L == 0:
            if i == 0 or i > self.rows.shape[1]:
                v = None
            else:
                col = self.rows[:, i - 1, :]
                v = (None if not col.any() else
                     np.stack([self._compress(col[s][None])
                               for s in range(S)]))
        else:
            a, b = self.node(L - 1, 2 * i), self.node(L - 1, 2 * i + 1)
            v = (b if a is None else a if b is None else
                 np.stack([self._merge2(a[s], b[s]) for s in range(S)]))
        self.memo[key] = v
        return v

    def _seg(self, arr, lo, hi):
        if hi - lo == 1:
            return arr[lo]
        mid = (lo + hi) // 2
        return self._merge2(self._seg(arr, lo, mid), self._seg(arr, mid, hi))

    def interval(self, t1, t2, ranges=((0, S),)):
        segs = []
        for lo, hi in ranges:
            canonical_cover(0, S, lo, hi, segs)
        acc = None
        for L, i in RH.dyadic_cover(t1, t2):
            arr = self.node(L, i)
            if arr is None:
                continue
            v = None
            for lo, hi in segs:
                sv = self._seg(arr, lo, hi)
                v = sv if v is None else self._merge2(v, sv)
            acc = v if acc is None else self._merge2(acc, v)
        return (np.zeros((2 * self.ell, D), np.float32) if acc is None
                else acc)


INTERVALS = [(1, 33), (0, 33), (5, 29), (16, 17), (1, 2), (7, 23)]
COHORTS = [(None, ((0, S),)),
           (range(0, 4), ((0, 4),)),
           (Cohort.range(1, 2) | Cohort.range(5, 7), ((1, 2), (5, 7)))]


def _gram(b):
    b = np.asarray(b, np.float64)
    return b.T @ b


# ---------------------------------------------------------------------------
# Dyadic cover
# ---------------------------------------------------------------------------


def test_dyadic_cover_and_budget_match_the_reference():
    rng = np.random.default_rng(7)
    for _ in range(300):
        t1 = int(rng.integers(0, 600))
        t2 = t1 + 1 + int(rng.integers(0, 600))
        cover = dyadic_cover(t1, t2)
        assert cover == RH.dyadic_cover(t1, t2)
        assert interval_merge_budget(t1, t2) == \
            RH.interval_merge_budget(t1, t2)
        cursor = t1
        for L, i in cover:
            assert i * (1 << L) == cursor
            cursor += 1 << L
        assert cursor == t2
        assert len(cover) - 1 <= interval_merge_budget(t1, t2)
    for bad in ((3, 3), (-1, 3)):
        with pytest.raises(ValueError):
            dyadic_cover(*bad)


# ---------------------------------------------------------------------------
# Bit-identity to the oracle: hot, warm budget, cold-faulted, restore
# ---------------------------------------------------------------------------


def test_hot_only_bit_identical_to_oracle():
    rows = _rows()
    eng = _engine(rows)
    assert eng.history.retired_through == eng.t - W == 32
    oracle = Oracle(rows)
    for t1, t2 in INTERVALS:
        for users, ranges in COHORTS:
            np.testing.assert_array_equal(
                eng.query_interval(users, t1, t2),
                oracle.interval(t1, t2, ranges))
    assert eng.history.store.spills == eng.history.store.faults == 0


def test_warm_query_within_merge_budget():
    eng = _engine(_rows())
    h = eng.history
    for t1, t2 in INTERVALS:
        eng.query_interval(None, t1, t2)
        m0 = h.merges
        eng.query_interval(None, t1, t2)
        assert h.merges - m0 <= interval_merge_budget(t1, t2)


def test_cold_faulted_bit_identical(tmp_path):
    rows = _rows()
    spill = str(tmp_path / "spill")
    eng = _engine(rows, history_hot_nodes=2, history_dir=spill)
    st = eng.history.store
    assert st.spills > 0 and len(st.on_disk) > 0
    assert os.path.isfile(os.path.join(spill, HISTORY_MARKER))
    node = sorted(n for n in os.listdir(spill) if n.startswith("node_"))[0]
    assert os.path.isfile(os.path.join(spill, node, "step_000000000",
                                       "manifest.json"))
    f0 = st.faults
    oracle = Oracle(rows)
    for t1, t2 in INTERVALS:
        for users, ranges in COHORTS:
            np.testing.assert_array_equal(
                eng.query_interval(users, t1, t2),
                oracle.interval(t1, t2, ranges))
    assert st.faults > f0
    assert eng.history.space()["cold_nodes"] == len(st.on_disk)


def test_checkpoint_restore_answers_identically(tmp_path):
    rows = _rows()
    eng = _engine(rows, history_hot_nodes=2,
                  history_dir=str(tmp_path / "spill"))
    want = {(t1, t2): eng.query_interval(None, t1, t2)
            for t1, t2 in INTERVALS}
    ck = str(tmp_path / "ck")
    eng.checkpoint(ck)
    rest = SketchFleetEngine.from_checkpoint(ck, device="cpu")
    assert rest.history.retired_through == eng.history.retired_through
    assert list(rest.history.store.hot) == list(eng.history.store.hot)
    for (t1, t2), v in want.items():
        np.testing.assert_array_equal(rest.query_interval(None, t1, t2), v)
    np.testing.assert_array_equal(
        rest.fleet.query_interval(rest.state, 5, 29).numpy(), want[(5, 29)])
    for e in (eng, rest):
        for _ in range(4):
            e.step(advance_time=True)
    assert rest.history.retired_through == eng.history.retired_through == 48
    np.testing.assert_array_equal(eng.query_interval(None, 30, 49),
                                  rest.query_interval(None, 30, 49))


def test_restore_refuses_partition_mismatch():
    meta, _ = _engine(_rows()).history.state_dict()
    with pytest.raises(ValueError, match="same stream partition"):
        HistoryPlane.from_state_dict(dict(meta, scope=[0, 4]), {},
                                     device="cpu")
    # restoring under another partition is refused too
    topo = FleetTopology(S, num_processes=2, process_id=1,
                         transport=MemTransport())
    with pytest.raises(ValueError, match="same stream partition"):
        HistoryPlane.from_state_dict(meta, {}, topology=topo, device="cpu")


# ---------------------------------------------------------------------------
# Retirement semantics
# ---------------------------------------------------------------------------


def test_idle_advance_time_ticks_retire():
    rows = _rows(idle_ticks=(2, 3))
    eng = _engine(rows)
    assert eng.history.retired_through == 32
    oracle = Oracle(rows)
    assert not eng.query_interval(None, 2 * BLOCK + 1, 4 * BLOCK + 1).any()
    for t1, t2 in [(1, 33), (5, 29), (9, 17)]:
        np.testing.assert_array_equal(eng.query_interval(None, t1, t2),
                                      oracle.interval(t1, t2))
    r0, t0 = eng.history.retired_units, eng.t
    eng.step()                                   # a clock-neutral poll
    assert (eng.history.retired_units, eng.t) == (r0, t0)


def test_retire_is_idempotent_and_exactly_once():
    eng = _engine(_rows())
    h = eng.history
    assert h.retired_units == h.retired_through == eng.t - W
    assert h.retire_through(h.retired_through) == 0
    assert h.retired_units == eng.t - W
    with pytest.raises(RuntimeError, match="retired twice"):
        h.store.put((0, 1), None)
    with pytest.raises(ValueError, match="already retired"):
        h.observe_block(np.ones((S, 1, D), np.float32), first_ts=3)


def test_eviction_matches_retirement_on_shared_clock():
    """With block = 1 and one cohort query before every tick, the
    AggTree's clock-driven eviction drops as many nodes as the plane
    retires units."""
    eng = SketchFleetEngine("dsfd", d=D, streams=S, eps=EPS, window=4,
                            block=1, history=True, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(4):
        eng.submit(0, rng.normal(size=D).astype(np.float32))
        eng.step()
    assert eng.tree.evicted_nodes == eng.history.retired_units == 0
    for j in range(10):
        eng.query_cohort(Cohort.range(0, 2))
        assert eng.tree.cached_nodes == 1
        eng.submit(0, rng.normal(size=D).astype(np.float32))
        eng.step()
        assert eng.tree.evicted_nodes == eng.history.retired_units == j + 1
        eng.step()                     # clock-neutral poll: changes nothing
        assert eng.tree.evicted_nodes == eng.history.retired_units == j + 1


# ---------------------------------------------------------------------------
# Raisers and bounds
# ---------------------------------------------------------------------------


def test_unretired_interval_raises():
    eng = _engine(_rows())
    with pytest.raises(ValueError, match="live window"):
        eng.query_interval(None, 1, eng.history.retired_through + 2)
    for t1, t2 in ((5, 5), (-1, 5)):
        with pytest.raises(ValueError, match="0 <= t1 < t2"):
            eng.query_interval(None, t1, t2)
    eng.query_interval(None, 1, eng.history.retired_through + 1)


def test_explanatory_raisers(tmp_path):
    single = PA.make_sketch("dsfd", d=D, eps=EPS, window=W, device="cpu")
    with pytest.raises(ValueError, match="single sketch.*history=True"):
        single.query_interval(None, 1, 2)
    fleet = PA.fleet_streams(single, S)
    with pytest.raises(ValueError, match="no history plane"):
        fleet.query_interval(None, 1, 2)
    with pytest.raises(ValueError, match="no history plane"):
        PA.query_interval(fleet, None, 1, 2)
    eng = SketchFleetEngine("dsfd", d=D, streams=S, eps=EPS, window=W,
                            block=BLOCK, device="cpu")
    with pytest.raises(ValueError, match=r"history=True\[, "
                       r"history_hot_nodes=\.\.\., history_dir=\.\.\.\]"):
        eng.query_interval(None, 1, 2)
    with pytest.raises(ValueError, match="hot capacity"):
        SketchFleetEngine("dsfd", d=D, streams=S, eps=EPS, window=W,
                          block=BLOCK, history=True, history_hot_nodes=0,
                          history_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="somewhere to spill"):
        HistoryPlane(streams=S, d=D, ell=ELL, window=W, hot_capacity=4,
                     device="cpu")
    with pytest.raises(ValueError, match="topology covers"):
        HistoryPlane(streams=S, d=D, ell=ELL, window=W, device="cpu",
                     topology=FleetTopology(2 * S, transport=MemTransport()))


def test_install_query_interval_protocol_hook():
    eng = _engine(_rows())
    fleet = PA.fleet_streams(PA.make_sketch("dsfd", d=D, eps=EPS, window=W,
                                            device="cpu"), S)
    fleet = install_query_interval(fleet, eng.history)
    assert fleet.meta["hist_box"]["plane"] is eng.history
    np.testing.assert_array_equal(PA.query_interval(fleet, None, 5, 29),
                                  eng.query_interval(None, 5, 29))


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def _keys(plane):
    """What a checkpoint carries of the index."""
    st = plane.store
    return (plane.retired_through, plane.retired_units, sorted(st.empty),
            sorted(st.on_disk), list(st.hot), sorted(plane._pending))


def _index(plane):
    st = plane.store
    return _keys(plane) + (plane.consolidations, st.spills, st.faults)


def test_plane_matches_the_reference_plane(tmp_path):
    """The same slabs into both planes (hot tier of 3, spilling): the
    same index, counters and per-query merges, Grams within 1e-4."""
    rows = _rows(seed=2, idle_ticks=(5,))
    ref = RH.HistoryPlane(streams=S, d=D, ell=ELL, window=W, hot_capacity=3,
                          spill_dir=str(tmp_path / "ref"))
    port = HistoryPlane(streams=S, d=D, ell=ELL, window=W, hot_capacity=3,
                        spill_dir=str(tmp_path / "port"), device="cpu")
    for k in range(N // BLOCK):
        slab = rows[:, k * BLOCK:(k + 1) * BLOCK]
        for plane in (ref, port):
            plane.observe_block(slab, first_ts=k * BLOCK + 1)
            plane.retire_through((k + 1) * BLOCK - W)
        assert _index(port) == _index(ref)
    for t1, t2 in INTERVALS:
        for users in (None, range(0, 4), [1, 5, 6]):
            got = port.query_interval(t1, t2, as_cohort(users)).numpy()
            want = ref.query_interval(t1, t2, RH.as_cohort(users))
            np.testing.assert_allclose(_gram(got), _gram(want), rtol=0,
                                       atol=TOL)
            assert (port.time_merges, port.stream_merges) == (
                ref.time_merges, ref.stream_merges)
    assert _index(port) == _index(ref)
    assert port.space()["cold_nodes"] == ref.space()["cold_nodes"]


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_history_engine_cross_load(tmp_path, direction):
    """An engine with history, checkpointed with cold nodes on disk and
    rows pending, restores in the other package: the index exactly, the
    intervals within 1e-4, also after both retire further units."""
    rows = _rows(seed=5)
    kw = dict(history_hot_nodes=3, history_dir=str(tmp_path / "spill"))
    if direction == "ref-to-port":
        src = _ref_engine(rows, mode="fast", **kw)
    else:
        src = _engine(rows, mode="fast", **kw)
    u = np.repeat(np.arange(S), 2)
    src.submit_many(u, rows[:, :2].reshape(-1, D))       # rows pending
    ck = str(tmp_path / "ck")
    src.checkpoint(ck)
    if direction == "ref-to-port":
        dst = SketchFleetEngine.from_checkpoint(ck, device="cpu")
    else:
        dst = RefEngine.from_checkpoint(ck)
    assert _keys(dst.history) == _keys(src.history)
    assert (dst.t, dst.rows_ingested, dst.backlog) == (
        src.t, src.rows_ingested, src.backlog)
    for t1, t2 in INTERVALS:
        np.testing.assert_allclose(
            _gram(dst.query_interval(None, t1, t2)),
            _gram(src.query_interval(None, t1, t2)), rtol=0, atol=TOL)
    for e in (src, dst):
        e.run()
        for _ in range(3):
            e.step(advance_time=True)
    assert dst.history.retired_through == src.history.retired_through
    np.testing.assert_allclose(_gram(dst.query_interval([1, 6], 20, 45)),
                               _gram(src.query_interval([1, 6], 20, 45)),
                               rtol=0, atol=TOL)
