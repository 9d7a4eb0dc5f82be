"""Shard checkpoints and the topology engine of the port on the CPU.

The process-elastic restore cases of ``tests/parallel/test_topology.py``
against the port: a plain checkpoint restored under a topology gives
exact row slices; two shards gather into one fleet and reshard into
three; a missing shard, a spec mismatch and a clock mismatch raise with
the reference's messages.  The engine routes global user ids by
ownership and refuses the others' (``OwnershipError`` names the owner),
and an engine checkpoint goes 1 → 2 → 1 processes with rows pending
across both saves, every answer bitwise.  Shards cross packages: a
reference topology fleet and engine write shards (each process in turn,
``MemTransport`` topologies) that the port restores plain, under P = 2
and under P = 3, and the other way round, leaves bitwise.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.parallel import topology as RT
from repro.serve.engine import SketchFleetEngine as RefEngine
from repro.sketch import api as RA
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.parallel import topology as PT
from repro_torch.serve.engine import SketchFleetEngine
from repro_torch.sketch import api as PA
from repro_torch.sketch import query as PQ
from repro_torch.tree import leaves, take

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

S, D, N, BLOCK = 8, 5, 12, 4


def _streams(S, n, d, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S, n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=2, keepdims=True)
    return X


def _topo(P, pid, streams=S):
    return PT.FleetTopology(streams, num_processes=P, process_id=pid,
                            transport=PT.MemTransport(), timeout_s=30.0)


def _rtopo(P, pid, streams=S):
    return RT.FleetTopology(streams, num_processes=P, process_id=pid,
                            transport=RT.MemTransport(), timeout_s=30.0)


def _np(state):
    return [x.cpu().numpy() for x in leaves(state)]


def _assert_leaves_equal(got, want, msg=""):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, msg
        np.testing.assert_array_equal(g, w, err_msg=msg)


def _sketch():
    return PA.make_sketch("dsfd", d=D, eps=0.25, window=N, device="cpu")


def _full_state(n=16):
    fleet = PA.fleet_streams(_sketch(), S)
    X = torch.from_numpy(_streams(S, n, D))
    return fleet.update_block(fleet.init(), X,
                              torch.arange(1, n + 1, dtype=torch.int32))


def _sliced(state, lo, hi):
    return _np(take(state, slice(lo, hi)))


# ---------------------------------------------------------------------------
# restore_fleet's elastic reassembly
# ---------------------------------------------------------------------------


def test_restore_plain_checkpoint_under_topology_slices_exactly(tmp_path):
    st = _full_state()
    PA.save_fleet(str(tmp_path), PA.shard_streams(_sketch(), S), st, 16)
    for P in (2, 3):
        for pid in range(P):
            topo = _topo(P, pid)
            fc = PA.restore_fleet(str(tmp_path), topology=topo,
                                  device="cpu")
            assert fc.t == 16 and fc.fleet.meta["topology"] is topo
            assert isinstance(PA.agg_tree(fc.fleet), PT.PartitionedAggTree)
            _assert_leaves_equal(_np(fc.state),
                                 _sliced(st, topo.lo, topo.hi),
                                 msg=f"P={P} pid={pid}")


def _save_shards(path, P, n=16, aux=True):
    """Each of P processes saves its shard; returns the full state."""
    st = _full_state(n)
    for pid in range(P):
        topo = _topo(P, pid)
        fleet = PA.shard_streams(_sketch(), S, topology=topo)
        PA.save_fleet(path, fleet, take(st, slice(topo.lo, topo.hi)), n,
                      aux=({"pending_user": np.array([topo.lo], np.int32)}
                           if aux else None))
    return st


def test_restore_shards_as_plain_fleet_and_reshard(tmp_path):
    st = _save_shards(str(tmp_path), 2)
    fc = PA.restore_fleet(str(tmp_path), device="cpu")     # 2 -> 1
    assert fc.fleet.meta["devices"] == 1 and fc.t == 16
    _assert_leaves_equal(_np(fc.state), _np(st))
    np.testing.assert_array_equal(fc.aux["pending_user"], [0, 4])
    ss = fc.manifest["sketch_spec"]
    assert ss["topology"]["range"] == [0, 4] and ss["local_streams"] == 4
    for pid in range(3):                                    # 2 -> 3
        topo3 = _topo(3, pid)
        fc3 = PA.restore_fleet(str(tmp_path), topology=topo3, device="cpu")
        _assert_leaves_equal(_np(fc3.state),
                             _sliced(st, topo3.lo, topo3.hi),
                             msg=f"3-way pid {pid}")


def test_restore_missing_shard_fails_loudly(tmp_path):
    topo = _topo(2, 0)
    st = _full_state()
    PA.save_fleet(str(tmp_path), PA.shard_streams(_sketch(), S,
                                                  topology=topo),
                  take(st, slice(0, 4)), 16)          # only [0, 4) lands
    with pytest.raises(ValueError, match=r"no shard covering streams "
                       r"\[4, 8\)"):
        PA.restore_fleet(str(tmp_path), device="cpu")
    # ...but the process that needs only [0, 4) restores it
    fc = PA.restore_fleet(str(tmp_path), topology=_topo(2, 0), device="cpu")
    _assert_leaves_equal(_np(fc.state), _sliced(st, 0, 4))


def test_restore_refuses_spec_and_clock_mismatch(tmp_path):
    st = _full_state()
    for pid, t in ((0, 16), (1, 20)):                  # another tick
        topo = _topo(2, pid)
        PA.save_fleet(str(tmp_path / "clock"),
                      PA.shard_streams(_sketch(), S, topology=topo),
                      take(st, slice(topo.lo, topo.hi)), t)
    with pytest.raises(ValueError, match="saved at clock 20"):
        PA.restore_fleet(str(tmp_path / "clock"), device="cpu")
    other = PA.make_sketch("dsfd", d=D, eps=0.25, window=N + 4,
                           device="cpu")
    for pid, sk in ((0, _sketch()), (1, other)):        # another fleet
        topo = _topo(2, pid)
        PA.save_fleet(str(tmp_path / "spec"),
                      PA.shard_streams(sk, S, topology=topo),
                      take(st, slice(topo.lo, topo.hi)), 16)
    with pytest.raises(ValueError, match="disagrees with its siblings"):
        PA.restore_fleet(str(tmp_path / "spec"), device="cpu")
    PA.save_fleet(str(tmp_path / "plain"), PA.fleet_streams(_sketch(), S),
                  st, 16)
    with pytest.raises(ValueError, match="holds 8 streams but the topology "
                       "covers 16"):
        PA.restore_fleet(str(tmp_path / "plain"), device="cpu",
                         topology=_topo(2, 0, streams=16))


# ---------------------------------------------------------------------------
# The engine: ownership routing and elastic checkpoints
# ---------------------------------------------------------------------------


def _engine(**kw):
    return SketchFleetEngine("dsfd", d=D, streams=S, eps=0.25, window=N,
                             block=BLOCK, device="cpu", **kw)


def _fill(eng, X, rows_per_user=6):
    users = np.repeat(np.arange(S), rows_per_user)
    eng.submit_many(users, X[:, :rows_per_user].reshape(-1, D))
    eng.run()


def test_engine_ownership_routing_and_rejection():
    X = _streams(S, 10, D)
    eng = _engine(topology=_topo(2, 0))
    assert eng.S == S and eng.S_local == 4
    assert eng.submit(3, X[3, 0])                       # owned: accepted
    with pytest.raises(PT.OwnershipError) as ei:
        eng.submit(5, X[5, 0])
    assert "process 1" in str(ei.value)
    with pytest.raises(PT.OwnershipError):
        eng.query_user(5)
    backlog0 = eng.backlog
    with pytest.raises(PT.OwnershipError):              # mixed: nothing in
        eng.submit_many(np.array([1, 6]), X[:2, 1])
    assert eng.backlog == backlog0
    with pytest.raises(ValueError, match="outside the fleet"):
        eng.submit(S + 3, X[0, 0])
    with pytest.raises(ValueError, match="outside the fleet"):
        eng.submit_many(np.array([1, S]), X[:2, 1])
    eng.run()
    assert eng.query_user(3).shape == eng.query_user(0).shape
    assert eng.state.main.buf.shape[0] == 4


def test_engine_checkpoint_elastic_one_to_two_and_back(tmp_path):
    X = _streams(S, 12, D)
    eng = _engine(score=True)
    _fill(eng, X)
    eng.submit(1, X[1, 8])                              # pending across
    eng.submit(6, X[6, 8])
    p1 = str(tmp_path / "one")
    eng.checkpoint(p1)
    oracle = {u: eng.query_user(u) for u in range(S)}
    scores = eng.score_plane.state_dict()

    halves = []
    for pid in range(2):                                # 1 -> 2
        topo = _topo(2, pid)
        e = SketchFleetEngine.from_checkpoint(p1, topology=topo,
                                              device="cpu")
        assert (e.t, e.S, e.S_local) == (eng.t, S, 4)
        assert e.rows_ingested == eng.rows_ingested
        assert e.backlog == 1                           # split by owner
        for u in range(topo.lo, topo.hi):
            np.testing.assert_array_equal(e.query_user(u), oracle[u])
        for k, v in e.score_plane.state_dict().items():
            np.testing.assert_array_equal(v, scores[k][topo.lo:topo.hi])
        halves.append(e)

    p2 = str(tmp_path / "two")                          # 2 -> 1
    for e in halves:
        e.checkpoint(p2)
    back = SketchFleetEngine.from_checkpoint(p2, device="cpu")
    assert (back.t, back.S, back.backlog) == (eng.t, S, 2)
    assert back.rows_ingested == eng.rows_ingested
    for u in range(S):
        np.testing.assert_array_equal(back.query_user(u), oracle[u])
    for k, v in back.score_plane.state_dict().items():
        np.testing.assert_array_equal(v, scores[k])
    # every restored engine drains its pending rows to the same answers
    for e in [back, eng] + halves:
        e.run()
    for u in range(S):
        owner = halves[0] if u < 4 else halves[1]
        np.testing.assert_array_equal(back.query_user(u),
                                      owner.query_user(u))
        np.testing.assert_array_equal(back.query_user(u), eng.query_user(u))


def test_engine_shards_restore_the_fleet_rows_ingested(tmp_path):
    """Shards of fresh halves that ingested different row counts restore
    the whole fleet's count (2 -> 1, 2 -> 2, 2 -> 3); saved again after
    more rows, the count is the restored one plus every shard's own."""
    X = _streams(S, 12, D)
    halves = []
    for pid, active in ((0, range(0, 4)), (1, range(4, 6))):
        e = _engine(topology=_topo(2, pid))
        users = np.repeat(np.asarray(active), 6)
        e.submit_many(users, X[list(active), :6].reshape(-1, D))
        e.run()
        halves.append(e)
    assert [e.rows_ingested for e in halves] == [24, 12]
    p1 = str(tmp_path / "one")
    for e in halves:
        e.checkpoint(p1)
    assert SketchFleetEngine.from_checkpoint(p1,
                                             device="cpu").rows_ingested == 36
    for P in (2, 3):
        for pid in range(P):
            e = SketchFleetEngine.from_checkpoint(p1, topology=_topo(P, pid),
                                                  device="cpu")
            assert e.rows_ingested == 36
    again = [SketchFleetEngine.from_checkpoint(p1, topology=_topo(2, pid),
                                               device="cpu")
             for pid in range(2)]
    again[1].submit_many(np.repeat(np.arange(6, 8), 4),
                         X[6:8, 6:10].reshape(-1, D))
    again[0].submit_many(np.repeat(np.arange(0, 1), 4),
                         X[0:1, 6:10].reshape(-1, D))
    for e in again:
        e.run()
    p2 = str(tmp_path / "two")
    for e in again:
        e.checkpoint(p2)
    back = SketchFleetEngine.from_checkpoint(p2, device="cpu")
    assert (back.t, back.rows_ingested) == (again[0].t, 36 + 8 + 4)


def test_topology_engines_answer_cohorts_and_anomalies_collectively():
    """Two engine halves (threads over one transport) answer the cohorts
    of the one-process engine bitwise, and gather the anomaly flags."""
    X = _streams(S, 12, D)
    whole = _engine(score=True, score_warmup=0)
    _fill(whole, X)
    cohorts = [None, PQ.Cohort.range(2, 7), [0, 5]]
    want = [whole.query_cohort(c) for c in cohorts]
    transport = PT.MemTransport()
    out = {}

    def proc(pid):
        topo = PT.FleetTopology(S, num_processes=2, process_id=pid,
                                transport=transport, timeout_s=30.0)
        e = _engine(topology=topo, score=True, score_warmup=0)
        users = np.repeat(np.arange(topo.lo, topo.hi), 6)
        e.submit_many(users, X[topo.lo:topo.hi, :6].reshape(-1, D))
        e.run()
        e.score_plane.flagged[:] = False
        e.score_plane.flagged[1] = True                 # global lo + 1
        out[pid] = ([e.query_cohort(c) for c in cohorts],
                    e.anomalies(), e.anomalies(collective=True))

    import threading

    threads = [threading.Thread(target=proc, args=(p,)) for p in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    for pid in (0, 1):
        for got, w in zip(out[pid][0], want):
            np.testing.assert_array_equal(got, w)
        assert out[pid][1].tolist() == [1 + 4 * pid]
        assert out[pid][2].tolist() == [1, 5]


# ---------------------------------------------------------------------------
# Shard checkpoints across packages
# ---------------------------------------------------------------------------


def _ref_sketch():
    return RA.make_sketch("dsfd", d=D, eps=0.25, window=N)


def _ref_full(n=16):
    fleet = RA.vmap_streams(_ref_sketch(), S)
    return fleet.update_block(fleet.init(), jnp.asarray(_streams(S, n, D)),
                              jnp.arange(1, n + 1, dtype=jnp.int32))


def _check_port_restores(path, want):
    """The port restores ``path`` plain, under P = 2 and under P = 3."""
    fc = PA.restore_fleet(path, device="cpu")
    _assert_leaves_equal(_np(fc.state), want)
    for P in (2, 3):
        for pid in range(P):
            topo = _topo(P, pid)
            fc = PA.restore_fleet(path, topology=topo, device="cpu")
            _assert_leaves_equal(_np(fc.state),
                                 [w[topo.lo:topo.hi] for w in want],
                                 msg=f"P={P} pid={pid}")


def _check_ref_restores(path, want):
    """The reference restores ``path`` plain, under P = 2 and P = 3."""
    fc = RA.restore_fleet(path)
    _assert_leaves_equal(jax.tree.leaves(fc.state), want)
    for P in (2, 3):
        for pid in range(P):
            topo = _rtopo(P, pid)
            fc = RA.restore_fleet(path, topology=topo)
            _assert_leaves_equal(jax.tree.leaves(fc.state),
                                 [w[topo.lo:topo.hi] for w in want],
                                 msg=f"P={P} pid={pid}")


def test_reference_fleet_shards_restore_in_the_port(tmp_path):
    st = _ref_full()
    for pid in range(2):
        topo = _rtopo(2, pid)
        fleet = RA.shard_streams(_ref_sketch(), S, topology=topo)
        RA.save_fleet(str(tmp_path), fleet,
                      jax.tree.map(lambda x: x[topo.lo:topo.hi], st), 16)
    _check_port_restores(str(tmp_path),
                         [np.asarray(x) for x in jax.tree.leaves(st)])


def test_port_fleet_shards_restore_in_the_reference(tmp_path):
    st = _save_shards(str(tmp_path), 2, aux=False)
    _check_ref_restores(str(tmp_path), _np(st))


def _feed(eng, X, users):
    eng.submit_many(np.repeat(users, 6),
                    X[users][:, :6].reshape(-1, D))
    eng.run()
    eng.submit(int(users[0]), X[users[0], 8])           # pending


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_engine_shards_cross_packages(tmp_path, direction):
    X = _streams(S, 12, D)
    path = str(tmp_path)
    for pid in range(2):
        if direction == "ref-to-port":
            topo = _rtopo(2, pid)
            eng = RefEngine("dsfd", d=D, streams=S, eps=0.25, window=N,
                            block=BLOCK, topology=topo)
        else:
            topo = _topo(2, pid)
            eng = _engine(topology=topo)
        _feed(eng, X, np.arange(topo.lo, topo.hi))
        eng.checkpoint(path)
    if direction == "ref-to-port":
        whole = RA.restore_fleet(path)
        want = [np.asarray(x) for x in jax.tree.leaves(whole.state)]
        _check_port_restores(path, want)
        back = SketchFleetEngine.from_checkpoint(path, device="cpu")
        halves = [SketchFleetEngine.from_checkpoint(
            path, topology=_topo(2, pid), device="cpu") for pid in (0, 1)]
    else:
        whole = PA.restore_fleet(path, device="cpu")
        want = _np(whole.state)
        _check_ref_restores(path, want)
        back = RefEngine.from_checkpoint(path)
        halves = [RefEngine.from_checkpoint(path, topology=_rtopo(2, pid))
                  for pid in (0, 1)]
    assert back.backlog == 2 and back.t == 8
    assert [h.backlog for h in halves] == [1, 1]
    for u in range(S):
        h = halves[u // 4]
        np.testing.assert_array_equal(np.asarray(back.query_user(u)),
                                      np.asarray(h.query_user(u)))
