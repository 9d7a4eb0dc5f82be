"""The history plane's collective (``repro_torch.sketch.history`` under a
``FleetTopology``) on the CPU.

The port of ``tests/sketch/test_history.py::
test_two_process_topology_bit_identical``: two threads standing in for
processes over one ``MemTransport`` each hold half the streams' retired
snapshots and answer the intervals collectively, bitwise the port's
one-process plane on the same rows and within 1e-4 absolute of the
reference's answers by Gram (the parity contract; entries of the Grams
are at most the interval's rows).  A history engine under a topology
checkpoints its shard and restores under the saving partition only, as
the reference refuses elastic resharding of retired history.
"""

import os
import threading

import numpy as np
import pytest
import torch

from repro.sketch.history import HistoryPlane as RefPlane
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.parallel.topology import FleetTopology, MemTransport
from repro_torch.serve.engine import SketchFleetEngine
from repro_torch.sketch.history import HistoryPlane

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

S, D, ELL, W, BLOCK, N = 8, 12, 4, 16, 4, 48
TOL = 1e-4
QUERIES = [(None, 1, 33), (None, 5, 29), (range(0, 4), 0, 33),
           ([1, 5, 6], 2, 31), (range(3, 7), 9, 17), ([2], 1, 2)]


def _rows(seed=0, idle_ticks=(4,), quiet=None):
    """(S, N, d) rows; row j stamped j + 1.  ``idle_ticks``: ticks whose
    block is zero for every stream; ``quiet``: (streams, ticks) zero for
    those streams only (units empty on one process, live on the other)."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(S, N, D)).astype(np.float32)
    for k in idle_ticks:
        rows[:, k * BLOCK:(k + 1) * BLOCK] = 0.0
    if quiet is not None:
        users, ticks = quiet
        for k in ticks:
            rows[users, k * BLOCK:(k + 1) * BLOCK] = 0.0
    return rows


def _feed(plane, rows, lo, hi):
    for k in range(N // BLOCK):
        plane.observe_block(rows[lo:hi, k * BLOCK:(k + 1) * BLOCK],
                            first_ts=k * BLOCK + 1)
        plane.retire_through((k + 1) * BLOCK - W)
    return plane


def _pair(rows, queries, make):
    """``make(topology)`` → a plane fed its half; both halves' answers."""
    transport = MemTransport()
    res, errs = {}, {}

    def worker(pid):
        try:
            topo = FleetTopology(S, num_processes=2, process_id=pid,
                                 transport=transport, namespace="hist2p",
                                 timeout_s=30.0)
            plane = _feed(make(topo), rows, topo.lo, topo.hi)
            res[pid] = ([plane.query_interval(t1, t2, c)
                         for c, t1, t2 in queries], plane)
        except Exception as e:                 # raised after the join
            errs[pid] = e

    threads = [threading.Thread(target=worker, args=(p,)) for p in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive(), "a thread stand-in hung"
    if errs:
        raise next(iter(errs.values()))
    return res


def _gram(b):
    b = np.asarray(b, np.float64)
    return b.T @ b


@pytest.mark.parametrize("quiet", [None, ([0, 1, 2, 3], (6, 7))],
                         ids=["every-stream", "one-half-quiet"])
def test_two_process_topology_bit_identical(quiet):
    rows = _rows(quiet=quiet)
    single = _feed(HistoryPlane(streams=S, d=D, ell=ELL, window=W,
                                device="cpu"), rows, 0, S)
    ref = _feed(RefPlane(streams=S, d=D, ell=ELL, window=W), rows, 0, S)
    res = _pair(rows, QUERIES, lambda topo: HistoryPlane(
        streams=S, d=D, ell=ELL, window=W, topology=topo, device="cpu"))
    for c, t1, t2 in QUERIES:
        want = single.query_interval(t1, t2, c)
        rwant = ref.query_interval(t1, t2, c)
        i = QUERIES.index((c, t1, t2))
        for pid in (0, 1):
            got = res[pid][0][i]
            np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                          err_msg=f"{c} [{t1}, {t2})")
            np.testing.assert_allclose(_gram(got.numpy()), _gram(rwant),
                                       rtol=0, atol=TOL,
                                       err_msg=f"{c} [{t1}, {t2})")
        np.testing.assert_array_equal(res[0][0][i].numpy(),
                                      res[1][0][i].numpy())
    for pid in (0, 1):
        plane = res[pid][1]
        assert plane.remote_fetches > 0 and plane.published > 0
        assert plane.retired_through == N - W


def test_collective_matches_the_reference_pair():
    """The reference's own two-process plane (threads) gives the same
    Grams, with the same units quiet on one half only."""
    from repro.parallel.topology import FleetTopology as RefTopology
    from repro.parallel.topology import MemTransport as RefTransport

    rows = _rows(quiet=([4, 5, 6, 7], (2, 9)))
    ours = _pair(rows, QUERIES, lambda topo: HistoryPlane(
        streams=S, d=D, ell=ELL, window=W, topology=topo, device="cpu"))
    transport = RefTransport()
    theirs = {}

    def worker(pid):
        topo = RefTopology(S, num_processes=2, process_id=pid,
                           transport=transport, namespace="r2p",
                           timeout_s=30.0)
        plane = _feed(RefPlane(streams=S, d=D, ell=ELL, window=W,
                               topology=topo), rows, topo.lo, topo.hi)
        theirs[pid] = [plane.query_interval(t1, t2, c)
                       for c, t1, t2 in QUERIES]

    threads = [threading.Thread(target=worker, args=(p,)) for p in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    for pid in (0, 1):
        for got, want in zip(ours[pid][0], theirs[pid]):
            np.testing.assert_allclose(_gram(got.numpy()), _gram(want),
                                       rtol=0, atol=TOL)


def test_history_engine_shards_restore_under_their_partition(tmp_path):
    rows = _rows()
    transport = MemTransport()
    answers = {}
    path = str(tmp_path / "ckpt")

    def engine(topo, **kw):
        return SketchFleetEngine("dsfd", d=D, streams=S, eps=0.25, window=W,
                                 block=BLOCK, history=True, topology=topo,
                                 device="cpu", **kw)

    def worker(pid):
        topo = FleetTopology(S, num_processes=2, process_id=pid,
                             transport=transport, timeout_s=30.0)
        eng = engine(topo)
        for k in range(N // BLOCK):
            blk = rows[topo.lo:topo.hi, k * BLOCK:(k + 1) * BLOCK]
            if blk.any():
                users = np.repeat(np.arange(topo.lo, topo.hi), BLOCK)
                assert eng.submit_many(users, blk.reshape(-1, D)).all()
                eng.step()
            else:
                eng.step(advance_time=True)
        answers[pid] = [eng.query_interval(c, t1, t2)
                        for c, t1, t2 in QUERIES]
        eng.checkpoint(path)

    threads = [threading.Thread(target=worker, args=(p,)) for p in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    np.testing.assert_array_equal(np.stack(answers[0]),
                                  np.stack(answers[1]))
    transport2 = MemTransport()
    again = {}

    def restore(pid):
        topo = FleetTopology(S, num_processes=2, process_id=pid,
                             transport=transport2, timeout_s=30.0)
        eng = SketchFleetEngine.from_checkpoint(path, topology=topo,
                                                device="cpu")
        assert eng.history.lo == topo.lo and eng.S_local == 4
        again[pid] = [eng.query_interval(c, t1, t2)
                      for c, t1, t2 in QUERIES]

    threads = [threading.Thread(target=restore, args=(p,)) for p in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    for pid in (0, 1):
        np.testing.assert_array_equal(np.stack(again[pid]),
                                      np.stack(answers[pid]))
    # another partition is refused: retired history is not resharded
    with pytest.raises(ValueError, match="same stream partition"):
        SketchFleetEngine.from_checkpoint(path, device="cpu")
    with pytest.raises(ValueError, match="same stream partition"):
        SketchFleetEngine.from_checkpoint(
            path, device="cpu", topology=FleetTopology(
                S, num_processes=4, process_id=0, transport=MemTransport()))
    # the slab of a topology plane is its own streams' only
    plane = HistoryPlane(streams=S, d=D, ell=ELL, window=W, device="cpu",
                         topology=FleetTopology(S, num_processes=2,
                                                process_id=0,
                                                transport=MemTransport()))
    with pytest.raises(ValueError, match="S_local=4"):
        plane.observe_block(torch.zeros((S, BLOCK, D)), 1)
