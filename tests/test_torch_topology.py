"""The port's fleet topology (``repro_torch.parallel.topology``) held
against the reference's (``repro.parallel.topology``) on the CPU.

The ports of ``tests/parallel/test_topology.py``: the AggTree-aligned
partition and the ownership lookups equal the reference's, messages
included; the three transports (and ``StoreTransport`` on a one-process
``TCPStore``) round-trip, publish first-write-wins and time out; a
topology fleet has global meta and local shapes.  Collective cohort
queries run under P threads standing in for processes over one
``MemTransport``: bitwise the port's one-process fleet, within 1e-4
absolute of the reference's ``query_cohort`` (f32 Grams with entries
≤ N = 12: the parity contract) on the same state, which is the
reference's carried into the port through ``convert``, and within the
spine budget ``cohorts·(2⌈log₂S⌉ + 2(P − 1))``.  The wire format: each
package's ``unpack_state`` decodes the other's ``pack_state`` bytes.
"""

import datetime
import os
import socket
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.parallel import topology as RT
from repro.sketch import api as RA
from repro.sketch import query as RQ
from repro_torch import convert
from repro_torch.launch import mesh
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.parallel import topology as PT
from repro_torch.sketch import api as PA
from repro_torch.sketch import query as PQ
from repro_torch.tree import leaves, take

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

TOL = 1e-4


def _streams(S, n, d, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S, n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=2, keepdims=True)
    return X


def _topo(S, P, pid, transport, **kw):
    return PT.FleetTopology(S, num_processes=P, process_id=pid,
                            transport=transport, timeout_s=30.0, **kw)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_threads(P, fn):
    """``fn(pid)`` in P threads standing in for processes; their results
    by pid (a worker's exception is raised here)."""
    outs, errs = {}, {}

    def proc(pid):
        try:
            outs[pid] = fn(pid)
        except Exception as e:             # raised after the join
            errs[pid] = e

    threads = [threading.Thread(target=proc, args=(p,)) for p in range(P)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive(), "a thread stand-in hung"
    if errs:
        raise next(iter(errs.values()))
    return outs


def assert_states_equal(a, b, msg=""):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype, msg
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy(),
                                      err_msg=msg)


# ---------------------------------------------------------------------------
# partition_streams and ownership, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", range(1, 9))
def test_partition_streams_matches_the_reference(P):
    for S in range(P, 65):
        assert PT.partition_streams(S, P) == RT.partition_streams(S, P)


@pytest.mark.parametrize("S,P", [(8, 0), (8, 9), (0, 1), (-3, 1)])
def test_partition_rejects_bad_shapes(S, P):
    with pytest.raises(ValueError) as want:
        RT.partition_streams(S, P)
    with pytest.raises(ValueError) as got:
        PT.partition_streams(S, P)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("S,P", [(8, 2), (13, 3), (64, 5)])
def test_ownership_lookups_and_messages_match_the_reference(S, P):
    for pid in range(P):
        p = _topo(S, P, pid, PT.MemTransport())
        r = RT.FleetTopology(S, num_processes=P, process_id=pid,
                             transport=RT.MemTransport())
        assert (p.lo, p.hi, p.local_size, p.ranges) == \
            (r.lo, r.hi, r.local_size, r.ranges)
        assert p.spec() == r.spec() and repr(p) == repr(r)
        for s in range(S):
            assert p.owner_of(s) == r.owner_of(s)
            assert p.is_local(s) == r.is_local(s)
            if r.is_local(s):
                assert p.to_local(s) == r.to_local(s)
                continue
            with pytest.raises(RT.OwnershipError) as want:
                r.to_local(s)
            with pytest.raises(PT.OwnershipError) as got:
                p.to_local(s)
            assert str(got.value) == str(want.value)
        for lo in range(S):
            for hi in range(lo + 1, S + 1):
                assert p.owner_of_range(lo, hi) == r.owner_of_range(lo, hi)
    with pytest.raises(ValueError, match="outside fleet"):
        p.owner_of(S)
    with pytest.raises(ValueError, match="process_id"):
        _topo(S, P, P, PT.MemTransport())


def test_topology_defaults_to_one_process_and_the_store_needs_a_runtime():
    topo = PT.FleetTopology(16)
    assert (topo.P, topo.pid, topo.lo, topo.hi) == (1, 0, 0, 16)
    assert isinstance(topo.transport, PT.MemTransport)
    with pytest.raises(RuntimeError, match="init_distributed"):
        PT.StoreTransport()


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


def _check_transport(tr):
    payload = os.urandom(257)
    tr.publish("ns/v0/t3/000000-000004", payload)
    tr.publish("ns/v0/t3/000000-000004", b"ignored")   # first write wins
    assert tr.fetch("ns/v0/t3/000000-000004", timeout=1.0) == payload
    big = os.urandom(100_000)
    tr.publish("ns/big", big)
    assert tr.fetch("ns/big", timeout=1.0) == big
    with pytest.raises(TimeoutError) as ei:
        tr.fetch("ns/v0/t3/never-published", timeout=0.05)
    assert "collective" in str(ei.value)


@pytest.mark.parametrize("kind", ["mem", "dir"])
def test_transport_roundtrip_idempotent_timeout(tmp_path, kind):
    _check_transport(PT.MemTransport() if kind == "mem"
                     else PT.DirTransport(str(tmp_path)))


def test_store_transport_on_a_single_process_store():
    store = dist.TCPStore("127.0.0.1", _free_port(), 1, True,
                          timeout=datetime.timedelta(seconds=30))
    _check_transport(PT.StoreTransport(store))
    # a second transport on the same store sees the first one's keys, and
    # its publish of a taken key changes nothing
    other = PT.StoreTransport(store)
    first = PT.StoreTransport(store).fetch("ns/big", 1.0)
    other.publish("ns/big", b"late")
    assert other.fetch("ns/big", 1.0) == first


def test_init_distributed_keeps_the_store_for_the_default_transport():
    store = mesh.init_distributed(0, 1, "127.0.0.1", _free_port(),
                                  timeout_s=30)
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert mesh.default_store() is store
        topo = PT.FleetTopology(8)
        assert (topo.P, topo.pid) == (1, 0)
        tr = PT.StoreTransport()
        tr.publish("k", b"v")
        assert store.get("repro-fleet/k") == b"v"
        assert mesh.local_device(topo, "cpu").type == "cpu"
        with pytest.raises(RuntimeError, match="already initialized"):
            mesh.init_distributed(0, 1, "127.0.0.1", _free_port())
    finally:
        mesh.shutdown()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh.default_store()


@pytest.mark.parametrize("env", [None, "3"])
def test_init_distributed_splits_the_host_threads(monkeypatch, env):
    """Unless OMP_NUM_THREADS is set, each process gets an even share of
    the host's cores."""
    if env is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", env)
    cores = len(os.sched_getaffinity(0))
    assert mesh.host_threads(1) == cores
    assert mesh.host_threads(2) == max(1, cores // 2)
    assert mesh.host_threads(4 * cores) == 1
    saved = torch.get_num_threads()
    try:
        torch.set_num_threads(1 + cores)
        mesh.init_distributed(0, 1, "127.0.0.1", _free_port(), timeout_s=30)
        mesh.shutdown()
        assert torch.get_num_threads() == (cores if env is None
                                           else 1 + cores)
    finally:
        mesh.shutdown()
        torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# shard_streams — the one-device fleet and the topology fleet
# ---------------------------------------------------------------------------


def test_shard_streams_refuses_a_multi_process_runtime(monkeypatch):
    sk = PA.make_sketch("dsfd", d=4, eps=0.25, window=8, device="cpu")
    monkeypatch.setattr(PA, "process_runtime", lambda: (2, 0))
    with pytest.raises(ValueError, match="topology"):
        PA.shard_streams(sk, 8)


def test_shard_streams_without_topology_is_the_one_device_fleet(tmp_path):
    sk = PA.make_sketch("dsfd", d=4, eps=0.25, window=8, device="cpu")
    fleet = PA.shard_streams(sk, 8)
    assert fleet.meta["devices"] == 1 and fleet.meta["streams"] == 8
    assert isinstance(PA.agg_tree(fleet), PQ.AggTree)
    PA.save_fleet(str(tmp_path), fleet, fleet.init(), 0)
    from repro_torch.train import checkpoint as ckpt

    manifest = ckpt.read_manifest(str(tmp_path))
    ss = manifest["sketch_spec"]
    assert (ss["sharded"], ss["mesh_axis"], ss["mesh_devices"]) == \
        (True, "streams", 1)
    assert manifest["mesh_shape"] == [1]
    back = RA.restore_fleet(str(tmp_path))           # the reference's too
    assert back.fleet.meta["streams"] == 8


def test_topology_fleet_meta_and_local_shapes():
    S, d = 8, 5
    sk = PA.make_sketch("dsfd", d=d, eps=0.25, window=16, device="cpu")
    topo = _topo(S, 2, 1, PT.MemTransport())
    fleet = PA.shard_streams(sk, S, topology=topo)
    assert fleet.meta["streams"] == S               # global
    assert fleet.meta["local_streams"] == 4
    assert fleet.meta["local_range"] == (4, 8)
    assert fleet.meta["topology"] is topo
    for leaf in leaves(fleet.init()):
        assert leaf.shape[0] == 4                   # local
    assert isinstance(PA.agg_tree(fleet), PT.PartitionedAggTree)
    with pytest.raises(ValueError, match="topology covers"):
        PA.shard_streams(sk, 16, topology=topo)


# ---------------------------------------------------------------------------
# PartitionedAggTree — collective queries
# ---------------------------------------------------------------------------


def _shared_state(S, n, d, N):
    """The reference's fleet after n rows a stream, its state carried into
    the port: (reference sketch, fleet, state, port sketch, state)."""
    rsk = RA.make_sketch("dsfd", d=d, eps=0.25, window=N)
    rfleet = RA.vmap_streams(rsk, S)
    rstate = rfleet.update_block(rfleet.init(),
                                 jnp.asarray(_streams(S, n, d)),
                                 jnp.arange(1, n + 1, dtype=jnp.int32))
    psk = PA.make_sketch("dsfd", d=d, eps=0.25, window=N, device="cpu")
    pstate = convert.fleet_state_from_numpy(
        psk, jax.tree.map(np.asarray, rstate), "cpu")
    return rsk, rfleet, rstate, psk, pstate


@pytest.mark.parametrize("S,P", [(8, 2), (6, 2), (8, 4), (13, 3)])
def test_collective_query_bitwise_the_one_process_fleet(S, P):
    d, n, N = 5, 20, 12
    rsk, rfleet, rstate, psk, pstate = _shared_state(S, n, d, N)
    cohorts = [PQ.ALL, PQ.Cohort.range(1, S - 1), PQ.Cohort.of(0, S - 1)]
    one = PA.fleet_streams(psk, S)
    oracle = [PA.query_cohort(one, pstate, c, n) for c in cohorts]
    transport = PT.MemTransport()

    def proc(pid):
        topo = _topo(S, P, pid, transport, namespace=f"q{S}x{P}")
        fleet = PA.shard_streams(psk, S, topology=topo)
        st = take(pstate, slice(topo.lo, topo.hi))
        answers = [fleet.query_cohort(st, c, n) for c in cohorts]
        return answers, PA.agg_tree(fleet)

    outs = run_threads(P, proc)
    # per query: ≤ 2⌈log₂S⌉ canonical segments, each split at most at the
    # P − 1 ownership boundaries
    budget = len(cohorts) * (2 * int(np.ceil(np.log2(S))) + 2 * (P - 1))
    for pid, (answers, tree) in outs.items():
        for c, got, want in zip(cohorts, answers, oracle):
            assert_states_equal(want, got, msg=f"pid {pid} cohort {c}")
        assert tree.remote_fetches <= budget
        assert tree.spine_merges <= 2 * budget
        assert tree.published > 0 or P == 1
    # and the reference's answers on the same state, by Gram
    for c, got in zip(cohorts, outs[0][0]):
        g_r = RA.query_cohort(rfleet, rstate, RQ.Cohort(c.ranges), n)
        q_r = np.asarray(rsk.query(g_r, n), np.float64)
        q_p = psk.query(got, n)[0].numpy().astype(np.float64)
        np.testing.assert_allclose(q_p.T @ q_p, q_r.T @ q_r, rtol=0,
                                   atol=TOL, err_msg=f"cohort {c}")
        np.testing.assert_array_equal(got.main.nbuf[0].numpy(),
                                      np.asarray(g_r.main.nbuf))


def test_collective_counts_of_the_card_phase_cohorts():
    """The topology phase's four cohorts over S = 256 on two processes
    fetch and merge by the cover and the partition alone: fetches 3 and
    6, spine merges 5 and 5, published 6 and 3, whatever the width."""
    S, d, n = 256, 4, 8
    sk = PA.make_sketch("dsfd", d=d, eps=0.25, window=8, device="cpu")
    one = PA.fleet_streams(sk, S)
    state = one.update_block(one.init(), torch.from_numpy(_streams(S, n, d)),
                             torch.arange(1, n + 1, dtype=torch.int32))
    cohorts = [PQ.ALL, PQ.Cohort.range(64, 192), PQ.Cohort.range(0, 100),
               PQ.Cohort.of(5, 200)]
    oracle = [PA.query_cohort(one, state, c, n) for c in cohorts]
    transport = PT.MemTransport()

    def proc(pid):
        topo = _topo(S, 2, pid, transport, namespace="card-phase")
        fleet = PA.shard_streams(sk, S, topology=topo)
        st = take(state, slice(topo.lo, topo.hi))
        answers = [fleet.query_cohort(st, c, n) for c in cohorts]
        return answers, PA.agg_tree(fleet)

    outs = run_threads(2, proc)
    for pid, (answers, tree) in outs.items():
        for c, got, want in zip(cohorts, answers, oracle):
            assert_states_equal(want, got, msg=f"pid {pid} cohort {c}")
    counts = [(t.remote_fetches, t.spine_merges, t.published)
              for _, t in (outs[0], outs[1])]
    assert counts == [(3, 5, 6), (6, 5, 3)]


def test_collective_query_memoizes_and_detects_unannounced_state():
    S, d, n, N = 8, 4, 10, 8
    sk = PA.make_sketch("dsfd", d=d, eps=0.25, window=N, device="cpu")
    fleet = PA.shard_streams(sk, S, topology=_topo(S, 1, 0,
                                                  PT.MemTransport()))
    X = torch.from_numpy(_streams(S, n, d))
    ts = torch.arange(1, n + 1, dtype=torch.int32)
    st = fleet.update_block(fleet.init(), X, ts)
    tree = PA.agg_tree(fleet)
    a = fleet.query_cohort(st, PQ.ALL, n)
    m0 = tree.merges
    b = fleet.query_cohort(st, PQ.ALL, n)             # the result memo
    assert tree.merges == m0 and b is a
    st2 = fleet.update_block(st, X, ts + n)           # not announced
    fleet.query_cohort(st2, PQ.ALL, 2 * n)
    assert tree.resets == 1 and tree.version == 1     # sound, never stale
    tree.advance(st2, None)
    assert tree.version == 2 and tree.cached_nodes == 0


def test_collective_advance_keeps_version_in_lockstep():
    S, d, n, N = 8, 4, 8, 8
    sk = PA.make_sketch("dsfd", d=d, eps=0.25, window=N, device="cpu")
    transport = PT.MemTransport()
    X = torch.from_numpy(_streams(S, n + 4, d))
    one = PA.fleet_streams(sk, S)
    full = one.update_block(one.init(), X[:, :n],
                            torch.arange(1, n + 1, dtype=torch.int32))
    want1 = PA.query_cohort(one, full, PQ.ALL, n)

    def proc(pid):
        topo = _topo(S, 2, pid, transport, namespace="adv")
        fleet = PA.shard_streams(sk, S, topology=topo)
        tree = PA.agg_tree(fleet)
        st = fleet.update_block(fleet.init(), X[topo.lo:topo.hi, :n],
                                torch.arange(1, n + 1, dtype=torch.int32))
        tree.advance(st, None)
        a1 = fleet.query_cohort(st, PQ.ALL, n)
        st = fleet.update_block(st, X[topo.lo:topo.hi, n:],
                                torch.arange(n + 1, n + 5,
                                             dtype=torch.int32))
        tree.advance(st, [0])
        a2 = fleet.query_cohort(st, PQ.Cohort.range(2, 7), n + 4)
        return a1, a2, tree.version

    outs = run_threads(2, proc)
    assert_states_equal(outs[0][0], outs[1][0])
    assert_states_equal(outs[0][1], outs[1][1])
    assert_states_equal(want1, outs[0][0])
    assert outs[0][2] == outs[1][2] == 2


def test_collective_query_times_out_when_a_process_skips_it():
    S, d = 8, 4
    sk = PA.make_sketch("dsfd", d=d, eps=0.25, window=8, device="cpu")
    topo = PT.FleetTopology(S, num_processes=2, process_id=0,
                            transport=PT.MemTransport(), timeout_s=0.2)
    fleet = PA.shard_streams(sk, S, topology=topo)
    with pytest.raises(TimeoutError, match="collectives"):
        fleet.query_cohort(fleet.init(), PQ.ALL, 1)


# ---------------------------------------------------------------------------
# The wire format, across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,hyper", [("dsfd", {}),
                                        ("time-dsfd", {"R": 4.0})])
def test_wire_format_crosses_packages(name, hyper):
    S, d, n, N = 4, 5, 16, 12
    rsk = RA.make_sketch(name, d=d, eps=0.25, window=N, **hyper)
    rfleet = RA.vmap_streams(rsk, S)
    rstate = rfleet.update_block(rfleet.init(),
                                 jnp.asarray(_streams(S, n, d)),
                                 jnp.arange(1, n + 1, dtype=jnp.int32))
    rnode = RA.query_cohort(rfleet, rstate, RQ.ALL, n)
    psk = PA.make_sketch(name, d=d, eps=0.25, window=N, device="cpu",
                         **hyper)
    pstate = convert.fleet_state_from_numpy(
        psk, jax.tree.map(np.asarray, rstate), "cpu")
    pnode = PA.query_cohort(PA.fleet_streams(psk, S), pstate, PQ.ALL, n)
    template = jax.eval_shape(lambda: rsk.init())
    # the reference decodes the port's bytes of its node, leaf for leaf
    back = RT.unpack_state(PT.pack_state(psk, pnode), template)
    want = [x[0] for x in leaves(convert.fleet_state_to_numpy(psk, pnode))]
    got = jax.tree.leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)
    # and the port decodes the reference's bytes of its node
    mine = PT.unpack_state(RT.pack_state(rnode), psk, device="cpu")
    for g, w in zip(leaves(convert.fleet_state_to_numpy(psk, mine)),
                    jax.tree.leaves(rnode)):
        np.testing.assert_array_equal(g[0], np.asarray(w))
    # a node of another configuration is refused
    other = PA.make_sketch(name, d=d + 1, eps=0.25, window=N, device="cpu",
                           **hyper)
    with pytest.raises(ValueError, match="config skew"):
        PT.unpack_state(PT.pack_state(psk, pnode), other, device="cpu")
