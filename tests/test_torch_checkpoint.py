"""Checkpoints of the port (``repro_torch.train.checkpoint``,
``sketch.api.save_fleet`` / ``restore_fleet`` and the engine's
``checkpoint`` / ``from_checkpoint``) on the CPU at small size.

The format's robustness cases are the reference's
(``tests/train/test_checkpoint_robustness.py``) run against the port's
module, and its layout is the reference's byte for byte: the same tree
saved by both packages gives the same manifest paths, dtypes and leaf
files.  Within the port a fleet or engine round trip is exact.  Across
the packages a checkpoint written by either restores in the other: the
clock, ``rows_ingested`` and the pending rows match exactly, and the
queries' Grams BᵀB agree within 1e-4 (SVD rows differ in sign between
torch and JAX), also after a few more ticks on both sides.
"""

import json
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import SketchFleetEngine as RefEngine
from repro.sketch import api as RA
from repro.train import checkpoint as rckpt
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.parallel.topology import FleetTopology, MemTransport
from repro_torch.serve.engine import SketchFleetEngine
from repro_torch.sketch import api as PA
from repro_torch.sketch.query import Cohort
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import leaves

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

TOL = 1e-4


def _tree(scale=1.0):
    return {"w": torch.arange(6.0).reshape(2, 3) * scale,
            "b": torch.ones((4,), dtype=torch.float32) * scale}


def _restore(d, **kw):
    return ckpt.restore(d, _tree(), device="cpu", **kw)


# ---------------------------------------------------------------------------
# The format: the reference's robustness cases against the port's module
# ---------------------------------------------------------------------------


def test_latest_step_ignores_stray_entries(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 7, _tree())
    os.mkdir(os.path.join(d, "step_final"))
    open(os.path.join(d, "step_notes.txt"), "w").close()
    open(os.path.join(d, "step_0001.bak"), "w").close()
    assert ckpt.latest_step(d) == 7
    _, manifest = _restore(d)
    assert manifest["step"] == 7
    ckpt.save(d, 8, _tree(2.0))
    assert ckpt.latest_step(d) == 8


def test_retain_keep_zero_deletes_everything(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        ckpt.save(d, s, _tree(), keep=10)
    assert ckpt.latest_step(d) == 3
    ckpt._retain(d, 0)
    assert ckpt.latest_step(d) is None


def test_save_with_keep_zero_never_self_destructs(tmp_path):
    d = str(tmp_path)
    path = ckpt.save(d, 1, _tree(), keep=0)
    assert os.path.isdir(path)
    assert ckpt.latest_step(d) == 1


def test_save_below_stale_newer_steps_survives_retention(tmp_path):
    d = str(tmp_path)
    for s in (200, 300, 400):
        ckpt.save(d, s, _tree())
    path = ckpt.save(d, 110, _tree(5.0), keep=3)
    assert os.path.isdir(path)
    got, _ = _restore(d, step=110)
    assert torch.equal(got["b"], torch.ones(4) * 5.0)


def test_retain_keeps_newest_n(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, _tree(), keep=2)
    assert [s for s, _ in ckpt._step_entries(d)] == [3, 4]


def test_resave_existing_step_takes_new_data(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 5, _tree(1.0))
    ckpt.save(d, 5, _tree(3.0))
    got, _ = _restore(d)
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3) * 3.0)
    assert not [p for p in os.listdir(d)
                if p.startswith(".tmp") or p.startswith(".old")]


def test_resave_crash_window_never_loses_both_copies(tmp_path, monkeypatch):
    d = str(tmp_path)
    ckpt.save(d, 5, _tree(1.0))
    calls = {"n": 0}
    real_replace = os.replace

    def crashy_replace(src, dst):
        calls["n"] += 1
        if calls["n"] == 2:            # the tmp → final rename
            raise OSError("simulated crash mid-resave")
        return real_replace(src, dst)

    monkeypatch.setattr(ckpt.os, "replace", crashy_replace)
    with pytest.raises(OSError, match="simulated crash"):
        ckpt.save(d, 5, _tree(9.0))
    monkeypatch.undo()
    complete = []
    for entry in os.listdir(d):
        mpath = os.path.join(d, entry, "manifest.json")
        if os.path.isfile(mpath):
            with open(mpath) as f:
                complete.append((entry, json.load(f)["step"]))
    kinds = {e.split("-")[0] for e, _ in complete}
    assert ".old" in kinds and ".tmp" in kinds, complete
    assert all(s == 5 for _, s in complete)
    ckpt.save(d, 5, _tree(7.0))
    got, _ = _restore(d)
    assert torch.equal(got["b"], torch.ones(4) * 7.0)


def _dead_pid() -> int:
    proc = subprocess.Popen(["sleep", "0"])
    proc.wait()
    return proc.pid


def test_save_sweeps_dead_pid_intermediates(tmp_path):
    d = str(tmp_path)
    dead = os.path.join(d, f".tmp-{_dead_pid()}-3")
    os.makedirs(dead)
    open(os.path.join(dead, "leaf_000000.npy"), "w").close()
    live = os.path.join(d, f".old-{os.getpid()}-4-0")
    os.makedirs(live)
    ckpt.save(d, 1, _tree())
    assert not os.path.exists(dead)
    assert os.path.exists(live)          # our own pid is alive


def test_sweep_rescues_complete_orphans_after_crash(tmp_path):
    pid = _dead_pid()
    d = str(tmp_path / "ck")
    os.makedirs(d)
    for scale, junk in ((1.0, f".old-{pid}-5-0"), (2.0, f".tmp-{pid}-5")):
        src = ckpt.save(str(tmp_path / f"scratch{scale}"), 5, _tree(scale))
        shutil.copytree(src, os.path.join(d, junk))
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 9, _tree())                     # triggers the sweep
    got, _ = _restore(d, step=5)                 # the newer (.tmp) copy
    assert torch.equal(got["b"], torch.ones(4) * 2.0)
    assert not [p for p in os.listdir(d)
                if p.startswith(".tmp") or p.startswith(".old")]


def _mark(path):
    os.makedirs(path, exist_ok=True)
    open(os.path.join(path, ckpt.HISTORY_MARKER), "w").close()


def test_retain_never_prunes_marked_history_dirs(tmp_path):
    d = str(tmp_path)
    hist = os.path.join(d, "step_000000001")     # worst case: step-shaped
    _mark(hist)
    sentinel = os.path.join(hist, "leaf_000000.npy")
    open(sentinel, "w").close()
    for s in (10, 11, 12):
        ckpt.save(d, s, _tree(), keep=1)
    assert os.path.isfile(sentinel)
    assert ckpt.latest_step(d) == 12
    assert [s for s, _ in ckpt._step_entries(d)] == [12]
    ckpt._retain(d, 0)
    assert os.path.isfile(sentinel)


def test_save_refuses_to_displace_history_dir(tmp_path):
    d = str(tmp_path)
    _mark(os.path.join(d, "step_000000002"))
    with pytest.raises(ValueError, match="history spill directory"):
        ckpt.save(d, 2, _tree())
    assert os.path.isfile(
        os.path.join(d, "step_000000002", ckpt.HISTORY_MARKER))
    assert not [p for p in os.listdir(d)
                if p.startswith(".tmp") or p.startswith(".old")]
    ckpt.save(d, 3, _tree())
    assert ckpt.latest_step(d) == 3


def test_sweep_skips_marked_junk_but_reclaims_unmarked(tmp_path):
    d = str(tmp_path)
    pid = _dead_pid()
    marked = os.path.join(d, f".old-{pid}-1-0")
    _mark(marked)
    unmarked = os.path.join(d, f".tmp-{pid}-2")
    os.makedirs(unmarked)
    ckpt.save(d, 1, _tree())
    assert os.path.isdir(marked)
    assert not os.path.exists(unmarked)


def test_realistic_spill_layout_survives_checkpointing(tmp_path):
    d = str(tmp_path)
    spill = os.path.join(d, "history")
    _mark(spill)
    for node in ("node_00_00000011", "node_01_00000003"):
        nd = os.path.join(spill, node)
        _mark(nd)
        ckpt.save(nd, 0, {"per_stream": _tree()["w"]}, keep=1)
    before = sorted(os.path.join(r, f)
                    for r, _, fs in os.walk(spill) for f in fs)
    for s in (1, 2, 3):
        ckpt.save(d, s, _tree(), keep=1)
    after = sorted(os.path.join(r, f)
                   for r, _, fs in os.walk(spill) for f in fs)
    assert before == after
    got, _ = ckpt.restore(os.path.join(spill, "node_00_00000011"),
                          {"per_stream": 0}, device="cpu")
    assert torch.equal(got["per_stream"], torch.arange(6.0).reshape(2, 3))


def test_sketch_spec_section_round_trips(tmp_path):
    d = str(tmp_path)
    spec = {"sketch": {"name": "dsfd", "d": 8, "eps": 0.25, "window": 32,
                       "hyper": {"mode": "fast"}},
            "streams": 16, "t": 123}
    ckpt.save(d, 123, _tree(), sketch_spec=spec)
    assert ckpt.read_manifest(d)["sketch_spec"] == spec
    ckpt.save(d, 124, _tree())
    assert ckpt.read_manifest(d)["sketch_spec"] is None
    assert ckpt.read_manifest(d, step=123)["sketch_spec"] == spec


# ---------------------------------------------------------------------------
# The layout against the reference's, and the port's own additions
# ---------------------------------------------------------------------------


def _nested(lib):
    """One tree with every container kind, built of numpy leaves."""
    from repro.core.dsfd import DSFDState, SketchState

    rng = np.random.default_rng(0)
    sk = SketchState(*(rng.normal(size=(3, 2)).astype(np.float32)
                       if i % 2 else np.arange(3, dtype=np.int32) + i
                       for i in range(12)))
    st = DSFDState(sk, sk._replace(snap_valid=np.array([True, False])))
    return {"z": [np.float64(1.5), (np.int64(2), st)], "a": {"y": None,
                                                               "x": 5},
            "m": lib(np.arange(4, dtype=np.int64))}


def test_layout_equals_the_reference_byte_for_byte(tmp_path):
    """Saved by both packages, one tree gives the same manifest paths,
    dtypes and shapes and byte-identical leaf files; each restores the
    other's."""
    pa, ra = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(pa, 3, _nested(torch.from_numpy))
    rckpt.save(ra, 3, _nested(np.asarray))
    mp, mr = ckpt.read_manifest(pa), rckpt.read_manifest(ra)
    for key in ("paths", "dtypes", "shapes", "format", "step"):
        assert mp[key] == mr[key], key
    assert mp["paths"][:3] == ["['a']['x']", "['m']", "['z'][0]"]
    assert "['z'][1][1].aux.snap_valid" in mp["paths"]
    for i in range(len(mp["paths"])):
        name = f"step_000000003/leaf_{i:06d}.npy"
        with open(os.path.join(pa, name), "rb") as f, \
                open(os.path.join(ra, name), "rb") as g:
            assert f.read() == g.read(), mp["paths"][i]
    got, _ = ckpt.restore(ra, _nested(np.asarray), device="cpu")
    assert got["z"][1][1].aux.snap_valid.dtype == torch.bool
    assert torch.equal(got["m"], torch.arange(4))
    back, _ = rckpt.restore(pa, _nested(np.asarray),
                            host_leaves=lambda p: True)
    np.testing.assert_array_equal(back["z"][1][1].main.buf,
                                  _nested(np.asarray)["z"][1][1].main.buf)
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore(pa, {"w": 0}, device="cpu")


def test_bf16_round_trips_as_its_bit_pattern(tmp_path):
    x = torch.tensor([1.5, -2.25, 3e-3, 65504.0], dtype=torch.bfloat16)
    ckpt.save(str(tmp_path), 1, {"x": x, "f": x.float()})
    m = ckpt.read_manifest(str(tmp_path))
    assert m["dtypes"] == ["float32", "bfloat16"]
    raw = np.load(tmp_path / "step_000000001" / "leaf_000001.npy")
    assert raw.dtype == np.uint16
    got, _ = ckpt.restore(str(tmp_path), {"x": 0, "f": 0}, device="cpu")
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], x)


def test_host_leaves_and_async_checkpointer(tmp_path):
    d = str(tmp_path)
    acc = np.array([1.0 + 2 ** -40, 3.0])        # lost in float32
    saver = ckpt.AsyncCheckpointer(d, keep=2)
    tree = {"aux": {"acc": acc, "n": np.int64(2 ** 40)}, "w": _tree()["w"]}
    saver.save(4, tree)
    tree["w"] += 1                               # after the host copy
    saver.save(5, tree)
    saver.wait()
    assert saver.last_path.endswith("step_000000005")
    got, m = ckpt.restore(d, tree, step=4, device="cpu",
                          host_leaves=lambda p: p.startswith("['aux']"))
    assert isinstance(got["aux"]["acc"], np.ndarray)
    assert got["aux"]["acc"].dtype == np.float64
    np.testing.assert_array_equal(got["aux"]["acc"], acc)
    assert int(got["aux"]["n"]) == 2 ** 40
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert m["paths"] == ["['aux']['acc']", "['aux']['n']", "['w']"]


# ---------------------------------------------------------------------------
# Fleet round trips within the port, every variant
# ---------------------------------------------------------------------------

S, D, N, BLOCK = 4, 8, 16, 4
VARIANTS = [("fd", {}), ("fd", {"adapt_target": 0.05}),
            ("dsfd", {"mode": "fast"}), ("dsfd", {"mode": "exact"}),
            ("dsfd", {"mode": "krylov"}),
            ("dsfd", {"mode": "krylov", "use_kernel": False}),
            ("seq-dsfd", {"R": 4.0}), ("time-dsfd", {"R": 4.0})]


def _rows(n, seed=11, S=S, scale=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S, n, D)).astype(np.float32)
    X /= np.linalg.norm(X, axis=2, keepdims=True)
    if scale:                                    # ‖a‖² ∈ [1, 4]
        X *= np.sqrt(rng.uniform(1, 4, (S, n, 1))).astype(np.float32)
    return X


@pytest.mark.parametrize("name,hyper", VARIANTS,
                         ids=[f"{n}-{'-'.join(map(str, h.values()))}"
                              for n, h in VARIANTS])
def test_fleet_round_trip_exact(tmp_path, name, hyper):
    sk = PA.make_sketch(name, d=D, eps=0.25, window=N, device="cpu", **hyper)
    fleet = PA.fleet_streams(sk, S)
    n = 40
    ts = torch.arange(1, n + 1, dtype=torch.int32)
    state = fleet.update_block(fleet.init(), torch.from_numpy(_rows(n)), ts)
    aux = {"acc": np.array([1.0 + 2 ** -40]), "ids": np.arange(3)}
    PA.save_fleet(str(tmp_path), fleet, state, n, aux=aux)
    fc = PA.restore_fleet(str(tmp_path), device="cpu")
    assert fc.t == n and fc.fleet.meta["streams"] == S
    if name == "dsfd":           # use_kernel is recorded as in force
        assert fc.fleet.meta["cfg"] == sk.meta["cfg"]
    else:
        assert fc.fleet.meta["base"].meta["spec"] == sk.meta["spec"]
    for a, b in zip(leaves(state), leaves(fc.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k, v in aux.items():
        assert fc.aux[k].dtype == v.dtype
        np.testing.assert_array_equal(fc.aux[k], v)
    more = torch.from_numpy(_rows(8, seed=5))
    ts2 = torch.arange(n + 1, n + 9, dtype=torch.int32)
    a = fleet.query(fleet.update_block(state, more, ts2), n + 8)
    b = fc.fleet.query(fc.fleet.update_block(fc.state, more, ts2), n + 8)
    assert torch.equal(a, b)


def test_spec_names_use_pallas_and_never_the_device(tmp_path):
    """``use_kernel`` is written as the reference's ``use_pallas`` (DS-FD
    records the value in force), and read back either way."""
    for hyper, want in (({}, True), ({"use_kernel": False}, False)):
        sk = PA.make_sketch("dsfd", d=D, eps=0.25, window=N, device="cpu",
                            mode="krylov", **hyper)
        fleet = PA.fleet_streams(sk, 2)
        path = str(tmp_path / str(want))
        PA.save_fleet(path, fleet, fleet.init(), 0)
        spec = ckpt.read_manifest(path)["sketch_spec"]
        assert spec["sketch"]["hyper"] == {"mode": "krylov",
                                           "use_pallas": want}
        assert "device" not in json.dumps(spec["sketch"])
        assert (spec["sharded"], spec["mesh_axis"],
                spec["mesh_devices"]) == (False, None, None)
        fc = PA.restore_fleet(path, device="cpu")
        assert fc.fleet.meta["cfg"].use_kernel is want
        ref = RA.restore_fleet(path)
        assert ref.fleet.meta["base"].meta["cfg"].use_pallas is want


def test_save_fleet_rejects_non_fleets_and_shards(tmp_path):
    sk = PA.make_sketch("dsfd", d=4, eps=0.25, window=8, device="cpu")
    with pytest.raises(ValueError, match="fleet_streams"):
        PA.save_fleet(str(tmp_path), sk, sk.init(), 0)
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="sketch_spec"):
        PA.restore_fleet(str(tmp_path), device="cpu")
    # a shard directory that holds no checkpoint, and a topology over a
    # checkpoint that is not a fleet's
    os.makedirs(tmp_path / "shards" / "shard-000000-000002")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        PA.restore_fleet(str(tmp_path / "shards"), device="cpu")
    topo = FleetTopology(4, num_processes=2, process_id=0,
                         transport=MemTransport())
    with pytest.raises(ValueError, match="sketch_spec"):
        PA.restore_fleet(str(tmp_path), device="cpu", topology=topo)


# ---------------------------------------------------------------------------
# Cross-loading: each package restores the other's fleet checkpoints
# ---------------------------------------------------------------------------

CROSS = [("fd", {}), ("dsfd", {"mode": "fast"}), ("time-dsfd", {"R": 4.0})]


def _gram(b):
    b = np.asarray(b, np.float64)
    return b.T @ b


def _close(a, b):
    np.testing.assert_allclose(_gram(a), _gram(b), rtol=0, atol=TOL)


def _ref_numpy(state):
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("name,hyper", CROSS, ids=[n for n, _ in CROSS])
@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_fleet_cross_load(tmp_path, name, hyper, direction):
    n, t_more = 40, 8
    X = _rows(n + t_more)
    rsk = RA.make_sketch(name, d=D, eps=0.25, window=N, **hyper)
    rfleet = RA.vmap_streams(rsk, S)
    psk = PA.make_sketch(name, d=D, eps=0.25, window=N, device="cpu",
                         **hyper)
    pfleet = PA.fleet_streams(psk, S)
    ts = np.arange(1, n + 1, dtype=np.int32)
    aux = {"rows": X[0, :3], "acc": np.array([2.0 ** 40 + 1], np.int64)}
    if direction == "ref-to-port":
        rstate = rfleet.update_block(rfleet.init(), jnp.asarray(X[:, :n]),
                                     jnp.asarray(ts))
        RA.save_fleet(str(tmp_path), rfleet, rstate, n, aux=aux)
        fc = PA.restore_fleet(str(tmp_path), device="cpu")
        pstate, t = fc.state, fc.t
        got_aux = fc.aux
    else:
        pstate = pfleet.update_block(pfleet.init(),
                                     torch.from_numpy(X[:, :n]),
                                     torch.from_numpy(ts))
        PA.save_fleet(str(tmp_path), pfleet, pstate, n, aux=aux)
        fc = RA.restore_fleet(str(tmp_path))
        rstate, t = fc.state, fc.t
        got_aux = fc.aux
    assert t == n
    for k, v in aux.items():
        assert got_aux[k].dtype == v.dtype
        np.testing.assert_array_equal(got_aux[k], v)
    # the saved state itself, leaf by leaf
    for a, b in zip(jax.tree.leaves(_ref_numpy(rstate)), leaves(pstate)):
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())
    # both go on: the same rows at the same clock, Grams within TOL
    ts2 = np.arange(n + 1, n + t_more + 1, dtype=np.int32)
    rstate = rfleet.update_block(rstate, jnp.asarray(X[:, n:]),
                                 jnp.asarray(ts2))
    pstate = pfleet.update_block(pstate, torch.from_numpy(X[:, n:]),
                                 torch.from_numpy(ts2))
    rq = np.asarray(rfleet.query(rstate, n + t_more))
    pq = pfleet.query(pstate, n + t_more).numpy()
    for s in range(S):
        _close(pq[s], rq[s])
    # and the integer bookkeeping exactly
    for a, b in zip(jax.tree.leaves(_ref_numpy(rstate)), leaves(pstate)):
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b.numpy())


def test_reference_sharded_checkpoint_restores_in_the_port(tmp_path):
    rsk = RA.make_sketch("dsfd", d=D, eps=0.25, window=N)
    rfleet = RA.shard_streams(rsk, S)
    X = _rows(24, scale=False)
    rstate = rfleet.update_block(rfleet.init(), jnp.asarray(X),
                                 jnp.arange(1, 25, dtype=jnp.int32))
    RA.save_fleet(str(tmp_path), rfleet, rstate, 24)
    assert ckpt.read_manifest(str(tmp_path))["sketch_spec"]["sharded"]
    fc = PA.restore_fleet(str(tmp_path), device="cpu")
    for a, b in zip(jax.tree.leaves(_ref_numpy(rstate)), leaves(fc.state)):
        np.testing.assert_array_equal(a, b.numpy())
    pq = fc.fleet.query(fc.state, 24).numpy()
    rq = np.asarray(rfleet.query(rstate, 24))
    for s in range(S):
        _close(pq[s], rq[s])


# ---------------------------------------------------------------------------
# Engines: kill and resume, warm caches, cross-loading
# ---------------------------------------------------------------------------


def _feed(eng, X, lo, hi):
    users = np.repeat(np.arange(X.shape[0]), hi - lo)
    assert eng.submit_many(users, X[:, lo:hi].reshape(-1, D)).all()


def _port_engine(**kw):
    args = dict(d=D, streams=S, eps=0.25, window=N, block=BLOCK,
                device="cpu")
    args.update(kw)
    return SketchFleetEngine("dsfd", **args)


@pytest.mark.parametrize("ingest", ["async", "sync"])
def test_engine_kill_and_resume_bitwise(tmp_path, ingest):
    """Checkpointed with one tick's rows staged (async) and more queued,
    killed, restored: draining both engines gives bit-identical answers."""
    X = _rows(40, seed=9)

    def run(eng, ticks):
        _feed(eng, X, 0, 8)                      # one tick ahead, as served
        for k in range(ticks):
            if 8 + 4 * k + 4 <= 40:
                _feed(eng, X, 8 + 4 * k, 8 + 4 * k + 4)
            eng.step()
        return eng

    oracle = run(_port_engine(ingest=ingest), 3)
    victim = run(_port_engine(ingest=ingest), 3)
    if ingest == "async":
        assert victim.pipe.staged_rows > 0
    assert victim.queue.backlog > 0
    backlog = victim.backlog
    victim.checkpoint(str(tmp_path))
    assert victim.backlog == backlog and victim.pipe.staged_rows == 0
    del victim
    resumed = SketchFleetEngine.from_checkpoint(str(tmp_path), device="cpu")
    assert (resumed.t, resumed.rows_ingested, resumed.backlog,
            resumed.ingest) == (oracle.t, oracle.rows_ingested,
                                oracle.backlog, ingest)
    oracle.run()
    resumed.run()
    assert resumed.t == oracle.t
    for u in range(S):
        np.testing.assert_array_equal(oracle.query_user(u),
                                      resumed.query_user(u))
    np.testing.assert_array_equal(oracle.query_global(),
                                  resumed.query_global())


def test_queue_snapshot_push_front_and_flush():
    from repro_torch.serve.ingest import AdmissionQueue, SlabTransfer, \
        make_pipeline

    q = AdmissionQueue(3, 2, capacity=8)
    rows = np.arange(12, dtype=np.float32).reshape(6, 2)
    assert q.submit_many(np.array([0, 2, 0, 1, 2, 0]), rows).all()
    pipe = make_pipeline("async", q, block=2, transfer=SlabTransfer("cpu"))
    pipe.after_dispatch()                        # stage the first slab
    assert pipe.staged_rows == 5 and q.backlog == 1 and q.reserved == 5
    assert q.live_users() == [0]
    assert [u for u, _ in pipe.staged_snapshot()] == [0, 1, 2]
    pipe.flush_to_queue()
    assert (pipe.staged_rows, q.reserved, q.backlog) == (0, 0, 6)
    assert q.live_users() == [0, 1, 2]
    users, got = q.snapshot()
    np.testing.assert_array_equal(users, [0, 0, 0, 1, 2, 2])
    np.testing.assert_array_equal(got, rows[[0, 2, 5, 3, 1, 4]])
    assert [len(x) for x in q.queues] == [3, 1, 2]
    q2 = AdmissionQueue(3, 2)
    q2.load(users, got)
    q2.push_front(1, [np.full(2, -1.0, np.float32)])
    u2, r2 = q2.snapshot()
    np.testing.assert_array_equal(u2, [0, 0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(r2[3], [-1.0, -1.0])


def test_engine_checkpoint_keeps_warm_tree_and_score_accumulators(tmp_path):
    """The warm ``AggTree`` nodes come back (the restored engine's first
    queries merge nothing new) and the score plane's float64/int64
    accumulators survive bit for bit."""
    eng = _port_engine(streams=6, score=True, score_warmup=1)
    X = _rows(16, seed=21, S=6)
    _feed(eng, X, 0, 16)
    eng.run()
    eng.score_plane.mean[0] += 2.0 ** -40        # not a float32
    q_all = eng.query_global()
    q_coh = eng.query_cohort(Cohort.range(1, 5))
    assert eng.tree.cached_nodes > 0
    eng.checkpoint(str(tmp_path))
    res = SketchFleetEngine.from_checkpoint(str(tmp_path), device="cpu")
    assert res.tree.cached_nodes == eng.tree.cached_nodes
    np.testing.assert_array_equal(res.query_global(), q_all)
    assert res.tree.merges == 0
    np.testing.assert_array_equal(res.query_cohort(Cohort.range(1, 5)),
                                  q_coh)
    for k, v in eng.score_plane.state_dict().items():
        got = res.score_plane.state_dict()[k]
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)
    assert res.score_plane.spec() == eng.score_plane.spec()
    aux = ckpt.read_manifest(str(tmp_path))["sketch_spec"]["aux_keys"]
    assert "score_mean_00000000_00000006" in aux
    assert any(k.startswith("aggnode_000000_000006_") for k in aux)


def test_engine_rejects_bare_fleet_and_agg_tree_mismatch_is_cold(tmp_path):
    sk = PA.make_sketch("dsfd", d=4, eps=0.25, window=8, device="cpu")
    fleet = PA.fleet_streams(sk, 2)
    PA.save_fleet(str(tmp_path / "bare"), fleet, fleet.init(), 0)
    with pytest.raises(ValueError, match="no engine"):
        SketchFleetEngine.from_checkpoint(str(tmp_path / "bare"),
                                          device="cpu")
    eng = _port_engine()
    _feed(eng, _rows(8), 0, 8)
    eng.run()
    eng.query_global()
    meta, arrays = eng.tree.state_dict(t=eng.t)
    assert eng.tree.load_state_dict(meta, arrays, eng.state)
    bad = dict(arrays)
    bad[next(iter(bad))] = bad[next(iter(bad))].astype(np.float64)
    assert not eng.tree.load_state_dict(meta, bad, eng.state)
    assert eng.tree.cached_nodes == 0
    assert not eng.tree.load_state_dict(dict(meta, n_leaves=3), arrays,
                                        eng.state)


def _ref_engine(**kw):
    args = dict(d=D, streams=S, eps=0.25, window=N, block=BLOCK)
    args.update(kw)
    return RefEngine("dsfd", **args)


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_engine_cross_load(tmp_path, direction):
    """An engine checkpoint of either package, with rows pending, a warm
    tree and a score plane, restores in the other: the clock, the
    ingested rows, the pending rows and the accumulators exactly, the
    answers within TOL, also after both drain the same further rows."""
    X = _rows(24, seed=4, scale=False)
    make = _ref_engine if direction == "ref-to-port" else _port_engine
    src = make(score=True, score_warmup=1, mode="fast")
    _feed(src, X, 0, 12)
    src.step()
    src.step()
    src.query_global()
    src.checkpoint(str(tmp_path))
    if direction == "ref-to-port":
        dst = SketchFleetEngine.from_checkpoint(str(tmp_path), device="cpu")
    else:
        dst = RefEngine.from_checkpoint(str(tmp_path))
    assert (dst.t, dst.rows_ingested, dst.backlog) == (
        src.t, src.rows_ingested, src.backlog)
    assert dst.tree.cached_nodes == src.tree.cached_nodes > 0
    qs = [np.asarray(q) for q in src.queue.queues]
    qd = [np.asarray(q) for q in dst.queue.queues]
    for a, b in zip(qs, qd):
        np.testing.assert_array_equal(a, b)
    for k, v in src.score_plane.state_dict().items():
        np.testing.assert_array_equal(dst.score_plane.state_dict()[k], v)
    _close(dst.query_global(), src.query_global())
    for eng in (src, dst):
        _feed(eng, X, 12, 24)
        eng.run()
    assert dst.t == src.t and dst.rows_ingested == src.rows_ingested
    for u in range(S):
        _close(dst.query_user(u), src.query_user(u))
    _close(dst.query_global(), src.query_global())
    np.testing.assert_array_equal(dst.anomalies(), src.anomalies())
