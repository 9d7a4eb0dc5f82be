"""The port on the card: the CUDA kernels against their plain versions,
the krylov engine through them (the fused kernels at ε = 1/4, the split
route's kernels at ε = 1/128), the dense serving path through the
flash kernel against the same engine on the CPU, the MoE block and a
reduced MoE serving engine against the CPU, the reduced VLM, SSM and
hybrid models against the CPU (the VLM's prefill also through the flash
kernel at head_dim 128), the history plane on
the card against the CPU, checkpoints that cross between card and CPU,
the async pipeline's unwind with a copy in flight, and a fleet across two
processes that share the card.

Every test here needs an NVIDIA card (the kernels have no CPU or
interpret mode) and skips without one.  The file imports neither JAX nor
the reference, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: kernel and plain version run the same float32 arithmetic in
another summation order (~1e-6 at unit-scale inputs), hence 1e-4.  The
flash kernel's bf16 output is one bf16 rounding from the plain version's
(~4e-3 relative at unit scale), hence 2e-2 there; lse stays f32, 1e-3.
The unfused kernels' bf16 outputs take the reference tests' tolerances
(2e-2; the window Gram 5e-2 relative, 5e-1 absolute).
"""

import dataclasses
import os


import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import dsfd
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn import ref as flash_ref
from repro_torch.kernels.fused_tick import kernel, ops, ref
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.power_iter import kernel as power_kernel
from repro_torch.kernels.power_iter import ops as power_ops
from repro_torch.kernels.power_iter import ref as power_ref
from repro_torch.kernels.rank1_downdate import kernel as downdate_kernel
from repro_torch.kernels.rank1_downdate import ops as downdate_ops
from repro_torch.kernels.rank1_downdate import ref as downdate_ref
from repro_torch.kernels.window_gram import kernel as wgram_kernel
from repro_torch.kernels.window_gram import ops as wgram_ops
from repro_torch.kernels.window_gram import ref as wgram_ref
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.models.params import init_params
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine, \
    SketchFleetEngine

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU or "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit_slab(S, m, d, seed, device):
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(S, m, d)).astype(np.float32)
    D /= np.linalg.norm(D, axis=2, keepdims=True)
    return torch.from_numpy(D).to(device)


# the fused kernels' shapes: the krylov path's m at 64 streams, the
# median streams of its step launches (11) and past one wave of CTAs
# (2048); unaligned and tiny; and the route's edges, where the kernels'
# own layouts are tightest: the largest fused m at d = 300 and 317, m and
# d past a 4-row block (rows past 128: more than 8 rows a warp, two or
# four Gram patches a thread), the largest fused m at d = 1 (where K's
# rows get no bank-conflict pad) and the largest fused d at m = 64
FUSED_SHAPES = [(64, 64, 300), (11, 64, 300), (2048, 64, 300), (7, 10, 37),
                (3, 1, 1), (2, 128, 300), (2, 128, 317), (2, 200, 37),
                (3, 238, 1), (2, 64, 823)]


@pytest.mark.parametrize("floor_norm", [False, True])
@pytest.mark.parametrize("S,m,d", FUSED_SHAPES)
def test_cuda_kernels_match_plain_versions(cuda, S, m, d, floor_norm):
    assert ops.route(m, d, cuda) == "fused"
    D = _unit_slab(S, m, d, S + m + d, cuda)
    n0 = kernel.gram_power_cuda.launches
    lam, u = ops.gram_power(D, iters=24, floor_norm=floor_norm)
    assert kernel.gram_power_cuda.launches == n0 + 1
    lam_p, u_p = ref.gram_power_ref(D, 24, floor_norm)
    torch.testing.assert_close(lam, lam_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(u, u_p, rtol=0, atol=1e-4)
    got = ops.fused_krylov_step(D, lam_p, u_p, iters=24,
                                floor_norm=floor_norm)
    want = ref.fused_krylov_step_ref(D, lam_p, u_p, 24, floor_norm)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("floor_norm", [False, True])
def test_cuda_kernels_on_a_zero_slab(cuda, floor_norm):
    D = torch.zeros((4, 64, 300), device=cuda)
    lam, u = ops.gram_power(D, iters=24, floor_norm=floor_norm)
    assert torch.all(lam == 0) and torch.all(u == 0)
    for o in ops.fused_krylov_step(D, lam, u, iters=24,
                                   floor_norm=floor_norm):
        assert torch.isfinite(o).all()


def test_buffer_too_large_for_one_cta_raises(cuda):
    """The fused kernels' own wrappers refuse a buffer past one CTA; the
    public wrappers take the split route for it instead."""
    D = torch.zeros((1, 512, 512), device=cuda)
    lam, u = torch.zeros(1, device=cuda), torch.zeros((1, 512), device=cuda)
    with pytest.raises(ValueError, match="split path"):
        kernel.gram_power_cuda(D, 1)
    with pytest.raises(ValueError, match="split path"):
        kernel.fused_krylov_step_cuda(D, lam, u, 1)
    assert ops.route(512, 512, cuda) == "split"
    lam, u = ops.gram_power(D, iters=1)
    assert not lam.any() and not u.any()


@pytest.mark.parametrize("use_kernel", [True, False])
def test_both_krylov_floors_launch_the_kernels(cuda, use_kernel):
    """``use_kernel`` picks only the norm floor: on the card either
    formulation of the krylov step runs the hand-written kernels."""
    rng = np.random.default_rng(1)
    d = 16
    rows = rng.normal(size=(2, 1, d)) + 0.05 * rng.normal(size=(2, 96, d))
    rows = (rows / np.linalg.norm(rows, axis=2, keepdims=True)).astype(
        np.float32)
    cfg = dsfd.make_config(d, 1 / 4, 32, mode="krylov", use_kernel=use_kernel)
    n0 = (kernel.gram_power_cuda.launches,
          kernel.fused_krylov_step_cuda.launches)
    dsfd.dsfd_run_stream(cfg, rows, device="cuda")
    assert kernel.gram_power_cuda.launches > n0[0]
    assert kernel.fused_krylov_step_cuda.launches > n0[1]


def test_krylov_engine_on_the_card_holds_theorem_3_1(cuda):
    """The krylov engine through the kernels on the card: both kernels
    launch and every user's window sketch is within 4εN of the exact
    window covariance.  (Not compared elementwise with the CPU run: the
    SVDs of cuSOLVER and LAPACK may pick other row signs, after which the
    krylov trajectories part, as between the port and the reference.)"""
    rng = np.random.default_rng(0)
    S, d, block, N, eps = 6, 32, 8, 64, 1 / 4
    dirs = rng.normal(size=(3, d))
    eng = SketchFleetEngine("dsfd", d=d, streams=S, eps=eps, window=N,
                            block=block, mode="krylov", use_kernel=True)
    n0 = (kernel.gram_power_cuda.launches,
          kernel.fused_krylov_step_cuda.launches)
    hist = []
    users = np.repeat(np.arange(S), block)
    for tick in range(30):
        rows = dirs[(users + tick // 5) % 3] + 0.05 * rng.normal(
            size=(users.size, d))
        rows = (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
            np.float32)
        eng.submit_many(users, rows)
        eng.step()
        hist.append(rows.reshape(S, block, d))
    assert kernel.gram_power_cuda.launches > n0[0]
    assert kernel.fused_krylov_step_cuda.launches > n0[1]
    A = np.concatenate(hist, axis=1).astype(np.float64)[:, -N:]
    for u in range(S):
        B = eng.query_user(u).astype(np.float64)
        err = np.max(np.abs(np.linalg.eigvalsh(A[u].T @ A[u] - B.T @ B)))
        assert err <= 4 * eps * N, f"user {u}: {err:.3f} > 4εN"


def test_layered_krylov_engine_on_the_card_holds_theorem_4_1(cuda):
    """Seq-DS-FD's krylov levels through the fused kernels on the card
    (the inline floor, ``floor_norm=True``), heavy rows bypassing into the
    rings: every user within βε‖A_W‖_F², β = 4 (Theorem 4.1)."""
    from repro_torch.core import seq_dsfd

    rng = np.random.default_rng(3)
    S, d, block, N, eps, R = 5, 32, 8, 64, 1 / 4, 16.0
    dirs = rng.normal(size=(3, d))
    eng = SketchFleetEngine("seq-dsfd", d=d, streams=S, eps=eps, window=N,
                            block=block, mode="krylov", R=R)
    n0 = (kernel.gram_power_cuda.launches,
          kernel.fused_krylov_step_cuda.launches)
    users = np.repeat(np.arange(S), block)
    hist = []
    for tick in range(24):
        rows = dirs[(users + tick // 4) % 3] + 0.1 * rng.normal(
            size=(users.size, d))
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        rows *= np.exp(rng.uniform(0, np.log(np.sqrt(R)), (users.size, 1)))
        rows = rows.astype(np.float32)
        eng.submit_many(users, rows)
        eng.step()
        hist.append(rows.reshape(S, block, d))
    assert kernel.gram_power_cuda.launches > n0[0]
    assert kernel.fused_krylov_step_cuda.launches > n0[1]
    sel = seq_dsfd.layered_select(eng.base.meta["cfg"], eng.state, eng.t)
    assert sel.device.type == "cuda"
    A = np.concatenate(hist, axis=1).astype(np.float64)[:, -N:]
    for u in range(S):
        B = eng.query_user(u).astype(np.float64)
        err = np.max(np.abs(np.linalg.eigvalsh(A[u].T @ A[u] - B.T @ B)))
        assert err <= 4 * eps * np.sum(A[u] ** 2), f"user {u}: {err:.3f}"


def test_agg_tree_on_the_card_matches_the_cpu(cuda):
    """The same fleet state on the card and on the CPU: cohort answers of
    the cached tree agree (cuSOLVER's and LAPACK's SVDs may pick other row
    signs, so the merged sketches are compared by their Grams), and the
    merge counts are the same."""
    from repro_torch.sketch import api
    from repro_torch.tree import tree_map

    S, n, d, N = 13, 24, 8, 16
    rng = np.random.default_rng(4)
    X = rng.normal(size=(S, n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=2, keepdims=True)
    ts = torch.arange(1, n + 1, dtype=torch.int32)
    trees, answers = [], []
    cpu_sk = api.make_sketch("dsfd", d=d, eps=0.25, window=N, device="cpu")
    cpu_fleet = api.fleet_streams(cpu_sk, S)
    state = cpu_fleet.update_block(cpu_fleet.init(), torch.from_numpy(X), ts)
    for dev in ("cpu", "cuda"):
        sk = api.make_sketch("dsfd", d=d, eps=0.25, window=N, device=dev)
        fleet = api.fleet_streams(sk, S)
        st = tree_map(lambda x: x.to(dev), state)
        out = []
        for c in (api.ALL, api.Cohort.range(2, 11), api.Cohort.of(0, 7, 12),
                  api.ALL):
            g = api.query_cohort(fleet, st, c, n)
            q = sk.query(g, n)[0].cpu().double().numpy()
            out.append(q.T @ q)
        trees.append(api.agg_tree(fleet))
        answers.append(out)
    for a, b in zip(*answers):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert trees[0].merges == trees[1].merges
    assert trees[0].space() == trees[1].space()


def test_scoring_basis_runs_on_the_gram_kernel(cuda):
    """``topr_basis`` forms its Gram through the hand-written f32 kernel
    (one launch a call) and agrees with the CPU's plain version."""
    from repro_torch.sketch import basis

    rows = torch.from_numpy(np.random.default_rng(5).normal(
        size=(6, 196, 300)).astype(np.float32))
    rows[:, 150:] = 0.0
    X = torch.from_numpy(np.random.default_rng(6).normal(
        size=(6, 8, 300)).astype(np.float32))
    got = _counted(gram_kernel.gram_cuda, lambda: basis.residual_scores(
        rows.to(cuda), X.to(cuda)))
    want = basis.residual_scores(rows, X)
    energy = float((X * X).sum(-1).max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * energy)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _history_engine(dev, **kw):
    return SketchFleetEngine("dsfd", d=16, streams=6, eps=1 / 4, window=16,
                             block=4, mode="fast", history=True, device=dev,
                             **kw)


def _feed_history(eng, rows):
    users = np.repeat(np.arange(rows.shape[0]), 4)
    for k in range(rows.shape[1] // 4):
        blk = rows[:, 4 * k:4 * k + 4]
        if blk.any():
            eng.submit_many(users, blk.reshape(-1, rows.shape[2]))
            eng.step()
        else:
            eng.step(advance_time=True)


def test_history_engine_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The same rows into a history engine on the card and on the CPU
    (a hot tier of 3, spilling): the same index and counters, the
    intervals' Grams within 1e-4 (cuSOLVER's and LAPACK's SVDs may pick
    other row signs; unit rows, so entries stay ~10)."""
    rng = np.random.default_rng(8)
    rows = _unit(rng.normal(size=(6, 64, 16)))
    rows[:, 20:28] = 0.0                           # two idle ticks
    engs = {}
    for dev in ("cpu", "cuda"):
        engs[dev] = _history_engine(dev, history_hot_nodes=3,
                                    history_dir=str(tmp_path / dev))
        _feed_history(engs[dev], rows)
    a, b = engs["cpu"].history, engs["cuda"].history
    assert b.store.hot[next(iter(b.store.hot))].device.type == "cuda"
    for attr in ("retired_through", "retired_units", "consolidations"):
        assert getattr(a, attr) == getattr(b, attr)
    assert (a.store.empty, a.store.on_disk, list(a.store.hot)) == (
        b.store.empty, b.store.on_disk, list(b.store.hot))
    for t1, t2, users in ((1, 49, None), (3, 40, [0, 2, 5]), (21, 29, None),
                          (17, 18, range(1, 4))):
        qa = engs["cpu"].query_interval(users, t1, t2).astype(np.float64)
        qb = engs["cuda"].query_interval(users, t1, t2).astype(np.float64)
        np.testing.assert_allclose(qb.T @ qb, qa.T @ qa, rtol=1e-4,
                                   atol=1e-4)
        assert (a.time_merges, a.stream_merges, a.store.faults) == (
            b.time_merges, b.stream_merges, b.store.faults)


def test_checkpoint_crosses_between_card_and_cpu(cuda, tmp_path):
    """An engine checkpoint written on the card restores on the CPU with
    every state leaf, pending row and index array bit for bit, and the
    CPU's restores on the card the same way."""
    from repro_torch.tree import leaves

    rng = np.random.default_rng(9)
    rows = _unit(rng.normal(size=(6, 48, 16)))
    for src_dev, dst_dev in (("cuda", "cpu"), ("cpu", "cuda")):
        src = _history_engine(src_dev, score=True,
                              history_hot_nodes=4,
                              history_dir=str(tmp_path / f"spill-{src_dev}"))
        _feed_history(src, rows[:, :40])
        src.submit_many(np.repeat(np.arange(6), 3),
                        rows[:, 40:43].reshape(-1, 16))
        src.query_global()
        path = str(tmp_path / f"ck-{src_dev}")
        src.checkpoint(path)
        dst = SketchFleetEngine.from_checkpoint(path, device=dst_dev)
        for x, y in zip(leaves(src.state), leaves(dst.state)):
            assert y.device.type == dst_dev
            assert torch.equal(x.cpu(), y.cpu())
        assert (dst.t, dst.rows_ingested, dst.backlog) == (
            src.t, src.rows_ingested, src.backlog)
        assert dst.tree.cached_nodes == src.tree.cached_nodes > 0
        assert list(dst.history.store.hot) == list(src.history.store.hot)
        for k, v in src.history.store.hot.items():
            assert torch.equal(dst.history.store.hot[k].cpu(), v.cpu())
        np.testing.assert_array_equal(
            dst.score_plane.state_dict()["score_mean"],
            src.score_plane.state_dict()["score_mean"])
        q = src.query_interval(None, 1, 25).astype(np.float64)
        r = dst.query_interval(None, 1, 25).astype(np.float64)
        np.testing.assert_allclose(r.T @ r, q.T @ q, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# A fleet across processes on the card
# ---------------------------------------------------------------------------

_PAIR_SCRIPT = """
import os, sys
pid, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels.fused_tick import kernel
from repro_torch.launch import mesh
from repro_torch.parallel.topology import FleetTopology
from repro_torch.sketch.api import make_sketch, shard_streams
from repro_torch.sketch.query import ALL, Cohort
from repro_torch.tree import leaves

mesh.init_distributed(pid, 2, "127.0.0.1", port, timeout_s=30)
try:
    X = np.load(os.path.join(root, "rows.npy"))
    S, n, d = X.shape
    topo = FleetTopology(S, timeout_s=30)
    dev = mesh.local_device(topo)                 # one card: both on cuda:0
    assert dev == torch.device("cuda", 0)
    sk = make_sketch("dsfd", d=d, eps=0.25, window=16, mode="krylov",
                     use_kernel=True, device=dev)
    fleet = shard_streams(sk, S, topology=topo)
    st = fleet.update_block(
        fleet.init(), torch.from_numpy(X[topo.lo:topo.hi]).to(dev),
        torch.arange(1, n + 1, dtype=torch.int32, device=dev))
    assert kernel.gram_power_cuda.launches > 0
    out = {}
    for name, c in (("all", ALL), ("mid", Cohort.range(2, 6))):
        for i, leaf in enumerate(leaves(fleet.query_cohort(st, c, n))):
            out[f"{name}_{i:03d}"] = leaf.cpu().numpy()
    np.savez(os.path.join(root, f"pair_{pid}.npz"), **out)
    topo.barrier("done")
finally:
    mesh.shutdown()
"""


def test_two_process_pair_on_one_card_matches_one_process(cuda, tmp_path):
    """Two processes share the card (both on ``cuda:0``), each ingests its
    half of S = 8 krylov streams through the fused kernels, and their
    collective cohort answers are the one-process fleet's on the card, bit
    for bit."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.sketch.api import fleet_streams, make_sketch
    from repro_torch.sketch.query import ALL, Cohort
    from repro_torch.tree import leaves

    S, n, d = 8, 40, 32
    rng = np.random.default_rng(12)
    X = _unit(rng.normal(size=(S, n, d)))
    X[1::2] = _unit(rng.normal(size=(S // 2, n, 3)) @ rng.normal(
        size=(3, d)))                              # odd users dump
    np.save(tmp_path / "rows.npy", X)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PAIR_SCRIPT, str(pid), str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    sk = make_sketch("dsfd", d=d, eps=0.25, window=16, mode="krylov",
                     use_kernel=True)
    fleet = fleet_streams(sk, S)
    st = fleet.update_block(fleet.init(), torch.from_numpy(X).cuda(),
                            torch.arange(1, n + 1, dtype=torch.int32,
                                         device="cuda"))
    for name, c in (("all", ALL), ("mid", Cohort.range(2, 6))):
        want = [x.cpu().numpy() for x in leaves(fleet.query_cohort(st, c,
                                                                   n))]
        for pid in range(2):
            got = np.load(tmp_path / f"pair_{pid}.npz")
            for i, w in enumerate(want):
                np.testing.assert_array_equal(got[f"{name}_{i:03d}"], w,
                                              err_msg=f"{name} pid {pid}")


def test_shard_checkpoints_cross_between_card_and_cpu(cuda, tmp_path):
    """Shards written by a topology engine on the card restore on the CPU
    (gathered, and under two processes) with every leaf bit for bit, and
    the CPU's shards restore on the card the same way."""
    from repro_torch.parallel.topology import FleetTopology, MemTransport
    from repro_torch.sketch.api import restore_fleet
    from repro_torch.tree import leaves

    S = 6
    rng = np.random.default_rng(10)
    rows = _unit(rng.normal(size=(S, 24, 16)))
    for src_dev, dst_dev in (("cuda", "cpu"), ("cpu", "cuda")):
        path = str(tmp_path / f"shards-{src_dev}")
        states = []
        for pid in range(2):
            topo = FleetTopology(S, num_processes=2, process_id=pid,
                                 transport=MemTransport())
            eng = SketchFleetEngine("dsfd", d=16, streams=S, eps=0.25,
                                    window=16, block=4, mode="krylov",
                                    use_kernel=True, topology=topo,
                                    device=src_dev)
            users = np.repeat(np.arange(topo.lo, topo.hi), 24)
            eng.submit_many(users, rows[topo.lo:topo.hi].reshape(-1, 16))
            eng.run()
            eng.checkpoint(path)
            states.append([x.cpu() for x in leaves(eng.state)])
        whole = [torch.cat(xs) for xs in zip(*states)]
        fc = restore_fleet(path, device=dst_dev)
        for x, y in zip(whole, leaves(fc.state)):
            assert y.device.type == dst_dev and torch.equal(x, y.cpu())
        for pid in range(2):
            topo = FleetTopology(S, num_processes=2, process_id=pid,
                                 transport=MemTransport())
            fc = restore_fleet(path, device=dst_dev, topology=topo)
            for x, y in zip(states[pid], leaves(fc.state)):
                assert y.device.type == dst_dev and torch.equal(x, y.cpu())


def test_flush_to_queue_with_a_copy_in_flight(cuda):
    """The async pipeline stages a slab (its host→device copy runs on the
    side stream) and is unwound at once: the rows go back to the queue
    front in FIFO order, and the next slab holds them all."""
    from repro_torch.serve.ingest import AdmissionQueue, SlabTransfer, \
        make_pipeline

    S, d, block = 64, 512, 8
    rng = np.random.default_rng(10)
    rows = rng.normal(size=(S * block * 2, d)).astype(np.float32)
    users = np.repeat(np.arange(S), 2 * block)
    q = AdmissionQueue(S, d)
    q.submit_many(users, rows)
    want_users, want_rows = q.snapshot()
    transfer = SlabTransfer(cuda)
    pipe = make_pipeline("async", q, block=block, transfer=transfer)
    pipe.after_dispatch()
    assert pipe.staged_rows == S * block
    pipe.flush_to_queue()                      # the copy may be in flight
    assert pipe.staged_rows == 0 and q.reserved == 0
    got_users, got_rows = q.snapshot()
    np.testing.assert_array_equal(got_users, want_users)
    np.testing.assert_array_equal(got_rows, want_rows)
    slab, touched, counts, nrows = pipe.next_slab()
    dev = transfer.to_compute(slab)
    assert nrows == S * block and touched == list(range(S))
    expect = want_rows.reshape(S, 2 * block, d)[:, :block]
    np.testing.assert_array_equal(dev.cpu().numpy(), expect)


def _counted(wrapper, call):
    """``call()``, asserting it launched ``wrapper``'s kernel once."""
    n0 = wrapper.launches
    out = call()
    assert wrapper.launches == n0 + 1
    return out


_BF16_TOL = {"gram": 2e-2, "rank1_downdate": 2e-2}
# share of o's elements whose bf16 value may differ from the plain
# version's in the bf16 flash test, on inputs scaled ×8: at llama3-8b's
# bucket-512 shape 0.05 % with p split in two, 1.9 % with p rounded to
# bf16 once (chip_smoke.py, PERF.md §6)
FLASH_BF16_MISMATCH = 0.005


# gram's copies: 16-byte in f32 at d = 300, 4-byte at d = 1, 37, 65 and
# 301 (m and d past a tile); in bf16 4-byte at d = 300, plain loads at odd d
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,m,d", [(16, 256, 300), (3, 10, 37), (2, 1, 1),
                                   (2, 130, 65), (256, 256, 300),
                                   (4, 200, 301)])
def test_gram_and_downdate_kernels_match_plain_versions(cuda, S, m, d, dtype):
    X = _unit_slab(S, m, d, S + m + d, cuda).to(dtype)
    v = _unit_slab(1, S, d, m, cuda)[0]
    K = _counted(gram_kernel.gram_cuda, lambda: gram_ops.gram(X))
    D2 = _counted(downdate_kernel.rank1_downdate_cuda,
                  lambda: downdate_ops.rank1_downdate(X, v))
    assert K.dtype == D2.dtype == dtype
    assert torch.equal(K, K.mT)                    # the mirror is exact
    for name, got, want in (("gram", K, gram_ref.gram_ref(X)),
                            ("rank1_downdate", D2,
                             downdate_ref.rank1_downdate_ref(X, v))):
        tol = _BF16_TOL[name] if dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=name)


# every cluster size the plan picks: 8 at (1, 256), (8, 256), (16, 256),
# (4, 512); 2 at (256, 256), (64, 40), (3, 10); 1 at (2, 1); and at
# m = 700, 702 and 1030, past what 8 CTAs hold, rows read from device
# memory each step (16-byte reads at m % 4 == 0, scalar ones otherwise)
@pytest.mark.parametrize("floor_norm", [False, True])
@pytest.mark.parametrize("S,m", [(64, 40), (16, 256), (4, 512), (3, 10),
                                 (2, 1), (1, 256), (8, 256), (256, 256),
                                 (2, 700), (2, 702), (1, 1030)])
def test_power_iter_kernel_matches_plain_version(cuda, S, m, floor_norm):
    X = _unit_slab(S, m, 300, S + m, cuda)
    K = gram_ref.gram_ref(X)
    lam, u = _counted(power_kernel.power_iter_cuda,
                      lambda: power_ops.power_iter(K, iters=24,
                                                   floor_norm=floor_norm))
    lam_p, u_p = power_ref.power_iter_ref(K, 24, floor_norm)
    torch.testing.assert_close(lam, lam_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(u, u_p, rtol=0, atol=1e-4)
    lam0, u0 = power_ops.power_iter(torch.zeros_like(K), iters=24,
                                    floor_norm=floor_norm)
    assert not lam0.any() and not u0.any()


# window_gram's copies: f32 16-byte at d = 300 and 4-byte at d = 301 and
# 37; bf16 8-byte at d = 300, 4-byte at d = 90, plain loads at odd d
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,n,d", [(16, 1024, 300), (3, 10, 37), (2, 129, 90),
                                   (1, 1, 301), (1, 31, 301), (1, 1024, 301),
                                   (1, 1, 300), (1, 31, 300), (1, 1024, 300),
                                   (1, 1, 37), (1, 31, 37), (1, 1024, 37)])
def test_window_gram_kernel_matches_plain_version(cuda, S, n, d, dtype):
    A = _unit_slab(S, n, d, S + n + d, cuda).to(dtype)
    G = _counted(wgram_kernel.window_gram_cuda,
                 lambda: wgram_ops.window_gram(A))
    assert G.dtype == torch.float32 and torch.equal(G, G.mT)
    tol = dict(rtol=5e-2, atol=5e-1) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(G, wgram_ref.window_gram_ref(A), **tol)


def test_unfused_kernels_refuse_what_they_cannot_take(cuda):
    X = torch.zeros((2, 8, 16), device=cuda)
    v = torch.zeros((2, 16), device=cuda)
    K = torch.zeros((2, 8, 8), device=cuda)
    calls = {
        "gram": lambda x: gram_kernel.gram_cuda(x),
        "rank1_downdate": lambda x: downdate_kernel.rank1_downdate_cuda(x, v),
        "window_gram": lambda x: wgram_kernel.window_gram_cuda(x),
        "power_iter": lambda x: power_kernel.power_iter_cuda(x, 4),
    }
    for name, call in calls.items():
        x = K if name == "power_iter" else X
        for bad in (x.double(), x.cpu(), x[0], x.transpose(1, 2)):
            with pytest.raises(ValueError, match=name):
                call(bad)
    with pytest.raises(ValueError, match="float32"):
        downdate_kernel.rank1_downdate_cuda(X, v.double())
    with pytest.raises(ValueError, match="must be"):
        downdate_kernel.rank1_downdate_cuda(X, v[:, :8].contiguous())
    with pytest.raises(ValueError, match="power_iter"):
        power_kernel.power_iter_cuda(X, 4)             # not square


@pytest.mark.parametrize("S", [1, 8, 16, 33, 64, 256])
def test_power_iter_plan_matches_the_c_library(cuda, S):
    """The cluster size, the rows a CTA owns and the rows it keeps on chip
    agree between csrc/power_iter.cu and its Python mirror, at this card's
    limits; up to m = 512 every row of K is held on chip."""
    props = torch.cuda.get_device_properties(cuda)
    smem = kernel.max_smem(cuda)
    for m in (1, 7, 10, 40, 64, 100, 128, 255, 256, 257, 300, 512, 700,
              1030, 4096):
        plan = power_kernel.plan(m, S, cuda)
        assert plan == power_kernel.cluster_plan(
            m, S, smem, props.multi_processor_count), (m, S, plan)
        c, rows, resident = plan
        if m <= 512:
            assert resident == rows and c * rows >= m


def test_fused_kernels_fit_the_routes_formula_everywhere(cuda):
    """At every (m, d) the route sends to the fused kernels (all m, and d
    densely up to 64, then in steps and at its largest), both kernels have
    a layout, and neither asks for more shared memory than the formula
    the route compares against the card's limit."""
    limit = kernel.max_smem(cuda)
    m = 1
    while ops.fused_tick_smem_bytes(m, 1) <= limit:
        d_max = 1
        while ops.fused_tick_smem_bytes(m, 2 * d_max) <= limit:
            d_max *= 2
        step = d_max
        while step:                   # the largest fused d at this m
            if ops.fused_tick_smem_bytes(m, d_max + step) <= limit:
                d_max += step
            step //= 2
        for d in sorted({*range(1, min(d_max, 64) + 1),
                         *range(65, d_max + 1, 37), d_max}):
            formula = ops.fused_tick_smem_bytes(m, d)
            for step_kernel in (False, True):
                need = kernel.kernel_smem(m, d, step_kernel)
                assert 0 < need <= formula, (m, d, step_kernel, need)
        m += 1
    assert m == 239                   # m = 238 is the largest fused m


def test_smem_formula_matches_the_c_library(cuda):
    for m, d in [(64, 300), (128, 300), (128, 317), (128, 318), (256, 300),
                 (10, 37), (1, 1)]:
        assert kernel.smem_bytes(m, d) == ops.fused_tick_smem_bytes(m, d)
        assert ops.route(m, d, cuda) == ops.route(m, d)   # an H100's limit


def test_fine_krylov_engine_takes_the_split_kernels(cuda):
    """ε = 1/128 at d = 300 (m = 256, past one CTA): the engine launches
    gram, power_iter and rank1_downdate, not the fused kernels, and every
    user's window sketch is within 4εN of the exact window covariance
    (from window_gram on the card)."""
    from repro_torch.core.errors import cova_error_gram, window_gram
    from repro_torch.data.streams import SyntheticSource

    S, d, block, N, eps = 4, 300, 8, 256, 1 / 128
    eng = SketchFleetEngine("dsfd", d=d, streams=S, eps=eps, window=N,
                            block=block, mode="krylov", use_kernel=True)
    wrappers = {"gram": gram_kernel.gram_cuda,
                "power_iter": power_kernel.power_iter_cuda,
                "rank1_downdate": downdate_kernel.rank1_downdate_cuda,
                "gram_power": kernel.gram_power_cuda,
                "fused_krylov_step": kernel.fused_krylov_step_cuda}
    n0 = {k: w.launches for k, w in wrappers.items()}
    srcs = (SyntheticSource(d, seed=0), SyntheticSource(d, k=10, seed=1))
    users = np.repeat(np.arange(S), block)
    hist = []
    for _ in range(int(2.5 * N) // block):
        rows = np.concatenate([s.rows(S // 2 * block) for s in srcs])
        eng.submit_many(users, rows)
        eng.step()
        hist.append(rows.reshape(S, block, d))
    ran = {k: w.launches - n0[k] for k, w in wrappers.items()}
    assert ran["gram"] > 0 and ran["power_iter"] > 0 \
        and ran["rank1_downdate"] > 0, ran
    assert ran["gram_power"] == ran["fused_krylov_step"] == 0, ran
    A = torch.from_numpy(np.concatenate(hist, axis=1)[:, -N:]).to(cuda)
    n_w = wgram_kernel.window_gram_cuda.launches
    err = cova_error_gram(window_gram(A), eng.base.query(eng.state, eng.t))
    assert wgram_kernel.window_gram_cuda.launches == n_w + 1
    assert bool((err <= 4 * eps * N).all()), err


@pytest.mark.parametrize("B,S,H,Hkv,dh,dtype,causal", [
    (1, 512, 32, 8, 128, torch.bfloat16, True),    # llama3-8b at bucket 512
    (2, 256, 9, 3, 64, torch.bfloat16, True),      # smollm, G = 3
    (1, 512, 16, 16, 64, torch.float32, True),     # qwen1.5, G = 1
    (2, 128, 4, 2, 128, torch.float32, False),
    (1, 192, 6, 2, 64, torch.float32, True),       # f32 at S = 3·64
    (1, 192, 6, 2, 128, torch.float32, False),
])
def test_flash_kernel_matches_plain_version(cuda, B, S, H, Hkv, dh, dtype,
                                            causal):
    g = torch.Generator(device=cuda).manual_seed(S + H + dh)
    q, k, v = (torch.randn((B * h, S, dh), generator=g, device=cuda,
                           dtype=torch.float32).to(dtype)
               for h in (H, Hkv, Hkv))
    n0 = flash_kernel.flash_fwd.launches
    o, lse = flash_ops.flash_forward(q, k, v, causal=causal)
    assert flash_kernel.flash_fwd.launches == n0 + 1
    o_p, lse_p = flash_ref.flash_ref(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), o_p.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_p, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("S", [64, 192, 512])
def test_flash_tensor_core_kernel_matches_plain_version(cuda, S, dh, G,
                                                        causal):
    """The bf16 kernel (wgmma, TMA) at S = 64 (one KV tile, half past S),
    192 (a 64-row query tail) and 512, on inputs scaled ×8: the softmax is
    peaked, and o rounds to the plain version's bf16 value almost
    everywhere, which a single bf16 rounding of p would not give."""
    g = torch.Generator(device=cuda).manual_seed(S + dh + G)
    q, k, v = (8 * torch.randn((h, S, dh), generator=g, device=cuda)
               for h in (2 * G, 2, 2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    n0 = flash_kernel.flash_fwd.launches
    o, lse = flash_ops.flash_forward(q, k, v, causal=causal)
    assert flash_kernel.flash_fwd.launches == n0 + 1
    o_p, lse_p = flash_ref.flash_ref(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), o_p.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, lse_p, rtol=1e-3, atol=1e-3)
    assert float((o != o_p).float().mean()) < FLASH_BF16_MISMATCH


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [6, 8])
@pytest.mark.parametrize("S", [256, 512])
def test_flash_tensor_core_kernel_at_moe_groups(cuda, S, G, causal):
    """The bf16 kernel at grok-1's group size (48 query heads over 8 KV
    heads: G = 6) and at G = 8, dh 128, at the MoE serve phase's prefill
    buckets, on ×8 inputs: one launch a call, o within the plain
    version's bf16 rounding.  G = 6 also at grok's full head count."""
    g = torch.Generator(device=cuda).manual_seed(S + G)
    for H, Hkv in ((2 * G, 2), (8 * G, 8)):
        q, k, v = (8 * torch.randn((h, S, 128), generator=g, device=cuda)
                   for h in (H, Hkv, Hkv))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        n0 = flash_kernel.flash_fwd.launches
        o, lse = flash_ops.flash_forward(q, k, v, causal=causal)
        assert flash_kernel.flash_fwd.launches == n0 + 1
        o_p, lse_p = flash_ref.flash_ref(q, k, v, causal=causal)
        torch.testing.assert_close(o.float(), o_p.float(), rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(lse, lse_p, rtol=1e-3, atol=1e-3)
        assert float((o != o_p).float().mean()) < FLASH_BF16_MISMATCH


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((2, 100, 64), device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_kernel.flash_fwd(q, q[:1], q[:1])
    q = torch.zeros((2, 128, 32), device=cuda)
    with pytest.raises(ValueError, match="dh in"):
        flash_kernel.flash_fwd(q, q, q)
    q = torch.zeros((2, 128, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash_kernel.flash_fwd(q, q, q)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def test_serve_engine_on_the_card_goes_through_flash(cuda):
    """Reduced llama3-8b with head_dim 64: every prefill launches the flash
    kernel once per layer, and the greedy tokens equal the CPU run's."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              head_dim=64, use_flash=True)
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(100, 256, 3)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _to(params, dev),
                          EngineConfig(slots=2, s_max=320,
                                       prefill_buckets=(256,)), device=dev)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new=4))
        n0 = flash_kernel.flash_fwd.launches
        done = eng.run()
        launched = flash_kernel.flash_fwd.launches - n0
        assert launched == (cfg.n_layers * len(prompts) if dev == "cuda"
                            else 0)
        out[dev] = ({u: r.out_tokens for u, r in done.items()}, eng.ticks)
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("E,k,D,F,T,cf", [
    (4, 2, 32, 32, 64, 1.25),       # reduced grok and kimi
    (4, 2, 32, 32, 64, 0.5),        # the capacity drops pairs
    (384, 8, 16, 8, 128, 1.25),     # kimi's dispatch at small width
])
def test_moe_block_on_the_card_matches_the_cpu(cuda, E, k, D, F, T, cf):
    """The MoE block on the card against the CPU (f32, 1e-5), with the
    same pairs dropped, and two calls on the card bitwise equal: the
    combine sums by gathers in slot order, with no atomics."""
    from repro_torch.configs.base import MoECfg
    from repro_torch.models.layers import moe

    g = torch.Generator().manual_seed(E + k + T)
    cfg = MoECfg(E, k, F, cf)
    x = torch.randn((2, T // 2, D), generator=g)
    ws = [0.5 * torch.randn((D, E), generator=g)] + [
        0.2 * torch.randn(shape, generator=g)
        for shape in ((E, D, F), (E, D, F), (E, F, D))]
    y_cpu, aux_cpu = moe.moe_block(x, *ws, moe=cfg)
    args = [t.to(cuda) for t in [x] + ws]
    y1, aux1 = moe.moe_block(*args, moe=cfg)
    y2, aux2 = moe.moe_block(*args, moe=cfg)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
    torch.testing.assert_close(y1.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux1.cpu(), aux_cpu, rtol=1e-6, atol=1e-6)
    slot_cpu = moe.route(cfg, x.reshape(T, D), ws[0])[0]
    slot = moe.route(cfg, args[0].reshape(T, D), args[1])[0]
    assert torch.equal(slot.cpu(), slot_cpu)


def test_moe_serve_engine_on_the_card_matches_the_cpu(cuda):
    """Reduced grok-1 through ServeEngine: the greedy tokens on the card
    equal the CPU run's."""
    cfg = get_config("grok-1-314b").reduced()
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(10, 33, 3)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _to(params, dev),
                          EngineConfig(slots=2, s_max=64,
                                       prefill_buckets=(16, 32)), device=dev)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new=4))
        done = eng.run()
        out[dev] = ({u: r.out_tokens for u, r in done.items()}, eng.ticks)
    assert out["cuda"] == out["cpu"]


def _vlm_positions(B, before, grid, after):
    """(B, S, 3) M-RoPE ids of text, a (t, h, w) image grid, text, laid
    out as Qwen2-VL's ``get_rope_index``."""
    t, h, w = grid
    ids = [(i, i, i) for i in range(before)]
    ids += [(before + a, before + b, before + c)
            for a in range(t) for b in range(h) for c in range(w)]
    ids += [(before + max(t, h, w) + i,) * 3 for i in range(after)]
    return torch.tensor(ids, dtype=torch.int32).expand(B, len(ids), 3)


def _greedy_from_prefill(cfg, params, batch, steps, dev):
    """Prefill then ``steps`` greedy decode steps on a cache with room:
    (prefill logits, tokens (B, steps + 1))."""
    B, S = batch["tokens"].shape
    with torch.no_grad():
        lg, pre = api.forward_prefill(cfg, params, batch)
        caches = api.init_cache(cfg, B, S + steps, torch.float32, dev)
        caches.k[:, :, :S] = pre.k
        caches.v[:, :, :S] = pre.v
        caches.length[:] = pre.length
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        toks = [tok]
        for _ in range(steps):
            out, caches = api.forward_decode(cfg, params, tok, caches)
            tok = torch.argmax(out[:, -1], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
    return lg, torch.cat(toks, dim=1)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_new_families_on_the_card_match_the_cpu(cuda, arch):
    """The reduced VLM, SSM and hybrid models (f32) on the card against the
    CPU: a 32-token prefill's logits within 1e-4, and greedy tokens
    identical: mamba2 and recurrentgemma through ServeEngine (prompts in
    both buckets), qwen2-vl through prefill and 4 decode steps with an
    image block's ids (its engine passes no M-RoPE ids)."""
    cfg = get_config(arch).reduced()
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)).astype(
        np.int32))
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in (9, 30, 12)]
    logits, out = {}, {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        batch = {"tokens": toks.to(dev)}
        if cfg.family == "vlm":
            batch["positions"] = _vlm_positions(2, 4, (1, 4, 6), 4).to(dev)
            logits[dev], out[dev] = _greedy_from_prefill(cfg, p, batch, 4,
                                                         dev)
            out[dev] = out[dev].cpu()
            continue
        with torch.no_grad():
            logits[dev], _ = api.forward_prefill(cfg, p, batch)
        eng = ServeEngine(cfg, p, EngineConfig(
            slots=2, s_max=64, prefill_buckets=(16, 32)), device=dev)
        for uid, pr in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=pr, max_new=4))
        done = eng.run()
        out[dev] = ({u: r.out_tokens for u, r in done.items()}, eng.ticks)
    torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"],
                               rtol=1e-4, atol=1e-4)
    if cfg.family == "vlm":
        assert torch.equal(out["cuda"], out["cpu"])
    else:
        assert out["cuda"] == out["cpu"]


def test_whisper_on_the_card_matches_the_cpu(cuda):
    """Reduced Whisper (f32) on the card against the CPU from the same
    weights and frames: a 32-token prefill's logits and its cross K/V
    within 1e-4, and greedy tokens identical through 4 decode steps on
    a cache with room for them; no flash launch (the reference's Whisper
    reaches no kernel)."""
    from repro_torch.models import whisper

    cfg = get_config("whisper-large-v3").reduced()
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)).astype(
        np.int32))
    frames = torch.from_numpy((0.1 * rng.standard_normal(
        (2, cfg.enc_frames, cfg.d_model))).astype(np.float32))
    out = {}
    n0 = flash_kernel.flash_fwd.launches
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        with torch.no_grad():
            lg, pre = api.forward_prefill(cfg, p, {"tokens": toks.to(dev),
                                                   "frames": frames.to(dev)})
            cache = whisper.init_cache(cfg, 2, 36, torch.float32, dev)
            cache.self_kv.k[:, :, :32] = pre.self_kv.k
            cache.self_kv.v[:, :, :32] = pre.self_kv.v
            cache.self_kv.length[:] = pre.self_kv.length
            cache = cache._replace(cross_k=pre.cross_k, cross_v=pre.cross_v)
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            seq = [tok]
            for _ in range(4):
                dec, cache = api.forward_decode(cfg, p, tok, cache)
                tok = torch.argmax(dec[:, -1], dim=-1).to(torch.int32)[
                    :, None]
                seq.append(tok)
        out[dev] = (lg.cpu(), pre.cross_k.cpu(), torch.cat(seq, 1).cpu())
    assert flash_kernel.flash_fwd.launches == n0
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert torch.equal(out["cuda"][2], out["cpu"][2])


def test_vlm_prefill_on_the_card_goes_through_flash(cuda):
    """qwen2-vl reduced to 2 layers at its full head_dim 128 (4 heads over
    2 KV heads) and M-RoPE sections (16, 24, 24), bf16, ``use_flash``: a
    256-token prefill with an image block launches the bf16 flash kernel
    once a layer, and its logits lie within the file's bf16 bound (2e-2
    relative) of the CPU's plain version."""
    cfg = dataclasses.replace(get_config("qwen2-vl-2b").reduced(),
                              head_dim=128, mrope_sections=(16, 24, 24),
                              use_flash=True, param_dtype="bfloat16",
                              act_dtype="bfloat16")
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(1),
                         dtype=torch.bfloat16, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 256)).astype(np.int32))
    pos = _vlm_positions(1, 64, (1, 8, 16), 64)
    out = {}
    for dev in ("cpu", "cuda"):
        n0 = flash_kernel.flash_fwd.launches
        with torch.no_grad():
            lg, caches = api.forward_prefill(cfg, _to(params, dev), {
                "tokens": toks.to(dev), "positions": pos.to(dev)})
        assert flash_kernel.flash_fwd.launches - n0 == (
            cfg.n_layers if dev == "cuda" else 0)
        out[dev] = lg.float().cpu()
    assert torch.isfinite(out["cuda"]).all()
    rel = float(torch.linalg.norm(out["cuda"] - out["cpu"])
                / torch.linalg.norm(out["cpu"]))
    assert rel <= 2e-2, rel


# (S, dh, G, causal, dtype) of the backward test: every S × dh × G × mask
# in both types, and grok-1's group sizes (G = 6; 8) at dh = 128 in bf16
FLASH_BWD_CASES = [
    (S, dh, G, causal, dtype)
    for S in (64, 256, 1024) for dh in (64, 128) for G in (1, 3, 4)
    for causal in (True, False) for dtype in (torch.float32, torch.bfloat16)
] + [(S, 128, G, causal, torch.bfloat16)
     for S in (64, 256, 1024) for G in (6, 8) for causal in (True, False)]


@pytest.mark.parametrize("S,dh,G,causal,dtype", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain_version(cuda, S, dh, G, causal,
                                                     dtype):
    """The backward kernel against ``flash_bwd_ref`` on the same residuals
    (the forward kernel's o and lse) and dO, one launch a call; two calls
    bitwise equal.  f32: 1e-4 (the same f32 identities, another summation
    order); bf16: 2e-2 (each gradient rounded to bf16 once from f32 sums
    in another order; ``-s`` prints the bf16 kernel's largest distance)."""
    g = torch.Generator(device=cuda).manual_seed(S + dh + G)
    q, k, v, do = (torch.randn((h, S, dh), generator=g, device=cuda)
                   .to(dtype) for h in (2 * G, 2, 2, 2 * G))
    o, lse = flash_ops.flash_forward(q, k, v, causal=causal)
    n0 = flash_kernel.flash_bwd.launches
    got = flash_ops.flash_backward(q, k, v, o, lse, do, causal=causal)
    assert flash_kernel.flash_bwd.launches == n0 + 1
    want = flash_ref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    if dtype == torch.bfloat16:
        print(f"flash_bwd bf16 S={S} dh={dh} G={G} causal={causal}: max "
              "|kernel − plain| " + "/".join(
                  f"{float((a.float() - b.float()).abs().max()):.3e}"
                  for a, b in zip(got, want)))
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    again = flash_ops.flash_backward(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_backward_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((2, 128, 64), device=cuda)
    lse = torch.zeros((2, 128), device=cuda)
    with pytest.raises(ValueError, match="lse"):
        flash_kernel.flash_bwd(q, q, q, q, lse[:, :64], q)
    with pytest.raises(ValueError, match="do"):
        flash_kernel.flash_bwd(q, q, q, q, lse, q.to(torch.bfloat16))
    q = torch.zeros((2, 96, 64), device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_kernel.flash_bwd(q, q, q, q, torch.zeros((2, 96), device=cuda),
                               q)


def test_flash_backward_fits_a_block(cuda):
    """The backward's shared memory fits what a block may opt in to at both
    head dims, as ``csrc/flash_attn_bwd.cu`` states: the f32 kernel's (its
    C formula, the larger of its two tiled passes) 203,776 B at dh = 64
    and 230,400 B at dh = 128 (the dK/dV pass), the bf16 kernel's 84,536
    and 166,456 B (its Python mirror ``tc_bwd_smem``); the fit check takes
    the larger, the f32 kernel's."""
    lib = flash_kernel._bwd_lib()
    have = lib.flash_attn_bwd_max_smem(cuda.index or 0)
    need = {dh: lib.flash_attn_bwd_smem_bytes(dh) for dh in (64, 128)}
    assert need == {64: 203_776, 128: 230_400} and need[128] <= have
    tc = {dh: lib.flash_attn_bwd_tc_smem_bytes(dh) for dh in (64, 128)}
    assert tc == {dh: flash_kernel.tc_bwd_smem(dh) for dh in (64, 128)}
    assert tc == {64: 84_536, 128: 166_456} and tc[128] <= have


# a few f32 rounding steps at the ×8 backward's gradients (~44: 2⁻²⁴·44
# ≈ 2.6e-6 a step), for cases where the plain version lies ~0 from f64
F64_FLOOR = 1e-5


def _flash_bwd_f64(q, k, v, o, lse, do, *, causal):
    """``flash_ref.flash_bwd_ref``'s identities evaluated in f64 on the
    same (f32) inputs: P = exp(q·kᵀ/√dh − lse), D = rowsum(dO∘o),
    dS = P∘(dO·vᵀ − D), dq = dS·k/√dh, dk = Σ_group dSᵀ·q/√dh,
    dv = Σ_group Pᵀ·dO."""
    BH, S, dh = q.shape
    G = BH // k.shape[0]
    qs = q.double() / dh ** 0.5
    kr, vr = (t.double().repeat_interleave(G, 0) for t in (k, v))
    s = qs @ kr.mT
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse.double()[..., None])
    dof = do.double()
    ds = p * (dof @ vr.mT - (dof * o.double()).sum(-1, keepdim=True))
    dq = ds @ kr / dh ** 0.5
    dk = (ds.mT @ qs).reshape(-1, G, S, dh).sum(1)
    dv = (p.mT @ dof).reshape(-1, G, S, dh).sum(1)
    return dq, dk, dv


@pytest.mark.parametrize("mul", [1.0, 8.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("S", [64, 192, 1024])
def test_flash_f32_kernels_match_plain_versions(cuda, S, dh, G, causal,
                                                mul):
    """The f32 forward and the backward in f32 and bf16 against their plain
    versions, one launch a call: S = 64 (one KV tile, a query tile half
    past S), 192 (a tail past the 128-row tiles) and 1024 (the training
    shape's), q scaled by ``mul`` (×8: scores of standard deviation 8, a
    peaked softmax).  f32 1e-4 and lse 1e-3 (the same arithmetic in
    another summation order); bf16 2e-2 (each gradient rounded once to
    bf16).  At ×8 the f32 backward's gradients reach ~44, and two f32
    summation orders need not agree to 1e-4 there, so both the kernel and
    the plain version are held to the same identities evaluated in f64 on
    the same inputs: the kernel's max error at most twice the plain
    version's plus ``F64_FLOOR`` (both printed).  Two backward calls on the
    same inputs are bitwise equal at both scales."""
    g = torch.Generator(device=cuda).manual_seed(S + dh + G + int(mul))
    q, k, v, do = (torch.randn((h, S, dh), generator=g, device=cuda)
                   for h in (2 * G, 2, 2, 2 * G))
    q = mul * q
    n0 = flash_kernel.flash_fwd.launches
    o, lse = flash_ops.flash_forward(q, k, v, causal=causal)
    assert flash_kernel.flash_fwd.launches == n0 + 1
    o_p, lse_p = flash_ref.flash_ref(q, k, v, causal=causal)
    torch.testing.assert_close(o, o_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, lse_p, rtol=1e-3, atol=1e-3)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        args = [t.to(dtype) for t in (q, k, v, o, lse, do)]
        args[4] = lse
        n0 = flash_kernel.flash_bwd.launches
        got = flash_ops.flash_backward(*args, causal=causal)
        assert flash_kernel.flash_bwd.launches == n0 + 1
        want = flash_ref.flash_bwd_ref(*args, causal=causal)
        for a, b in zip(got, want):
            assert a.dtype == dtype and a.shape == b.shape
            assert bool(torch.isfinite(a).all())
            if dtype == torch.bfloat16 or mul == 1.0:
                torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                           atol=tol)
        if dtype == torch.float32 and mul != 1.0:
            exact = _flash_bwd_f64(*args, causal=causal)
            for name, a, b, x in zip("qkv", got, want, exact):
                e_k = float((a.double() - x).abs().max())
                e_p = float((b.double() - x).abs().max())
                print(f"flash_bwd f32 ×{mul:g} S={S} dh={dh} G={G} "
                      f"causal={causal} d{name}: max |kernel − f64| "
                      f"{e_k:.3e}, max |plain − f64| {e_p:.3e}")
                assert e_k <= 2 * e_p + F64_FLOOR, (name, e_k, e_p)
        again = flash_ops.flash_backward(*args, causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dh,S,BH,BHkv", [
    (64, 1024, 72, 24),     # smollm-135m's training shape
    (128, 512, 32, 8),      # llama3-8b's f32 prefill
    (64, 192, 6, 2), (128, 192, 6, 2), (64, 64, 3, 3), (128, 1024, 16, 4),
])
def test_flash_f32_plans_match_the_c_library(cuda, dh, S, BH, BHkv):
    """The f32 kernels' launch plans from the C libraries equal their
    Python mirrors (threads, rows, shared memory, grid), fit what a block
    may opt in to, and leave at least one CTA resident a SM."""
    got = flash_kernel.plan(dh, S, BH, BHkv, cuda)
    have = flash_kernel._lib().flash_attn_max_smem(cuda.index or 0)
    for name, mirror in (("fwd", flash_kernel.f32_plan(dh, S, BH)),
                         ("bwd", flash_kernel.bwd_plan(dh, S, BH, BHkv))):
        assert got[name][:5] == mirror, (name, got[name], mirror)
        assert mirror[2] <= have and got[name][5] >= 1, (name, got[name])


def test_two_layer_train_step_on_the_card_matches_the_cpu(cuda):
    """A reduced smollm-135m with head_dim 64 and the flash gate, remat
    "full": one step's loss and every gradient on the card (both flash
    kernels) against the CPU (their plain versions).  Loss 1e-5 relative;
    gradients 1e-3 relative plus 1e-6 (f32 throughout, TF32 off: only
    summation orders differ, through two layers and a 128-way head)."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.train_step import loss_fn
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              head_dim=64, use_flash=True, remat="full")
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    _, batch = TokenPipeline(vocab=cfg.vocab, seq_len=256,
                             global_batch=2).next_batch({"step": 0})
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        ps = [t.requires_grad_(True) for t in leaves(p)]
        n0 = flash_kernel.flash_fwd.launches, flash_kernel.flash_bwd.launches
        tot, _ = loss_fn(cfg, p, {k: torch.from_numpy(v).to(dev)
                                  for k, v in batch.items()})
        grads = torch.autograd.grad(tot, ps)
        fwd = flash_kernel.flash_fwd.launches - n0[0]
        bwd = flash_kernel.flash_bwd.launches - n0[1]
        assert (fwd, bwd) == ((2 * cfg.n_layers, cfg.n_layers)
                              if dev == "cuda" else (0, 0))
        out[dev] = (tot.detach().cpu(), [g.cpu() for g in grads])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)


def _grad_tree(cfg, seed, scale=0.05):
    """A gradient tree with ``cfg``'s leaves, drawn with numpy (CPU)."""
    from repro_torch.tree import map_dicts

    rng = np.random.default_rng(seed)
    params = init_params(api.param_defs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    return map_dicts(lambda p: torch.from_numpy(
        (scale * rng.standard_normal(tuple(p.shape))).astype(np.float32)),
        params)


def _gram_rows(rows):
    r = rows.detach().cpu().double().reshape(-1, rows.shape[-1])
    return r.T @ r


def test_gradient_monitor_on_the_card_matches_the_cpu(cuda):
    """The monitor's count-sketch row (``index_add_``: atomics on the
    card, so another summation order of the same f32 addends) within
    1e-5, as the CPU's against the reference; then 6 ``sketch_update``
    steps: metrics 1e-4 relative and the window Gram BᵀB 1e-4 (the DS-FD
    shrinks' SVDs are cuSOLVER's here and LAPACK's there; rows are unique
    only up to sign, their Gram is not).  θ = window/ℓ = 2.5: the
    running bound σ̂₁² that triggers a rotation grows by a unit row's
    energy, 1 ± a rounding, a step, so an integer θ puts the trigger on a
    tie that the card's and the CPU's roundings break apart (at window 8,
    σ̂₁² = 1.99999976 on the card and ≥ 2 on the CPU after two steps)."""
    from repro_torch.sketch import monitor

    cfg = get_config("smollm-135m").reduced()
    scfg = monitor.SketchConfig(d=64, eps=0.25, window=10)
    g = _grad_tree(cfg, 0)
    torch.testing.assert_close(monitor.project_grads(scfg, _to(g, cuda)).cpu(),
                               monitor.project_grads(scfg, g), rtol=1e-5,
                               atol=1e-5)
    st = {"cpu": None, "cuda": None}
    for step in range(6):
        g = _grad_tree(cfg, step, scale=0.05 * (1 + step % 3))
        m = {}
        for dev in st:
            st[dev], m[dev] = monitor.sketch_update(
                scfg, st[dev], _to(g, dev), torch.tensor(step, device=dev))
        for k in m["cpu"]:
            torch.testing.assert_close(
                m["cuda"][k].cpu(), m["cpu"][k], rtol=1e-4, atol=1e-6,
                msg=lambda e: f"step {step} {k}: {e}")
    assert st["cuda"]["dsfd"].main.buf.is_cuda
    q = {dev: scfg.sketch(dev).query_rows(st[dev]["dsfd"]) for dev in st}
    torch.testing.assert_close(_gram_rows(q["cuda"]), _gram_rows(q["cpu"]),
                               rtol=0, atol=1e-4)


def test_gradient_compression_on_the_card_matches_the_cpu(cuda):
    """4 steps of ``compress_grads`` (the first projects onto the empty
    sketch's basis, the later ones onto the learned one): compressed
    gradients and error-feedback accumulators 1e-4, the window Gram 1e-4,
    as the CPU's against the reference (sign-invariant projections onto
    the sketch basis, whose SVDs differ in rounding)."""
    from repro_torch.core.dsfd import dsfd_query_rows
    from repro_torch.sketch import compress
    from repro_torch.tree import leaves

    cfg = get_config("smollm-135m").reduced()
    ccfg = compress.CompressConfig(rank=4, eps=0.25, window=8,
                                   min_size=2048, summary_rows=2)
    st = {"cpu": None, "cuda": None}
    for step in range(4):
        g = _grad_tree(cfg, step)
        out = {}
        for dev in st:
            out[dev], st[dev] = compress.compress_grads(ccfg, _to(g, dev),
                                                        st[dev])
        for a, b in zip(leaves(out["cuda"]), leaves(out["cpu"])):
            assert a.is_cuda and torch.isfinite(a).all()
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    for name in ("embed", "wq", "wd"):
        a, b = (s[name] if name == "embed" else s["layers"][name]
                for s in (st["cuda"], st["cpu"]))
        assert int(a["step"]) == int(b["step"]) == 4
        torch.testing.assert_close(a["err"].cpu(), b["err"], rtol=0,
                                   atol=1e-4)
        dcfg = ccfg.dsfd(b["err"].shape[-1])
        torch.testing.assert_close(
            _gram_rows(dsfd_query_rows(dcfg, a["dsfd"])),
            _gram_rows(dsfd_query_rows(dcfg, b["dsfd"])), rtol=0, atol=1e-4)


def test_sketchy_update_on_the_card_matches_the_cpu(cuda):
    """Two ``sketchy_dsfd`` updates from the same parameters and state
    (each run on its own copy: the update writes in place): parameters
    within 1e-5, as the CPU's step against the reference's; momenta (the
    normalised updates, entries ≤ 1) 1e-4; each sketched leaf's window
    Gram 1e-4."""
    from repro_torch.sketch import sketchy
    from repro_torch.tree import leaves, map_dicts

    cfg = get_config("smollm-135m").reduced()
    scfg = sketchy.SketchyConfig(lr=2e-2, rank=4, eps=0.5, window=16,
                                 summary_rows=2, warmup=4)
    opt = sketchy.sketchy_dsfd(scfg)
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(1), device="cpu")
    run = {}
    for dev in ("cpu", "cuda"):
        p = map_dicts(lambda t: t.to(dev, copy=True), params)
        state = opt.init(p)
        for step in range(2):
            p, state = opt.update(_to(_grad_tree(cfg, step), dev), state, p,
                                  torch.tensor(step, dtype=torch.int32,
                                               device=dev))
        run[dev] = (p, state)
    (pc, sc), (pg, sg) = run["cpu"], run["cuda"]
    for a, b in zip(leaves(pg), leaves(pc)):
        assert a.is_cuda and torch.isfinite(a).all()
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    for a, b in zip(leaves(sg.mom), leaves(sc.mom)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    for name in ("wq", "wd"):
        a, b = sg.sketch["layers"][name], sc.sketch["layers"][name]
        d = params["layers"][name].shape[-1]
        torch.testing.assert_close(
            _gram_rows(scfg.sketch(d, cuda).query_rows(a)),
            _gram_rows(scfg.sketch(d, "cpu").query_rows(b)), rtol=0,
            atol=1e-4)


_EP_SCRIPT = """
import os, sys
pid, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch import convert
from repro_torch.configs.base import MoECfg
from repro_torch.launch import mesh
from repro_torch.models.layers import moe
from repro_torch.models.params import ParamDef
from repro_torch.parallel.sharding import axis_rules, make_rules

mesh.init_distributed(pid, 2, "127.0.0.1", port, timeout_s=30)
try:
    torch.cuda.set_device(0)
    pm = mesh.make_process_mesh(2)
    z = np.load(os.path.join(root, "moe.npz"))
    cfg = MoECfg(n_experts=int(z["E"]), top_k=int(z["k"]),
                 d_expert=z["wg"].shape[-1])
    w = {k: torch.from_numpy(z[k]).cuda() for k in
         ("x", "wr", "wg", "wu", "wd")}
    rules = make_rules(pm, {"experts": cfg.n_experts})
    defs = {k: ParamDef(tuple(w[k].shape), ("experts", None, None))
            for k in ("wg", "wu", "wd")}
    local = convert.local_params({k: w[k] for k in defs}, defs, rules, pm,
                                 convert.mesh_coords(pm))
    with axis_rules(pm, rules), torch.no_grad():
        y, aux = moe.moe_block(w["x"], w["wr"], local["wg"], local["wu"],
                               local["wd"], moe=cfg)
    np.savez(os.path.join(root, f"ep_{pid}.npz"), y=y.cpu().numpy(),
             aux=aux.cpu().numpy())
finally:
    mesh.shutdown()
"""


def test_expert_parallel_block_on_one_card_matches_one_process(cuda,
                                                              tmp_path):
    """Two processes share the card, each holding 4 of 8 experts (gloo
    group, y staged through the host): y within 1e-5 and aux within 1e-6
    of ``moe_block`` in one process on the card."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.configs.base import MoECfg
    from repro_torch.models.layers import moe

    E, k, D, F = 8, 2, 64, 128
    rng = np.random.default_rng(25)
    z = {"x": rng.normal(size=(2, 48, D)), "wr": rng.normal(size=(D, E)),
         "wg": 0.1 * rng.normal(size=(E, D, F)),
         "wu": 0.1 * rng.normal(size=(E, D, F)),
         "wd": 0.1 * rng.normal(size=(E, F, D))}
    z = {n: a.astype(np.float32) for n, a in z.items()}
    np.savez(tmp_path / "moe.npz", E=E, k=k, **z)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _EP_SCRIPT, str(pid), str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    w = {n: torch.from_numpy(a).to(cuda) for n, a in z.items()}
    with torch.no_grad():
        y, aux = moe.moe_block(w["x"], w["wr"], w["wg"], w["wu"], w["wd"],
                               moe=MoECfg(n_experts=E, top_k=k, d_expert=F))
    for pid in range(2):
        got = np.load(tmp_path / f"ep_{pid}.npz")
        np.testing.assert_allclose(got["y"], y.cpu().numpy(), atol=1e-5,
                                   rtol=0)
        assert abs(float(got["aux"]) - float(aux)) <= 1e-6


_TRAIN_MESH_SCRIPT = r"""
import json, os, sys
import torch
pid, port, root, arch, n_model = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], int(sys.argv[5]))
sketches = json.loads(sys.argv[6]) if len(sys.argv) > 6 else {}
torch.backends.cuda.matmul.allow_tf32 = False
import dataclasses
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh
from repro_torch.sketch import (CompressConfig, SketchConfig, SketchyConfig,
                                sketchy_dsfd)
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.train_step import TrainStepConfig

mesh.init_distributed(pid, 2, "127.0.0.1", port, timeout_s=30)
try:
    torch.cuda.set_device(0)
    pm = mesh.make_process_mesh(n_model)
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=64,
                              use_flash=True, remat="full")
    tsc = TrainStepConfig(
        sketch=(SketchConfig(**sketches["monitor"])
                if "monitor" in sketches else None),
        compress=(CompressConfig(**sketches["compress"])
                  if "compress" in sketches else None))
    opt = (sketchy_dsfd(SketchyConfig(**sketches["sketchy"]))
           if "sketchy" in sketches else None)
    res = train(cfg, pm, device="cuda", loop=LoopConfig(steps=3),
                seq_len=256, global_batch=4, tsc=tsc, opt=opt)
    with open(os.path.join(root, f"train_{pid}.json"), "w") as f:
        json.dump(res["history"], f)
finally:
    mesh.shutdown()
"""


def _train_pair(root, arch, n_model, sketches=None):
    """The two processes' histories of ``_TRAIN_MESH_SCRIPT``."""
    import json
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TRAIN_MESH_SCRIPT, str(pid), str(port),
         str(root), arch, str(n_model), json.dumps(sketches or {})],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [json.loads((root / f"train_{pid}.json").read_text())
            for pid in range(2)]


def _mesh_train_cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), head_dim=64,
                               use_flash=True, remat="full")


@pytest.mark.parametrize("arch,n_model", [("grok-1-314b", 2),
                                          ("smollm-135m", 1)])
def test_train_under_a_process_mesh_on_one_card_matches_one_process(
        cuda, tmp_path, arch, n_model):
    """``train(cfg, mesh)`` over two processes sharing the card, through
    the flash kernels with full remat (whose recompute runs on autograd's
    device thread): reduced grok-1 expert-parallel under (1, 2), reduced
    smollm-135m data-parallel under (2, 1), against ``train(cfg)`` in one
    process on the card: each step's loss and gradient norm within 1e-5
    relative (f32, TF32 off: the partial gradients' sums in another
    order)."""
    from repro_torch.train.loop import LoopConfig, train

    pair = _train_pair(tmp_path, arch, n_model)
    want = train(_mesh_train_cfg(arch), device=cuda,
                 loop=LoopConfig(steps=3), seq_len=256,
                 global_batch=4)["history"]
    for pid, got in enumerate(pair):
        for g, w in zip(got, want):
            for k in ("loss", "grad_norm"):
                assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (pid, k, g, w)


# the gradient sketches of tests/test_torch_grad_sketch_mesh.py
MESH_SKETCHES = {
    "monitor+compress": {
        "monitor": dict(d=64, eps=0.25, window=64),
        "compress": dict(rank=4, eps=0.25, window=8, min_size=2048,
                         summary_rows=4)},
    "sketchy": {"sketchy": dict(lr=2e-2, rank=4, eps=0.5, window=4,
                                summary_rows=4, warmup=4)}}


@pytest.mark.parametrize("which", sorted(MESH_SKETCHES))
def test_gradient_sketches_under_a_model_axis_on_one_card_match_one_process(
        cuda, tmp_path, which):
    """Reduced grok-1 under (1, 2) over two processes sharing the card,
    with the monitor and compression (AdamW) or with Sketchy, against one
    process on the card: each step's loss, balance loss and gradient norm
    within 2e-4 and the monitor's metrics within 1e-4 (the CPU tests'
    tolerances: the count-sketch sums by atomics, the FD summary is
    carried across the two processes, the blocks' sums are added over the
    axis).  The two processes' losses and norms are held to each other
    alike (the count-sketch's atomics may round their rows apart)."""
    from repro_torch.sketch import (CompressConfig, SketchConfig,
                                    SketchyConfig, sketchy_dsfd)
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.train_step import TrainStepConfig

    kw = MESH_SKETCHES[which]
    pair = _train_pair(tmp_path, "grok-1-314b", 2, kw)
    tsc = TrainStepConfig(
        sketch=SketchConfig(**kw["monitor"]) if "monitor" in kw else None,
        compress=(CompressConfig(**kw["compress"]) if "compress" in kw
                  else None))
    opt = sketchy_dsfd(SketchyConfig(**kw["sketchy"])) if "sketchy" in kw \
        else None
    want = train(_mesh_train_cfg("grok-1-314b"), device=cuda,
                 loop=LoopConfig(steps=3), seq_len=256, global_batch=4,
                 tsc=tsc, opt=opt)["history"]
    for got in pair:
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                tol = 1e-4 if k.startswith("sketch/") else 2e-4
                assert abs(g[k] - w[k]) <= tol * max(abs(w[k]), 1.0), \
                    (k, g, w)


def test_chunked_count_sketch_on_the_card_matches_the_cpu(cuda):
    """A leaf of more than one ``HASH_CHUNK`` (hashed in chunks) and a
    small one: the card's row within 1e-5·‖row‖ of the CPU's (atomics
    sum the same f32 addends in another order)."""
    from repro_torch.sketch import monitor

    rng = np.random.default_rng(31)
    g = {"big": torch.from_numpy(rng.standard_normal(
        (3, monitor.HASH_CHUNK // 2 + 7)).astype(np.float32)),
        "small": torch.from_numpy(rng.standard_normal((5, 9)).astype(
            np.float32))}
    cfg = monitor.SketchConfig(d=128)
    want = monitor.project_grads(cfg, g)
    got = monitor.project_grads(cfg, _to(g, cuda)).cpu()
    assert torch.linalg.vector_norm(got - want) <= 1e-5 * float(
        torch.linalg.vector_norm(want))


def test_analyzer_counts_a_flash_prefill_alike_on_card_and_cpu(cuda):
    """The program analyzer (``launch/hlo.py``) counts a 2-layer bf16
    prefill through the flash kernel on the card as through its plain
    version on the CPU: the same FLOPs, bytes and calls (the kernel by its
    work formula, once a launch)."""
    from repro_torch.launch import hlo

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              head_dim=64, use_flash=True,
                              param_dtype="bfloat16", act_dtype="bfloat16")
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(3),
                         dtype=torch.bfloat16, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 256)).astype(np.int32))
    counts = {}
    for dev in ("cpu", cuda):
        p = {k: ({n: t.to(dev) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        batch = {"tokens": toks.to(dev)}
        before = flash_kernel.flash_fwd.launches
        with torch.no_grad(), hlo.analyze() as a:
            api.forward_prefill(cfg, p, batch)
        counts[str(dev)] = a.stats
        launched = flash_kernel.flash_fwd.launches - before
    assert launched == cfg.n_layers
    cpu, card = counts["cpu"], counts[str(cuda)]
    assert card.kernel_calls == cpu.kernel_calls == {
        "flash_fwd": cfg.n_layers}
    assert card.matmul_flops == cpu.matmul_flops
    assert card.hbm_bytes == cpu.hbm_bytes
    assert card.dot_calls == cpu.dot_calls
