"""The port's fleet engine (``repro_torch.serve``) against the reference
engine, and its ingest contract, on the CPU at small size.

One submit/step script runs through both engines; the clock and
``rows_ingested`` must match exactly and every ``query_user`` /
``query_global`` answer must have the reference's Gram BᵀB within float32
tolerance (sign-free: SVD rows differ in sign between torch and JAX; the
global fold has the reference's ``AggTree.query(ALL)`` association, so the
same merges run in the same order).  Under krylov the trajectories part
after the first SVD sign flip (see ``test_torch_dsfd.py``), so the krylov
engine is held to Theorem 3.1 instead.  Inside the port, sync and async
ingest and ``submit_many`` vs ``submit`` must give identical states.
"""

import os

import numpy as np
import pytest
import torch

from repro.serve.engine import SketchFleetEngine as RefEngine
from repro_torch.core.errors import window_gram_np
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.serve.engine import SketchFleetEngine
from repro_torch.serve.ingest import AdmissionQueue, IngestBacklogError, \
    SlabTransfer, make_pipeline
from repro_torch.tree import leaves

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

S, D, N_WIN, BLOCK, EPS = 5, 16, 64, 4, 1 / 4
TOL = 1e-4   # float32 Grams with entries up to ~N: see test_torch_dsfd.py


def _script(seed, ticks=40):
    """Per tick: (users, rows, batched?) — ragged per-user arrival with
    piecewise directions, so dumps, shrinks, expiry and swaps all run."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(6, D))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    out = []
    for tick in range(ticks):
        n = int(rng.integers(0, 3 * S))
        users = rng.integers(0, S, n)
        rows = dirs[(users + tick // 8) % 6] + 0.05 * rng.normal(size=(n, D))
        rows = (rows / np.linalg.norm(rows, axis=1, keepdims=True))
        out.append((users, rows.astype(np.float32), tick % 2 == 1))
    return out


def _drive(eng, script):
    for users, rows, batched in script:
        if batched:
            eng.submit_many(users, rows)
        else:
            for u, r in zip(users, rows):
                eng.submit(int(u), r)
        eng.step()
    eng.run()
    return eng


def _port(**kw):
    args = dict(d=D, streams=S, eps=EPS, window=N_WIN, block=BLOCK,
                device="cpu")
    args.update(kw)
    return SketchFleetEngine("dsfd", **args)


@pytest.fixture(scope="module")
def script():
    return _script(seed=1)


@pytest.fixture(scope="module")
def ref_engine(script):
    eng = RefEngine("dsfd", d=D, streams=S, eps=EPS, window=N_WIN,
                    block=BLOCK, mode="fast")
    _drive(eng, script)
    return eng, [eng.query_user(u) for u in range(S)], eng.query_global()


def _gram(b):
    return b.astype(np.float64).T @ b.astype(np.float64)


def test_engine_parity_with_reference(script, ref_engine):
    ref, users, glob = ref_engine
    eng = _drive(_port(mode="fast"), script)
    assert (eng.t, eng.rows_ingested) == (ref.t, ref.rows_ingested)
    for u in range(S):
        np.testing.assert_allclose(_gram(eng.query_user(u)), _gram(users[u]),
                                   atol=TOL, err_msg=f"user {u}")
    np.testing.assert_allclose(_gram(eng.query_global()), _gram(glob),
                               atol=TOL)


def test_query_global_fold_matches_reference_for_odd_fleets():
    """The midpoint fold of an odd fleet (unbalanced tree) against the
    reference's AggTree root, from the same per-stream states."""
    script = _script(seed=4, ticks=20)
    S3 = 3
    ref = RefEngine("dsfd", d=D, streams=S3, eps=EPS, window=N_WIN,
                    block=BLOCK)
    eng = SketchFleetEngine("dsfd", d=D, streams=S3, eps=EPS, window=N_WIN,
                            block=BLOCK, device="cpu")
    for users, rows, _ in script:
        keep = users < S3
        for e in (ref, eng):
            e.submit_many(users[keep], rows[keep])
            e.step()
    np.testing.assert_allclose(_gram(eng.query_global()),
                               _gram(ref.query_global()), atol=TOL)


def test_krylov_engine_holds_theorem_3_1():
    """Krylov through the fused kernels' plain versions: every user's
    window sketch within 4εN of the exact window covariance."""
    rng = np.random.default_rng(8)
    dirs = rng.normal(size=(4, D))
    eng = _port(mode="krylov", use_kernel=True)
    hist = [[] for _ in range(S)]
    for tick in range(60):
        # at most BLOCK rows per user, so each tick takes all of them and
        # a user's timeline is its rows, then zero (idle) rows to BLOCK
        k = rng.integers(0, BLOCK + 1, S)
        users = np.repeat(np.arange(S), k)
        rows = dirs[(users + tick // 10) % 4] + 0.1 * rng.normal(
            size=(users.size, D))
        rows = (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
            np.float32)
        eng.submit_many(users, rows)
        eng.step(advance_time=True)
        for u in range(S):
            hist[u].append(rows[users == u])
            hist[u].append(np.zeros((BLOCK - k[u], D), np.float32))
    for u in range(S):
        A = np.concatenate(hist[u]).astype(np.float64)
        G = window_gram_np(A, eng.t, N_WIN)
        B = eng.query_user(u).astype(np.float64)
        err = np.max(np.abs(np.linalg.eigvalsh(G - B.T @ B)))
        assert err <= 4 * EPS * N_WIN, f"user {u}: {err:.3f} > 4εN"


def _states_equal(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["fast", "krylov"])
def test_sync_equals_async(script, mode):
    hyper = {"use_kernel": True} if mode == "krylov" else {}
    a = _drive(_port(mode=mode, ingest="async", **hyper), script)
    b = _drive(_port(mode=mode, ingest="sync", **hyper), script)
    assert (a.t, a.rows_ingested) == (b.t, b.rows_ingested)
    _states_equal(a.state, b.state)


def test_async_tops_up_rows_submitted_after_staging():
    """Rows submitted between staging and dispatch join the staged slab,
    exactly as a synchronous tick would take them."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(3, 2 * BLOCK, D)).astype(np.float32)
    a, b = _port(ingest="async"), _port(ingest="sync")
    for e in (a, b):
        e.submit_many(np.zeros(2 * BLOCK, int), X[0])
        e.step()                       # async stages user 0's second block
        e.submit_many(np.ones(BLOCK, int), X[1, :BLOCK])
        e.step()
    assert a.backlog == b.backlog == 0
    _states_equal(a.state, b.state)


def test_submit_many_equals_submit(script):
    a = _port()
    b = _port()
    for users, rows, _ in script:
        a.submit_many(users, rows)
        for u, r in zip(users, rows):
            b.submit(int(u), r)
        a.step()
        b.step()
    _states_equal(a.state, b.state)


def test_idle_step_is_clock_neutral_and_advance_time_ages():
    eng = _port()
    assert eng.step() == 0 and eng.t == 0
    eng.submit(0, np.ones(D, np.float32) / 4.0)
    assert eng.step() == 1 and eng.t == BLOCK
    for _ in range(3):
        assert eng.step() == 0
    assert eng.t == BLOCK
    before = eng.query_user(0)
    assert np.abs(before).sum() > 0
    for _ in range(N_WIN // BLOCK + 1):
        eng.step(advance_time=True)
    assert eng.t == BLOCK + (N_WIN // BLOCK + 1) * BLOCK


def test_run_budget_and_backpressure():
    eng = _port(queue_capacity=2 * S)
    rows = np.ones((3 * S, D), np.float32)
    mask = eng.submit_many(np.arange(3 * S) % S, rows)
    assert mask.sum() == 2 * S and mask[:2 * S].all()
    assert not eng.submit(0, rows[0])
    for ingest in ("sync", "async"):
        eng = _port(ingest=ingest)
        eng.submit_many(np.zeros(3 * BLOCK, int), rows[:3 * BLOCK])
        with pytest.raises(IngestBacklogError) as ei:
            eng.run(max_ticks=1)
        assert ei.value.remaining == 2 * BLOCK == eng.backlog
        with pytest.warns(RuntimeWarning, match="did NOT complete"):
            assert eng.run(max_ticks=1, on_budget="warn") == 1
        assert eng.run() == 1 and eng.backlog == 0


def test_admission_validation():
    q = AdmissionQueue(S, D)
    with pytest.raises(ValueError, match="outside"):
        q.submit(S, np.zeros(D))
    with pytest.raises(ValueError, match="shape"):
        q.submit(0, np.zeros(D + 1))
    with pytest.raises(ValueError, match="1-D integer"):
        q.submit_many(np.zeros((2, 2), int), np.zeros((4, D)))
    assert q.backlog == 0
    with pytest.raises(ValueError, match="unknown ingest mode"):
        make_pipeline("eager", q, block=BLOCK,
                      transfer=SlabTransfer("cpu"))
