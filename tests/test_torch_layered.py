"""Seq-DS-FD and Time-DS-FD of the port (``repro_torch.core.seq_dsfd``)
held against the reference (``repro.core.seq_dsfd``), on the CPU at small
size.

The parity contract is ``test_torch_dsfd.py``'s: under the fast and exact
cadences whole streams are compared on the selected level's Gram BᵀB
(float32 tolerance, 1e-4 absolute at these window energies) and on the
bookkeeping exactly; under krylov, one tick at a time from the
reference's state re-synced through ``repro_torch.convert``.  Rows are
scaled off exact ties with a threshold: Time-DS-FD's θ₀ = 1 against a
unit row is a tie float rounding breaks either way
(``tests/sketch/test_api.py:87``), so rows here have ‖a‖² log-uniform on
[1, R] and never exactly a power of two.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import seq_dsfd as R
from repro.serve.engine import SketchFleetEngine as RefEngine
from repro_torch import convert
from repro_torch.core import dsfd as PD
from repro_torch.core import seq_dsfd as P
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.serve.engine import SketchFleetEngine

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

TOL = 1e-4
BETA = 4.0


def _rows(n, d, R_, seed, S=2):
    """S streams of n rows with ‖a‖² log-uniform on [1, R_]."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n, d))
    A /= np.linalg.norm(A, axis=2, keepdims=True)
    A *= np.exp(rng.uniform(0, np.log(np.sqrt(R_)), size=(S, n, 1)))
    return A.astype(np.float32)


def _time_stamps(n, seed):
    """Gaps (idle periods) and repeated timestamps (bursts), as the
    reference's ``test_time_based_with_idle_and_bursts``."""
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.geometric(0.4, size=n))
    burst = rng.choice(n, size=n // 20, replace=False)
    ts[burst] = ts[np.maximum(burst - 1, 0)]
    return np.sort(ts).astype(np.int32)


@pytest.mark.parametrize("kind,args", [
    ("seq", (16, 1 / 8, 400, 64.0)), ("seq", (16, 1 / 4, 128, 1.0)),
    ("seq", (300, 1 / 32, 1024, 64.0)), ("time", (16, 1 / 8, 300, 16.0)),
    ("time", (300, 1 / 32, 1024, 16.0)), ("time", (8, 1 / 4, 4, 1.0))])
def test_configs_match_reference(kind, args):
    make_p = P.make_seq_config if kind == "seq" else P.make_time_config
    make_r = R.make_seq_config if kind == "seq" else R.make_time_config
    for mode in ("fast", "krylov"):
        p, r = make_p(*args, mode=mode), make_r(*args, mode=mode)
        assert p.thetas == r.thetas
        assert p.swap_energies == r.swap_energies
        assert p.levels == r.levels
        b, rb = p.base, r.base
        assert (b.d, b.ell, b.window, b.cap, b.mode, b.power_iters) == \
            (rb.d, rb.ell, rb.window, rb.cap, rb.mode, rb.power_iters)
        assert b.use_kernel is False and rb.use_pallas is False
        assert convert.layered_config_from_reference(r) == p


def _ref_run(cfg_r, A, ts, q):
    """The reference's scan, one stream at a time."""
    out = []
    for s in range(A.shape[0]):
        st, o = R.layered_run_stream(cfg_r, jnp.asarray(A[s]),
                                     jnp.asarray(ts), query_every=q)
        out.append((jax.tree.map(np.asarray, st), np.asarray(o)))
    return out


def _assert_runs_match(cfg_p, cfg_r, ts, q, ref, state, outs):
    L = cfg_p.levels
    outs = outs.numpy()
    emitted = 0
    for s, (rstate, routs) in enumerate(ref):
        for i in np.flatnonzero(ts % q == 0):
            b_p, b_r = outs[i, s], routs[i]
            np.testing.assert_allclose(b_p.T @ b_p, b_r.T @ b_r, atol=TOL,
                                       err_msg=f"stream {s} row {i}")
            emitted += 1
        t_end = int(ts[-1])
        rsel = int(R.layered_select(cfg_r, rstate, t_end))
        psel = P.layered_select(cfg_p, state, t_end)[s]
        assert int(psel) == rsel
        for side in ("main", "aux"):
            p, r = getattr(state, side), getattr(rstate, side)
            for f in ("nbuf", "cov_start", "last_t", "snap_next", "start_t"):
                np.testing.assert_array_equal(getattr(p, f)[s].numpy(),
                                              getattr(r, f), err_msg=f)
            np.testing.assert_array_equal(p.snap_valid[s].sum(1).numpy(),
                                          r.snap_valid.sum(1))
            for j in range(L):
                np.testing.assert_allclose(
                    p.buf[s, j].numpy().T @ p.buf[s, j].numpy(),
                    r.buf[j].T @ r.buf[j], atol=TOL)
    assert emitted > 0


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_seq_whole_stream_parity(mode):
    n, d, N, eps, R_ = 360, 16, 64, 1 / 4, 16.0
    A = _rows(n, d, R_, seed=11)
    ts = np.arange(1, n + 1, dtype=np.int32)
    cfg_r = R.make_seq_config(d, eps, N, R_, mode=mode)
    cfg_p = P.make_seq_config(d, eps, N, R_, mode=mode)
    state, outs = P.layered_run_stream(cfg_p, A, ts, query_every=40,
                                       device="cpu")
    _assert_runs_match(cfg_p, cfg_r, ts, 40, _ref_run(cfg_r, A, ts, 40),
                       state, outs)


def test_time_whole_stream_parity_with_gaps_and_bursts():
    n, d, N, eps, R_ = 400, 16, 96, 1 / 4, 8.0
    A = _rows(n, d, R_, seed=13)
    ts = _time_stamps(n, seed=13)
    cfg_r = R.make_time_config(d, eps, N, R_)
    cfg_p = P.make_time_config(d, eps, N, R_)
    state, outs = P.layered_run_stream(cfg_p, A, ts, query_every=10,
                                       device="cpu")
    _assert_runs_match(cfg_p, cfg_r, ts, 10, _ref_run(cfg_r, A, ts, 10),
                       state, outs)


def test_krylov_parity_per_tick():
    """Each tick starts the port from the reference's layered state
    (through ``convert``) and applies one row under the inline floor:
    bookkeeping exact; buffers elementwise where a krylov dump ran and no
    SVD did; Grams everywhere."""
    n, d, N, eps, R_ = 110, 16, 48, 1 / 4, 16.0
    A = _rows(n, d, R_, seed=17, S=3)
    cfg_r = R.make_seq_config(d, eps, N, R_, mode="krylov")
    cfg_p = convert.layered_config_from_reference(cfg_r)
    S = A.shape[0]
    step = jax.jit(jax.vmap(lambda s, r, t: R.layered_update(cfg_r, s, r,
                                                             t)))
    rs = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                      R.layered_init(cfg_r))
    dumped = 0
    for i in range(n):
        t = i + 1
        before = jax.tree.map(np.asarray, rs)
        ps = convert.layered_state_from_numpy(cfg_p, before, device="cpu")
        ps = P.layered_update(cfg_p, ps, torch.from_numpy(A[:, i]), t)
        rs = step(rs, jnp.asarray(A[:, i]), jnp.full((S,), t, jnp.int32))
        got = convert.layered_state_to_numpy(ps)
        want = jax.tree.map(np.asarray, rs)
        for side in ("main", "aux"):
            g, w, b = (getattr(x, side) for x in (got, want, before))
            for f in ("nbuf", "start_t", "last_t", "cov_start", "snap_s",
                      "snap_t", "snap_valid", "snap_next"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                              err_msg=f"{side}.{f} t={t}")
            np.testing.assert_allclose(g.energy, w.energy, rtol=1e-6)
            krylov = (w.snap_next > b.snap_next) & (w.nbuf >= b.nbuf) \
                & (w.energy > b.energy)
            dumped += int(krylov.sum())
            np.testing.assert_allclose(g.buf[krylov], w.buf[krylov],
                                       atol=TOL)
            np.testing.assert_allclose(
                np.einsum("slmd,slme->slde", g.buf, g.buf),
                np.einsum("slmd,slme->slde", w.buf, w.buf), atol=TOL)
    assert dumped > 0, "no krylov dump ran"


def test_bypass_lands_at_the_right_levels():
    """A row with θ₁ ≤ ‖a‖² < θ₂ goes verbatim into the rings of levels 0
    and 1 of main and aux (Algorithm 6 lines 4-6), leaving their buffers
    and energies alone, and into the buffers of the levels above; every
    level's bookkeeping as in the reference."""
    d, N, eps, R_ = 8, 32, 1 / 4, 64.0
    cfg_r = R.make_seq_config(d, eps, N, R_)
    cfg_p = P.make_seq_config(d, eps, N, R_)
    th = cfg_p.thetas
    rng = np.random.default_rng(5)
    row = rng.normal(size=d)
    row = (row / np.linalg.norm(row) * np.sqrt(1.5 * th[1])).astype(
        np.float32)
    ps, _ = P.layered_run_stream(cfg_p, np.stack([row, row]), [1, 2],
                                 device="cpu")
    rs, _ = R.layered_run_stream(cfg_r, jnp.asarray(np.stack([row, row])),
                                 jnp.asarray([1, 2]))
    rs = jax.tree.map(np.asarray, rs)
    for side in ("main", "aux"):
        p, r = getattr(ps, side), getattr(rs, side)
        for f in ("snap_next", "nbuf", "snap_s", "snap_t", "snap_valid",
                  "last_t", "cov_start"):
            np.testing.assert_array_equal(getattr(p, f)[0].numpy(),
                                          getattr(r, f), err_msg=f)
        np.testing.assert_allclose(p.energy[0].numpy(), r.energy)
        assert p.snap_next[0, :2].tolist() == [2, 2]
        assert p.nbuf[0, :2].tolist() == [0, 0]
        assert p.energy[0, :2].tolist() == [0.0, 0.0]
        assert (p.energy[0, 2:] > 0).all()
        np.testing.assert_array_equal(p.snap_v[0, :2, :2].numpy(),
                                      np.broadcast_to(row, (2, 2, d)))
        np.testing.assert_array_equal(p.snap_s[0, :2, :2].numpy(),
                                      [[1, 2], [1, 2]])


def test_dsfd_bypass_and_per_stream_thresholds():
    """``dsfd_update(bypass=True)`` with one θ per stream equals one
    reference sketch per stream at its own θ."""
    from repro.core import dsfd as RD

    d, N = 8, 32
    cfg_r = RD.make_config(d, 1 / 4, N)
    cfg_p = convert.config_from_reference(cfg_r)
    theta = np.array([2.0, 6.0, 30.0], np.float32)
    A = _rows(60, d, 16.0, seed=3, S=3)
    ps = PD.dsfd_init(cfg_p, streams=3, device="cpu")
    for i in range(A.shape[1]):
        ps = PD.dsfd_update(cfg_p, ps, torch.from_numpy(A[:, i]), i + 1,
                            theta=theta, bypass=True)
    upd = jax.jit(lambda st, r, t, th: RD.dsfd_update(
        cfg_r, st, r, t, theta=th, bypass=True))
    for s in range(3):
        rs = RD.dsfd_init(cfg_r)
        for i in range(A.shape[1]):
            rs = upd(rs, jnp.asarray(A[s, i]), i + 1, theta[s])
        rs = jax.tree.map(np.asarray, rs)
        for f in ("nbuf", "snap_next", "cov_start", "last_t"):
            assert int(getattr(ps.main, f)[s]) == int(getattr(rs.main, f)), f
        b_p = PD.dsfd_query_rows(cfg_p, ps)[s].numpy()
        b_r = np.asarray(RD.dsfd_query_rows(cfg_r, rs))
        np.testing.assert_allclose(b_p.T @ b_p, b_r.T @ b_r, atol=TOL)


def _engine_script(S, d, R_, seed, ticks=30):
    rng = np.random.default_rng(seed)
    out = []
    for tick in range(ticks):
        n = int(rng.integers(0, 3 * S))
        users = rng.integers(0, S, n)
        rows = rng.normal(size=(n, d))
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        rows *= np.exp(rng.uniform(0, np.log(np.sqrt(R_)), size=(n, 1)))
        out.append((users, rows.astype(np.float32)))
    return out


@pytest.mark.parametrize("name", ["seq-dsfd", "time-dsfd"])
def test_engine_parity_with_reference(name):
    S, d, N, block, R_ = 4, 12, 48, 4, 8.0
    kw = dict(d=d, streams=S, eps=1 / 4, window=N, block=block, R=R_)
    ref = RefEngine(name, **kw)
    eng = SketchFleetEngine(name, device="cpu", **kw)
    for users, rows in _engine_script(S, d, R_, seed=2, ticks=20):
        for e in (ref, eng):
            e.submit_many(users, rows)
            e.step(advance_time=True)
    assert (eng.t, eng.rows_ingested) == (ref.t, ref.rows_ingested)
    gram = lambda b: b.astype(np.float64).T @ b.astype(np.float64)  # noqa
    for u in range(S):
        np.testing.assert_allclose(gram(eng.query_user(u)),
                                   gram(ref.query_user(u)), atol=TOL)
    np.testing.assert_allclose(gram(eng.query_global()),
                               gram(ref.query_global()), atol=TOL)
    assert eng.space()["per_stream_total"] == \
        ref.space()["per_stream_total"]


def _theorem_worst(cfg, A, ts, eps, N, q):
    state, outs = P.layered_run_stream(cfg, A, ts, query_every=q,
                                       device="cpu")
    outs = outs.numpy()
    worst = 0.0
    for i in np.flatnonzero(ts % q == 0):
        if i + 1 < len(ts) and ts[i + 1] == ts[i]:
            continue                    # a burst: query after its last row
        t = int(ts[i])
        win = (ts >= t - N + 1) & (ts <= t)
        for s in range(A.shape[0]):
            AW = A[s][win].astype(np.float64)
            G = AW.T @ AW
            B = outs[i, s].astype(np.float64)
            err = np.max(np.abs(np.linalg.eigvalsh(G - B.T @ B)))
            worst = max(worst, err / (BETA * eps * max(np.sum(AW * AW),
                                                       1e-9)))
    return worst


@pytest.mark.parametrize("mode", ["fast", "krylov"])
def test_seq_theorem_4_1(mode):
    """Seq-DS-FD on the port: ‖A_WᵀA_W − BᵀB‖₂ ≤ βε‖A_W‖_F², β = 4."""
    n, d, N, eps, R_ = 480, 16, 128, 1 / 8, 64.0
    A = _rows(n, d, R_, seed=21)
    heavy = np.random.default_rng(22).random((2, n)) < 0.02
    A[heavy] *= np.sqrt(0.99 * R_) / np.linalg.norm(A[heavy], axis=1,
                                                    keepdims=True)
    ts = np.arange(1, n + 1, dtype=np.int32)
    worst = _theorem_worst(P.make_seq_config(d, eps, N, R_, mode=mode), A,
                           ts, eps, N, 80)
    assert worst <= 1.0, f"{worst:.2f}·βε‖A_W‖² breaks Theorem 4.1"


@pytest.mark.parametrize("mode", ["fast", "krylov"])
def test_time_corollary_5_1(mode):
    """Time-DS-FD on the port, with gaps and bursts: within βε‖A_W‖_F²."""
    n, d, N, eps, R_ = 480, 16, 128, 1 / 8, 16.0
    A = _rows(n, d, R_, seed=23)
    ts = _time_stamps(n, seed=23)
    worst = _theorem_worst(P.make_time_config(d, eps, N, R_, mode=mode), A,
                           ts, eps, N, 40)
    assert worst <= 1.0, f"{worst:.2f}·βε‖A_W‖² breaks Corollary 5.1"

