"""The port's scoring plane, capabilities and adaptive rank held against
the reference on the CPU at small size.

* ``sketch/basis.py`` and ``dsfd_score``: the port forms the basis from
  the Gram of the ``gram`` kernel's plain version and ``torch.linalg.eigh``
  where the reference uses ``rows @ rows.T`` and ``jnp.linalg.eigh``;
  eigenvalues agree to 1e-4 relative, eigenvectors up to sign, and scores
  (‖x‖² − ‖x Vᵀ‖², a difference of two terms of the size of ‖x‖²) to
  1e-4 of the probe's energy ‖x‖².
* ``ScorePlane`` is the same float64 arithmetic on the host: bitwise.
* The serving engines flag the same users and score probes alike.
* Adaptive-rank FD: the working ranks are decisions, so exact; the
  sketches' Grams to float32 tolerance.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import dsfd as RD
from repro.serve.engine import SketchFleetEngine as RefEngine
from repro.sketch import api as RA
from repro.sketch import basis as RB
from repro.sketch import capability as RC
from repro.sketch import score as RS
from repro_torch import convert
from repro_torch.core import dsfd as PD
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.serve.engine import SketchFleetEngine
from repro_torch.sketch import api as PA
from repro_torch.sketch import basis as PB
from repro_torch.sketch import capability as PC
from repro_torch.sketch import score as PS

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

RTOL = 1e-4
D = 16


def _rows(S, k, d, seed, zero_rows=3):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(S, k, d)).astype(np.float32)
    rows[:, -zero_rows:] = 0.0                   # empty ring slots
    return rows


def _up_to_sign(a, b, atol):
    d_plus = np.abs(a - b).max(axis=-1)
    d_minus = np.abs(a + b).max(axis=-1)
    assert np.all(np.minimum(d_plus, d_minus) <= atol)


def test_basis_matches_reference():
    S, k, d, r = 3, 20, D, 6
    rows = _rows(S, k, d, seed=0)
    X = np.random.default_rng(1).normal(size=(S, 9, d)).astype(np.float32)
    lam, V = PB.topr_basis(torch.from_numpy(rows), r)
    res = PB.residual_scores(torch.from_numpy(rows), torch.from_numpy(X))
    coef, low = PB.project_rank_r(torch.from_numpy(X), V)
    ov = PB.subspace_overlap(V, V)
    for s in range(S):
        lam_r, V_r = RB.topr_basis(jnp.asarray(rows[s]), r)
        lam_r, V_r = np.asarray(lam_r), np.asarray(V_r)
        np.testing.assert_allclose(lam[s].numpy(), lam_r,
                                   rtol=RTOL, atol=RTOL * lam_r.max())
        _up_to_sign(V[s].numpy(), V_r, 1e-4)
        want = np.asarray(RB.residual_scores(jnp.asarray(rows[s]),
                                             jnp.asarray(X[s])))
        np.testing.assert_allclose(res[s].numpy(), want, rtol=RTOL,
                                   atol=RTOL * float(np.sum(X[s] ** 2, 1)
                                                     .max()))
        _, low_r = RB.project_rank_r(jnp.asarray(X[s]), jnp.asarray(V_r))
        np.testing.assert_allclose(low[s].numpy(), np.asarray(low_r),
                                   atol=1e-4)
        np.testing.assert_allclose(float(ov[s]), float(RB.subspace_overlap(
            jnp.asarray(V_r), jnp.asarray(V_r))), rtol=RTOL)
    assert coef.shape == (S, 9, r)
    # an (n, d) probe block is scored against every stream
    shared = PB.residual_scores(torch.from_numpy(rows), torch.from_numpy(X[0]))
    torch.testing.assert_close(shared[0], res[0])


def test_topr_basis_of_empty_rows_is_zero():
    lam, V = PB.topr_basis(torch.zeros((2, 6, 5)), 3)
    assert not lam.any() and not V.any()


@pytest.mark.parametrize("mode", ["fast", "krylov"])
def test_dsfd_score_matches_reference(mode):
    S, n, N = 3, 150, 48
    cfg_r = RD.make_config(D, 1 / 4, N, mode=mode)
    cfg_p = convert.config_from_reference(cfg_r)
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(3, D))
    A = np.stack([dirs[s % 3] * rng.normal(size=(n, 1))
                  + 0.2 * rng.normal(size=(n, D)) for s in range(S)])
    A = (A / np.linalg.norm(A, axis=2, keepdims=True)).astype(np.float32)
    state = jax.vmap(lambda a: RD.dsfd_run_stream(cfg_r, a)[0])(
        jnp.asarray(A))
    X = rng.normal(size=(S, 5, D)).astype(np.float32)
    X[:, 0] = dirs[np.arange(S) % 3]               # in the window's span
    for t in (None, n + 20):
        want = np.asarray(jax.vmap(lambda s, x: RD.dsfd_score(
            cfg_r, s, x, now=t))(state, jnp.asarray(X)))
        ps = convert.dsfd_state_from_numpy(cfg_p, jax.tree.map(np.asarray,
                                                               state),
                                           device="cpu")
        got = PD.dsfd_score(cfg_p, ps, torch.from_numpy(X), now=t).numpy()
        # relative to each probe's energy: the score is ‖x‖² − ‖x Vᵀ‖²
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * float(np.sum(X * X, 2).max()))
        sk = PA.make_sketch("dsfd", d=D, eps=1 / 4, window=N, mode=mode,
                            device="cpu")
        np.testing.assert_array_equal(sk.score(ps, X, t).numpy(), got)


def test_host_residual_scores_match_reference():
    rows = _rows(1, 12, D, seed=5)[0]
    X = np.random.default_rng(6).normal(size=(7, D))
    for r in (rows, np.zeros_like(rows)):
        np.testing.assert_array_equal(PS.host_residual_scores(r, X),
                                      RS.host_residual_scores(r, X))


def test_score_plane_is_bitwise_the_reference():
    rng = np.random.default_rng(7)
    kw = dict(ema=0.2, zscore=2.5, warmup=3)
    p, r = PS.ScorePlane(6, **kw), RS.ScorePlane(6, **kw)
    for tick in range(30):
        scores = rng.gamma(2.0, size=(6, 4))
        if tick in (12, 20):
            scores[tick % 6] *= 40                 # spikes
        counts = rng.integers(0, 5, 6)
        np.testing.assert_array_equal(p.observe(scores, counts),
                                      r.observe(scores, counts))
        for k in ("mean", "var", "count", "flagged", "last"):
            a, b = getattr(p, k), getattr(r, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    np.testing.assert_array_equal(p.anomalies(reset=True),
                                  r.anomalies(reset=True))
    assert p.anomalies().size == 0


def _score_script(S, seed):
    """Warm in-subspace traffic, then a spike on user 2 and a burst of
    off-subspace rows on user 4."""
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((2, D)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ticks = []
    for tick in range(14):
        users, rows = [], []
        for u in range(S):
            for _ in range(int(rng.integers(1, 4))):
                c = rng.standard_normal(2).astype(np.float32)
                row = c @ dirs
                if tick == 11 and u == 2:
                    row = rng.standard_normal(D).astype(np.float32) * 10
                if tick == 12 and u == 4:
                    row = rng.standard_normal(D).astype(np.float32)
                users.append(u)
                rows.append(row)
        ticks.append((np.asarray(users), np.stack(rows)))
    return ticks, dirs, rng


def test_engine_anomalies_and_scores_match_reference():
    S = 6
    kw = dict(d=D, streams=S, eps=1 / 4, window=96, block=4, score=True,
              score_warmup=3, score_zscore=3.0)
    ref = RefEngine("dsfd", **kw)
    eng = SketchFleetEngine("dsfd", device="cpu", **kw)
    ticks, dirs, rng = _score_script(S, seed=31)
    for users, rows in ticks:
        for e in (ref, eng):
            e.submit_many(users, rows)
            e.step()
        np.testing.assert_array_equal(eng.anomalies(), ref.anomalies())
    flagged = eng.anomalies(reset=True)
    assert 2 in flagged and 4 in flagged
    np.testing.assert_array_equal(flagged, ref.anomalies(reset=True))
    assert eng.anomalies().size == 0
    np.testing.assert_allclose(eng.score_plane.mean, ref.score_plane.mean,
                               rtol=RTOL, atol=RTOL)
    novel = np.linalg.qr(np.vstack([dirs, rng.standard_normal(
        (D - 2, D)).astype(np.float32)]).T)[0][:, -1].astype(np.float32)
    probes = np.stack([dirs[0], novel, rng.standard_normal(D)]).astype(
        np.float32)
    for got, want in ((eng.score_cohort(probes), ref.score_cohort(probes)),
                      (eng.score_cohort(probes, [0, 1, 5]),
                       ref.score_cohort(probes, [0, 1, 5])),
                      (eng.score_rows(probes, user=1),
                       ref.score_rows(probes, user=1)),
                      (eng.score_rows(probes), ref.score_rows(probes))):
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    assert eng.score_rows(probes, user=1)[0] <= 1e-3
    assert eng.score_cohort(probes)[1] >= 0.5
    with pytest.raises(ValueError, match="score=True"):
        SketchFleetEngine("dsfd", d=D, streams=2, device="cpu").anomalies()


def _adaptive_streams(S, n, seed):
    rng = np.random.default_rng(seed)
    A = np.stack([rng.normal(size=(n, 2)) @ rng.normal(size=(2, D))
                  + 0.05 * rng.normal(size=(n, D)) for _ in range(S)])
    return (A / np.linalg.norm(A, axis=2, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("target,ell0", [(0.05, None), (0.002, 3)])
def test_adaptive_fd_matches_reference(target, ell0):
    S, n = 4, 160
    kw = dict(d=D, eps=1 / 8, window=96, adapt_target=target, ell0=ell0)
    rsk = RA.make_sketch("fd", **kw)
    psk = PA.make_sketch("fd", device="cpu", **kw)
    assert psk.meta["adapt"] == rsk.meta["adapt"]
    rf, pf = RA.vmap_streams(rsk, S), PA.fleet_streams(psk, S)
    X = _adaptive_streams(S, n, seed=10)
    rs = rf.init()
    ps = pf.init()
    ranks_seen = set(pf.ranks(ps).tolist())
    for lo in range(0, n, 20):                  # compared every 20 rows
        ts = np.arange(lo + 1, lo + 21, dtype=np.int32)
        rs = rf.update_block(rs, jnp.asarray(X[:, lo:lo + 20]),
                             jnp.asarray(ts))
        ps = pf.update_block(ps, torch.from_numpy(X[:, lo:lo + 20]),
                             torch.from_numpy(ts))
        np.testing.assert_array_equal(pf.ranks(ps).numpy(),
                                      np.asarray(rf.ranks(rs)))
        np.testing.assert_array_equal(ps.nbuf.numpy(), np.asarray(rs.nbuf))
        ranks_seen |= set(pf.ranks(ps).tolist())
        for s in range(S):
            b_p, b_r = ps.buf[s].numpy(), np.asarray(rs.buf[s])
            np.testing.assert_allclose(b_p.T @ b_p, b_r.T @ b_r, atol=1e-4,
                                       rtol=1e-5)
        np.testing.assert_allclose(ps.shed.numpy(), np.asarray(rs.shed),
                                   rtol=1e-4, atol=1e-5)
    assert len(ranks_seen) > 1, "the controller never moved the rank"
    sp = pf.space(ps)
    np.testing.assert_array_equal(sp.ranks.numpy(), np.asarray(rf.ranks(rs)))
    # the stream-wise merge restores the stream accounting
    m_p = psk.merge(ps, ps)
    m_r = jax.vmap(lambda a, b: rsk.merge(a, b))(rs, rs)
    np.testing.assert_array_equal(m_p.ell.numpy(), np.asarray(m_r.ell))
    np.testing.assert_allclose(m_p.energy.numpy(), np.asarray(m_r.energy),
                               rtol=1e-5)
    back = convert.adaptive_state_from_numpy(jax.tree.map(np.asarray, rs),
                                             device="cpu")
    np.testing.assert_array_equal(back.ell.numpy(), ps.ell.numpy())


def test_engine_ranks_and_space_match_reference():
    S = 3
    kw = dict(d=D, streams=S, eps=1 / 8, window=96, block=4,
              adapt_target=0.05)
    ref, eng = RefEngine("fd", **kw), SketchFleetEngine("fd", device="cpu",
                                                        **kw)
    X = _adaptive_streams(S, 60, seed=12)
    users = np.repeat(np.arange(S), 60)
    for e in (ref, eng):
        e.submit_many(users, X.reshape(-1, D))
        e.run()
    np.testing.assert_array_equal(eng.ranks(), ref.ranks())
    assert eng.space() == ref.space()
    with pytest.raises(ValueError, match="adapt_target"):
        SketchFleetEngine("dsfd", d=D, streams=2, device="cpu").ranks()


def _variants():
    return [("dsfd", {}), ("fd", {}), ("fd", {"adapt_target": 0.05}),
            ("seq-dsfd", {"R": 4.0}), ("time-dsfd", {"R": 4.0})]


@pytest.mark.parametrize("name,hyper", _variants())
def test_capabilities_match_reference(name, hyper):
    rsk = RA.make_sketch(name, d=D, eps=1 / 4, window=32, **hyper)
    psk = PA.make_sketch(name, d=D, eps=1 / 4, window=32, device="cpu",
                         **hyper)
    for p, r in ((psk, rsk), (PA.fleet_streams(psk, 3),
                              RA.vmap_streams(rsk, 3))):
        cp, cr = PC.capabilities(p), RC.capabilities(r)
        assert {k: v.available for k, v in cp.items()} == \
            {k: v.available for k, v in cr.items()}
        for k, info in cp.items():
            if not info.available:
                assert "vmap_streams" not in info.reason
                assert "shard_streams" not in info.reason
                with pytest.raises(ValueError):
                    getattr(p, k)()
    assert psk.meta["spec"] == rsk.meta["spec"]
    psk.meta["spec"]["hyper"]["x"] = 1          # a per-call copy
    assert "x" not in PA.make_sketch(name, d=D, eps=1 / 4, window=32,
                                     device="cpu", **hyper).meta["spec"][
                                         "hyper"]


def test_layered_queries_need_a_time():
    sk = PA.make_sketch("seq-dsfd", d=D, eps=1 / 4, window=32, R=4.0,
                        device="cpu")
    st = sk.init(streams=2)
    with pytest.raises(ValueError, match="explicit query time"):
        sk.query_rows(st)
    with pytest.raises(ValueError, match="explicit query time"):
        sk.score(st, np.ones((1, D), np.float32))
    assert sk.query(st, 5).shape == (2, 2 * sk.meta["ell"], D)
    assert sk.space(st).tolist() == [0, 0]
