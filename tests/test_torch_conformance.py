"""Registry-wide conformance of the port: every name of
``repro_torch.sketch.api``'s registry × every protocol method, at
``device="cpu"`` — the counterpart of ``tests/sketch/test_conformance.py``
on its stream (360 unit rows, d 16, window 120, ε 1/8) and under its
bounds.  Then ``sketch/runner.py::run_sketch`` against the reference's
(``benchmarks/common.py::run_sketch``) for every name.

The port's own variants (``meta["backend"] == "torch"``) carry the stream
axis S first, so a single sketch is a fleet of one: blocks are (1, B, d),
queries (1, k, d), ``space`` (1,).  The host baselines keep the
reference's one-stream protocol ((B, d) blocks, (k, d) queries, an int
``space``) and have no fleet.

Tolerances: the host baselines run the reference's numpy arithmetic, so
their queries are equal bit for bit and their peaks exact; the torch
variants' queries are held by their Gram BᵀB (SVD rows are unique only up
to sign) within 1e-4 absolute plus 1e-5 relative, with equal peaks: the
stream triples three coordinates before normalising, so Gram entries
reach ~18, and 240 rows of f32 SVD shrinks move them by ~1e-5 relative.
The runner's stream is the conformance stream scaled by 0.9, as the
reference's own ``update_block`` test scales it: a unit row puts ‖a‖² on
Time-DS-FD's level-0 θ = 1, an exact θ tie that the two packages' f32
sums break apart (ROADMAP, parity contract).
"""

import math
import os

import numpy as np
import pytest
import torch

from benchmarks.common import run_sketch as ref_run_sketch
from repro.sketch import api as RA
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.serve.engine import SketchFleetEngine
from repro_torch.sketch import capability as PC
from repro_torch.sketch.api import available_sketches, fleet_streams, \
    make_sketch, shard_streams
from repro_torch.sketch.query import AggTree
from repro_torch.sketch.runner import run_sketch
from repro_torch.tree import leaves

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

N_ROWS, D, WINDOW, EPS = 360, 16, 120, 1 / 8
CHUNK = 30                                   # space sampled per chunk

NAMES = sorted(available_sketches())
HYPER = {"seq-dsfd": {"R": 1.0}, "time-dsfd": {"R": 1.0}}
HOST = ("difd", "lmfd", "swor", "swr")

# the reference suite's ceilings on ‖A_WᵀA_W − BᵀB‖₂ / ‖A_W‖_F²
# (``tests/sketch/test_conformance.py:33-43``)
BOUNDS = {
    "fd": 1.0 * EPS + 1e-3,
    "dsfd": 4.0 * EPS,
    "seq-dsfd": 4.0 * EPS,
    "time-dsfd": 4.0 * EPS,
    "lmfd": 6.0 * EPS,
    "difd": 4.0 * EPS,
    "swr": 4.0 * EPS,
    "swor": 4.0 * EPS,
}
GRAM_ATOL, GRAM_RTOL = 1e-4, 1e-5


def _stream(n=N_ROWS, d=D, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, d)).astype(np.float32)
    A[:, :3] *= 3.0
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    return A


def _rel_err(AW, B):
    B = np.asarray(B, np.float64)
    M = AW.T.astype(np.float64) @ AW - B.T @ B
    return float(np.linalg.norm(M, 2) / np.sum(AW * AW))


def _spec_err2(rows_w, B):
    B = np.asarray(B, np.float64)
    M = rows_w.T.astype(np.float64) @ rows_w - B.T @ B
    return float(np.linalg.norm(M, 2))


def _make(name, **kw):
    return make_sketch(name, d=D, eps=EPS, window=WINDOW, device="cpu",
                       **{**HYPER.get(name, {}), **kw})


def _host(sk):
    return sk.meta["backend"] == "host"


def _block(sk, state, A, ts):
    """Absorb the (B, d) rows ``A`` at times ``ts`` in the variant's own
    form."""
    if _host(sk):
        return sk.update_block(state, A, ts)
    return sk.update_block(state, torch.from_numpy(A)[None],
                           torch.from_numpy(np.asarray(ts, np.int32)))


def _one(sk, state, row, t):
    if _host(sk):
        return sk.update(state, row, t)
    return sk.update(state, torch.from_numpy(row)[None],
                     torch.tensor([t], dtype=torch.int32))


def _rows(sk, out):
    """One stream's (k, d) answer as numpy."""
    out = out if _host(sk) else out[0]
    return np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)


def _space(sk, state):
    sp = sk.space(state)
    return int(sp if _host(sk) else sp[0])


def _space_bound(sk, state0):
    """The variant's stated live-row ceiling (the reference suite's)."""
    name, ell = sk.name, sk.meta["ell"]
    if name == "fd":
        return 2 * ell
    if name == "dsfd":
        cfg = sk.meta["cfg"]
        return 2 * (cfg.cap + cfg.m)
    if name in ("seq-dsfd", "time-dsfd"):
        cfg = sk.meta["cfg"]
        return cfg.levels * 2 * (cfg.base.cap + cfg.base.m)
    if name == "lmfd":
        levels = int(math.log2(max(N_ROWS / state0.q0, 2.0))) + 2
        return (state0.b + 1) * 2 * ell * levels + 2 * ell
    if name == "difd":
        return sum(2 * min(lj, D) * (WINDOW // Lj + 2)
                   for lj, Lj in zip(state0.ell_j, state0.len_j))
    if name == "swr":
        return ell * (4 * int(math.log2(WINDOW)) + 8)
    if name == "swor":
        return 8 * ell + 64 + 64
    raise AssertionError(f"no stated bound for {name}")


def _feed_chunked(sk, A, ts):
    state, spaces = sk.init(), []
    for lo in range(0, len(A), CHUNK):
        state = _block(sk, state, A[lo:lo + CHUNK], ts[lo:lo + CHUNK])
        spaces.append(_space(sk, state))
    return state, spaces


def test_registry_is_the_references():
    assert NAMES == sorted(RA.available_sketches())
    assert set(NAMES) == set(BOUNDS)


@pytest.mark.parametrize("name", NAMES)
def test_protocol_surface(name):
    sk = _make(name)
    for method in ("init", "update", "update_block", "query_rows", "query",
                   "space", "merge"):
        assert callable(getattr(sk, method)), f"{name}.{method} missing"
    for key in ("d", "eps", "window", "ell", "backend", "device"):
        assert key in sk.meta, f"{name}.meta[{key!r}] missing"
    rsk = RA.make_sketch(name, d=D, eps=EPS, window=WINDOW,
                         **HYPER.get(name, {}))
    assert sk.meta["backend"] == {"jax": "torch", "host": "host"}[
        rsk.meta["backend"]]
    assert sk.meta["ell"] == rsk.meta["ell"]
    assert sk.meta["spec"] == rsk.meta["spec"]


@pytest.mark.parametrize("name", NAMES)
def test_state_shapes_dtypes_stable(name):
    """One update and one block keep the state's leaf shapes and types."""
    sk = _make(name)
    A = _stream(n=CHUNK)
    ts = np.arange(1, CHUNK + 1, dtype=np.int32)
    state = sk.init()
    if _host(sk):
        state = sk.update(state, A[0], 1)
        state = sk.update_block(state, A[1:], ts[1:])
        q = np.asarray(sk.query(state, CHUNK))
        assert q.ndim == 2 and q.shape[1] == D and q.dtype == np.float32
        assert int(sk.space(state)) >= 0
        return

    def spec(st):
        return [(tuple(x.shape), x.dtype) for x in leaves(st)]

    spec0 = spec(state)
    s1 = _one(sk, state, A[0], 1)
    s2 = _block(sk, s1, A[1:], ts[1:])
    assert spec(s1) == spec0 and spec(s2) == spec0, f"{name}: state drifted"
    q = sk.query(s2, CHUNK)
    assert q.shape == (1, 2 * sk.meta["ell"], D) and q.dtype == torch.float32
    rows = sk.query_rows(s2, CHUNK)
    assert rows.ndim == 3 and rows.shape[0] == 1 and rows.shape[2] == D
    assert tuple(sk.space(s2).shape) == (1,)


@pytest.mark.parametrize("name", NAMES)
def test_update_block_matches_repeated_update(name):
    n = 48
    A = _stream(n=n, seed=5) * 0.9          # off the θ knife edge
    ts = np.arange(1, n + 1, dtype=np.int32)
    sk = _make(name)
    blocked = _block(sk, sk.init(), A, ts)
    state = sk.init()
    for i in range(n):
        state = _one(sk, state, A[i], int(ts[i]))
    np.testing.assert_allclose(
        _rows(sk, sk.query_rows(blocked, n)),
        _rows(sk, sk.query_rows(state, n)), atol=1e-5,
        err_msg=f"{name}: update_block ≠ repeated update")
    assert _space(sk, blocked) == _space(sk, state)


@pytest.mark.parametrize("name", NAMES)
def test_space_never_exceeds_stated_bound(name):
    sk = _make(name)
    ts = np.arange(1, N_ROWS + 1, dtype=np.int32)
    state, spaces = _feed_chunked(sk, _stream(), ts)
    bound = _space_bound(sk, state)
    assert max(spaces) <= bound, \
        f"{name}: live rows {max(spaces)} > stated bound {bound}"


@pytest.mark.parametrize("name", NAMES)
def test_query_error_within_bound(name):
    sk = _make(name)
    A = _stream()
    ts = np.arange(1, N_ROWS + 1, dtype=np.int32)
    state, _ = _feed_chunked(sk, A, ts)
    AW = A if name == "fd" else A[N_ROWS - WINDOW:]   # fd has no expiry
    err = _rel_err(AW, _rows(sk, sk.query(state, N_ROWS)))
    assert err <= BOUNDS[name], f"{name}: rel err {err:.4f}"
    err_rows = _rel_err(AW, _rows(sk, sk.query_rows(state, N_ROWS)))
    assert err_rows <= BOUNDS[name] + 1e-6


@pytest.mark.parametrize("name", NAMES)
def test_merge(name):
    """Two sketches over disjoint streams of one timeline: the additive FD
    bound for the deterministic variants, structure for the samplers
    (identical seeds refused), LM-FD's documented NotImplementedError."""
    sk = _make(name)
    n = N_ROWS
    A, B = _stream(seed=11), _stream(seed=12)
    ts = np.arange(1, n + 1, dtype=np.int32)
    if name in ("swr", "swor"):
        same = _block(sk, sk.init(), A, ts)
        with pytest.raises(ValueError):
            sk.merge(same, _block(sk, sk.init(), B, ts), n)
        sk1, sk2 = _make(name, seed=1), _make(name, seed=2)
        s1 = _block(sk1, sk1.init(), A, ts)
        s2 = _block(sk2, sk2.init(), B, ts)
    else:
        s1 = _block(sk, sk.init(), A, ts)
        s2 = _block(sk, sk.init(), B, ts)

    if name == "lmfd":
        with pytest.raises(NotImplementedError):
            sk.merge(s1, s2, n)
        return

    space1, space2 = _space(sk, s1), _space(sk, s2)
    q1 = _rows(sk, sk.query_rows(s1, n)).astype(np.float64)
    q2 = _rows(sk, sk.query_rows(s2, n)).astype(np.float64)
    merged = sk.merge(s1, s2, n)

    q = _rows(sk, sk.query(merged, n))
    assert q.ndim == 2 and q.shape[1] == D
    assert _space(sk, merged) <= space1 + space2

    if name in ("swr", "swor"):
        return                                # statistical guarantee only
    w1 = A if name == "fd" else A[n - WINDOW:]
    w2 = B if name == "fd" else B[n - WINDOW:]
    union = np.vstack([w1, w2])
    ell = sk.meta["ell"]
    budget = (_spec_err2(w1, q1) + _spec_err2(w2, q2)
              + (np.sum(q1 * q1) + np.sum(q2 * q2)) / ell)
    err = _spec_err2(union, q)
    assert err <= budget * (1 + 1e-3) + 1e-6, \
        f"{name}: merged err {err:.4f} > additive budget {budget:.4f}"


# -- scoring ------------------------------------------------------------------


N_SCORE = 90


def _scored_state(sk, seed=21):
    A = _stream(n=N_SCORE, seed=seed)
    ts = np.arange(1, N_SCORE + 1, dtype=np.int32)
    return _block(sk, sk.init(), A, ts)


def _scores(sk, out):
    out = out if _host(sk) else out[0]
    return np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)


@pytest.mark.parametrize("name", NAMES)
def test_score_shapes_dtypes_and_nonnegative(name):
    sk = _make(name)
    state = _scored_state(sk)
    X = _stream(n=7, seed=22) * 2.0
    out = _scores(sk, sk.score(state, X, N_SCORE))
    assert out.shape == (7,) and out.dtype == np.float32
    assert np.all(out >= 0.0), f"{name}: negative residual"
    try:
        out_nt = _scores(sk, sk.score(state, X))
    except ValueError as e:
        assert "query time" in str(e)
    else:
        assert out_nt.shape == (7,) and np.all(out_nt >= 0.0)


@pytest.mark.parametrize("name", NAMES)
def test_score_in_basis_row_is_zero(name):
    sk = _make(name)
    state = _scored_state(sk)
    rows = _rows(sk, sk.query_rows(state, N_SCORE)).astype(np.float64)
    live = rows[np.linalg.norm(rows, axis=1) > 0]
    assert live.size, f"{name}: empty sketch after {N_SCORE} rows"
    probe_in = (live[0] / np.linalg.norm(live[0])).astype(np.float32)
    q, _ = np.linalg.qr(np.asarray(live).T, mode="complete")
    probe_out = q[:, -1].astype(np.float32)
    rank = np.linalg.matrix_rank(live)
    out = _scores(sk, sk.score(state, np.stack([probe_in, probe_out]),
                               N_SCORE))
    assert out[0] <= 1e-4, f"{name}: in-basis residual {out[0]}"
    if rank < D:
        assert out[1] >= 0.9, \
            f"{name}: orthogonal probe scored {out[1]}, expected ≈ 1"


@pytest.mark.parametrize("name", HOST)
def test_host_scores_are_the_references(name):
    """The numpy adapter on the same state: the reference's residuals bit
    for bit."""
    sk = _make(name)
    rsk = RA.make_sketch(name, d=D, eps=EPS, window=WINDOW)
    A = _stream(n=N_SCORE, seed=21)
    ts = np.arange(1, N_SCORE + 1, dtype=np.int32)
    st = sk.update_block(sk.init(), A, ts)
    rst = rsk.update_block(rsk.init(), A, ts)
    X = _stream(n=7, seed=22) * 2.0
    assert np.array_equal(sk.score(st, X, N_SCORE),
                          np.asarray(rsk.score(rst, X, N_SCORE)))


# -- capabilities and fleets -------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_capability_introspection_single(name):
    sk = _make(name)
    caps = PC.capabilities(sk)
    assert set(caps) == set(PC.OPTIONAL_FIELDS)
    assert caps["score"].available, f"{name}: score must be universal"
    assert not caps["query_cohort"].available
    assert not caps["query_interval"].available
    assert not caps["ranks"].available
    for cap, info in caps.items():
        if info.available:
            continue
        assert info.reason
        with pytest.raises(ValueError) as ei:
            getattr(sk, cap)()
        assert str(ei.value) == info.reason
        assert "vmap_streams" not in info.reason
    assert "fleet_streams" in caps["query_cohort"].reason
    if _host(sk):
        assert "host-side baseline" in caps["query_cohort"].reason
        assert "host-side baseline" in caps["query_interval"].reason
        assert "torch fleet path" in caps["query_interval"].reason
        # the message for a hand-built baseline with no scorer
        bare = PC.install_missing(sk._replace(score=None))
        assert "numpy adapter" in PC.capabilities(bare)["score"].reason
        assert "repro_torch.sketch.capability.install" in \
            PC.capabilities(bare)["score"].reason
    else:
        assert "single sketch" in caps["query_interval"].reason


@pytest.mark.parametrize("name", NAMES)
def test_capability_introspection_fleet(name):
    """A torch variant lifted to a fleet answers cohorts; a host baseline
    has no fleet: every lift refuses it with the reference's message."""
    sk = _make(name)
    if _host(sk):
        for lift in (lambda: fleet_streams(sk, 3),
                     lambda: shard_streams(sk, 3),
                     lambda: AggTree(sk, 3),
                     lambda: SketchFleetEngine(name, d=D, streams=3,
                                               eps=EPS, window=WINDOW,
                                               device="cpu")):
            with pytest.raises(ValueError, match=r"torch-backed .*"
                               r"backend='host'"):
                lift()
        return
    caps = PC.capabilities(fleet_streams(sk, 3))
    assert caps["query_cohort"].available
    assert caps["score"].available
    assert not caps["query_interval"].available
    assert "history plane" in caps["query_interval"].reason
    assert "install_query_interval(fleet, plane)" \
        in caps["query_interval"].reason


# -- the stream runner --------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_run_sketch_matches_the_reference(name):
    A = _stream() * 0.9                      # off the θ knife edge
    kw = dict(eps=EPS, window=WINDOW, query_every=60, **HYPER.get(name, {}))
    want, want_peak, _ = ref_run_sketch(name, A, **kw)
    got, peak, wall = run_sketch(name, A, device="cpu", **kw)
    assert sorted(got) == sorted(want) == [60, 120, 180, 240, 300, 360]
    assert peak == want_peak and peak > 0
    assert wall > 0.0
    for i in want:
        if name in HOST:
            assert np.array_equal(got[i], want[i]), f"{name} row {i}"
            continue
        g, w = got[i].astype(np.float64), want[i].astype(np.float64)
        np.testing.assert_allclose(g.T @ g, w.T @ w, atol=GRAM_ATOL,
                                   rtol=GRAM_RTOL, err_msg=f"{name} row {i}")


def test_run_sketch_honours_timestamps():
    """Gapped timestamps: a time-based window expires by time, as in the
    reference's runner."""
    A = _stream() * 0.9
    ts = np.cumsum(np.random.default_rng(4).integers(1, 3, N_ROWS))
    for name, hyper in (("swr", {}), ("time-dsfd", {"R": 1.0})):
        kw = dict(eps=EPS, window=WINDOW, query_every=90, timestamps=ts,
                  **hyper)
        want, want_peak, _ = ref_run_sketch(name, A, **kw)
        got, peak, _ = run_sketch(name, A, device="cpu", **kw)
        assert peak == want_peak
        for i in want:
            g, w = got[i].astype(np.float64), want[i].astype(np.float64)
            np.testing.assert_allclose(g.T @ g, w.T @ w, atol=GRAM_ATOL,
                                       rtol=GRAM_RTOL)
