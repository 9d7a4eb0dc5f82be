"""The port's copies of the paper's baselines (``repro_torch.core.
baselines``: LM-FD, DI-FD, SWR, SWOR) held against the reference's
classes on the same seeded streams, and the reference's own baseline
tests (``tests/core/test_baselines.py``) run against the port.

Both packages run the same numpy arithmetic (``np.linalg.svd`` in NpFD)
and draw from ``np.random.default_rng(seed)`` in the same order, so every
query must give the reference's rows bit for bit (``np.array_equal``),
with the same stored-row count at every query point.
"""

import os

import numpy as np
import pytest

from repro.core import baselines as ref
from repro_torch.core import baselines as port
from repro_torch.launch.mesh import pin_host_threads

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

N_ROWS, D, WINDOW, EPS = 2400, 12, 400, 1 / 8
QUERY_EVERY = 200


def _stream(n, d, seed=0, R=1.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, d)).astype(np.float32)
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    if R > 1:
        A *= np.exp(rng.uniform(0, np.log(np.sqrt(R)), size=(n, 1)))
    return A.astype(np.float32)


def _pair(name, seed=0, **kw):
    """(reference instance, port instance) of one baseline."""
    if name in ("swr", "swor"):
        cls = {"swr": "SWR", "swor": "SWOR"}[name]
        ell = kw.pop("ell", 16)
        return tuple(getattr(m, cls)(D, ell=ell, window=WINDOW, seed=seed,
                                     **kw) for m in (ref, port))
    cls = {"lmfd": "LMFD", "difd": "DIFD"}[name]
    return tuple(getattr(m, cls)(D, EPS, WINDOW, **kw) for m in (ref, port))


CASES = {
    "lmfd": ("lmfd", {}, 1.0),
    "lmfd-b3": ("lmfd", {"blocks_per_level": 3}, 1.0),
    "lmfd-R16": ("lmfd", {}, 16.0),
    "difd": ("difd", {}, 1.0),
    "difd-R16": ("difd", {"R": 16.0}, 16.0),
    "swr": ("swr", {}, 1.0),
    "swr-R16": ("swr", {}, 16.0),
    "swor": ("swor", {}, 1.0),
    "swor-R16": ("swor", {"ell": 24}, 16.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_queries_are_the_references_bit_for_bit(case):
    name, kw, R = CASES[case]
    A = _stream(N_ROWS, D, seed=1, R=R)
    r, p = _pair(name, **kw)
    for i in range(N_ROWS):
        r.update(A[i])
        p.update(A[i])
        assert p.n_rows_stored == r.n_rows_stored
        if (i + 1) % QUERY_EVERY == 0:
            want, got = r.query(), p.query()
            assert got.dtype == want.dtype
            assert np.array_equal(got, want), f"{case} row {i + 1}"
    assert p.t == r.t == N_ROWS


def test_timestamps_and_gaps_are_the_references():
    """Explicit timestamps with gaps: expiry follows the given times."""
    A = _stream(600, D, seed=2, R=4.0)
    ts = np.cumsum(np.random.default_rng(3).integers(1, 4, 600))
    for name in ("lmfd", "difd", "swr", "swor"):
        r, p = _pair(name)
        for i in range(600):
            r.update(A[i], int(ts[i]))
            p.update(A[i], int(ts[i]))
        assert np.array_equal(p.query(), r.query()), name
        assert p.n_rows_stored == r.n_rows_stored, name


@pytest.mark.parametrize("name", ["difd", "swr", "swor"])
def test_combine_is_the_references(name):
    """Two instances over disjoint streams of one timeline, combined:
    the port's merged state answers as the reference's does."""
    A, B = _stream(800, D, seed=4), _stream(800, D, seed=5)
    seeds = (1, 2) if name in ("swr", "swor") else (0, 0)
    r1, p1 = _pair(name, seed=seeds[0])
    r2, p2 = _pair(name, seed=seeds[1])
    for i in range(800):
        for inst in (r1, p1):
            inst.update(A[i])
        for inst in (r2, p2):
            inst.update(B[i])
    assert r1.combine(r2) is r1 and p1.combine(p2) is p1
    assert np.array_equal(p1.query(), r1.query())
    assert p1.n_rows_stored == r1.n_rows_stored
    # later updates of either side leave the other alone (deep copies)
    p2.update(A[0])
    assert np.array_equal(p1.query(), r1.query())


@pytest.mark.parametrize("name", ["swr", "swor"])
def test_samplers_refuse_identical_seeds(name):
    r1, p1 = _pair(name, seed=3)
    r2, p2 = _pair(name, seed=3)
    for a, b in ((r1, r2), (p1, p2)):
        with pytest.raises(ValueError, match="independently-seeded"):
            a.combine(b)


def test_combine_refuses_other_configurations():
    p = port.DIFD(D, EPS, WINDOW)
    with pytest.raises(ValueError, match="identically-configured"):
        p.combine(port.DIFD(D, EPS, 2 * WINDOW))
    s = port.SWR(D, ell=8, window=WINDOW, seed=1)
    with pytest.raises(ValueError, match="identically-configured"):
        s.combine(port.SWR(D, ell=9, window=WINDOW, seed=2))


def test_lmfd_combine_raises_the_documented_error():
    r, p = _pair("lmfd")
    with pytest.raises(NotImplementedError) as want:
        r.combine(_pair("lmfd")[0])
    with pytest.raises(NotImplementedError) as got:
        p.combine(_pair("lmfd")[1])
    assert str(got.value) == str(want.value)


def test_npfd_matches_the_reference():
    A = _stream(300, D, seed=6, R=9.0)
    r, p = ref.NpFD(4, D), port.NpFD(4, D)
    for i in range(300):
        r.update(A[i])
        p.update(A[i])
        if i % 37 == 0:
            assert np.array_equal(p.query(), r.query())
    assert np.array_equal(p.rows(), r.rows())
    assert p.fro == r.fro and p.nbuf == r.nbuf


# -- the reference's own baseline tests, on the port --------------------------


def _worst(alg, A, N, q=400):
    worst = 0.0
    for i in range(len(A)):
        alg.update(A[i])
        t = i + 1
        if t % q == 0 and t >= N:
            B = alg.query()
            AW = A[t - N:t]
            err = np.linalg.norm(AW.T @ AW - B.T @ B, 2)
            worst = max(worst, err / max(np.sum(AW * AW), 1e-9))
    return worst


@pytest.mark.parametrize("cls,tol", [(port.LMFD, 8.0), (port.DIFD, 8.0)])
def test_deterministic_baselines_error(cls, tol):
    """LM-FD and DI-FD within 8ε (paper §7.1)."""
    n, d, N, eps = 2400, 12, 400, 1 / 8
    assert _worst(cls(d, eps, N), _stream(n, d), N) <= tol * eps


@pytest.mark.parametrize("cls", [port.SWR, port.SWOR])
def test_sampling_baselines_error(cls):
    n, d, N, eps = 2400, 12, 400, 1 / 4
    alg = cls(d, ell=int(2 / eps ** 2), window=N, seed=0)
    assert _worst(alg, _stream(n, d), N) <= 1.0


def test_space_accounting_monotone_in_precision():
    """Space grows as ε shrinks — Figure 7's x-axis sanity."""
    n, d, N = 1500, 10, 300
    A = _stream(n, d)
    sizes = []
    for eps in (1 / 4, 1 / 8, 1 / 16):
        alg = port.LMFD(d, eps, N)
        peak = 0
        for i in range(n):
            alg.update(A[i])
            peak = max(peak, alg.n_rows_stored)
        sizes.append(peak)
    assert sizes[0] < sizes[1] < sizes[2]


def test_swor_distinct_rows():
    n, d, N = 800, 8, 200
    A = _stream(n, d, seed=9)
    alg = port.SWOR(d, ell=8, window=N, seed=1)
    for i in range(n):
        alg.update(A[i])
    B = alg.query()
    assert B.shape[0] <= 8
    assert np.isfinite(B).all()
    assert len({row.tobytes() for row in B}) == B.shape[0]
