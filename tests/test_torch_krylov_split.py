"""The split route of the krylov dump step (``repro_torch.kernels.fused_tick
.ops``), held against the fused plain versions and the reference.

Where one stream's (m, d) buffer does not fit one CTA's shared memory,
``gram_power`` and ``fused_krylov_step`` run the chain of the reference's
inline krylov branch through the unfused kernels instead (v-extraction,
``rank1_downdate``, ``gram``, ``power_iter``).  The route depends on (m, d)
alone, so the CPU takes it at the same shapes as an H100.  The tests force
it at small shapes by lowering the route's limit, and run one engine
unpatched at the smallest shape past the limit.

Tolerances: the split chain and the fused plain version compute the same
f32 function in another order (~1e-7 relative per operation): 1e-5.  The
per-tick parity with the reference uses the tolerances of
``test_torch_dsfd.py``'s krylov test (1e-4: f32 Grams with entries up to
N = 64).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import dsfd as R
from repro_torch import convert
from repro_torch.core import dsfd as P
from repro_torch.data.streams import SyntheticSource
from repro_torch.kernels.fused_tick import ops, ref
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.serve.engine import SketchFleetEngine

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

TOL = 1e-4


@pytest.fixture
def split_everywhere(monkeypatch):
    """Every (m, d) takes the split route; counts the chain's calls."""
    monkeypatch.setattr(ops, "H100_SMEM_PER_BLOCK", 0)
    calls = {"gram": 0, "power_iter": 0, "rank1_downdate": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("m,d,want", [(64, 300, "fused"), (128, 300, "fused"),
                                      (256, 300, "split"),
                                      (128, 318, "split"),
                                      # the edges the fused kernels must take
                                      (128, 317, "fused"), (200, 37, "fused"),
                                      (238, 1, "fused"), (239, 1, "split"),
                                      (64, 823, "fused"), (64, 824, "split")])
def test_route_is_a_function_of_the_shape(m, d, want):
    assert ops.route(m, d) == want
    assert ops.route(m, d, torch.device("cpu")) == want
    assert (ops.fused_tick_smem_bytes(m, d) <= ops.H100_SMEM_PER_BLOCK) \
        == (want == "fused")


@pytest.mark.parametrize("floor_norm", [False, True])
@pytest.mark.parametrize("S,m,d", [(3, 8, 32), (2, 13, 37), (2, 1, 5)])
def test_split_route_equals_the_fused_plain_versions(split_everywhere, S, m,
                                                     d, floor_norm):
    rng = np.random.default_rng(S * m + d)
    D = torch.from_numpy(rng.normal(size=(S, m, d)).astype(np.float32))
    lam, u = ops.gram_power(D, iters=24, floor_norm=floor_norm)
    lam_f, u_f = ref.gram_power_ref(D, 24, floor_norm)
    torch.testing.assert_close(lam, lam_f, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(u, u_f, rtol=0, atol=1e-5)
    got = ops.fused_krylov_step(D, lam_f, u_f, iters=24,
                                floor_norm=floor_norm)
    want = ref.fused_krylov_step_ref(D, lam_f, u_f, 24, floor_norm)
    scale = max(float(D.abs().max()) ** 2, 1.0)
    for g, w, name in zip(got, want, ["snap", "D'", "lam'", "u'"]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * scale,
                                   msg=name)
    assert split_everywhere == {"gram": 2, "power_iter": 2,
                                "rank1_downdate": 1}


def test_split_route_on_a_zero_buffer(split_everywhere):
    D = torch.zeros((2, 8, 32))
    for fl in (False, True):
        lam, u = ops.gram_power(D, iters=24, floor_norm=fl)
        assert torch.all(lam == 0) and torch.all(u == 0)
        for o in ops.fused_krylov_step(D, lam, u, iters=24, floor_norm=fl):
            assert torch.isfinite(o).all()


def _streams(n, d, seed):
    """iid and piecewise-direction streams of unit rows (the parity
    families of ``test_torch_dsfd.py``; the spike family ties σ₁² with θ)."""
    rng = np.random.default_rng(seed)
    A0 = rng.normal(size=(n, d))
    dirs = rng.normal(size=(8, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    A1 = dirs[(np.arange(n) // (n // 8)) % 8] + 0.05 * rng.normal(size=(n, d))
    out = np.stack([A0, A1]).astype(np.float32)
    return out / np.linalg.norm(out, axis=2, keepdims=True)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_krylov_parity_per_tick_on_the_split_route(split_everywhere,
                                                   use_kernel):
    """Each tick starts the port from the reference's state (through
    ``convert``) and applies one update with every dump step on the split
    route; buffers and snapshots match where no SVD ran, an SVD shrink is
    compared sign-free, the bookkeeping exactly."""
    d, N, eps = 16, 64, 1 / 4
    streams = _streams(320, d, seed=3)
    cfg_r = R.make_config(d, eps, N, mode="krylov", use_pallas=use_kernel)
    cfg_p = convert.config_from_reference(cfg_r)
    step = jax.jit(jax.vmap(lambda s, r, t: R.dsfd_update(cfg_r, s, r, t)))
    S = streams.shape[0]
    rs = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                      R.dsfd_init(cfg_r))
    dumped = 0
    for i in range(220):
        t = i + 1
        before = jax.tree.map(np.asarray, rs)
        ps = convert.dsfd_state_from_numpy(cfg_p, before, device="cpu")
        ps = P.dsfd_update(cfg_p, ps, torch.from_numpy(streams[:, i]), t)
        rs = step(rs, jnp.asarray(streams[:, i]),
                  jnp.full((S,), t, jnp.int32))
        got = convert.dsfd_state_to_numpy(ps)
        want = jax.tree.map(np.asarray, rs)
        for side in ("main", "aux"):
            g, w, b = (getattr(x, side) for x in (got, want, before))
            for f in ("nbuf", "start_t", "last_t", "cov_start", "snap_s",
                      "snap_t", "snap_valid", "snap_next"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                              err_msg=f"{side}.{f} t={t}")
            np.testing.assert_allclose(g.energy, w.energy, rtol=1e-6)
            np.testing.assert_allclose(g.sig1, w.sig1, rtol=1e-4, atol=TOL)
            d_plus = np.abs(g.snap_v - w.snap_v).max(axis=-1)
            d_minus = np.abs(g.snap_v + w.snap_v).max(axis=-1)
            assert np.all(np.minimum(d_plus, d_minus) <= TOL)
            shrunk = w.nbuf < b.nbuf
            krylov = (w.snap_next > b.snap_next) & ~shrunk
            dumped += int(krylov.sum())
            np.testing.assert_allclose(g.buf[krylov], w.buf[krylov],
                                       atol=TOL)
            np.testing.assert_allclose(g.snap_v[krylov], w.snap_v[krylov],
                                       atol=TOL)
            for s in range(S):
                np.testing.assert_allclose(g.buf[s].T @ g.buf[s],
                                           w.buf[s].T @ w.buf[s], atol=TOL)
    assert dumped > 0, "no krylov dump ran; the test saw only SVD merges"
    assert split_everywhere["rank1_downdate"] > 0


def test_engine_past_one_cta_holds_theorem_3_1(monkeypatch):
    """The smallest shape past one CTA (d = 318, ε = 1/64: m = 128, 232,728
    B for D and K), unpatched: the engine takes the split route and every
    user's window sketch is within 4εN of the exact window covariance
    after 2.5·N rows."""
    d, eps, N, S, block = 318, 1 / 64, 256, 2, 8
    assert ops.route(128, d) == "split"
    calls = {"n": 0}
    downdate = ops.rank1_downdate

    def counted(*a, **k):
        calls["n"] += 1
        return downdate(*a, **k)

    monkeypatch.setattr(ops, "rank1_downdate", counted)
    eng = SketchFleetEngine("dsfd", d=d, streams=S, eps=eps, window=N,
                            block=block, mode="krylov", device="cpu")
    # user 0: the paper's SYNTHETIC model; user 1: signal dimension 10,
    # whose top directions are dumped (ROADMAP note (c))
    srcs = (SyntheticSource(d, seed=0), SyntheticSource(d, k=10, seed=1))
    users = np.repeat(np.arange(S), block)
    hist = []
    for _ in range(int(2.5 * N) // block):
        rows = np.concatenate([s.rows(block) for s in srcs])
        eng.submit_many(users, rows)
        eng.step()
        hist.append(rows.reshape(S, block, d))
    assert calls["n"] > 0, "the engine never took the split route"
    A = np.concatenate(hist, axis=1).astype(np.float64)[:, -N:]
    for u in range(S):
        B = eng.query_user(u).astype(np.float64)
        err = np.max(np.abs(np.linalg.eigvalsh(A[u].T @ A[u] - B.T @ B)))
        assert err <= 4 * eps * N, f"user {u}: {err:.3f} > 4εN"
