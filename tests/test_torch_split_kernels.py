"""The port's unfused kernels (``repro_torch.kernels.{gram, power_iter,
rank1_downdate, window_gram}``) held against the reference's.

On the CPU the port's wrappers run their plain versions; those are held
against the reference's ``ref.py`` oracles and its Pallas kernels in
interpret mode, at a subset of the reference tests' shapes
(``tests/kernels/test_kernels.py``), in f32 and bf16, batched against
per-stream.  The CUDA kernels are held against the plain versions on the
card in ``test_torch_cuda.py`` (``gpu`` marker) and by ``chip_smoke.py``.

Tolerances are the reference tests' own: f32 rtol = atol = 1e-4 (both
sides compute in f32 and differ only in summation order); bf16 outputs
rtol = atol = 2e-2 (one bf16 rounding of the f32 result, ~4e-3 relative);
the window Gram from bf16 inputs rtol 5e-2, atol 5e-1.  Batched against
per-stream inside the port: 1e-5 (CPU BLAS blocking, a few ulp).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.dsfd import _power_topvec as jax_inline_power
from repro.kernels.gram.ops import gram as jax_gram
from repro.kernels.gram.ref import gram_ref as jax_gram_ref
from repro.kernels.power_iter.ops import power_iter as jax_power
from repro.kernels.power_iter.ref import power_iter_ref as jax_power_ref
from repro.kernels.rank1_downdate.ops import rank1_downdate as jax_downdate
from repro.kernels.rank1_downdate.ref import \
    rank1_downdate_ref as jax_downdate_ref
from repro.kernels.window_gram.ops import window_gram as jax_wgram
from repro.kernels.window_gram.ref import window_gram_ref as jax_wgram_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.power_iter import kernel as power_kernel
from repro_torch.kernels.power_iter.ops import power_iter
from repro_torch.kernels.rank1_downdate import kernel as downdate_kernel
from repro_torch.kernels.rank1_downdate.ops import rank1_downdate
from repro_torch.kernels.window_gram import kernel as wgram_kernel
from repro_torch.kernels.window_gram.ops import window_gram
from repro_torch.launch.mesh import pin_host_threads

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

SHAPES_MD = [(8, 64), (16, 128), (20, 77)]      # (m, d), the reference's
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)


def _both(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of ``dtype``
    (bf16 rounded once, on the torch side, so both hold the same bits)."""
    t = torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy(), getattr(jnp, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,d", SHAPES_MD)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_matches_reference(m, d, dtype):
    rng = np.random.default_rng(m * d)
    X, Xj = _both(rng.normal(size=(2, m, d)), dtype)
    K = gram(X)
    assert K.dtype == X.dtype and K.shape == (2, m, m)
    for s in range(2):
        np.testing.assert_allclose(_np(K[s]), _np(jax_gram_ref(Xj[s])),
                                   **_tol(dtype))
    np.testing.assert_allclose(_np(K[0]),
                               _np(jax_gram(Xj[0], interpret=True)),
                               **_tol(dtype))


@pytest.mark.parametrize("m", [8, 16, 40, 64])
def test_power_iter_matches_reference_and_eigh(m):
    rng = np.random.default_rng(m)
    A = rng.normal(size=(2, m, 3 * m)).astype(np.float32)
    K = A @ A.transpose(0, 2, 1)
    lam, u = power_iter(torch.from_numpy(K), iters=64)
    for s in range(2):
        lam_r, u_r = jax_power_ref(jnp.asarray(K[s]), iters=64)
        np.testing.assert_allclose(float(lam[s]), float(lam_r), rtol=1e-4)
        np.testing.assert_allclose(u[s].numpy(), np.asarray(u_r), atol=1e-4)
        w = np.linalg.eigvalsh(K[s].astype(np.float64))
        assert abs(float(lam[s]) - w[-1]) <= 1e-2 * w[-1] + 1e-4
    lam_k, u_k = jax_power(jnp.asarray(K[0]), iters=64, interpret=True)
    np.testing.assert_allclose(float(lam[0]), float(lam_k), rtol=1e-4)
    np.testing.assert_allclose(np.abs(u[0].numpy()), np.abs(np.asarray(u_k)),
                               atol=1e-3)


@pytest.mark.parametrize("m,d", [(8, 64), (13, 37), (40, 64)])
def test_power_iter_inline_floor_matches_reference_inline_power(m, d):
    """``floor_norm=True`` is the reference's inline power loop
    (``repro.core.dsfd._power_topvec`` without Pallas: ‖w‖ floored at
    1e-30)."""
    rng = np.random.default_rng(m + d)
    X = rng.normal(size=(2, m, d)).astype(np.float32)
    K = X @ X.transpose(0, 2, 1)
    lam, u = power_iter(torch.from_numpy(K), iters=24, floor_norm=True)
    for s in range(2):
        lam_r, u_r = jax_inline_power(jnp.asarray(K[s]), 24, False)
        np.testing.assert_allclose(float(lam[s]), float(lam_r), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(u[s].numpy(), np.asarray(u_r), atol=1e-5)


@pytest.mark.parametrize("floor_norm", [False, True])
def test_power_iter_on_a_zero_gram(floor_norm):
    """An all-zero K gives λ̂ = 0 and û = 0 under either floor, as the
    reference's kernel and its inline loop do."""
    lam, u = power_iter(torch.zeros((2, 16, 16)), iters=24,
                        floor_norm=floor_norm)
    assert torch.all(lam == 0) and torch.all(u == 0)
    lam_r, u_r = (jax_inline_power(jnp.zeros((16, 16)), 24, False)
                  if floor_norm else jax_power_ref(jnp.zeros((16, 16))))
    assert float(lam_r) == 0.0 and not np.asarray(u_r).any()


@pytest.mark.parametrize("m,d", SHAPES_MD)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rank1_downdate_matches_reference(m, d, dtype):
    rng = np.random.default_rng(m + d)
    D, Dj = _both(rng.normal(size=(2, m, d)), dtype)
    v = rng.normal(size=(2, d))
    v, vj = _both(v / np.linalg.norm(v, axis=1, keepdims=True), dtype)
    out = rank1_downdate(D, v)
    assert out.dtype == D.dtype and out.shape == D.shape
    for s in range(2):
        np.testing.assert_allclose(_np(out[s]),
                                   _np(jax_downdate_ref(Dj[s], vj[s])),
                                   **_tol(dtype))
    np.testing.assert_allclose(
        _np(out[0]), _np(jax_downdate(Dj[0], vj[0], interpret=True)),
        **_tol(dtype))


def test_rank1_downdate_removes_direction():
    """After the downdate, D has zero component along v (Lemma 1)."""
    rng = np.random.default_rng(0)
    D = torch.from_numpy(rng.normal(size=(2, 16, 200)).astype(np.float32))
    v = rng.normal(size=(2, 200)).astype(np.float32)
    v = torch.from_numpy(v / np.linalg.norm(v, axis=1, keepdims=True))
    out = rank1_downdate(D, v)
    np.testing.assert_allclose(torch.bmm(out, v[:, :, None]).numpy(), 0.0,
                               atol=1e-3)


@pytest.mark.parametrize("n,d", [(64, 16), (129, 90)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_gram_matches_reference(n, d, dtype):
    rng = np.random.default_rng(n)
    A, Aj = _both(rng.normal(size=(2, n, d)), dtype)
    G = window_gram(A)
    assert G.dtype == torch.float32 and G.shape == (2, d, d)
    tol = dict(rtol=5e-2, atol=5e-1) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-3)
    for s in range(2):
        np.testing.assert_allclose(G[s].numpy(), _np(jax_wgram_ref(Aj[s])),
                                   **tol)
    np.testing.assert_allclose(G[0].numpy(),
                               _np(jax_wgram(Aj[0], interpret=True)), **tol)


def test_batched_equals_per_stream():
    rng = np.random.default_rng(11)
    X = torch.from_numpy(rng.normal(size=(5, 10, 48)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(5, 48)).astype(np.float32))
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    K, D2, G = gram(X), rank1_downdate(X, v), window_gram(X)
    lam, u = power_iter(K, iters=24)
    for s in range(5):
        one = slice(s, s + 1)
        torch.testing.assert_close(gram(X[one]), K[one], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(rank1_downdate(X[one], v[one]), D2[one],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(window_gram(X[one]), G[one], rtol=1e-5,
                                   atol=1e-5)
        lam1, u1 = power_iter(K[one], iters=24)
        torch.testing.assert_close(lam1, lam[one], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(u1, u[one], rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    wrappers = (gram_kernel.gram_cuda, power_kernel.power_iter_cuda,
                downdate_kernel.rank1_downdate_cuda,
                wgram_kernel.window_gram_cuda)
    before = [w.launches for w in wrappers]
    X = torch.ones((2, 4, 8))
    power_iter(gram(X), iters=4)
    rank1_downdate(X, torch.ones((2, 8)))
    window_gram(X)
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError, match="slab"):
        gram(X[0])
    with pytest.raises(ValueError, match="slab"):
        power_iter(torch.ones((2, 4, 5)))
    with pytest.raises(ValueError, match="rank1_downdate"):
        rank1_downdate(X, torch.ones(8))
    with pytest.raises(ValueError, match="slab"):
        window_gram(X[0])


def test_power_iter_cluster_plan_holds_k_on_chip():
    """The Python mirror of the CUDA kernel's launch plan, at an H100's
    limits: the cluster size c never shrinks as m grows, and for every
    m ≤ 512 (the reference's largest m = 2ℓ) c CTAs hold all of K, each
    its ⌈m/c⌉ rows (⌈m/c⌉·m·4 B at a 4-float row stride) beside its two x
    buffers and mbarriers.  Few streams get wide clusters, many the
    smallest that holds K."""
    plan, limit = power_kernel.cluster_plan, dispatch.H100_SMEM_PER_BLOCK
    for S in (1, 8, 16, 33, 64, 256):
        widest = 1
        for m in range(1, 513):
            c, rows, resident = plan(m, S)
            assert c in (1, 2, 4, 8) and c >= widest, (m, S, c)
            widest = c
            ld = -(-m // 4) * 4
            assert rows == -(-m // c) and resident == rows, (m, S)
            assert 16 + 8 * ld + 4 * rows * ld <= limit, (m, S)
    assert [plan(256, S)[0] for S in (1, 8, 16, 32, 64, 256)] == \
        [8, 8, 8, 4, 2, 2]
    assert plan(512, 64)[0] == 8 and plan(512, 1)[0] == 8
    assert plan(40, 64)[0] == 2 and plan(10, 3)[0] == 2 and plan(1, 2)[0] == 1
    assert plan(1030, 1) == (8, 129, 54)   # past 8 CTAs: rows in HBM
