"""The port's error metrics (``repro_torch.core.errors``) held against the
reference's (``repro.core.errors``) on the CPU.

``window_gram`` runs the window-gram kernel's plain version on a CPU
tensor (the kernel itself is held against it on the card in
``test_torch_cuda.py`` and ``chip_smoke.py``).  Both sides compute in f32
and differ in summation order, so the metrics agree to ~1e-6 relative:
1e-5 relative is used; the numpy helpers agree exactly.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import errors as R
from repro_torch.core import errors as P
from repro_torch.launch.mesh import pin_host_threads

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def _sketch_pair(n, d, ell, seed):
    """A window A (n, d) and a sketch B (ℓ, d) of it: A's top rows of its
    SVD, so the error is the (ℓ+1)-th squared singular value."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, d)).astype(np.float32)
    _, s, vt = np.linalg.svd(A, full_matrices=False)
    B = (s[:ell, None] * vt[:ell]).astype(np.float32)
    return A, B


@pytest.mark.parametrize("n,d,ell", [(64, 16, 4), (129, 40, 8)])
def test_cova_and_relative_error_match_the_reference(n, d, ell):
    A, B = _sketch_pair(n, d, ell, seed=n + d)
    e = float(P.cova_error(torch.from_numpy(A), torch.from_numpy(B)))
    e_r = float(R.cova_error(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(e, e_r, rtol=1e-5)
    rel = float(P.relative_error(torch.from_numpy(A), torch.from_numpy(B)))
    rel_r = float(R.relative_error(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(rel, rel_r, rtol=1e-5)
    # the optimal rank-ℓ sketch's error is σ²_{ℓ+1}
    s = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(e, s[ell] ** 2, rtol=1e-4)


def test_metrics_take_a_batch_of_streams():
    pairs = [_sketch_pair(50, 12, 3, seed=s) for s in range(3)]
    A = torch.from_numpy(np.stack([a for a, _ in pairs]))
    B = torch.from_numpy(np.stack([b for _, b in pairs]))
    e = P.cova_error(A, B)
    rel = P.relative_error(A, B)
    assert e.shape == rel.shape == (3,)
    for s, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(
            float(e[s]), float(R.cova_error(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5)
        np.testing.assert_allclose(
            float(rel[s]),
            float(R.relative_error(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5)


def test_relative_error_of_an_empty_window_is_finite():
    A, B = torch.zeros((8, 5)), torch.zeros((2, 5))
    assert float(P.relative_error(A, B)) == 0.0
    assert float(R.relative_error(jnp.zeros((8, 5)), jnp.zeros((2, 5)))) == 0.0


@pytest.mark.parametrize("t,window", [(1, 64), (40, 64), (200, 64),
                                      (300, 300)])
def test_window_helpers_match_the_reference(t, window):
    rows = np.random.default_rng(t).normal(size=(300, 9))
    np.testing.assert_array_equal(P.window_gram_np(rows, t, window),
                                  R.window_gram_np(rows, t, window))
    assert P.window_fro_np(rows, t, window) == \
        R.window_fro_np(rows, t, window)


@pytest.mark.parametrize("t,window", [(40, 64), (200, 64)])
def test_window_gram_on_the_device_matches_the_host_ground_truth(t, window):
    """The exact window Gram on the tensor's device (here the kernel's plain
    version) equals ``window_gram_np`` of the reference, for one window and
    for a batch of streams' windows."""
    rng = np.random.default_rng(t)
    rows = rng.normal(size=(3, 300, 9)).astype(np.float32)
    lo = max(t - window, 0)
    G = P.window_gram(torch.from_numpy(rows[:, lo:t]))
    assert G.shape == (3, 9, 9) and G.dtype == torch.float32
    for s in range(3):
        want = R.window_gram_np(rows[s].astype(np.float64), t, window)
        np.testing.assert_allclose(G[s].numpy(), want, rtol=1e-5, atol=1e-4)
        one = P.window_gram(torch.from_numpy(rows[s, lo:t]))
        torch.testing.assert_close(one, G[s], rtol=1e-5, atol=1e-5)
    # the device Gram feeds the covariance error as the host Gram does
    B = torch.from_numpy(rows[0, lo:lo + 4])
    e_dev = float(P.cova_error_gram(G[0], B))
    e_ref = float(R.cova_error_gram(
        jnp.asarray(R.window_gram_np(rows[0], t, window)), jnp.asarray(B)))
    np.testing.assert_allclose(e_dev, e_ref, rtol=1e-5)
