"""The port's fused krylov-tick kernels (``repro_torch.kernels.fused_tick``)
held against the reference's.

On the CPU the port's wrappers run their plain versions; those are held
against ``repro.kernels.fused_tick.ref`` and against the Pallas kernels in
interpret mode, on aligned and unaligned shapes, on a zero buffer, and
batched against per-stream.  The CUDA kernels themselves are held against
the plain versions on the card in ``test_torch_cuda.py`` (``gpu`` marker)
and by ``chip_smoke.py`` at the main path's shape.

Tolerances: both sides compute in float32 and differ only in summation
order (torch's bmm vs XLA's dot), ~1e-7 relative per product; 24-64 power
steps on these gapped random spectra keep that below 1e-5, so λ̂ is held
to rtol 1e-5 and vectors to atol 1e-5 (the reference's own interpret-vs-
ref tests use 2e-4).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.dsfd import _power_topvec as jax_inline_power
from repro.kernels.fused_tick.ops import fused_krylov_step as ref_step_ops
from repro.kernels.fused_tick.ops import gram_power as ref_gp_ops
from repro.kernels.fused_tick.ref import fused_krylov_step_ref as jax_step
from repro.kernels.fused_tick.ref import gram_power_ref as jax_gp
from repro_torch.kernels import dispatch
from repro_torch.kernels.fused_tick import kernel, ops
from repro_torch.launch.mesh import pin_host_threads

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

RTOL, ATOL = 1e-5, 1e-5
SHAPES = [(3, 8, 32), (2, 1, 1), (3, 7, 130), (2, 13, 37)]   # (S, m, d)


def _slab(S, m, d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(S, m, d)).astype(np.float32)


def _jax_per_stream(fn, *arrays, iters):
    outs = [fn(*(jnp.asarray(a[s]) for a in arrays), iters=iters)
            for s in range(arrays[0].shape[0])]
    return [np.stack([np.asarray(o[k]) for o in outs])
            for k in range(len(outs[0]))]


@pytest.mark.parametrize("S,m,d", SHAPES)
@pytest.mark.parametrize("iters", [24, 64])
def test_gram_power_matches_reference_ref(S, m, d, iters):
    D = _slab(S, m, d, seed=S * m + d)
    lam, u = ops.gram_power(torch.from_numpy(D), iters=iters)
    lam_r, u_r = _jax_per_stream(jax_gp, D, iters=iters)
    np.testing.assert_allclose(lam.numpy(), lam_r, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(u.numpy(), u_r, atol=ATOL)


@pytest.mark.parametrize("S,m,d", SHAPES)
def test_fused_step_matches_reference_ref(S, m, d):
    D = _slab(S, m, d, seed=7 * m + d)
    lam, u = _jax_per_stream(jax_gp, D, iters=24)
    got = ops.fused_krylov_step(torch.from_numpy(D), torch.from_numpy(lam),
                                torch.from_numpy(u), iters=24)
    want = _jax_per_stream(jax_step, D, lam, u, iters=24)
    scale = max(float(np.abs(D).max()) ** 2, 1.0)
    for g, w, name in zip(got, want, ["snap", "D'", "lam'", "u'"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * scale, err_msg=name)


@pytest.mark.parametrize("m,d", [(8, 128), (9, 127)])
def test_plain_versions_match_pallas_interpret(m, d):
    """The port's plain versions against the Pallas kernel bodies run in
    interpret mode (padded to (8, 128) tiles by the reference's ops)."""
    D = _slab(1, m, d, seed=m + d)
    lam_k, u_k = ref_gp_ops(jnp.asarray(D[0]), iters=24, interpret=True)
    lam, u = ops.gram_power(torch.from_numpy(D), iters=24)
    np.testing.assert_allclose(lam.numpy()[0], float(lam_k), rtol=1e-4)
    np.testing.assert_allclose(u.numpy()[0], np.asarray(u_k), atol=1e-4)
    got = ops.fused_krylov_step(torch.from_numpy(D), lam, u, iters=24)
    want = ref_step_ops(jnp.asarray(D[0]), jnp.asarray(lam.numpy()[0]),
                        jnp.asarray(u.numpy()[0]), iters=24, interpret=True)
    for g, w, name in zip(got, want, ["snap", "D'", "lam'", "u'"]):
        np.testing.assert_allclose(g.numpy()[0], np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_zero_buffer_stays_finite():
    D = torch.zeros((3, 8, 32))
    lam, u = ops.gram_power(D, iters=24)
    assert torch.all(lam == 0) and torch.all(u == 0)
    outs = ops.fused_krylov_step(D, lam, u, iters=24)
    for o in outs:
        assert torch.isfinite(o).all()
    lam_r, u_r = jax_gp(jnp.zeros((8, 32)), iters=24)
    assert float(lam_r) == 0.0 and not np.asarray(u_r).any()


@pytest.mark.parametrize("S,m,d", SHAPES)
def test_inline_floor_matches_reference_inline_power(S, m, d):
    """``floor_norm=True`` is the reference's inline power loop
    (``repro.core.dsfd._power_topvec`` without Pallas: ‖w‖ floored at
    1e-30) on K = DDᵀ."""
    D = _slab(S, m, d, seed=5 * m + d)
    lam, u = ops.gram_power(torch.from_numpy(D), iters=24, floor_norm=True)
    for s in range(S):
        Dj = jnp.asarray(D[s])
        lam_r, u_r = jax_inline_power(Dj @ Dj.T, 24, False)
        np.testing.assert_allclose(float(lam[s]), float(lam_r), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(u[s].numpy(), np.asarray(u_r), atol=ATOL)


def test_inline_floor_on_a_zero_buffer():
    """Both floors give u = 0 and finite outputs on an all-zero buffer."""
    D = torch.zeros((2, 8, 32))
    lam, u = ops.gram_power(D, iters=24, floor_norm=True)
    assert torch.all(lam == 0) and torch.all(u == 0)
    for o in ops.fused_krylov_step(D, lam, u, iters=24, floor_norm=True):
        assert torch.isfinite(o).all()


def test_padding_rows_never_capture_the_top_vector():
    """Zero rows in a buffer (the empty slots of a DS-FD buffer) give
    exactly zero coordinates of û, as the reference pins for padding."""
    D = _slab(2, 12, 40, seed=3)
    D[:, 7:] = 0.0
    lam, u = ops.gram_power(torch.from_numpy(D), iters=64)
    assert torch.all(u[:, 7:] == 0)
    lam7, u7 = ops.gram_power(torch.from_numpy(D[:, :7].copy()), iters=64)
    # same direction; u₀ = 1/√m differs, so only up to rounding
    np.testing.assert_allclose(u[:, :7].numpy(), u7.numpy(), atol=1e-6)
    np.testing.assert_allclose(lam.numpy(), lam7.numpy(), rtol=1e-6)


def test_batched_equals_per_stream():
    """A stream's result does not depend on its batch.  Equal up to the
    CPU BLAS's blocking of a batched product (a few ulp), hence 1e-5."""
    D = torch.from_numpy(_slab(5, 10, 48, seed=11))
    lam, u = ops.gram_power(D, iters=24)
    got = ops.fused_krylov_step(D, lam, u, iters=24)
    for s in range(5):
        lam1, u1 = ops.gram_power(D[s:s + 1], iters=24)
        torch.testing.assert_close(lam1, lam[s:s + 1], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(u1, u[s:s + 1], rtol=1e-5, atol=1e-5)
        one = ops.fused_krylov_step(D[s:s + 1], lam[s:s + 1], u[s:s + 1],
                                    iters=24)
        for a, b in zip(one, got):
            torch.testing.assert_close(a, b[s:s + 1], rtol=1e-5, atol=1e-5)


def test_step_removes_top_direction():
    D = _slab(1, 10, 40, seed=5)
    D[0, 0] *= 6.0
    Dt = torch.from_numpy(D)
    lam, u = ops.gram_power(Dt, iters=96)
    snap, D2, lam2, _ = ops.fused_krylov_step(Dt, lam, u, iters=96)
    ev = np.linalg.eigvalsh(D[0].astype(np.float64) @ D[0].T)
    assert abs(float(lam[0]) - ev[-1]) <= 1e-3 * ev[-1]
    assert float(lam2[0]) <= ev[-2] * (1 + 1e-3)
    np.testing.assert_allclose(float(torch.sum(snap * snap)), ev[-1],
                               rtol=1e-3)


def test_cpu_tensors_take_the_plain_version():
    before = (kernel.gram_power_cuda.launches,
              kernel.fused_krylov_step_cuda.launches)
    D = torch.from_numpy(_slab(2, 4, 8, seed=1))
    lam, u = ops.gram_power(D, iters=8)
    ops.fused_krylov_step(D, lam, u, iters=8)
    assert (kernel.gram_power_cuda.launches,
            kernel.fused_krylov_step_cuda.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        dispatch.use_kernel(torch.empty(1, device="meta"))
    with pytest.raises(ValueError, match="slab"):
        ops.gram_power(D[0])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(dispatch.shutil, "which", lambda _: None)
    monkeypatch.setattr(dispatch, "NVCC_DEFAULT", tmp_path / "nvcc")
    monkeypatch.setattr(dispatch, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(dispatch.KernelBuildError, match="nvcc not found"):
        dispatch.build(["fused_tick"])
