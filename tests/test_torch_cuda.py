"""The port on the card: the CUDA kernels against their plain versions,
and the krylov engine through them against the same engine on the CPU.

Every test here needs an NVIDIA card (the kernels have no CPU or
interpret mode) and skips without one.  The file imports neither JAX nor
the reference, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: kernel and plain version run the same float32 arithmetic in
another summation order (~1e-6 at unit-scale inputs), hence 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import dsfd
from repro_torch.kernels.fused_tick import kernel, ops, ref
from repro_torch.serve.engine import SketchFleetEngine

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


@pytest.mark.parametrize("floor_norm", [False, True])
@pytest.mark.parametrize("S,m,d", [(64, 64, 300), (7, 10, 37), (3, 1, 1)])
def test_cuda_kernels_match_plain_versions(cuda, S, m, d, floor_norm):
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
    D = torch.zeros((1, 512, 512), device=cuda)
    with pytest.raises(ValueError, match="split path"):
        ops.gram_power(D, iters=1)


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
