"""The port's flash-attention forward (``repro_torch.kernels.flash_attn``)
held against the reference's.

On the CPU the port's wrappers run the plain version (``ref.py``); it is
held against the reference's Pallas kernel in interpret mode and against
the reference's jnp oracle, on the reference test's cases
(``tests/kernels/test_flash_attn.py``) with its tolerances: 2e-5 in f32
(the same exact softmax in another summation order), 2e-2 in bf16 (one
rounding of o to bf16, ~4e-3 relative, at unit-scale outputs), lse 1e-3.
Inputs are drawn in f32 with numpy and rounded to bf16 by both packages
the same way (round to nearest even).  The CUDA kernel itself is held
against the plain version on the card (``test_torch_cuda.py``, ``gpu``
marker, and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_fwd_pallas
from repro.kernels.flash_attn.ops import \
    flash_attention_bshd as ref_flash_bshd
from repro.kernels.flash_attn.ref import flash_ref as jax_flash_ref
from repro_torch.kernels.flash_attn import kernel, ops, ref

CASES = [   # (BH, BHkv, S, dh, causal, dtype): the reference test's cases
    (4, 2, 256, 64, True, "float32"),
    (4, 4, 256, 64, False, "float32"),
    (2, 1, 512, 128, True, "float32"),
    (8, 2, 128, 64, True, "bfloat16"),
    (3, 3, 384, 64, True, "float32"),       # non-pow2 BH, S=3·128
]


def _inputs(BH, BHkv, S, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((BH, S, dh), (BHkv, S, dh), (BHkv, S, dh))]
    tdt = getattr(torch, dtype)
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("BH,BHkv,S,dh,causal,dtype", CASES)
def test_flash_forward_matches_pallas_and_oracle(BH, BHkv, S, dh, causal,
                                                 dtype):
    (q, k, v), (qj, kj, vj) = _inputs(BH, BHkv, S, dh, dtype)
    n0 = kernel.flash_fwd.launches
    o, lse = ops.flash_forward(q, k, v, causal=causal)
    assert kernel.flash_fwd.launches == n0          # CPU: plain version
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert o.shape == q.shape and lse.shape == (BH, S)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for o_r, lse_r in (
            flash_fwd_pallas(qj, kj, vj, causal=causal, cq=128, ckv=128,
                             interpret=True),
            jax_flash_ref(qj, kj, vj, causal=causal)):
        np.testing.assert_allclose(_f32(o), _f32(o_r), atol=tol, rtol=tol)
        np.testing.assert_allclose(_f32(lse), _f32(lse_r), atol=1e-3,
                                   rtol=1e-3)
    o2 = ops.flash_attention(q, k, v, causal, 128, 128)
    assert torch.equal(o2, o)


@pytest.mark.parametrize("B,S,H,Hkv,dh", [(2, 256, 4, 2, 64),
                                          (1, 256, 3, 3, 128)])
def test_flash_attention_bshd_matches(B, S, H, Hkv, dh):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)))
    got = ops.flash_attention_bshd(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, cq=128, ckv=128)
    want = ref_flash_bshd(*map(jnp.asarray, (q, k, v)), causal=True,
                          cq=128, ckv=128)
    assert got.shape == (B, S, H, dh)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_plain_version_first_query_sees_one_key():
    """Exact values on a case small enough to reason about: with one key
    per query (causal, first row) the output is that key's value."""
    (q, k, v), _ = _inputs(2, 1, 64, 64, "float32", seed=3)
    o, lse = ref.flash_ref(q, k, v, causal=True)
    torch.testing.assert_close(o[:, 0], v[0, 0].expand(2, 64))
    s00 = (q[:, 0] @ k[0, 0]) / 8.0
    torch.testing.assert_close(lse[:, 0], s00)


def test_no_backward_yet():
    (q, k, v), _ = _inputs(2, 1, 64, 64, "float32")
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == q.shape


def test_argument_checks():
    (q, k, v), _ = _inputs(2, 1, 192, 64, "float32")
    with pytest.raises(ValueError, match="multiple of the tiles"):
        ops.flash_attention(q, k, v, True, 128, 128)     # 192 % 128
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_fwd(q, k, v)            # checked before any build
