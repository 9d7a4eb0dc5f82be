"""The port's flash attention (``repro_torch.kernels.flash_attn``), forward
and backward, held against the reference's.

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

The backward: ``flash_attention`` is a ``torch.autograd.Function`` whose
CPU backward is ``ref.flash_bwd_ref``; its dq, dk, dv are held against
``jax.grad`` through the reference's custom VJP (its pure-JAX ``_bwd``)
on the forward test's cases, at the reference's own VJP test tolerance
in f32 (atol 5e-5, rtol 5e-4) and 2e-2 in bf16 (one rounding of each
gradient to bf16).

The bf16 kernel computes on the tensor cores, which take bf16 operands:
``_tensor_core_model`` repeats its arithmetic in torch (bf16 q·kᵀ
accumulated in f32 and scaled after, the online softmax over its 128-key
tiles, p split into bf16 hi + lo, each times v accumulated in f32) and is
held to the reference's Pallas kernel, run in f32 on the same
bf16-valued inputs, at the f32 tolerance: the split keeps the reference's
f32 p, where a single bf16 rounding of p would not.

The bf16 backward computes on the tensor cores too:
``_tensor_core_bwd_model`` repeats its arithmetic (bf16 products exact in
f32 and scaled after, P and dS in f32, P and dS split into bf16 hi + lo
for dV, dK and dQ) and is held to the reference's own ``_fwd`` and
``_bwd`` on the same bf16-valued residuals at the reference's f32 VJP
tolerance (atol 5e-5, rtol 5e-4); with P and dS rounded to bf16 once it
misses that tolerance.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_fwd_pallas
from repro.kernels.flash_attn import ops as ref_ops
from repro.kernels.flash_attn.ops import \
    flash_attention as ref_flash_attention
from repro.kernels.flash_attn.ops import \
    flash_attention_bshd as ref_flash_bshd
from repro.kernels.flash_attn.ref import flash_ref as jax_flash_ref
from repro_torch.kernels.flash_attn import kernel, ops, ref
from repro_torch.launch.mesh import pin_host_threads

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

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


def test_autograd_works():
    """``flash_attention`` is differentiable in q, k and v; the autograd
    node keeps only (q, k, v, o, lse), never an S×S tensor; under
    ``torch.no_grad()`` it records nothing."""
    (q, k, v), _ = _inputs(2, 1, 64, 64, "float32")
    for t in (q, k, v):
        t.requires_grad_(True)
    o = ops.flash_attention(q, k, v)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5 and max(t.numel() for t in saved) == q.numel()
    dq, dk, dv = torch.autograd.grad(o.sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


def _grads_of(fn, q, k, v):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    return torch.autograd.grad(torch.sin(fn(q, k, v)).float().sum(),
                               (q, k, v))


def _jax_grads(fn, q, k, v):
    return jax.grad(lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v)).astype(
        jnp.float32)), argnums=(0, 1, 2))(q, k, v)


GRAD_TOL = {"float32": (5e-5, 5e-4), "bfloat16": (2e-2, 2e-2)}


@pytest.mark.parametrize("BH,BHkv,S,dh,causal,dtype", CASES + [
    (4, 2, 256, 64, False, "float32")])   # the reference VJP test's cases
def test_flash_gradients_match_jax_grad(BH, BHkv, S, dh, causal, dtype):
    """dq, dk, dv through the port's plain backward against ``jax.grad``
    through the reference's custom VJP (its ``_bwd``, pure JAX), for
    Σ sin(o): f32 at the reference test's atol 5e-5, rtol 5e-4 (both
    compute the flash identities in f32); bf16 at 2e-2 (each gradient is
    rounded to bf16 once from f32 values on both sides)."""
    (q, k, v), (qj, kj, vj) = _inputs(BH, BHkv, S, dh, dtype, seed=1)
    got = _grads_of(lambda *a: ops.flash_attention(*a, causal, 128, 128),
                    q, k, v)
    want = _jax_grads(lambda *a: ref_flash_attention(*a, causal, 128, 128),
                      qj, kj, vj)
    atol, rtol = GRAD_TOL[dtype]
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_f32(a), _f32(b), atol=atol, rtol=rtol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,S,H,Hkv,dh", [(2, 256, 4, 2, 64),
                                          (1, 256, 3, 3, 128)])
def test_flash_attention_bshd_gradients_match(B, S, H, Hkv, dh):
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh))]
    got = _grads_of(lambda *a: ops.flash_attention_bshd(
        *a, causal=True, cq=128, ckv=128), *map(torch.from_numpy, arrs))
    want = _jax_grads(lambda *a: ref_flash_bshd(*a, causal=True, cq=128,
                                                ckv=128),
                      *map(jnp.asarray, arrs))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("G,causal", [(1, True), (3, True), (2, False)])
def test_plain_backward_matches_autograd_through_the_forward(G, causal):
    """``flash_bwd_ref`` against autograd through ``flash_ref`` (the plain
    forward, differentiated op by op) on the same dO: 1e-5, f32 both."""
    (q, k, v), _ = _inputs(2 * G, 2, 128, 64, "float32", seed=G)
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        q.shape).astype(np.float32))
    o, lse = ref.flash_ref(q, k, v, causal=causal)
    got = ref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(ref.flash_ref(qq, kk, vv, causal=causal)[0],
                               (qq, kk, vv), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_argument_checks():
    (q, k, v), _ = _inputs(2, 1, 192, 64, "float32")
    with pytest.raises(ValueError, match="multiple of the tiles"):
        ops.flash_attention(q, k, v, True, 128, 128)     # 192 % 128
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_fwd(q, k, v)            # checked before any build
    with pytest.raises(ValueError, match="flash_bwd: q must be"):
        kernel.flash_bwd(q, k, v, q, q[:, :, 0], q)


@pytest.mark.parametrize("dh", [64, 128])
def test_f32_launch_plans_fit_a_block_and_cover_s(dh):
    """The Python mirrors of the f32 kernels' launch plans
    (``flash_attn_f32_plan``, ``flash_attn_bwd_plan``; the card test holds
    them to the C libraries): shared memory as the sources' notes state,
    within an H100 block's opt-in; tiles that cover every query row and
    key at each S that is a multiple of 64, the last at most one tile past
    S; at the training shape 576 forward CTAs (4.4 waves at one CTA a SM)
    and 192 dK/dV + 576 dQ CTAs in the backward's one grid (5.8 waves)."""
    from repro_torch.kernels import dispatch
    fwd_smem, bwd_smem = {64: (204_800, 203_776), 128: (196_608, 230_400)}[dh]
    for S in range(64, 2049, 64):
        fwd = kernel.f32_plan(dh, S, 6)
        bwd = kernel.bwd_plan(dh, S, 6, 2)
        assert (fwd[2], bwd[2]) == (fwd_smem, bwd_smem)
        assert max(fwd_smem, bwd_smem) <= dispatch.H100_SMEM_PER_BLOCK
        assert fwd[:2] == (256, 128) and fwd[3] == 6
        assert bwd[:2] == ((256, 128) if dh == 64 else (128, 64))
        assert fwd[4] * fwd[1] >= S > (fwd[4] - 1) * fwd[1]
        tiles = bwd[3] // 2
        assert bwd[4] == 6 * tiles and tiles * bwd[1] >= S > \
            (tiles - 1) * bwd[1]
    fwd = kernel.f32_plan(64, 1024, 72)
    bwd = kernel.bwd_plan(64, 1024, 72, 24)
    assert fwd[3:] == (72, 8) and bwd[3:] == (192, 576)
    assert round(kernel.waves(fwd[3] * fwd[4], 1), 2) == 4.36
    assert round(kernel.waves(bwd[3] + bwd[4], 1), 2) == 5.82


KV_TILE = 128       # keys per KV tile of the bf16 kernel


def _tensor_core_model(q, k, v, causal, split=True):
    """(o before its cast to bf16, lse) of the bf16 kernel's arithmetic on
    f32 tensors that hold bf16 values; ``split=False`` rounds p to bf16
    once instead."""
    BH, S, dh = q.shape
    G = BH // k.shape[0]
    k, v = (t.repeat_interleave(G, 0) for t in (k, v))
    m = torch.full((BH, S), ref.NEG_INF)
    l = torch.zeros((BH, S))
    acc = torch.zeros((BH, S, dh))
    rows = torch.arange(S)[:, None]
    for j0 in range(0, S, KV_TILE):
        kt, vt = k[:, j0:j0 + KV_TILE], v[:, j0:j0 + KV_TILE]
        s = (q @ kt.mT) * (1.0 / math.sqrt(dh))   # exact products, f32 sums
        if causal:
            keys = torch.arange(j0, j0 + kt.shape[1])[None, :]
            s = torch.where(keys > rows, torch.tensor(ref.NEG_INF), s)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + hi @ vt
        if split:
            acc = acc + (p - hi).to(torch.bfloat16).float() @ vt
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    return acc / lc[..., None], m + torch.log(lc)


@pytest.mark.parametrize("BH,BHkv,S,dh,causal,dtype", CASES)
def test_tensor_core_arithmetic_matches_pallas(BH, BHkv, S, dh, causal,
                                               dtype):
    """Every case in bf16 values (the kernel's operands), whatever its
    dtype."""
    (q, k, v), _ = _inputs(BH, BHkv, S, dh, "bfloat16", seed=5)
    q, k, v = (t.float() for t in (q, k, v))          # bf16 values, in f32
    o_r, lse_r = flash_fwd_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                  causal=causal, cq=128, ckv=128,
                                  interpret=True)
    o, lse = _tensor_core_model(q, k, v, causal)
    np.testing.assert_allclose(o.numpy(), _f32(o_r), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _f32(lse_r), atol=2e-5,
                               rtol=2e-5)
    # the tolerance tells the split from one bf16 rounding of p
    o1, _ = _tensor_core_model(q, k, v, causal, split=False)
    assert np.abs(o1.numpy() - _f32(o_r)).max() > 2e-5


def _halves(x):
    """x as bf16 hi + lo (both rounded to nearest even), in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _tensor_core_bwd_model(q, k, v, o, lse, do, causal, split=True):
    """(dq, dk, dv) before their cast to bf16 of the bf16 backward kernel's
    arithmetic on f32 tensors that hold bf16 values: the products q·kᵀ and
    dO·vᵀ exact (f32 sums), scaled after; P = exp(s·scale − lse) with the
    difference rounded once, 0 above the diagonal; dS = P∘(dP − D) in f32;
    dV = Pᵀ·dO, dK = dSᵀ·q·scale and dQ = dS·k·scale with P and dS as bf16
    hi + lo, each half's product summed in f32, the GQA group summed onto
    its KV head.  ``split=False`` rounds P and dS to bf16 once instead.
    The kernel's tile order changes only the order of f32 sums."""
    BH, S, dh = q.shape
    BHkv = k.shape[0]
    G = BH // BHkv
    scale = 1.0 / math.sqrt(dh)
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    D = (do * o).sum(-1)
    x = ((q @ kr.mT).double() * scale - lse.double()[..., None]).float()
    p = torch.exp(x)
    if causal:
        p = torch.where(torch.ones((S, S), dtype=torch.bool).tril(), p,
                        torch.zeros(()))
    ds = p * (do @ vr.mT - D[..., None])

    def mm(a, b):
        if split:
            hi, lo = _halves(a)
            return hi @ b + lo @ b
        return a.to(torch.bfloat16).float() @ b

    dq = mm(ds, kr) * scale
    dk = mm(ds.mT, q).reshape(BHkv, G, S, dh).sum(1) * scale
    dv = mm(p.mT, do).reshape(BHkv, G, S, dh).sum(1)
    return dq, dk, dv


@pytest.mark.parametrize("BH,BHkv,S,dh,causal,dtype", CASES)
def test_tensor_core_backward_arithmetic_matches_reference_bwd(
        BH, BHkv, S, dh, causal, dtype):
    """Every case in bf16 values, whatever its dtype: q, k, v and dO, and o
    rounded to bf16 as the forward kernel returns it; the reference's
    ``_fwd`` gives o and lse, and its ``_bwd`` the gradients in f32 on the
    same residuals.  The model is within the reference's f32 VJP tolerance
    (atol 5e-5, rtol 5e-4; measured ≤ 1.6e-5 at gradients up to ~10), and
    with P and dS rounded to bf16 once it is not."""
    (q, k, v), _ = _inputs(BH, BHkv, S, dh, "bfloat16", seed=5)
    q, k, v = (t.float() for t in (q, k, v))
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(
        q.shape).astype(np.float32)).to(torch.bfloat16).float()
    qj, kj, vj, doj = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    o, (*_, lse) = ref_ops._fwd(qj, kj, vj, causal, 128, 128)
    o = torch.from_numpy(np.array(o)).to(torch.bfloat16).float()
    lse = torch.from_numpy(np.array(lse))
    want = ref_ops._bwd(causal, 128, 128,
                        (qj, kj, vj, jnp.asarray(o.numpy()),
                         jnp.asarray(lse.numpy())), doj)
    atol, rtol = GRAD_TOL["float32"]
    got = _tensor_core_bwd_model(q, k, v, o, lse, do, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), _f32(b), atol=atol, rtol=rtol,
                                   err_msg=f"d{name}")
    # the tolerance tells the split from one bf16 rounding of P and dS
    once = _tensor_core_bwd_model(q, k, v, o, lse, do, causal, split=False)
    for a, b in zip(once, want):
        b = _f32(b)
        assert (np.abs(a.numpy() - b) > atol + rtol * np.abs(b)).any()


@pytest.mark.parametrize("dh,want", [(64, 84_536), (128, 166_456)])
def test_tensor_core_backward_fits_a_block(dh, want):
    """The Python mirror of the bf16 backward's shared memory
    (``flash_attn_bwd_tc_smem_bytes``; the card test holds it to the C
    library): 84,536 B at dh = 64 and 166,456 B at dh = 128, as
    ``csrc/flash_attn_bwd.cu`` states, within an H100 block's opt-in and
    under the f32 backward's, so the wrapper's fit check is unchanged."""
    from repro_torch.kernels import dispatch
    assert kernel.tc_bwd_smem(dh) == want
    assert want <= dispatch.H100_SMEM_PER_BLOCK
    assert want < kernel.bwd_plan(dh, 1024, 72, 24)[2]
