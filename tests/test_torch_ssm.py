"""The port's SSD layer and Mamba2 family (mamba2-2.7b through
``repro_torch.models.mamba2``) held against the reference, on the CPU at
small width.

The reference's ``ssd_chunked`` runs under ``jax.jit`` here, as its model
runs it: XLA's CPU backend refuses its bf16 products with an f32 result
when dispatched op by op at more than one chunk.

Its intra-chunk term carries no decay (its decay matrix is
exp(cum_t − cum_t) = 1; ROADMAP §3 note (m)), and the port computes the
same function.  So the chunked form equals the token recurrence only where
the decay is 1: the block-then-decode test runs at A = −e⁻³⁰ (every
exp(dt·A) rounds to 1 in f32), and a test of its own pins the fact at a
real A against the recurrence with and without the decay.

Tolerances: f32 throughout on both sides, summation order only: the
SSD's output and state 1e-5 (relative, unit-scale inputs, outputs up to
~30); block against block plus decode 1e-5; logits 1e-4; gradients atol
5e-5, rtol 5e-4.  bf16: the outputs within one bf16 step (2⁻⁷ relative);
the f32 state within 1e-2, since the reference's three-operand einsum
may round its first product to bf16 where the port keeps f32 (measured:
at most 1.3e-3 at states of order 1).  Greedy tokens identical.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models.layers import ssm as ref_ssm
from repro.models.params import count_params as ref_count_params
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.models.layers import ssm
from repro_torch.models.params import count_params, init_params
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from test_torch_vlm import _np, assert_train_matches, configs, params_pair

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

ARCH = "mamba2-2.7b"
SSD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-2)}
BLOCK_TOL, LOGIT_TOL = 1e-5, 1e-4
CHUNK = 8


def _ssd_inputs(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    return dict(
        xh=rng.standard_normal((B, S, H, P)).astype(np.float32),
        Bc=rng.standard_normal((B, S, G, N)).astype(np.float32),
        Cc=rng.standard_normal((B, S, G, N)).astype(np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
            np.float32),
        A=-np.exp(rng.standard_normal(H)).astype(np.float32),
        D=rng.standard_normal(H).astype(np.float32))


def _run_ssd(inp, dtype):
    """(port (y, state), reference (y, state)) of the same inputs."""
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = ssm.ssd_chunked(
        *(torch.from_numpy(inp[k]).to(td) for k in ("xh", "Bc", "Cc")),
        torch.from_numpy(inp["dt"]), torch.from_numpy(inp["A"]),
        torch.from_numpy(inp["D"]).to(td), CHUNK)
    want = jax.jit(ref_ssm.ssd_chunked, static_argnums=6)(
        *(jnp.asarray(inp[k]).astype(jd) for k in ("xh", "Bc", "Cc")),
        jnp.asarray(inp["dt"]), jnp.asarray(inp["A"]),
        jnp.asarray(inp["D"]).astype(jd), CHUNK)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [5, 2 * CHUNK, 2 * CHUNK + 5])
def test_ssd_chunked_matches_the_reference(dtype, groups, S):
    """S under a chunk, two whole chunks, and two chunks and a padded
    third; B and C shared by 4 or 2 heads a group."""
    inp = _ssd_inputs(2, S, 4, 4, groups, 6, seed=S + groups)
    (y, h), (y_r, h_r) = _run_ssd(inp, dtype)
    assert y.shape == (2, S, 4, 4) and y.dtype == getattr(torch, dtype)
    assert h.shape == (2, 4, 6, 4) and h.dtype == torch.float32
    rtol, stol = SSD_TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(y_r), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(_np(h), _np(h_r), rtol=stol, atol=stol)


def _recurrence(inp, decay: bool):
    """The SSD as its token recurrence, f64: h ← a·h + dt·B ⊗ x,
    y = C·h + D·x, with a = exp(dt·A), or 1 without ``decay``."""
    xh, Bc, Cc, dt = (inp[k].astype(np.float64) for k in
                      ("xh", "Bc", "Cc", "dt"))
    B, S, H, P = xh.shape
    rep = H // Bc.shape[2]
    Bh, Ch = np.repeat(Bc, rep, 2), np.repeat(Cc, rep, 2)
    h = np.zeros((B, H, Bc.shape[3], P))
    ys = []
    for t in range(S):
        a = np.exp(dt[:, t] * inp["A"]) if decay else np.ones((B, H))
        h = (a[..., None, None] * h + dt[:, t, :, None, None]
             * Bh[:, t, :, :, None] * xh[:, t, :, None, :])
        ys.append(np.einsum("bhn,bhnp->bhp", Ch[:, t], h)
                  + xh[:, t] * inp["D"][None, :, None])
    return np.stack(ys, 1), h


def test_intra_chunk_term_has_no_decay_as_in_the_reference():
    """Note (m): within one chunk both packages give the recurrence
    without decay, not the one with it; their final states (the chunk
    summaries, which the reference decays) are the decayed recurrence's."""
    inp = _ssd_inputs(2, CHUNK, 4, 4, 1, 6, seed=11)
    (y, h), (y_r, _) = _run_ssd(inp, "float32")
    flat, _ = _recurrence(inp, decay=False)
    decayed, h_want = _recurrence(inp, decay=True)
    np.testing.assert_allclose(_np(y), _np(y_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(y), flat, rtol=1e-4, atol=1e-4)
    assert np.abs(_np(y) - decayed).max() > 0.1
    np.testing.assert_allclose(_np(h), h_want, rtol=1e-4, atol=1e-4)


def test_ssd_state_carries_the_decay_across_chunks():
    """Where the decay is 1 (A → 0) the chunked form is the recurrence
    over every chunk boundary, output and state."""
    inp = _ssd_inputs(1, 3 * CHUNK + 3, 4, 4, 2, 6, seed=12)
    inp["A"] = -np.exp(np.full(4, -30.0)).astype(np.float32)
    (y, h), _ = _run_ssd(inp, "float32")
    want, h_want = _recurrence(inp, decay=True)
    np.testing.assert_allclose(_np(y), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h), h_want, rtol=1e-4, atol=1e-4)


# -- the block and the model -------------------------------------------------


@pytest.fixture(scope="module")
def model():
    ref_cfg, cfg = configs(ARCH)
    ref_params, params = params_pair(ref_cfg, cfg)
    return ref_cfg, cfg, ref_params, params


def _block_params(params, i=0, flat_decay=False):
    lp = {k: w[i] for k, w in params["layers"].items()}
    p = {k: w for k, w in lp.items() if k not in ("norm", "norm_gate")}
    p["norm"] = lp["norm_gate"]
    if flat_decay:
        p["A_log"] = torch.full_like(p["A_log"], -30.0)
    return p


@pytest.mark.parametrize("groups", [1, 2])
def test_block_then_decode_steps_equal_the_block(model, groups):
    """``mamba_block(return_cache=True)`` over S tokens, then k decode
    steps from its cache, against the block over all S + k tokens (at
    A → 0, see the module docstring), and the block against the
    reference's."""
    ref_cfg, cfg, ref_params, params = model
    if groups == 2:
        new = dataclasses.replace(cfg.ssm, n_groups=2)
        cfg = dataclasses.replace(cfg, ssm=new)
        ref_cfg = dataclasses.replace(ref_cfg, ssm=dataclasses.replace(
            ref_cfg.ssm, n_groups=2))
        gen = torch.Generator().manual_seed(groups)
        params = init_params(api.param_defs(cfg), gen, device="cpu")
    p = _block_params(params, flat_decay=True)
    S, k = 21, 4
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, S + k, cfg.d_model)).astype(np.float32))
    want, _ = ssm.mamba_block(cfg, p, x)
    out, cache = ssm.mamba_block(cfg, p, x[:, :S], return_cache=True)
    np.testing.assert_allclose(_np(out), _np(want[:, :S]), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    for j in range(k):
        y, cache = ssm.mamba_decode_step(cfg, p, x[:, S + j:S + j + 1], cache)
        np.testing.assert_allclose(_np(y), _np(want[:, S + j:S + j + 1]),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)
    ref_p = {n: jnp.asarray(_np(w)) for n, w in p.items()}
    got, c = ssm.mamba_block(cfg, p, x, return_cache=True)
    ref, c_r = jax.jit(lambda p_, x_: ref_ssm.mamba_block(
        ref_cfg, p_, x_, return_cache=True))(ref_p, jnp.asarray(_np(x)))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    for a, b in zip(c, c_r):
        np.testing.assert_allclose(_np(a), _np(b), rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL)


def test_forward_and_grad_match_the_reference(model):
    ref_cfg, cfg, ref_params, params = model
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    assert_train_matches(cfg, ref_cfg, params, ref_params,
                         {"tokens": torch.from_numpy(tokens)},
                         {"tokens": jnp.asarray(tokens)}, labels)


def test_prefill_and_decode_match_the_reference(model):
    ref_cfg, cfg, ref_params, params = model
    B, S = 2, 24
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S + 3)).astype(np.int32)
    lg, caches = api.forward_prefill(
        cfg, params, {"tokens": torch.from_numpy(toks[:, :S])})
    lg_r, caches_r = ref_api.forward_prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(toks[:, :S])})
    np.testing.assert_allclose(_np(lg), _np(lg_r), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert caches.state.shape == (cfg.n_layers, B, 8, 16, 8)
    for j in range(3):
        nxt = toks[:, S + j:S + j + 1]
        dec, caches = api.forward_decode(cfg, params, torch.from_numpy(nxt),
                                         caches)
        dec_r, caches_r = ref_api.forward_decode(ref_cfg, ref_params,
                                                 jnp.asarray(nxt), caches_r)
        np.testing.assert_allclose(_np(dec), _np(dec_r), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    for a, b in zip(caches, caches_r):
        np.testing.assert_allclose(_np(a), _np(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def _requests(cfg, cls):
    rng = np.random.default_rng(8)
    return [cls(uid=u, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=4) for u, n in enumerate((7, 30, 16))]


def test_serve_engine_matches_the_reference(model):
    """2 slots, buckets (16, 32), prompts of 7, 30 and 16 tokens: greedy
    tokens, ticks and the spliced states as the reference engine's."""
    ref_cfg, cfg, ref_params, params = model
    ecfg = dict(slots=2, s_max=64, prefill_buckets=(16, 32))
    ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**ecfg))
    eng = ServeEngine(cfg, params, EngineConfig(**ecfg), device="cpu")
    for r in _requests(cfg, RefRequest):
        ref.submit(r)
    for r in _requests(cfg, Request):
        eng.submit(r)
    done_r, done = ref.run(), eng.run()
    assert sorted(done) == sorted(done_r) == [0, 1, 2]
    for uid in done:
        assert done[uid].out_tokens == done_r[uid].out_tokens
        assert len(done[uid].out_tokens) == 5
    assert eng.ticks == ref.ticks
    for a, b in zip(eng.caches, ref.caches):
        np.testing.assert_allclose(_np(a), _np(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_full_config_params_on_the_meta_device():
    cfg = get_config(ARCH)
    params = init_params(api.param_defs(cfg), torch.Generator(),
                         dtype=torch.bfloat16, device="meta")
    leaves = jax.tree_util.tree_leaves(params)
    assert all(x.device.type == "meta" for x in leaves)
    n = sum(x.numel() for x in leaves)
    assert n == count_params(api.param_defs(cfg)) == ref_count_params(
        ref_api.param_defs(ref_get_config(ARCH))) == 2_702_579_200
    assert params["layers"]["wdt"].shape == (64, 2560, 80)


def test_config_and_cache_match_the_reference():
    ref, port = ref_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    cfg = port.reduced()
    got = api.init_cache(cfg, 3, 99, torch.float32, "cpu")
    want = ref_api.init_cache(ref.reduced(), 3, 99, jnp.float32)
    assert type(got).__name__ == type(want).__name__ == "SSMCache"
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and not a.any()
    assert got.state.dtype == torch.float32
