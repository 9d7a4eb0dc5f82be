"""The port's RG-LRU layer, local-attention caches and RecurrentGemma family
(recurrentgemma-9b through ``repro_torch.models.recurrentgemma``) held
against the reference, on the CPU at small width.

The reduced model is the reference's: 38 mixing layers (its layout does
not follow ``n_layers``) at d_model 32, MQA, a local window of 8.

Tolerances: f32 on both sides.  The gates and coefficients 1e-6 (the same
elementwise f32 ops).  The scan: the port's doubling scan and the
reference's ``associative_scan`` apply the same operator in another
association, so they differ by rounding only: 1e-5 (measured: at most
2.4e-7, about one f32 step, at |h| ≤ 3.1 and S ≤ 512 with decays in
(0, 1)); against the port's own sequential recurrence 1e-5 too (the same
2.4e-7).  Block against chained decode steps 1e-5.
Logits 1e-4; gradients atol 5e-5, rtol 5e-4.  Cache appends are exact.
Greedy tokens identical.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models.layers import attention as ref_attn
from repro.models.layers import rglru as ref_rglru
from repro.models.params import count_params as ref_count_params
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api, recurrentgemma
from repro_torch.models.layers import attention, rglru
from repro_torch.models.params import count_params, init_params
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from test_torch_vlm import _np, assert_train_matches, configs, params_pair

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

ARCH = "recurrentgemma-9b"
COEFF_TOL, SCAN_TOL, BLOCK_TOL, LOGIT_TOL = 1e-6, 1e-5, 1e-5, 1e-4


def _rec_params(R, seed):
    """One recurrent layer's weights at width R (the reference's shapes),
    numpy f32, gate biases and Λ drawn so every term is exercised."""
    rng = np.random.default_rng(seed)
    bw = R // rglru._N_BLOCKS
    return {"w_a": 0.3 * rng.standard_normal((16, bw, bw)),
            "b_a": 0.3 * rng.standard_normal(R),
            "w_x": 0.3 * rng.standard_normal((16, bw, bw)),
            "b_x": 0.3 * rng.standard_normal(R),
            "lam": 1.0 + 0.3 * rng.standard_normal(R),
            "w_branch1": 0.2 * rng.standard_normal((24, R)),
            "w_branch2": 0.2 * rng.standard_normal((24, R)),
            "conv_w": 0.2 * rng.standard_normal((4, R)),
            "conv_b": 0.1 * rng.standard_normal(R),
            "w_out": 0.2 * rng.standard_normal((R, 24))}


def _pair(p):
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _sequential(a, b):
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("S", [1, 7, 64, 300])
def test_gates_coefficients_and_scan_match_the_reference(S):
    R = 32
    p, p_r = _pair(_rec_params(R, S))
    x = np.random.default_rng(S + 1).standard_normal((2, S, R)).astype(
        np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(
        _np(rglru._blocked_gate(tx, p["w_a"], p["b_a"])),
        _np(jax.jit(ref_rglru._blocked_gate)(jx, p_r["w_a"], p_r["b_a"])),
        rtol=COEFF_TOL, atol=COEFF_TOL)
    a, b = rglru._rglru_coeffs(p, tx)
    a_r, b_r = jax.jit(ref_rglru._rglru_coeffs)(p_r, jx)
    np.testing.assert_allclose(_np(a), _np(a_r), rtol=COEFF_TOL,
                               atol=COEFF_TOL)
    np.testing.assert_allclose(_np(b), _np(b_r), rtol=COEFF_TOL,
                               atol=COEFF_TOL)
    assert 0.0 < float(a.min()) and float(a.max()) < 1.0
    h = rglru.rglru_scan(p, tx)
    np.testing.assert_allclose(_np(h), _np(jax.jit(ref_rglru.rglru_scan)(
        p_r, jx)),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(_np(h), _np(_sequential(a, b)),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


def test_recurrent_block_decode_chained_equals_the_block():
    R, S = 32, 19
    p, p_r = _pair(_rec_params(R, 3))
    cfg = get_config(ARCH).reduced()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, S, 24)).astype(np.float32))
    want = rglru.recurrent_block(cfg, p, x)
    np.testing.assert_allclose(
        _np(want), _np(jax.jit(functools.partial(
            ref_rglru.recurrent_block, ref_get_config(ARCH).reduced()))(
                p_r, jnp.asarray(_np(x)))),
        rtol=BLOCK_TOL, atol=BLOCK_TOL)
    cache = rglru.RGLRUCache(h=torch.zeros((2, R)),
                             conv=torch.zeros((2, 3, R)))
    for t in range(S):
        y, cache = rglru.recurrent_block_decode(cfg, p, x[:, t:t + 1], cache)
        np.testing.assert_allclose(_np(y), _np(want[:, t:t + 1]),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)


def _caches(rng, B, s_max, Hkv, dh, length):
    k, v = (rng.standard_normal((B, s_max, Hkv, dh)).astype(np.float32)
            for _ in range(2))
    length = np.asarray(length, np.int32)
    return (attention.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(length)),
            ref_attn.KVCache(jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(length)))


@pytest.mark.parametrize("n", [1, 3])
def test_ring_append_wraps_like_the_reference(n):
    """Ring caches of 8 slots across the wrap: one token per sequence at
    ``length mod 8`` (lengths 7, 8, 13), several tokens from sequence 0's
    wrapped position."""
    rng = np.random.default_rng(n)
    B, s_max, Hkv, dh = 3, 8, 1, 4
    lengths = [7, 8, 13] if n == 1 else [9, 9, 9]
    cache, cache_r = _caches(rng, B, s_max, Hkv, dh, lengths)
    kv = rng.standard_normal((B, n, Hkv, dh)).astype(np.float32)
    got = attention.kv_cache_append(cache, torch.from_numpy(kv),
                                    torch.from_numpy(kv), ring=True)
    want = ref_attn.kv_cache_append(cache_r, jnp.asarray(kv),
                                    jnp.asarray(kv), ring=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if n == 1:
        for s, ln in enumerate(lengths):
            np.testing.assert_array_equal(got.k[s, ln % s_max].numpy(),
                                          kv[s, 0])
    else:
        np.testing.assert_array_equal(got.k[:, 1:4].numpy(), kv)
    np.testing.assert_array_equal(got.length.numpy(),
                                  np.asarray(lengths) + n)
    # without ring the full slot (length 8) is left as it was
    flat = attention.kv_cache_append(cache, torch.from_numpy(kv),
                                     torch.from_numpy(kv))
    flat_r = ref_attn.kv_cache_append(cache_r, jnp.asarray(kv),
                                      jnp.asarray(kv))
    for a, b in zip(flat, flat_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("s_max,window,lengths", [
    (8, 8, [3, 8, 21]),          # ring branch: kpos < min(length, s_max)
    (8, 16, [3, 8, 21]),         # ring shorter than the window
    (24, 6, [3, 10, 24]),        # window branch: length − 1 − window < kpos
    (24, 0, [3, 10, 24]),        # no window
])
def test_decode_attention_window_branches(s_max, window, lengths):
    rng = np.random.default_rng(s_max + window)
    B, Hkv, dh, H = 3, 1, 8, 4
    cache, cache_r = _caches(rng, B, s_max, Hkv, dh, lengths)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    got = attention.decode_attention(torch.from_numpy(q), cache,
                                     window=window)
    want = ref_attn.decode_attention(jnp.asarray(q), cache_r, window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    if window and s_max > window:    # the slots out of the window count not
        k = cache.k.clone()
        k[1, :10 - window] = 100.0
        other = attention.decode_attention(
            torch.from_numpy(q), attention.KVCache(k, cache.v, cache.length),
            window=window)
        np.testing.assert_array_equal(_np(other), _np(got))


# -- the reduced model --------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    ref_cfg, cfg = configs(ARCH)
    ref_params, params = params_pair(ref_cfg, cfg)
    return ref_cfg, cfg, ref_params, params


def test_forward_and_grad_match_the_reference(model):
    ref_cfg, cfg, ref_params, params = model
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    assert_train_matches(cfg, ref_cfg, params, ref_params,
                         {"tokens": torch.from_numpy(tokens)},
                         {"tokens": jnp.asarray(tokens)}, labels)


def test_prefill_then_decode_across_the_ring_wrap(model):
    """Prefill of 24 tokens (past the window of 8: the caches keep the last
    8 keys), then 10 decode steps, so that every ring wraps."""
    ref_cfg, cfg, ref_params, params = model
    B, S = 2, 24
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S + 10)).astype(np.int32)
    lg, caches = api.forward_prefill(
        cfg, params, {"tokens": torch.from_numpy(toks[:, :S])})
    lg_r, caches_r = jax.jit(functools.partial(
        ref_api.forward_prefill, ref_cfg))(
            ref_params, {"tokens": jnp.asarray(toks[:, :S])})
    np.testing.assert_allclose(_np(lg), _np(lg_r), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert caches.attn.k.shape == (12, B, 8, cfg.n_kv, cfg.dh)
    ref_decode = jax.jit(functools.partial(ref_api.forward_decode, ref_cfg))
    for j in range(10):
        nxt = toks[:, S + j:S + j + 1]
        dec, caches = api.forward_decode(cfg, params, torch.from_numpy(nxt),
                                         caches)
        dec_r, caches_r = ref_decode(ref_params, jnp.asarray(nxt), caches_r)
        np.testing.assert_allclose(_np(dec), _np(dec_r), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    got, want = jax.tree_util.tree_leaves(caches), jax.tree_util.tree_leaves(
        caches_r)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    assert int(caches.attn.length[0, 0]) == S + 10


def _requests(cfg, cls):
    rng = np.random.default_rng(9)
    return [cls(uid=u, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=5) for u, n in enumerate((9, 30, 12))]


def test_serve_engine_matches_the_reference(model):
    """2 slots, buckets (16, 32): requests 0 and 1 prefill at 16 and 32,
    so their slots decode at different lengths, and every slot's RoPE
    takes slot 0's position (note (l)); greedy tokens identical to the
    reference engine's."""
    ref_cfg, cfg, ref_params, params = model
    ecfg = dict(slots=2, s_max=64, prefill_buckets=(16, 32))
    ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**ecfg))
    eng = ServeEngine(cfg, params, EngineConfig(**ecfg), device="cpu")
    for r in _requests(cfg, RefRequest):
        ref.submit(r)
    for r in _requests(cfg, Request):
        eng.submit(r)
    eng.step()
    assert eng.caches.attn.length[:, 0].tolist() == [17] * 12
    assert eng.caches.attn.length[:, 1].tolist() == [33] * 12
    done_r, done = ref.run(), eng.run()
    assert sorted(done) == sorted(done_r) == [0, 1, 2]
    for uid in done:
        assert done[uid].out_tokens == done_r[uid].out_tokens
        assert len(done[uid].out_tokens) == 6
    assert eng.ticks == ref.ticks
    for a, b in zip(jax.tree_util.tree_leaves(eng.caches),
                    jax.tree_util.tree_leaves(ref.caches)):
        np.testing.assert_allclose(_np(a), _np(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_decode_takes_slot_zeros_position(model):
    """Note (l): a slot's logits depend on slot 0's length, not its own."""
    _, cfg, _, params = model
    caches = api.init_cache(cfg, 2, 64, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(0)
    caches = caches._replace(attn=caches.attn._replace(
        k=torch.randn(caches.attn.k.shape, generator=gen),
        v=torch.randn(caches.attn.v.shape, generator=gen)))
    toks = torch.tensor([[3], [5]], dtype=torch.int32)
    out = {}
    for l0 in (4, 11):
        length = torch.tensor([l0, 4], dtype=torch.int32)
        c = caches._replace(attn=caches.attn._replace(
            length=length.expand(12, 2).clone()))
        out[l0], _ = api.forward_decode(cfg, params, toks, c)
    assert float((out[4][1] - out[11][1]).abs().max()) > 1e-6


def test_full_config_params_on_the_meta_device():
    cfg = get_config(ARCH)
    params = init_params(api.param_defs(cfg), torch.Generator(),
                         dtype=torch.bfloat16, device="meta")
    leaves = jax.tree_util.tree_leaves(params)
    assert all(x.device.type == "meta" for x in leaves)
    n = sum(x.numel() for x in leaves)
    assert n == count_params(api.param_defs(cfg)) == ref_count_params(
        ref_api.param_defs(ref_get_config(ARCH))) == 8_578_519_040
    assert params["groups"]["rec1"]["w_a"].shape == (12, 16, 256, 256)
    assert params["tail"]["mlp"]["wd"].shape == (2, 12288, 4096)


def test_config_and_cache_match_the_reference():
    ref, port = ref_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    for s_max in (5, 64):
        got = api.init_cache(port.reduced(), 3, s_max, torch.float32, "cpu")
        want = ref_api.init_cache(ref.reduced(), 3, s_max, jnp.float32)
        assert type(got).__name__ == type(want).__name__ == "RGCache"
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert tuple(a.shape) == b.shape and not a.any()
    assert recurrentgemma.N_GROUPS * 3 + recurrentgemma.N_TAIL == 38
