"""The port's dense serving path (``repro_torch.models`` and
``repro_torch.serve.engine.ServeEngine``) held against the reference, on
the CPU at small width.

Two configurations, each the reference's ``reduced()`` form with
``head_dim=64`` and ``use_flash=True`` so a 256-token prefill takes the
flash branch in both packages: ``llama3-8b`` (4 heads over 2 KV heads,
G = 2, RoPE θ = 5e5, untied head) and ``qwen1.5-0.5b`` (QKV bias, G = 1,
tied embeddings).  Weights come from the reference's ``init_params`` and
cross through ``convert.model_params_from_reference``; the zero- and
one-initialised leaves (norm gains, biases) get small random values so
that the ``1 + scale`` norm and the biases are exercised.

Tolerances: both sides compute in f32 and differ in summation order
(~1e-7 relative per product): layers 1e-5 at unit-scale inputs; whole
forward passes (embeddings, 2 layers, a 128-way head) 1e-4.  Tokens,
ticks and cache lengths must be identical: greedy decoding at
temperature 0, since ``jax.random`` and ``torch.Generator`` draw
different numbers.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.kernels.flash_attn import ops as ref_flash_ops
from repro.models import api as ref_api
from repro.models.layers import attention as ref_attn
from repro.models.layers import common as ref_common
from repro.models.layers import mlp as ref_mlp
from repro.models.params import count_params as ref_count_params
from repro.models.params import init_params as ref_init_params
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.models.params import count_params, init_params
from repro_torch.models.layers import attention, common, mlp
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.serve_step import build_decode_step

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

ARCHS = ["llama3-8b", "qwen1.5-0.5b"]
LAYER_TOL, MODEL_TOL = 1e-5, 1e-4


def _configs(arch):
    over = dict(head_dim=64, use_flash=True)
    return (dataclasses.replace(ref_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference config, port config, reference params, port params)."""
    ref_cfg, cfg = _configs(request.param)
    params = jax.tree.map(np.asarray, ref_init_params(
        ref_api.param_defs(ref_cfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    layers = params["layers"]
    for name in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):
        if name in layers:
            layers[name] = 0.1 * rng.standard_normal(
                layers[name].shape).astype(np.float32)
    params["final_norm"] = 0.1 * rng.standard_normal(
        params["final_norm"].shape).astype(np.float32)
    ref_params = jax.tree.map(jnp.asarray, params)
    port = convert.model_params_from_reference(params, cfg, device="cpu")
    return ref_cfg, cfg, ref_params, port


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def test_configs_match_the_reference():
    for arch in ("smollm-135m", "qwen1.5-0.5b", "minitron-4b", "llama3-8b",
                 "qwen2-vl-2b", "mamba2-2.7b", "recurrentgemma-9b",
                 "whisper-large-v3"):
        ref, port = ref_get_config(arch), get_config(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(port.reduced()) == \
            dataclasses.asdict(ref.reduced())
        assert count_params(api.param_defs(port)) == \
            ref_count_params(ref_api.param_defs(ref))
    # every family of the reference has a module; an unknown one raises
    unknown = dataclasses.replace(get_config("llama3-8b"), family="audio")
    with pytest.raises(KeyError, match="audio"):
        api.model_module(unknown)
    with pytest.raises(KeyError, match="audio"):
        ref_api.model_module(unknown)


def test_convert_checks_the_tree(model):
    ref_cfg, cfg, ref_params, _ = model
    params = jax.tree.map(np.asarray, ref_params)
    del params["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        convert.model_params_from_reference(params, cfg, device="cpu")
    params = jax.tree.map(np.asarray, ref_params)
    params["layers"]["wq"] = params["layers"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        convert.model_params_from_reference(params, cfg, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_rope_swiglu():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    scale = 0.1 * rng.standard_normal(32).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale)), LAYER_TOL)
    xh = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    for theta in (1e4, 5e5, 1e6):
        _close(common.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos),
                                 theta),
               ref_common.apply_rope(jnp.asarray(xh), jnp.asarray(pos),
                                     theta), LAYER_TOL)
    w = [0.2 * rng.standard_normal(s).astype(np.float32)
         for s in ((32, 64), (32, 64), (64, 32))]
    _close(mlp.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w)),
           ref_mlp.swiglu(jnp.asarray(x), *map(jnp.asarray, w)), LAYER_TOL)


def _qkv(B, Sq, Skv, H, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, dh)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("branch,shape,kw", [
    ("full", (2, 16, 16, 4, 2, 8), dict(causal=True)),
    ("full", (2, 16, 16, 4, 2, 8), dict(causal=False, window=5)),
    ("chunked", (2, 19, 19, 4, 2, 8),
     dict(causal=True, kv_valid_len=13, chunk_q=8, chunk_kv=6)),
    ("chunked", (1, 5, 37, 2, 2, 8),
     dict(causal=True, window=9, q_offset=32, kv_valid_len=37, chunk_q=4,
          chunk_kv=16)),
    ("flash", (2, 256, 256, 4, 2, 64), dict(causal=True, use_flash=True)),
])
def test_attention_any_branches(branch, shape, kw):
    q, k, v = _qkv(*shape, seed=len(kw))
    n0 = flash_kernel.flash_fwd.launches
    got = attention.attention_any(*map(torch.from_numpy, (q, k, v)), **kw)
    want = ref_attn.attention_any(*map(jnp.asarray, (q, k, v)), **kw)
    _close(got, want, LAYER_TOL)
    assert flash_kernel.flash_fwd.launches == n0     # CPU: plain version


def test_decode_attention_and_cache_append():
    rng = np.random.default_rng(3)
    B, s_max, Hkv, dh, H = 3, 12, 2, 8, 4
    cache = [rng.standard_normal((B, s_max, Hkv, dh)).astype(np.float32)
             for _ in range(2)]
    length = np.array([3, 11, 12], np.int32)     # the last slot is full
    k_new, v_new = (rng.standard_normal((B, 1, Hkv, dh)).astype(np.float32)
                    for _ in range(2))
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    ref_c = ref_attn.kv_cache_append(
        ref_attn.KVCache(*map(jnp.asarray, cache), jnp.asarray(length)),
        jnp.asarray(k_new), jnp.asarray(v_new))
    port_c = attention.kv_cache_append(
        attention.KVCache(*map(torch.from_numpy, cache),
                          torch.from_numpy(length)),
        torch.from_numpy(k_new), torch.from_numpy(v_new))
    for a, b in zip(port_c, ref_c):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(attention.decode_attention(torch.from_numpy(q), port_c),
           ref_attn.decode_attention(jnp.asarray(q), ref_c), LAYER_TOL)
    # several tokens start at length[0], clamped so the slice fits
    kv = rng.standard_normal((B, 4, Hkv, dh)).astype(np.float32)
    for start in (2, 10):
        lens = np.full(B, start, np.int32)
        ref_c = ref_attn.kv_cache_append(
            ref_attn.KVCache(*map(jnp.asarray, cache), jnp.asarray(lens)),
            jnp.asarray(kv), jnp.asarray(kv))
        port_c = attention.kv_cache_append(
            attention.KVCache(*map(torch.from_numpy, cache),
                              torch.from_numpy(lens)),
            torch.from_numpy(kv), torch.from_numpy(kv))
        for a, b in zip(port_c, ref_c):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def _prefill_pair(model, seed, S=256):
    ref_cfg, cfg, ref_params, port = model
    toks = _tokens(cfg, 1, S, seed)
    want = ref_api.forward_prefill(ref_cfg, ref_params,
                                   {"tokens": jnp.asarray(toks)})
    n0 = flash_kernel.flash_fwd.launches
    got = api.forward_prefill(cfg, port, {"tokens": torch.from_numpy(toks)})
    assert flash_kernel.flash_fwd.launches == n0
    return got, want


@pytest.fixture(scope="module")
def prefilled(model):
    """(port, reference) prefill of one 256-token prompt: the flash branch
    in both packages."""
    return _prefill_pair(model, seed=4)


def test_forward_prefill_matches(model, prefilled):
    (lg, caches), (lg_r, caches_r) = prefilled
    assert lg.shape == (1, 1, model[1].vocab)
    _close(lg, lg_r, MODEL_TOL)
    _close(caches.k, caches_r.k, MODEL_TOL)
    _close(caches.v, caches_r.v, MODEL_TOL)
    np.testing.assert_array_equal(caches.length.numpy(),
                                  np.asarray(caches_r.length))


@pytest.mark.parametrize("model", ["llama3-8b"], indirect=True)
def test_forward_prefill_against_the_pallas_kernel(model, monkeypatch):
    """The reference's prefill with its Pallas flash kernel run in
    interpret mode (its own lowering switch), not its jnp oracle."""
    monkeypatch.setenv("REPRO_KERNEL_LOWERING", "interpret")
    # the lowering is read when the jitted wrapper traces
    ref_flash_ops.flash_attention_bshd.clear_cache()
    try:
        (lg, caches), (lg_r, caches_r) = _prefill_pair(model, seed=5)
    finally:
        monkeypatch.delenv("REPRO_KERNEL_LOWERING")
        ref_flash_ops.flash_attention_bshd.clear_cache()
    _close(lg, lg_r, MODEL_TOL)
    _close(caches.k, caches_r.k, MODEL_TOL)


def test_forward_decode_three_steps(model, prefilled):
    ref_cfg, cfg, ref_params, port = model
    B, s_max = 1, 264
    (_, pre), (_, pre_r) = prefilled
    S = pre.k.shape[2]
    caches = api.init_cache(cfg, B, s_max, torch.float32, "cpu")
    caches.k[:, :, :S] = pre.k
    caches.v[:, :, :S] = pre.v
    caches.length[:] = pre.length
    empty = ref_api.init_cache(ref_cfg, B, s_max, jnp.float32)
    caches_r = ref_attn.KVCache(empty.k.at[:, :, :S].set(pre_r.k),
                                empty.v.at[:, :, :S].set(pre_r.v),
                                pre_r.length)
    toks = _tokens(cfg, B, 1, 7)
    for _ in range(3):
        lg, caches = api.forward_decode(cfg, port, torch.from_numpy(toks),
                                        caches)
        lg_r, caches_r = ref_api.forward_decode(ref_cfg, ref_params,
                                                jnp.asarray(toks), caches_r)
        _close(lg, lg_r, MODEL_TOL)
        np.testing.assert_array_equal(caches.length.numpy(),
                                      np.asarray(caches_r.length))
        # both continue from the reference's token, so a near-tie cannot
        # fork the two runs
        toks = np.argmax(_np(lg_r)[:, -1], axis=-1).astype(np.int32)[:, None]
    _close(caches.k, caches_r.k, MODEL_TOL)


def test_sampled_decode_draws_from_the_generator(model, prefilled):
    """temperature > 0 with a generator samples (the reference's
    ``jax.random`` draws other numbers, so this is held to itself: the same
    seed gives the same tokens); without one the step stays greedy."""
    _, cfg, _, port = model
    (lg, caches), _ = prefilled
    toks = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
    step = build_decode_step(cfg, temperature=1.0)
    draws = [step(port, toks, caches,
                  torch.Generator().manual_seed(s))[0] for s in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1])
    assert all(0 <= int(d) < cfg.vocab for d in draws)
    greedy, _ = step(port, toks, caches)
    want = api.forward_decode(cfg, port, toks, caches)[0][:, -1]
    assert torch.equal(greedy[:, 0], torch.argmax(want, dim=-1).int())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _requests(cfg, cls, n=3, lo=100, hi=255, max_new=4, seed=8):
    rng = np.random.default_rng(seed)
    return [cls(uid=u, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(lo, hi + 1))).astype(np.int32),
        max_new=max_new) for u in range(n)]


def test_serve_engine_matches(model):
    ref_cfg, cfg, ref_params, port = model
    ecfg = dict(slots=2, s_max=320, prefill_buckets=(256,))
    ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**ecfg))
    eng = ServeEngine(cfg, port, EngineConfig(**ecfg), device="cpu")
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
    np.testing.assert_array_equal(eng.caches.length.numpy(),
                                  np.asarray(ref.caches.length))
    _close(eng.caches.k, ref.caches.k, MODEL_TOL)


# ---------------------------------------------------------------------------
# the reference's engine regressions, mirrored on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """smollm-135m reduced, as the reference's engine tests use it; these
    tests check the cache's layout, so the port's own init serves."""
    cfg = get_config("smollm-135m").reduced()
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _tiny_engine(tiny, **kw):
    cfg, params = tiny
    defaults = dict(slots=2, s_max=64, prefill_buckets=(16,))
    defaults.update(kw)
    return ServeEngine(cfg, params, EngineConfig(**defaults), device="cpu")


def test_splice_left_aligns_into_long_cache_slot(tiny):
    """A 5-token prompt (bucket 16) in s_max=64 buffers: the prefill KV
    lands at [0, 16) with zeros after, length 16, and each decode tick
    appends at exactly position ``length``."""
    eng = _tiny_engine(tiny)
    rng = np.random.default_rng(1)
    eng.submit(Request(uid=0, prompt=rng.integers(0, tiny[0].vocab, 5)
                       .astype(np.int32), max_new=3))
    eng.step()                              # admit + first decode tick
    length = eng.caches.length.numpy()
    assert (length[:, 0] == 17).all()
    norms = torch.linalg.vector_norm(eng.caches.k[:, 0], dim=(-2, -1))
    assert (norms[:, :17] > 0).all(), "prefill cache not left-aligned"
    assert (norms[:, 17:] == 0).all(), "cache content beyond `length`"
    eng.step()
    norms = torch.linalg.vector_norm(eng.caches.k[:, 0], dim=(-2, -1))
    assert (norms[:, 17] > 0).all() and (norms[:, 18:] == 0).all(), \
        "decode tick did not continue from the spliced position"


def test_splice_clears_what_the_slot_held_before(tiny):
    """A slot refilled after a longer request holds zeros past the new
    prefill, as the reference's padded splice leaves it."""
    eng = _tiny_engine(tiny, slots=1, prefill_buckets=(16, 32))
    rng = np.random.default_rng(2)
    for uid, n in enumerate((30, 5)):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, tiny[0].vocab, n)
                           .astype(np.int32), max_new=2))
    eng.step()
    eng.step()                 # request 0 finishes: its slot held 34 rows
    eng.step()                 # request 1 is admitted into that slot
    norms = torch.linalg.vector_norm(eng.caches.k[:, 0], dim=(-2, -1))
    assert (norms[:, :17] > 0).all() and (norms[:, 17:] == 0).all()


def test_over_long_prompt_is_rejected(tiny):
    eng = _tiny_engine(tiny)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        eng.submit(Request(uid=0, prompt=np.zeros(17, np.int32)))
    assert not eng.queue
