"""The port's encoder-decoder family (whisper-large-v3 through
``repro_torch.models.whisper``), its LayerNorm and GELU MLP, and the
analytic FLOP count (``repro_torch.launch.flops``) held against the
reference, on the CPU at small width.

Weights come from the reference's ``init_params`` and cross through
``convert.model_params_from_reference`` (``test_torch_vlm.params_pair``:
every zero- or one-initialised leaf, the LayerNorm gains and the biases
here, gets a small random offset so that it is exercised).  The frames
that stand in for the conv frontend's output are 0.1·N(0, 1), as in the
reference's smoke test.  The reference's model calls run under
``jax.jit``.

Tolerances: both sides compute in f32 and differ in summation order only:
LayerNorm and the GELU MLP 1e-5 at unit-scale inputs; LayerNorm in bf16
one bf16 rounding of its output (2⁻⁸ relative, atol 1e-2 at unit
inputs); the encoder's states 1e-5; logits and caches 1e-4; gradients
atol 5e-5, rtol 5e-4, the levels of the other model files.  A decode on
the prefill's own cache against the training forward: the reference smoke
test's 5e-2 (ROADMAP §3 note (n): that decode never sees its own token).
FLOP counts: exact.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.configs.base import all_configs as ref_all_configs
from repro.configs.base import get_config as ref_get_config
from repro.launch import flops as ref_flops
from repro.models import api as ref_api
from repro.models import whisper as ref_whisper
from repro.models.layers import common as ref_common
from repro.models.layers import mlp as ref_mlp
from repro.models.layers.attention import KVCache as RefKVCache
from repro.models.params import count_params as ref_count_params
from repro.serve import engine as ref_engine
from repro_torch import convert
from repro_torch.configs.base import SHAPES, ShapeSpec, all_configs, \
    get_config
from repro_torch.launch import flops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api, whisper
from repro_torch.models.layers import common, mlp
from repro_torch.models.params import count_params, init_params
from repro_torch.serve import engine
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.tree import map_dicts
from test_torch_vlm import _np, assert_train_matches, configs, params_pair

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

ARCH = "whisper-large-v3"
LAYER_TOL, LOGIT_TOL, LOOSE_TOL = 1e-5, 1e-4, 5e-2
LN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def model():
    ref_cfg, cfg = configs(ARCH)
    ref_params, params = params_pair(ref_cfg, cfg)
    return ref_cfg, cfg, ref_params, params


def _inputs(cfg, B, S, seed):
    """(tokens (B, S) int32, frames (B, enc_frames, D) f32) as numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = (0.1 * rng.standard_normal(
        (B, cfg.enc_frames, cfg.d_model))).astype(np.float32)
    return tokens, frames


def _batches(tokens, frames):
    """The same batch for the port and for the reference."""
    return ({"tokens": torch.from_numpy(tokens),
             "frames": torch.from_numpy(frames)},
            {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})


def _ref_prefill(ref_cfg):
    return jax.jit(lambda p, b: ref_api.forward_prefill(ref_cfg, p, b))


def _ref_decode(ref_cfg):
    return jax.jit(lambda p, t, c: ref_api.forward_decode(ref_cfg, p, t, c))


def _cache_leaves(cache):
    """(k, v, length, cross_k, cross_v) of either package's cache."""
    return (cache.self_kv.k, cache.self_kv.v, cache.self_kv.length,
            cache.cross_k, cache.cross_v)


def _assert_caches(got, want, tol=LOGIT_TOL):
    for a, b in zip(_cache_leaves(got), _cache_leaves(want)):
        assert tuple(a.shape) == tuple(np.shape(b))
        _close(a, b, tol)


# -- configs and parameters ---------------------------------------------------


def test_config_and_reduced_match_the_reference():
    ref, port = ref_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert (port.family, port.enc_layers, port.enc_frames, port.norm_eps,
            port.rope_theta) == ("encdec", 32, 1500, 1e-6, 0.0)
    assert set(all_configs()) == set(ref_all_configs())
    assert SHAPES == {k: ShapeSpec(*dataclasses.astuple(v))
                      for k, v in REF_SHAPES.items()}
    assert api.model_module(port) is whisper


def test_param_count_and_full_config_on_the_meta_device():
    cfg = get_config(ARCH)
    defs = api.param_defs(cfg)
    assert count_params(defs) == ref_count_params(
        ref_api.param_defs(ref_get_config(ARCH))) == 1_579_450_880
    assert count_params(api.param_defs(cfg.reduced())) == ref_count_params(
        ref_api.param_defs(ref_get_config(ARCH).reduced()))
    params = init_params(defs, torch.Generator(), dtype=torch.bfloat16,
                         device="meta")
    leaves = jax.tree_util.tree_leaves(params)
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in leaves) == 1_579_450_880
    assert params["dec_pos"].shape == (whisper.MAX_DEC_POS, 1280) == \
        (32_768, 1280)
    assert params["enc_layers"]["w_in"].shape == (32, 1280, 5120)
    assert params["dec_layers"]["x_wk"].shape == (32, 1280, 1280)
    assert "bk" not in params["dec_layers"] and "x_bk" not in \
        params["dec_layers"]


def test_init_cache_matches_the_reference():
    ref_cfg, cfg = configs(ARCH)
    got = api.init_cache(cfg, 3, 11, torch.float32, "cpu")
    want = ref_api.init_cache(ref_cfg, 3, 11, jnp.float32)
    assert type(got).__name__ == type(want).__name__ == "WhisperCache"
    for a, b in zip(_cache_leaves(got), _cache_leaves(want)):
        assert tuple(a.shape) == b.shape and not a.any()
    assert got.cross_k.shape == (cfg.n_layers, 3, cfg.enc_frames,
                                 cfg.n_heads, cfg.dh)


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = (1.5 + rng.standard_normal((2, 7, 48))).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = common.layer_norm(torch.from_numpy(x).to(td),
                            torch.from_numpy(s).to(td),
                            torch.from_numpy(b).to(td), 1e-6)
    want = jax.jit(ref_common.layer_norm, static_argnums=3)(
        jnp.asarray(x).astype(jd), jnp.asarray(s).astype(jd),
        jnp.asarray(b).astype(jd), 1e-6)
    assert got.dtype == td
    _close(got, want, LN_TOL[dtype])


def test_gelu_mlp_is_the_tanh_form_of_the_reference():
    """Note (p): ``jax.nn.gelu`` defaults to the tanh approximation, so
    the port's MLP matches the reference's, and the exact erf form misses
    it by far more than the tolerance."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    w_in = (0.4 * rng.standard_normal((32, 64))).astype(np.float32)
    b_in = (0.5 * rng.standard_normal(64)).astype(np.float32)
    w_out = (0.2 * rng.standard_normal((64, 32))).astype(np.float32)
    b_out = (0.1 * rng.standard_normal(32)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, w_in, b_in, w_out, b_out)]
    got = mlp.gelu_mlp(*args)
    want = jax.jit(ref_mlp.gelu_mlp)(*(jnp.asarray(a) for a in
                                       (x, w_in, b_in, w_out, b_out)))
    _close(got, want, LAYER_TOL)
    h = F.gelu(torch.matmul(args[0], args[1]) + args[2])     # erf form
    exact = torch.matmul(h, args[3]) + args[4]
    assert float((exact - got).abs().max()) > 20 * LAYER_TOL


# -- the model ----------------------------------------------------------------


def test_encode_matches_the_reference(model):
    ref_cfg, cfg, ref_params, params = model
    _, frames = _inputs(cfg, 2, 1, seed=2)
    got = whisper.encode(cfg, params, torch.from_numpy(frames))
    want = jax.jit(lambda p, f: ref_whisper.encode(ref_cfg, p, f))(
        ref_params, jnp.asarray(frames))
    assert got.shape == (2, cfg.enc_frames, cfg.d_model)
    _close(got, want, LAYER_TOL)


def test_forward_and_grad_match_the_reference(model):
    """Logits, the loss and every gradient (encoder, decoder, both
    position tables, the tied table) against ``jax.grad``."""
    ref_cfg, cfg, ref_params, params = model
    tokens, frames = _inputs(cfg, 2, 12, seed=3)
    labels = np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    batch, ref_batch = _batches(tokens, frames)
    assert_train_matches(cfg, ref_cfg, params, ref_params, batch, ref_batch,
                         labels)


def test_remat_full_equals_none_bitwise(model):
    _, cfg, _, params = model
    tokens, frames = _inputs(cfg, 2, 10, seed=5)
    batch, _ = _batches(tokens, frames)
    out = {}
    for remat in ("none", "full"):
        p = map_dicts(lambda w: w.detach().clone().requires_grad_(True),
                      params)
        leaves = jax.tree_util.tree_leaves(p)
        logits, _ = api.forward_train(dataclasses.replace(cfg, remat=remat),
                                      p, batch)
        loss = torch.logsumexp(logits, dim=-1).mean()
        out[remat] = (logits.detach(),
                      torch.autograd.grad(loss, leaves))
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


def test_prefill_matches_the_reference(model):
    """The last position's logits and all four cache leaves (self K/V of
    exactly S slots, their lengths, the cross K/V over the frames)."""
    ref_cfg, cfg, ref_params, params = model
    tokens, frames = _inputs(cfg, 2, 9, seed=6)
    batch, ref_batch = _batches(tokens, frames)
    with torch.no_grad():
        lg, cache = api.forward_prefill(cfg, params, batch)
    lg_r, cache_r = _ref_prefill(ref_cfg)(ref_params, ref_batch)
    assert lg.shape == (2, 1, cfg.vocab)
    _close(lg, lg_r, LOGIT_TOL)
    assert cache.self_kv.k.shape == (cfg.n_layers, 2, 9, cfg.n_heads, cfg.dh)
    assert cache.self_kv.length.tolist() == [[9, 9]] * cfg.n_layers
    _assert_caches(cache, cache_r)


def _with_room(cfg, pre, s_max):
    """A prefill's ``WhisperCache`` copied into an empty one of ``s_max``
    self-attention slots."""
    big = api.init_cache(cfg, pre.cross_k.shape[1], s_max, torch.float32,
                         "cpu")
    S = pre.self_kv.k.shape[2]
    big.self_kv.k[:, :, :S] = pre.self_kv.k
    big.self_kv.v[:, :, :S] = pre.self_kv.v
    big.self_kv.length[:] = pre.self_kv.length
    big.cross_k[:] = pre.cross_k
    big.cross_v[:] = pre.cross_v
    return big


def _ref_with_room(ref_cfg, pre, s_max):
    big = ref_api.init_cache(ref_cfg, pre.cross_k.shape[1], s_max,
                             jnp.float32)
    S = pre.self_kv.k.shape[2]
    kv = big.self_kv
    return ref_whisper.WhisperCache(
        self_kv=RefKVCache(k=kv.k.at[:, :, :S].set(pre.self_kv.k),
                           v=kv.v.at[:, :, :S].set(pre.self_kv.v),
                           length=pre.self_kv.length),
        cross_k=pre.cross_k, cross_v=pre.cross_v)


def _spliced_pair(model, S, s_max, seed):
    """Prefill in each package, each cache moved into ``s_max`` slots:
    (tokens, port cache, reference cache)."""
    ref_cfg, cfg, ref_params, params = model
    tokens, frames = _inputs(cfg, 2, S + 4, seed)
    batch, ref_batch = _batches(tokens[:, :S], frames)
    with torch.no_grad():
        _, pre = api.forward_prefill(cfg, params, batch)
    _, pre_r = _ref_prefill(ref_cfg)(ref_params, ref_batch)
    return (tokens, _with_room(cfg, pre, s_max),
            _ref_with_room(ref_cfg, pre_r, s_max))


def test_decode_on_a_spliced_cache_matches_the_reference(model):
    """Three decode steps on an s_max cache that holds the prefill in
    its first S slots: each step's logits and the final caches."""
    ref_cfg, cfg, ref_params, params = model
    S = 7
    tokens, cache, cache_r = _spliced_pair(model, S, 16, seed=7)
    decode = _ref_decode(ref_cfg)
    for j in range(3):
        nxt = tokens[:, S + j:S + j + 1]
        with torch.no_grad():
            lg, cache = api.forward_decode(cfg, params,
                                           torch.from_numpy(nxt), cache)
        lg_r, cache_r = decode(ref_params, jnp.asarray(nxt), cache_r)
        _close(lg, lg_r, LOGIT_TOL)
    assert cache.self_kv.length.tolist() == [[S + 3] * 2] * cfg.n_layers
    assert cache.self_kv.k[:, :, S:S + 3].abs().sum() > 0
    assert not cache.self_kv.k[:, :, S + 3:].any()
    _assert_caches(cache, cache_r)


def test_decode_on_the_prefill_cache_stores_nothing(model):
    """Note (n): on the prefill's own cache (exactly S slots) the decode
    step's append matches no slot, the length still grows, and the token
    attends to the S prompt positions only.  The reference's cache,
    carried across by ``convert.whisper_cache_from_reference``, gives the
    reference's logits."""
    ref_cfg, cfg, ref_params, params = model
    S = 8
    tokens, frames = _inputs(cfg, 2, S + 1, seed=8)
    _, ref_batch = _batches(tokens[:, :S], frames)
    _, pre_r = _ref_prefill(ref_cfg)(ref_params, ref_batch)
    pre_np = jax.tree.map(np.asarray, pre_r)
    pre = convert.whisper_cache_from_reference(pre_np, cfg, device="cpu")
    nxt = tokens[:, S:]
    with torch.no_grad():
        lg, cache = api.forward_decode(cfg, params, torch.from_numpy(nxt),
                                       pre)
    lg_r, cache_r = _ref_decode(ref_cfg)(ref_params, jnp.asarray(nxt), pre_r)
    _close(lg, lg_r, LOGIT_TOL)
    _assert_caches(cache, cache_r)
    assert torch.equal(cache.self_kv.k, pre.self_kv.k)
    assert torch.equal(cache.self_kv.v, pre.self_kv.v)
    assert cache.self_kv.length.tolist() == [[S + 1] * 2] * cfg.n_layers
    bad = pre_np._replace(cross_k=pre_np.cross_k[:, :, :-1])
    with pytest.raises(ValueError, match="cross_k"):
        convert.whisper_cache_from_reference(bad, cfg, device="cpu")


def test_prefill_decode_consistency_at_the_reference_smoke_tolerance(model):
    """The reference smoke test's check on the port: prefill over S
    against the training forward at S − 1, and a decode on the prefill's
    own cache against it at S, within 5e-2 (the decode misses its own
    token, note (n))."""
    _, cfg, _, params = model
    S = 24
    tokens, frames = _inputs(cfg, 2, S + 1, seed=9)
    full, _ = _batches(tokens, frames)
    pre_batch, _ = _batches(tokens[:, :S], frames)
    with torch.no_grad():
        want, _ = api.forward_train(cfg, params, full)
        lg, cache = api.forward_prefill(cfg, params, pre_batch)
        dec, _ = api.forward_decode(cfg, params,
                                    torch.from_numpy(tokens[:, S:]), cache)
    _close(lg[:, 0], want[:, S - 1], LAYER_TOL)
    _close(dec[:, 0], want[:, S], LOOSE_TOL)


def test_decode_takes_slot_zeros_position(model):
    """Note (o): with slots at different lengths every slot's learned
    position is slot 0's, in both packages: moving the ``dec_pos`` row
    at slot 1's own length leaves its logits as they were, moving slot
    0's changes them."""
    ref_cfg, cfg, ref_params, params = model
    S = 6
    tokens, cache, cache_r = _spliced_pair(model, S, 12, seed=10)
    cache.self_kv.length[:, 1] = S - 2
    cache_r = cache_r._replace(self_kv=cache_r.self_kv._replace(
        length=cache_r.self_kv.length.at[:, 1].set(S - 2)))
    nxt = tokens[:, S:S + 1]

    def port(p):
        with torch.no_grad():
            return api.forward_decode(cfg, p, torch.from_numpy(nxt),
                                      cache)[0]

    lg = port(params)
    lg_r, _ = _ref_decode(ref_cfg)(ref_params, jnp.asarray(nxt), cache_r)
    _close(lg, lg_r, LOGIT_TOL)
    for row, moves in ((S - 2, False), (S, True)):
        moved = dict(params)
        moved["dec_pos"] = params["dec_pos"].clone()
        moved["dec_pos"][row] += 1.0
        out = port(moved)
        assert torch.equal(out[1], lg[1]) is not moves
        assert torch.equal(out[0], lg[0]) is not moves


def test_missing_frames_raise_a_value_error(model):
    """Note (q): without frames the port raises a ``ValueError`` that
    names them, where the reference fails on the missing key; so do the
    engine (its ``_admit`` passes only tokens, as the reference's) and
    ``launch/serve.py``."""
    ref_cfg, cfg, ref_params, params = model
    tokens, frames = _inputs(cfg, 2, 5, seed=11)
    t = torch.from_numpy(tokens)
    for fn in (api.forward_prefill, api.forward_train):
        with pytest.raises(ValueError, match="frames"):
            fn(cfg, params, {"tokens": t})
        with pytest.raises(ValueError, match=r"shape \(2, 15, 32\)"):
            fn(cfg, params, {"tokens": t,
                             "frames": torch.from_numpy(frames[:, 1:])})
    with pytest.raises(KeyError, match="frames"):
        ref_api.forward_prefill(ref_cfg, ref_params,
                                {"tokens": jnp.asarray(tokens)})
    eng = ServeEngine(cfg, params, EngineConfig(slots=2, s_max=32,
                                                prefill_buckets=(16,)),
                      device="cpu")
    eng.submit(Request(uid=0, prompt=tokens[0], max_new=2))
    with pytest.raises(ValueError, match="frames"):
        eng.run()
    with pytest.raises(ValueError, match="frames"):
        launch_serve.main(["--device", "cpu", "--arch", ARCH,
                           "--requests", "1"])


def test_splice_caches_left_aligns_self_kv_and_copies_cross_kv(model):
    """``_splice_caches`` of a batch-1 prefill into slot 1 of an engine
    cache: the self K/V left-aligned with zeros after, the length S, the
    cross K/V over all frames copied whole, the other slots untouched;
    the reference's splice gives the same leaves."""
    ref_cfg, cfg, ref_params, params = model
    S, s_max, slots = 5, 16, 3
    tokens, frames = _inputs(cfg, 1, S, seed=12)
    batch, ref_batch = _batches(tokens, frames)
    with torch.no_grad():
        _, one = api.forward_prefill(cfg, params, batch)
    big = api.init_cache(cfg, slots, s_max, torch.float32, "cpu")
    big.self_kv.k.fill_(7.0)                 # stale content past S
    engine._splice_caches(big, one, 1)
    k = big.self_kv.k
    assert torch.equal(k[:, 1, :S], one.self_kv.k[:, 0])
    assert not k[:, 1, S:].any() and bool((k[:, 0] == 7).all())
    assert torch.equal(big.self_kv.v[:, 1, :S], one.self_kv.v[:, 0])
    assert big.self_kv.length.tolist() == [[0, S, 0]] * cfg.n_layers
    assert torch.equal(big.cross_k[:, 1], one.cross_k[:, 0])
    assert torch.equal(big.cross_v[:, 1], one.cross_v[:, 0])
    assert not big.cross_k[:, [0, 2]].any()
    _, one_r = _ref_prefill(ref_cfg)(ref_params, ref_batch)
    big_r = ref_api.init_cache(ref_cfg, slots, s_max, jnp.float32)
    big_r = big_r._replace(self_kv=big_r.self_kv._replace(
        k=big_r.self_kv.k + 7.0))
    got_r = ref_engine._splice_caches(ref_cfg, big_r, one_r, 1, s_max)
    _assert_caches(big, got_r)


# -- the analytic FLOP count --------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ref_all_configs()))
def test_model_flops_equal_the_reference(arch):
    for reduce in (False, True):
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        if reduce:
            cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
        assert flops.active_matmul_params(cfg) == \
            ref_flops.active_matmul_params(ref_cfg)
        for name, shape in SHAPES.items():
            assert flops.model_flops(cfg, shape) == \
                ref_flops.model_flops(ref_cfg, REF_SHAPES[name])


def test_model_flops_miss_the_encoders_frames():
    """Note (r): at a (4, 4) prefill both packages count 0.059 TFLOP for
    Whisper, the encoder's weights once a decoder token, where its
    products over 4 × 1500 frames alone take about 7.6 TFLOP."""
    cfg = get_config(ARCH)
    got = flops.model_flops(cfg, ShapeSpec("p", 4, 4, "prefill"))
    assert got == ref_flops.model_flops(ref_get_config(ARCH),
                                        RefShapeSpec("p", 4, 4, "prefill"))
    assert 0.058e12 < got < 0.060e12
    D, F, L = cfg.d_model, cfg.d_ff, cfg.enc_layers
    encoder = 2.0 * L * (4 * D * D + 2 * D * F) * 4 * cfg.enc_frames
    assert encoder > 100 * got
