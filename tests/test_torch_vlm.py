"""The port's M-RoPE and VLM family (qwen2-vl-2b through
``repro_torch.models.transformer``) held against the reference, on the CPU
at small width.

Position ids come in two kinds: identical t = h = w ids, as text tokens
carry (M-RoPE then equals plain RoPE in both packages), and an image block
of 1 × h × w patches between text, laid out as Qwen2-VL's
``get_rope_index`` lays it out (arXiv:2409.12191 §2.1): text before it at
0..T-1; patch (0, i, j) at (T, T + i, T + j); text after it from
T + max(1, h, w) on.

Weights come from the reference's ``init_params`` and cross through
``convert.model_params_from_reference``; every zero- or one-initialised
leaf (norm gains, biases and, in the other families, A_log, dt_bias,
D_skip, Λ) gets a small random offset so that it is exercised.  The
reference runs without a mesh.

Tolerances: both sides compute in f32 and differ in summation order only.
M-RoPE itself 1e-6 in f32 (the same cos/sin of the same f32 angles); in
bf16 one bf16 rounding of the rotated value (2⁻⁸ relative, atol 1e-2 at
unit inputs).  Whole forward passes: logits 1e-4; gradients atol 5e-5,
rtol 5e-4, the levels of the dense and MoE files.
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
from repro.models.layers import common as ref_common
from repro.models.params import count_params as ref_count_params
from repro.models.params import init_params as ref_init_params
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.models.layers import common
from repro_torch.models.params import _leaves, count_params, init_params
from repro_torch.tree import map_dicts

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

ARCH = "qwen2-vl-2b"
MROPE_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
LOGIT_TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def vlm_ids(before: int, grid, after: int) -> np.ndarray:
    """(S, 3) M-RoPE ids of ``before`` text tokens, a (t, h, w) grid of
    image patches, then ``after`` text tokens, as ``get_rope_index``."""
    ids = [(i, i, i) for i in range(before)]
    t, h, w = grid
    ids += [(before + a, before + b, before + c)
            for a in range(t) for b in range(h) for c in range(w)]
    nxt = before + max(t, h, w)
    ids += [(nxt + i,) * 3 for i in range(after)]
    return np.asarray(ids, np.int32)


def configs(arch):
    return ref_get_config(arch).reduced(), get_config(arch).reduced()


def params_pair(ref_cfg, cfg, seed=0):
    """(reference params as jnp, port params): the reference's draw (one
    jitted call), every zero- or one-initialised leaf offset by
    0.1·N(0, 1)."""
    defs = ref_api.param_defs(ref_cfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: ref_init_params(defs, key))(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for path, d in _leaves(api.param_defs(cfg)):
        if d.init in ("zeros", "ones"):
            node = params
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = (node[path[-1]] + 0.1 * rng.standard_normal(
                d.shape)).astype(np.float32)
    return (jax.tree.map(jnp.asarray, params),
            convert.model_params_from_reference(params, cfg, device="cpu"))


def assert_train_matches(cfg, ref_cfg, params, ref_params, batch, ref_batch,
                         labels):
    """The training forward's logits, the loss (mean NLL) and every
    gradient against the reference's, its forward and ``jax.grad`` in one
    jitted call."""
    def ref_loss(p):
        logits, _ = ref_api.forward_train(ref_cfg, p, ref_batch)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(lp, jnp.asarray(labels)[..., None],
                                    axis=-1).mean(), logits

    (want_loss, want), want_g = jax.jit(jax.value_and_grad(
        ref_loss, has_aux=True))(ref_params)
    params = map_dicts(lambda p: p.detach().clone().requires_grad_(True),
                       params)
    leaves = jax.tree_util.tree_leaves(params)
    logits, aux = api.forward_train(cfg, params, batch)
    assert logits.shape == tuple(want.shape) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), _np(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    lp = torch.log_softmax(logits.float(), dim=-1)
    loss = -torch.gather(lp, -1,
                         torch.from_numpy(labels)[..., None].long()).mean()
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    flat_want = jax.tree_util.tree_leaves(want_g)
    assert len(flat_want) == len(grads)
    for g, w in zip(grads, flat_want):
        np.testing.assert_allclose(_np(g), _np(w), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)
    assert all(float(g.abs().sum()) > 0 for g in grads)
    return logits.detach()


# -- M-RoPE -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,sections", [(8, (2, 1, 1)),
                                         (128, (16, 24, 24))])
@pytest.mark.parametrize("ids", ["text", "image"])
def test_apply_mrope_matches_the_reference(dtype, dh, sections, ids):
    rng = np.random.default_rng(dh)
    B, H, theta = 2, 3, 1e6
    pos = (vlm_ids(3, (1, 4, 6), 5) if ids == "image"
           else vlm_ids(32, (0, 0, 0), 0))
    S = pos.shape[0]
    pos = np.broadcast_to(pos, (B, S, 3)).copy()
    x = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = common.apply_mrope(tx, torch.from_numpy(pos), theta, sections)
    want = ref_common.apply_mrope(jx, jnp.asarray(pos), theta, sections)
    assert got.dtype == tx.dtype
    tol = MROPE_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    if ids == "text":       # t = h = w: plain RoPE, in both packages
        np.testing.assert_array_equal(
            _np(got), _np(common.apply_rope(tx, torch.from_numpy(
                pos[..., 0]), theta)))
        np.testing.assert_array_equal(
            _np(want), _np(ref_common.apply_rope(jx, jnp.asarray(
                pos[..., 0]), theta)))
    else:                   # the patches' h and w turn their own sections
        plain = common.apply_rope(tx, torch.from_numpy(pos[..., 0]), theta)
        assert not torch.equal(got, plain)


def test_vlm_ids_follow_get_rope_index():
    ids = vlm_ids(2, (1, 2, 3), 2)
    np.testing.assert_array_equal(ids, [
        (0, 0, 0), (1, 1, 1),
        (2, 2, 2), (2, 2, 3), (2, 2, 4), (2, 3, 2), (2, 3, 3), (2, 3, 4),
        (5, 5, 5), (6, 6, 6)])


def test_apply_mrope_checks_its_sections():
    x = torch.zeros((1, 2, 1, 8))
    with pytest.raises(ValueError, match="sum to dh/2 = 4"):
        common.apply_mrope(x, torch.zeros((1, 2, 3), dtype=torch.int32),
                           1e4, (2, 1, 2))


# -- the reduced model --------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    ref_cfg, cfg = configs(ARCH)
    ref_params, params = params_pair(ref_cfg, cfg)
    return ref_cfg, cfg, ref_params, params


def test_forward_and_grad_match_the_reference(model):
    ref_cfg, cfg, ref_params, params = model
    B = 2
    pos = np.broadcast_to(vlm_ids(4, (1, 4, 6), 4), (B, 32, 3)).copy()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (B, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, 32)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens),
             "positions": torch.from_numpy(pos)}
    ref_batch = {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos)}
    got = assert_train_matches(cfg, ref_cfg, params, ref_params, batch,
                               ref_batch, labels)
    # the image block's ids matter: plain 0..S-1 ids give other logits
    plain = np.broadcast_to(vlm_ids(32, (0, 0, 0), 0), (B, 32, 3)).copy()
    with torch.no_grad():
        other, _ = api.forward_train(cfg, params, {
            "tokens": batch["tokens"], "positions": torch.from_numpy(plain)})
    assert float((other - got).abs().max()) > 1e-3


def test_prefill_and_decode_match_the_reference(model):
    """Prefill of 24 tokens (text, a 1×4×4 image, text) and three decode
    steps, whose ids are the cache length (t = h = w) in both packages."""
    ref_cfg, cfg, ref_params, params = model
    B, S = 2, 24
    pos = np.broadcast_to(vlm_ids(4, (1, 4, 4), 4), (B, S, 3)).copy()
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S + 3)).astype(np.int32)
    lg, caches = api.forward_prefill(cfg, params, {
        "tokens": torch.from_numpy(toks[:, :S]),
        "positions": torch.from_numpy(pos)})
    lg_r, caches_r = ref_api.forward_prefill(ref_cfg, ref_params, {
        "tokens": jnp.asarray(toks[:, :S]), "positions": jnp.asarray(pos)})
    np.testing.assert_allclose(_np(lg), _np(lg_r), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(_np(caches.k), _np(caches_r.k),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)

    full = api.init_cache(cfg, B, S + 8, torch.float32, "cpu")
    full.k[:, :, :S] = caches.k
    full.v[:, :, :S] = caches.v
    full.length[:] = caches.length
    empty = ref_api.init_cache(ref_cfg, B, S + 8, jnp.float32)
    full_r = type(caches_r)(empty.k.at[:, :, :S].set(caches_r.k),
                            empty.v.at[:, :, :S].set(caches_r.v),
                            caches_r.length)
    for j in range(3):
        nxt = toks[:, S + j:S + j + 1]
        dec, full = api.forward_decode(cfg, params, torch.from_numpy(nxt),
                                       full)
        dec_r, full_r = ref_api.forward_decode(ref_cfg, ref_params,
                                               jnp.asarray(nxt), full_r)
        np.testing.assert_allclose(_np(dec), _np(dec_r), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    np.testing.assert_array_equal(full.length.numpy(),
                                  np.asarray(full_r.length))
    np.testing.assert_allclose(_np(full.k), _np(full_r.k), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_prefill_without_positions_raises(model):
    """Note (k): neither package invents M-RoPE ids.  The port names the
    missing (B, S, 3) ids; the reference fails inside ``apply_mrope``."""
    ref_cfg, cfg, ref_params, params = model
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match=r"\(B, S, 3\) = \(1, 8, 3\)"):
        api.forward_prefill(cfg, params, {"tokens": torch.from_numpy(toks)})
    with pytest.raises(ValueError, match="M-RoPE position ids"):
        api.forward_train(cfg, params, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.zeros((1, 8), dtype=torch.int32)})
    with pytest.raises(IndexError):
        ref_api.forward_prefill(ref_cfg, ref_params,
                                {"tokens": jnp.asarray(toks)})


def test_launch_serve_refuses_the_vlm():
    """The launcher's engine passes tokens only, so qwen2-vl fails at its
    first prefill, as the reference's does."""
    with pytest.raises(ValueError, match="M-RoPE position ids"):
        launch_serve.main(["--device", "cpu", "--arch", ARCH,
                           "--requests", "1", "--max-new", "1"])


def test_full_config_params_on_the_meta_device():
    cfg = get_config(ARCH)
    params = init_params(api.param_defs(cfg), torch.Generator(),
                         dtype=torch.bfloat16, device="meta")
    leaves = jax.tree_util.tree_leaves(params)
    assert all(x.device.type == "meta" for x in leaves)
    n = sum(x.numel() for x in leaves)
    assert n == count_params(api.param_defs(cfg)) == ref_count_params(
        ref_api.param_defs(ref_get_config(ARCH))) == 1_543_714_304
    assert params["layers"]["bk"].shape == (28, 2 * 128)


def test_config_matches_the_reference():
    ref, port = ref_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.mrope_sections == (16, 24, 24) and port.dh == 128
    assert port.reduced().mrope_sections == (2, 1, 1)
