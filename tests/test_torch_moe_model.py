"""The port's MoE models (grok-1 and kimi-k2 through
``repro_torch.models.transformer``) held against the reference, on the CPU
at small width: the training forward with its balance loss and gradients,
prefill and decode, the serving engine and AdamW steps; the block itself
is in ``test_torch_moe.py``, whose docstring gives the tolerances' reasons.

The reference runs without a mesh, except in the train steps, which run
under its (1, 1) mesh and axis rules as its ``train()`` does (its MoE
block then goes through ``shard_map`` at model-axis size 1).
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
from repro.models.params import count_params as ref_count_params
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro.train import train_step as ref_ts
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.models.params import count_params, init_params
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.train import train_step as ts
from test_torch_moe import ARCHS, AUX_TOL, GRAD_ATOL, GRAD_RTOL, LOGIT_TOL
from test_torch_train import STEP_TOL, _assert_trees, _configs, _flat_port, \
    _np, _params
from test_torch_train_loop import _run_port_steps, _run_ref_steps

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


# -- the model ----------------------------------------------------------------


def _loss(logits, aux, labels):
    """The reference smoke test's loss: nll + 0.01·aux."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, labels[..., None].long()).mean()
    return nll + 0.01 * aux


def _ref_loss(cfg, params, tokens, labels):
    logits, aux = ref_api.forward_train(cfg, params,
                                        {"tokens": jnp.asarray(tokens)})
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(lp, jnp.asarray(labels)[..., None],
                               axis=-1).mean()
    return nll + 0.01 * aux


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_grad_match_the_reference(arch):
    ref_cfg, cfg = _configs(arch)
    ref_params, params = _params(ref_cfg, cfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    want, want_aux = ref_api.forward_train(ref_cfg, ref_params,
                                           {"tokens": jnp.asarray(tokens)})
    got, aux = api.forward_train(cfg, params,
                                 {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 32, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert float(aux) > 0.0
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL

    want_loss, want_g = jax.value_and_grad(_ref_loss, argnums=1)(
        ref_cfg, ref_params, tokens, labels)
    leaves = [p.requires_grad_(True) for p in
              jax.tree_util.tree_leaves(params)]
    logits, aux = api.forward_train(cfg, params,
                                    {"tokens": torch.from_numpy(tokens)})
    loss = _loss(logits, aux, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    flat_want = jax.tree_util.tree_leaves(want_g)
    assert len(flat_want) == len(grads)
    for g, w in zip(grads, flat_want):
        np.testing.assert_allclose(_np(g), _np(w), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)
    assert all(float(g.abs().sum()) > 0 for g in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_the_reference(arch):
    """Prefill of 24 tokens and one decode step against the reference's,
    and against the port's own train forward at the reference smoke
    test's tolerance (the capacity sees other token counts there)."""
    ref_cfg, cfg = _configs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=1)
    B, S = 2, 24
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32)
    lg, caches = api.forward_prefill(
        cfg, params, {"tokens": torch.from_numpy(toks[:, :S])})
    lg_r, caches_r = ref_api.forward_prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(toks[:, :S])})
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
    nxt = toks[:, S:S + 1]
    dec, _ = api.forward_decode(cfg, params, torch.from_numpy(nxt), full)
    dec_r, _ = ref_api.forward_decode(ref_cfg, ref_params, jnp.asarray(nxt),
                                      full_r)
    np.testing.assert_allclose(_np(dec), _np(dec_r), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)

    train, _ = api.forward_train(cfg, params,
                                 {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(lg[:, 0]), _np(train[:, S - 1]),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(train[:, S]),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("arch,least", [("grok-1-314b", 2.4e11),
                                        ("kimi-k2-1t-a32b", 5e11)])
def test_full_config_params_on_the_meta_device(arch, least):
    """The full configs' parameters as shapes only, on the ``meta``
    device: no allocation, the reference test's bounds on the count."""
    cfg = get_config(arch)
    params = init_params(api.param_defs(cfg), torch.Generator(),
                         dtype=torch.bfloat16, device="meta")
    leaves = jax.tree_util.tree_leaves(params)
    assert all(x.device.type == "meta" for x in leaves)
    n = sum(x.numel() for x in leaves)
    assert n == count_params(api.param_defs(cfg)) == \
        ref_count_params(ref_api.param_defs(ref_get_config(arch)))
    assert least <= n <= 3 * least
    E, F = cfg.moe.n_experts, cfg.moe.d_expert
    assert params["layers"]["wg"].shape == (cfg.n_layers, E, cfg.d_model, F)
    assert params["layers"]["wd"].shape == (cfg.n_layers, E, F, cfg.d_model)
    assert params["layers"]["wr"].shape == (cfg.n_layers, cfg.d_model, E)


@pytest.mark.parametrize("remat", ["minimal", "full"])
def test_remat_gives_the_same_gradients(remat):
    """The MoE block inside checkpointed layers recomputes the same
    routing: the loss and every gradient equal the unchecked model's."""
    ref_cfg, cfg = _configs("grok-1-314b")
    _, params = _params(ref_cfg, cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=2)
    _, b = pipe.next_batch({"step": 0})
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    out = {}
    for mode in ("none", remat):
        c = dataclasses.replace(cfg, remat=mode)
        p = {k: ({n: w.clone() for n, w in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in params.items()}
        out[mode] = ts._grads(c, p, batch, 0.01)
    (ga, la, aa), (gb, lb, ab) = out["none"], out[remat]
    assert torch.equal(la, lb) and torch.equal(aa, ab)
    assert float(aa) > 0.0
    for a, b in zip(_flat_port(ga).values(), _flat_port(gb).values()):
        np.testing.assert_array_equal(a, b)


def _requests(cfg, cls, n=3, lo=10, hi=32, max_new=4, seed=8):
    rng = np.random.default_rng(seed)
    return [cls(uid=u, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(lo, hi + 1))).astype(np.int32),
        max_new=max_new) for u in range(n)]


def test_serve_engine_matches_the_reference():
    ref_cfg, cfg = _configs("grok-1-314b")
    ref_params, params = _params(ref_cfg, cfg, seed=2)
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
    np.testing.assert_allclose(_np(eng.caches.k), _np(ref.caches.k),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_train_steps_match_the_reference():
    """Three AdamW steps of the reduced grok from the same converted
    start: each loss and the final parameters (the reference under its
    (1, 1) mesh, its MoE block through ``shard_map`` at size 1)."""
    ref_cfg, cfg = _configs("grok-1-314b")
    ref_params, params = _params(ref_cfg, cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=4)
    rp, _, rl = _run_ref_steps(ref_cfg, ref_params,
                               ref_ts.TrainStepConfig(), 3, pipe)
    pp, _, pl, step = _run_port_steps(cfg, params, ts.TrainStepConfig(), 3,
                                      pipe)
    assert step == 3
    np.testing.assert_allclose(pl, rl, atol=STEP_TOL, rtol=STEP_TOL)
    _assert_trees(pp, rp, STEP_TOL)
