"""The port's training path (``repro_torch.models.transformer.forward_train``,
``repro_torch.train.{optimizer,train_step}``, ``data/tokens.py``) held
against the reference, on the CPU at small width; whole runs of the step
and the loop are in ``test_torch_train_loop.py``.

The reference runs as its own tests run it here: its flash op's forward in
the ``ref`` lowering and its custom VJP's ``_bwd`` in pure JAX, its train
step under a (1, 1) mesh and the axis rules, as its ``train()`` does.
Weights come from the reference's ``init_params`` and cross through
``convert.model_params_from_reference``.

Tolerances (both packages compute in f32; only the summation order and
the fusion of elementwise chains differ, ~1e-7 relative a product):
- logits of a 2-layer reduced model: 1e-4 absolute (values ~1);
- one optimizer update: 1e-6 on parameters, moments at 1e-6 relative;
- 20 train steps: each step's loss within 2e-4 of the reference's, the
  final parameters within 2e-4.  AdamW divides by √v̂: where a gradient
  entry is far below its running scale, a rounding of g moves the update
  by up to lr·(δg/√v̂), so the trajectories separate slowly;
- checkpoint resumes across packages: the resumed losses within 2e-4 of
  the other package's uninterrupted run, whose step 6 state they start
  from exactly (the checkpoint's leaves are the saved bits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.launch.mesh import make_mesh_compat
from repro.models import api as ref_api
from repro.models.params import init_params as ref_init_params
from repro.parallel.sharding import axis_rules, make_rules
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import convert
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import api
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts

LOGIT_TOL = 1e-4
STEP_TOL = 2e-4


def _mesh():
    return make_mesh_compat((1, 1), ("data", "model"))


def _in_mesh(ref_cfg):
    """The reference's mesh and axis rules, as its ``train()`` sets them."""
    mesh = _mesh()
    rules = make_rules(mesh, ref_api.sharding_dims(ref_cfg))

    class _Ctx:
        def __enter__(self):
            self._m = mesh.__enter__()
            self._r = axis_rules(mesh, rules)
            self._r.__enter__()

        def __exit__(self, *exc):
            self._r.__exit__(*exc)
            mesh.__exit__(*exc)

    return _Ctx()


def _configs(arch, **over):
    return (dataclasses.replace(ref_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _params(ref_cfg, cfg, seed=0):
    """(reference params as jnp, port params), the norm gains and biases
    given small random values so they are exercised."""
    params = jax.tree.map(np.asarray, ref_init_params(
        ref_api.param_defs(ref_cfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for name in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):
        if name in params["layers"]:
            params["layers"][name] = 0.1 * rng.standard_normal(
                params["layers"][name].shape).astype(np.float32)
    params["final_norm"] = 0.1 * rng.standard_normal(
        params["final_norm"].shape).astype(np.float32)
    return (jax.tree.map(jnp.asarray, params),
            convert.model_params_from_reference(params, cfg, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flat_port(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_port(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: _np(tree)}


def _assert_trees(port, ref, tol):
    want = _flat_port(jax.tree.map(np.asarray, ref))
    got = _flat_port(port)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)


def _batch(pipe, k):
    state = {"step": k}
    _, b = pipe.next_batch(state)
    return b


# -- the token pipeline -------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(128, 16, 8, 3),
                                                  (49152, 64, 4, 0)])
def test_token_batches_equal_the_reference(vocab, seq, batch, seed):
    mine = TokenPipeline(vocab=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    ref = RefPipeline(vocab=vocab, seq_len=seq, global_batch=batch,
                      seed=seed)
    for k in (0, 1, 7):
        a, b = _batch(mine, k), _batch(ref, k)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_token_pipeline_deterministic_and_shardable():
    pipe = TokenPipeline(vocab=128, seq_len=16, global_batch=8, seed=3)
    s0 = pipe.init_state()
    s1, b1 = pipe.next_batch(s0)
    _, b1b = pipe.next_batch(s0)
    np.testing.assert_array_equal(b1["tokens"], b1b["tokens"])
    _, b2 = pipe.next_batch(s1)
    assert not np.array_equal(b1["tokens"], b2["tokens"])
    sl = pipe.shard_slice(b1, 1, 4)
    np.testing.assert_array_equal(sl["tokens"], b1["tokens"][2:4])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


# -- forward_train ------------------------------------------------------------


FORWARD_CASES = {
    "smollm": ("smollm-135m", {}, 32),
    "qwen": ("qwen1.5-0.5b", {}, 32),
    "smollm-flash": ("smollm-135m", dict(head_dim=64, use_flash=True), 256),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_train_matches_the_reference(case):
    arch, over, S = FORWARD_CASES[case]
    ref_cfg, cfg = _configs(arch, **over)
    ref_params, params = _params(ref_cfg, cfg)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    with _in_mesh(ref_cfg):
        want, want_aux = ref_api.forward_train(
            ref_cfg, ref_params, {"tokens": jnp.asarray(tokens)})
    got, aux = api.forward_train(cfg, params,
                                 {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("remat", ["minimal", "full"])
def test_remat_gives_the_same_gradients(remat):
    """Checkpointed layers recompute the same forward: the loss and every
    gradient equal the unchecked model's (same ops, same order).  The
    flash-gated variant runs the custom backward inside the recompute."""
    _, cfg = _configs("smollm-135m", head_dim=64, use_flash=True)
    _, params = _params(*_configs("smollm-135m", head_dim=64,
                                  use_flash=True))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=256, global_batch=2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(pipe, 0).items()}
    out = {}
    for mode in ("none", remat):
        c = dataclasses.replace(cfg, remat=mode)
        p = {k: ({n: w.clone() for n, w in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in params.items()}
        out[mode] = ts._grads(c, p, batch, 0.01)
    (ga, la, _), (gb, lb, _) = out["none"], out[remat]
    assert torch.equal(la, lb)
    for a, b in zip(_flat_port(ga).values(), _flat_port(gb).values()):
        np.testing.assert_array_equal(a, b)


def test_unknown_remat_is_refused():
    _, cfg = _configs("smollm-135m")
    _, params = _params(*_configs("smollm-135m"))
    with pytest.raises(ValueError, match="remat"):
        api.forward_train(dataclasses.replace(cfg, remat="some"), params,
                          {"tokens": torch.zeros((1, 8), dtype=torch.int32)})


# -- optimizers ---------------------------------------------------------------


def _grad_tree(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (0.05 * rng.standard_normal(p.shape)).astype(np.float32),
        jax.tree.map(np.asarray, params))


def _port_tree(tree_np):
    return {k: _port_tree(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree_np.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_one_update_matches_the_reference(name):
    ref_cfg, cfg = _configs("smollm-135m")
    ref_params, params = _params(ref_cfg, cfg)
    kw = dict(warmup=3) if name != "sgdm" else {}
    ropt = ref_opt.get_optimizer(name, **kw)
    popt = opt_mod.get_optimizer(name, **kw)
    rstate = ropt.init(ref_params)
    pstate = popt.init(params)
    for step in range(3):                       # moments carried over steps
        g = _grad_tree(ref_params, step)
        ref_params, rstate = ropt.update(jax.tree.map(jnp.asarray, g),
                                         rstate, ref_params,
                                         jnp.asarray(step, jnp.int32))
        params, pstate = popt.update(_port_tree(g), pstate, params,
                                     torch.tensor(step, dtype=torch.int32))
    _assert_trees(params, ref_params, 1e-6)
    back = convert.opt_state_from_reference(
        jax.tree.map(np.asarray, rstate), device="cpu")
    assert type(back) is type(pstate)
    for a, b in zip(ckpt.leaves_with_paths(back),
                    ckpt.leaves_with_paths(pstate)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        # the bf16 momentum: one rounding of the same f32 value, so at
        # most one bf16 step (2⁻⁸ relative) where the two f32 values
        # straddle a rounding boundary
        tol = 8e-3 if a[1].dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(_np(a[1]), _np(b[1]), rtol=tol,
                                   atol=1e-7, err_msg=a[0])


def test_adafactor_momentum_is_bf16_and_can_be_dropped():
    _, cfg = _configs("smollm-135m")
    _, params = _params(*_configs("smollm-135m"))
    st = opt_mod.adafactor().init(params)
    assert st.mom["embed"].dtype == torch.bfloat16
    assert st.vr["layers"]["wq"].shape == params["layers"]["wq"].shape[:-1]
    st0 = opt_mod.adafactor(momentum=0.0).init(params)
    assert st0.mom["embed"].shape == ()


def test_pick_optimizer_and_microbatches():
    assert ts.pick_optimizer_name(get_config("smollm-135m")) == "adamw"
    for arch in ("smollm-135m", "llama3-8b"):
        for shape in (ShapeSpec("t", 4096, 256, "train"),
                      ShapeSpec("t", 1024, 8, "train")):
            from repro.configs.base import ShapeSpec as RefShape
            rs = RefShape(shape.name, shape.seq_len, shape.global_batch,
                          shape.kind)
            for shards in (1, 16):
                assert ts.auto_microbatches(get_config(arch), shape,
                                            shards) == \
                    ref_ts.auto_microbatches(ref_get_config(arch), rs,
                                             shards)


def test_microbatches_must_divide_the_batch():
    """A batch of 3 in 2 microbatches: the reference's reshape to
    (n_micro, B // n_micro, ...) fails, and the port refuses it rather
    than train on the first 2 rows."""
    ref_cfg, cfg = _configs("smollm-135m")
    ref_params, params = _params(ref_cfg, cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=3)
    batch = _batch(pipe, 0)
    popt = opt_mod.get_optimizer("adamw")
    fn = ts.build_train_step(cfg, popt, ts.TrainStepConfig(n_micro=2))
    with pytest.raises(ValueError, match="n_micro=2 does not divide the "
                       "batch of 3"):
        fn(params, popt.init(params), torch.tensor(0, dtype=torch.int32),
           {k: torch.from_numpy(v) for k, v in batch.items()})
    ropt = ref_opt.get_optimizer("adamw")
    with _in_mesh(ref_cfg), pytest.raises(TypeError, match="reshape"):
        ref_ts.build_train_step(ref_cfg, ropt, ref_ts.TrainStepConfig(
            n_micro=2))(ref_params, ropt.init(ref_params),
                        jnp.zeros((), jnp.int32),
                        jax.tree.map(jnp.asarray, batch))
