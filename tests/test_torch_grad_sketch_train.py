"""The port's train step with the gradient monitor and compression held
against the reference's, on the CPU at small width.  Helpers and tolerances are ``test_torch_grad_sketch.py``'s (its
docstring gives their reasons).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as ref_get_config
from repro.launch.mesh import make_mesh_compat
from repro.models import api as ref_api
from repro.models.params import init_params as ref_init_params
from repro.parallel.sharding import axis_rules, make_rules
from repro.sketch import compress as ref_compress
from repro.sketch import monitor as ref_monitor
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.sketch import compress, monitor
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts
from test_torch_grad_sketch import _ccfg, _jnp

# -- the train step with the monitor and compression ----------------------------


def _in_mesh(ref_cfg):
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    return mesh, axis_rules(mesh, make_rules(
        mesh, ref_api.sharding_dims(ref_cfg)))


def test_train_step_with_monitor_and_compression_matches_the_reference():
    """``test_train_with_sketch_monitor_and_compress``'s settings, 12 steps
    of the train step from the same converted start: losses and every
    metric (the monitor's included) against the reference's."""
    ref_cfg = ref_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    rtsc = ref_ts.TrainStepConfig(
        sketch=ref_monitor.SketchConfig(d=64, eps=0.25, window=64),
        compress=_ccfg(ref_compress))
    tsc = ts.TrainStepConfig(
        sketch=monitor.SketchConfig(d=64, eps=0.25, window=64),
        compress=_ccfg(compress))
    params_np = jax.tree.map(np.asarray, ref_init_params(
        ref_api.param_defs(ref_cfg), jax.random.PRNGKey(0)))
    rparams = _jnp(params_np)
    params = convert.model_params_from_reference(params_np, cfg,
                                                 device="cpu")
    ropt = ref_opt.get_optimizer("adamw", lr=1e-3, warmup=20)
    popt = opt_mod.get_optimizer("adamw", lr=1e-3, warmup=20)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=4)
    mesh, rules = _in_mesh(ref_cfg)
    with mesh, rules:
        rfn = jax.jit(ref_ts.build_train_step(ref_cfg, ropt, rtsc))
        rsk = ref_ts.init_sketch_state(rtsc, rparams, ropt)
        rstate, rstep = ropt.init(rparams), jnp.zeros((), jnp.int32)
        rm = []
        for k in range(12):
            _, b = pipe.next_batch({"step": k})
            rparams, rstate, rstep, m, rsk = rfn(
                rparams, rstate, rstep, _jnp(b), rsk)
            rm.append({n: float(v) for n, v in m.items()})
    fn = ts.build_train_step(cfg, popt, tsc)
    sk = ts.init_sketch_state(tsc, params, popt, device="cpu")
    state, step = popt.init(params), torch.zeros((), dtype=torch.int32)
    for k in range(12):
        _, b = pipe.next_batch({"step": k})
        params, state, step, m, sk = fn(
            params, state, step, {n: torch.from_numpy(v)
                                  for n, v in b.items()}, sk)
        got = {n: float(v) for n, v in m.items()}
        assert got.keys() == rm[k].keys()
        np.testing.assert_allclose(got["loss"], rm[k]["loss"], atol=2e-4)
        for n in got:
            np.testing.assert_allclose(got[n], rm[k][n], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{k} {n}")
    assert sk["monitor"]["norm_hist"].shape == (64,)
