"""The port's Sketchy optimizer (``repro_torch.sketch.sketchy``) held
against the reference's, on the CPU at small width.  Helpers and
tolerances are ``test_torch_grad_sketch.py``'s (its docstring gives their
reasons).
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
from repro.sketch import sketchy as ref_sketchy
from repro.train import train_step as ref_ts
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.sketch import sketchy
from repro_torch.train import train_step as ts
from repro_torch.train.loop import LoopConfig, train
from test_torch_grad_sketch import _flat, _jnp, _np

SKETCHY = dict(lr=2e-2, rank=4, eps=0.5, window=16, summary_rows=2,
               warmup=4)             # test_sketchy_optimizer_trains' settings


def test_sketchy_training_runs_and_keeps_the_reference_layout():
    """The port's own 20-step run at those settings (``train()`` on the
    CPU): finite losses, and the state's layout is the reference's (a
    DS-FD state of one stream for each leaf of two dimensions, a diagonal
    for the others)."""
    res = train(get_config("smollm-135m").reduced(), device="cpu",
                loop=LoopConfig(steps=20, log_every=100),
                opt=sketchy.sketchy_dsfd(sketchy.SketchyConfig(**SKETCHY)),
                seq_len=32, global_batch=4)
    assert np.isfinite([h["loss"] for h in res["history"]]).all()
    st = res["opt_state"]
    assert st.sketch["final_norm"] is None
    assert st.diag["final_norm"].shape == (32,)
    assert st.diag["embed"].shape == ()
    assert st.sketch["layers"]["wq"].main.buf.shape == (1, 4, 32)
    assert st.mom["embed"].dtype == torch.float32


def test_sketchy_training_matches_the_reference_step_by_step():
    """``test_sketchy_optimizer_trains``' run (reduced smollm-135m, seq 32,
    batch 4, 20 steps, the same settings) in the reference; before each of
    its steps the port takes the reference's parameters and Sketchy state
    (through ``convert``) and the same batch, and must give the
    reference's loss (1e-5: the same forward in f32) and its next
    parameters (1e-5, as the update test).  No loss trend is asserted: the
    reference's own run does not fall (ROADMAP.md §3, note (a))."""
    ref_cfg = ref_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    pcfg = sketchy.SketchyConfig(**SKETCHY)
    ropt = ref_sketchy.sketchy_dsfd(ref_sketchy.SketchyConfig(**SKETCHY))
    popt = sketchy.sketchy_dsfd(pcfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=4)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    with mesh, axis_rules(mesh, make_rules(mesh,
                                           ref_api.sharding_dims(ref_cfg))):
        rfn = jax.jit(ref_ts.build_train_step(ref_cfg, ropt))
        rparams = ref_init_params(ref_api.param_defs(ref_cfg),
                                  jax.random.PRNGKey(0))
        rstate, rstep = ropt.init(rparams), jnp.zeros((), jnp.int32)
        pfn = ts.build_train_step(cfg, popt)
        for k in range(20):
            _, b = pipe.next_batch({"step": k})
            params = convert.model_params_from_reference(
                jax.tree.map(np.asarray, rparams), cfg, device="cpu")
            state = convert.opt_state_from_reference(
                jax.tree.map(np.asarray, rstate), device="cpu",
                sketchy=pcfg)
            params, _, _, m = pfn(params, state,
                                  torch.tensor(k, dtype=torch.int32),
                                  {n: torch.from_numpy(v)
                                   for n, v in b.items()})
            rparams, rstate, rstep, rm = rfn(rparams, rstate, rstep,
                                             _jnp(b))
            np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                       rtol=1e-5, err_msg=f"step {k}")
            want = _flat(jax.tree.map(np.asarray, rparams))
            for name, v in _flat(params).items():
                np.testing.assert_allclose(_np(v), want[name], atol=1e-5,
                                           rtol=1e-5,
                                           err_msg=f"step {k} {name}")
