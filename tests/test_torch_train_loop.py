"""The port's train step and loop (``repro_torch.train.{train_step,loop}``,
``launch/train.py``) held against the reference over whole runs, on the
CPU at small width: 20 steps of the train step from the same converted
start, and checkpoints that one package saves and the other resumes.
The helpers and tolerances are ``test_torch_train.py``'s (its docstring
gives their reasons).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts
from repro_torch.train.loop import LoopConfig, StragglerWatchdog, train
from test_torch_train import STEP_TOL, _assert_trees, _batch, _configs, \
    _in_mesh, _mesh, _params

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

# -- the train step over 20 steps ---------------------------------------------


def _run_ref_steps(ref_cfg, ref_params, rtsc, steps, pipe, opt=None):
    ropt = opt or ref_opt.get_optimizer("adamw", lr=1e-3, warmup=20)
    with _in_mesh(ref_cfg):
        fn = jax.jit(ref_ts.build_train_step(ref_cfg, ropt, rtsc))
        state = ropt.init(ref_params)
        step = jnp.zeros((), jnp.int32)
        losses = []
        p = ref_params
        for k in range(steps):
            b = {n: jnp.asarray(v) for n, v in _batch(pipe, k).items()}
            p, state, step, m = fn(p, state, step, b)
            losses.append(float(m["loss"]))
    return p, state, losses


def _run_port_steps(cfg, params, tsc, steps, pipe, opt=None):
    popt = opt or opt_mod.get_optimizer("adamw", lr=1e-3, warmup=20)
    fn = ts.build_train_step(cfg, popt, tsc)
    state = popt.init(params)
    step = torch.zeros((), dtype=torch.int32)
    losses = []
    for k in range(steps):
        b = {n: torch.from_numpy(v) for n, v in _batch(pipe, k).items()}
        params, state, step, m = fn(params, state, step, b)
        losses.append(float(m["loss"]))
    return params, state, losses, int(step)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_twenty_train_steps_match_the_reference(n_micro):
    ref_cfg, cfg = _configs("smollm-135m")
    ref_params, params = _params(ref_cfg, cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=4)
    rp, _, rl = _run_ref_steps(ref_cfg, ref_params,
                               ref_ts.TrainStepConfig(n_micro=n_micro), 20,
                               pipe)
    pp, _, pl, step = _run_port_steps(cfg, params,
                                      ts.TrainStepConfig(n_micro=n_micro),
                                      20, pipe)
    assert step == 20
    np.testing.assert_allclose(pl, rl, atol=STEP_TOL, rtol=STEP_TOL)
    _assert_trees(pp, rp, STEP_TOL)


# -- the loop, checkpoints across packages ------------------------------------


def _losses(res):
    return [h["loss"] for h in res["history"]]


def test_checkpoints_resume_across_packages(tmp_path):
    """The reference's ``train()`` saves at step 6 and the port resumes to
    step 10, and the reverse; each resumed run's losses against the other
    package's uninterrupted run (the same tokens from the pipeline's
    ``data_state``)."""
    ref_cfg, cfg = _configs("smollm-135m")
    kw = dict(seq_len=32, global_batch=4)
    ref_full = ref_loop.train(ref_cfg, _mesh(),
                              loop=ref_loop.LoopConfig(steps=10), **kw)
    port_full = train(cfg, device="cpu", loop=LoopConfig(steps=10), **kw)

    a = str(tmp_path / "ref_then_port")
    ref_loop.train(ref_cfg, _mesh(),
                   loop=ref_loop.LoopConfig(steps=6, ckpt_dir=a,
                                            ckpt_every=3), **kw)
    assert ckpt.latest_step(a) == 6
    resumed = train(cfg, device="cpu",
                    loop=LoopConfig(steps=10, ckpt_dir=a, ckpt_every=4),
                    **kw)
    assert resumed["step"] == 10 and len(resumed["history"]) == 4
    np.testing.assert_allclose(_losses(resumed), _losses(ref_full)[6:],
                               atol=STEP_TOL, rtol=STEP_TOL)

    b = str(tmp_path / "port_then_ref")
    train(cfg, device="cpu",
          loop=LoopConfig(steps=6, ckpt_dir=b, ckpt_every=3), **kw)
    assert ckpt.latest_step(b) == 6
    back = ref_loop.train(ref_cfg, _mesh(),
                          loop=ref_loop.LoopConfig(steps=10, ckpt_dir=b,
                                                   ckpt_every=4), **kw)
    assert back["step"] == 10 and len(back["history"]) == 4
    np.testing.assert_allclose(_losses(back), _losses(port_full)[6:],
                               atol=STEP_TOL, rtol=STEP_TOL)


def test_train_loss_decreases():
    res = train(get_config("smollm-135m").reduced(), device="cpu",
                loop=LoopConfig(steps=25, log_every=100), seq_len=64,
                global_batch=8)
    losses = _losses(res)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_checkpoint_resume(tmp_path):
    cfg = get_config("smollm-135m").reduced()
    d = str(tmp_path / "ck")
    train(cfg, device="cpu", loop=LoopConfig(steps=6, ckpt_dir=d,
                                             ckpt_every=3),
          seq_len=32, global_batch=4)
    assert ckpt.latest_step(d) == 6
    r2 = train(cfg, device="cpu", loop=LoopConfig(steps=10, ckpt_dir=d,
                                                  ckpt_every=4),
               seq_len=32, global_batch=4)
    assert r2["step"] == 10 and len(r2["history"]) == 4
    assert np.isfinite(_losses(r2)).all()
    assert ckpt.read_manifest(d)["data_state"] == {"step": 10}


def test_straggler_watchdog():
    wd = StragglerWatchdog(LoopConfig(straggler_factor=3.0))
    for _ in range(10):
        assert not wd.observe(0.1)
    assert wd.observe(1.0)
    assert wd.flagged == 1


def test_launch_train_runs_on_the_cpu(capsys):
    res = launch_train.main(["--device", "cpu", "--steps", "3"])
    assert res["step"] == 3 and len(res["history"]) == 3
    assert "on cpu" in capsys.readouterr().out


def test_flash_gated_training_runs_the_plain_backward():
    """A flash-gated reduced model trains on the CPU through the plain
    versions: no kernel launches, finite losses."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              head_dim=64, use_flash=True, remat="full")
    n0 = flash_kernel.flash_fwd.launches, flash_kernel.flash_bwd.launches
    res = train(cfg, device="cpu", loop=LoopConfig(steps=2), seq_len=256,
                global_batch=2)
    assert np.isfinite(_losses(res)).all()
    assert (flash_kernel.flash_fwd.launches,
            flash_kernel.flash_bwd.launches) == n0
