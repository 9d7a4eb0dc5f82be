"""The port's gradient sketches (``repro_torch.sketch.{monitor,compress,
sketchy}``) held against the reference's, on the CPU at small width.

Gradient trees have the reduced smollm-135m's leaves (the reference's
``param_defs``), drawn with numpy from a seed, and cross into the port as
nested dicts of tensors.  States cross through ``convert``.

Tolerances, with their reasons:
- count-sketch buckets and signs: exact (integer arithmetic);
- the projected row: 1e-5 (the same f32 addends, summed into each bucket
  in another order);
- DS-FD states and queries: Grams BᵀB and eigenvalues at 1e-4 (SVD rows
  are unique only up to sign, ``ROADMAP.md`` §Ground rules); metrics 1e-5
  relative; compressed gradients and error-feedback accumulators 1e-4
  (they are sign-invariant projections onto the sketch basis);
- Sketchy's updates (``test_torch_sketchy.py``): one step at a time from
  the reference's state (``convert.opt_state_from_reference``),
  parameters within 1e-5; the isotropic tail divides the residual by
  √ρ = 1e-3 and the update is then normalised, so a whole trajectory
  amplifies roundings and is held to finiteness and to the reference's
  per-step answers, not to its path;
- train steps with the monitor and compression
  (``test_torch_grad_sketch_train.py``): losses 2e-4, metrics 1e-4
  relative, as ``test_torch_train_loop.py``'s 20 steps.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models.params import init_params as ref_init_params
from repro.sketch import compress as ref_compress
from repro.sketch import monitor as ref_monitor
from repro_torch import convert
from repro_torch.core.dsfd import dsfd_query_rows
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.sketch import compress, monitor
from repro_torch.sketch.api import fleet_streams

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

GRAM_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _param_shapes():
    cfg = ref_get_config("smollm-135m").reduced()
    return jax.eval_shape(lambda: ref_init_params(ref_api.param_defs(cfg),
                                                  jax.random.PRNGKey(0)))


def _grad_np(seed, scale=0.05):
    """A gradient tree with the reduced smollm-135m's leaves."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                        .astype(np.float32), _param_shapes())


def _port(tree):
    return {k: _port(v) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _gram(rows):
    r = _np(rows).reshape(-1, _np(rows).shape[-1])
    return r.T @ r


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# -- the monitor ----------------------------------------------------------------


def test_count_sketch_buckets_and_signs_equal_the_reference():
    for path, n in (("['layers']['wq']", 70001), ("['embed']", 4096)):
        b, s = monitor.hash_buckets(path, n, 128, "cpu")
        seed = ref_monitor._leaf_seed(path)
        assert seed == monitor._leaf_seed(path)
        idx = jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(seed)
        rb = ((idx * ref_monitor._P1) >> 16).astype(jnp.int32) % 128
        rs = jnp.where((idx * ref_monitor._P2) & jnp.uint32(1 << 15),
                       1.0, -1.0)
        np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


@pytest.mark.parametrize("d", [64, 128])
def test_project_grads_matches_the_reference(d):
    g = _grad_np(0)
    want = ref_monitor.project_grads(ref_monitor.SketchConfig(d=d), _jnp(g))
    got = monitor.project_grads(monitor.SketchConfig(d=d), _port(g))
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def _monitor_runs(steps, rcfg, pcfg):
    rstate, pstate = ref_monitor.sketch_init(rcfg), \
        monitor.sketch_init(pcfg, device="cpu")
    update = jax.jit(functools.partial(ref_monitor.sketch_update, rcfg))
    for step in range(steps):
        g = _grad_np(step, scale=0.05 * (1 + step % 3))
        rstate, rm = update(rstate, _jnp(g), jnp.asarray(step))
        pstate, pm = monitor.sketch_update(pcfg, pstate, _port(g),
                                           torch.tensor(step))
        assert rm.keys() == pm.keys()
        for k in rm:
            np.testing.assert_allclose(_np(pm[k]), _np(rm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    return rstate, pstate


def test_sketch_update_query_and_drift_match_the_reference():
    rcfg = ref_monitor.SketchConfig(d=64, eps=0.25, window=8)
    pcfg = monitor.SketchConfig(d=64, eps=0.25, window=8)
    rstate, pstate = _monitor_runs(14, rcfg, pcfg)
    np.testing.assert_allclose(_np(pstate["norm_hist"]),
                               _np(rstate["norm_hist"]), rtol=1e-5)
    np.testing.assert_allclose(
        _gram(pcfg.sketch("cpu").query_rows(pstate["dsfd"])),
        _gram(rcfg.sketch().query_rows(rstate["dsfd"])), atol=GRAM_TOL)
    rl, _ = ref_monitor.sketch_query(rcfg, rstate, r=4)
    pl, pv = monitor.sketch_query(pcfg, pstate, r=4)
    assert pv.shape == (4, 64)
    np.testing.assert_allclose(_np(pl), _np(rl), atol=GRAM_TOL)
    # the state carried across matches the port's own
    back = convert.monitor_state_from_reference(
        pcfg, jax.tree.map(np.asarray, rstate), device="cpu")
    np.testing.assert_allclose(
        _gram(pcfg.sketch("cpu").query_rows(back["dsfd"])),
        _gram(pcfg.sketch("cpu").query_rows(pstate["dsfd"])), atol=GRAM_TOL)
    # drift against an earlier state, and scores of probe rows
    r_early, p_early = _monitor_runs(5, rcfg, pcfg)
    np.testing.assert_allclose(
        float(monitor.subspace_drift(pcfg, p_early, pstate, r=4)),
        float(ref_monitor.subspace_drift(rcfg, r_early, rstate, r=4)),
        atol=1e-4)
    assert float(monitor.subspace_drift(pcfg, pstate, pstate, r=4)) < 1e-5
    probes = np.random.default_rng(9).standard_normal((3, 64)).astype(
        np.float32)
    np.testing.assert_allclose(
        _np(monitor.sketch_score(pcfg, pstate, torch.from_numpy(probes))),
        _np(ref_monitor.sketch_score(rcfg, rstate, jnp.asarray(probes))),
        rtol=1e-4, atol=1e-4)


def test_cohort_sketch_query_folds_the_workers():
    """Two workers' monitors as a fleet of two streams: the cohort query
    over both spans what the merged windows hold."""
    pcfg = monitor.SketchConfig(d=32, eps=0.25, window=8)
    fleet = fleet_streams(pcfg.sketch("cpu"), 2)
    state = fleet.init()
    rng = np.random.default_rng(4)
    for t in range(1, 7):
        rows = rng.standard_normal((2, 1, 32)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
        state = fleet.update_block(state, torch.from_numpy(rows),
                                   torch.tensor([t], dtype=torch.int32))
    lam, V = monitor.cohort_sketch_query(pcfg, fleet, state, r=4)
    assert lam.shape == (4,) and V.shape == (4, 32)
    assert bool(torch.all(lam[:-1] >= lam[1:]))
    np.testing.assert_allclose(_np(V @ V.T), np.eye(4), atol=1e-4)


# -- compression ----------------------------------------------------------------


def _ccfg(mod):
    return mod.CompressConfig(rank=4, eps=0.25, window=8, min_size=2048,
                              summary_rows=2)


def test_compress_grads_match_the_reference_for_eight_steps():
    rcfg, pcfg = _ccfg(ref_compress), _ccfg(compress)
    rstate = ref_compress.compress_init(rcfg, _jnp(_grad_np(0)))
    pstate = compress.compress_init(pcfg, _port(_grad_np(0)), device="cpu")
    ref_step = jax.jit(functools.partial(ref_compress.compress_grads, rcfg))
    for step in range(8):
        g = _grad_np(step)
        rg, rstate = ref_step(_jnp(g), rstate)
        pg, pstate = compress.compress_grads(pcfg, _port(g), pstate)
        want, got = _flat(jax.tree.map(np.asarray, rg)), _flat(pg)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(_np(got[k]), want[k], atol=1e-4,
                                       err_msg=f"step {step} {k}")
    back = convert.compress_state_from_reference(
        pcfg, jax.tree.map(np.asarray, rstate), device="cpu")
    for name in ("embed", "layers/wq", "layers/wd"):
        leaf, theirs = pstate, back
        for key in name.split("/"):
            leaf, theirs = leaf[key], theirs[key]
        assert int(leaf["step"]) == int(theirs["step"]) == 8
        np.testing.assert_allclose(_np(leaf["err"]), _np(theirs["err"]),
                                   atol=1e-4)
        cfg = pcfg.dsfd(leaf["err"].shape[-1])
        np.testing.assert_allclose(
            _gram(dsfd_query_rows(cfg, leaf["dsfd"])),
            _gram(dsfd_query_rows(cfg, theirs["dsfd"])), atol=GRAM_TOL)
    # leaves under min_size (the norms' (2, 32)) pass through untouched
    assert pstate["final_norm"] is None and pstate["layers"]["attn_norm"] \
        is None


def test_wire_bytes_equal_the_reference():
    g = _grad_np(0)
    for cfg_kw in (dict(min_size=2048), dict(min_size=65536),
                   dict(min_size=1, rank=2)):
        r = ref_compress.wire_bytes(ref_compress.CompressConfig(**cfg_kw),
                                    _jnp(g))
        p = compress.wire_bytes(compress.CompressConfig(**cfg_kw), _port(g))
        assert p == r


def test_compressed_psum_in_a_one_process_group(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((16, 12)).astype(
            np.float32))
        V = torch.linalg.qr(torch.from_numpy(
            rng.standard_normal((12, 3)).astype(np.float32)))[0].T
        got = compress.compressed_psum(x, None, V)
        torch.testing.assert_close(got, (x @ V.T) @ V)
    finally:
        dist.destroy_process_group()
