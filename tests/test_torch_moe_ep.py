"""Expert parallelism of the port's MoE block across processes, held
against the one-process block and against the reference's ``shard_map``
block.

Each case's inputs are drawn from a numpy seed in one-device layout
(x (B, S, D), wr (D, E), wg, wu (E, D, F), wd (E, F, D)).  Gloo groups of
2 and 4 ``python -c`` children on the CPU (``launch.mesh.
init_distributed`` on a free localhost port, a 120 s limit each) cut
every expert into the virtual experts of their model axis
(``convert.split_experts``), keep their own block of each leaf
(``convert.local_params`` under ``param_pspecs``-style rules) and run
``moe_block`` under ``axis_rules``; the parent compares their y, aux and
the (token, choice) pairs the capacity dropped, and their gradients of
sum(y²) + aux with respect to x, the router and the experts, with:

* the port's one-process ``moe_block`` on the same weights (y 1e-5, aux
  1e-6, the dropped set equal);
* the reference's one-device ``moe_block``, and its ``shard_map`` block
  under a host mesh of 2 and 4 devices (``XLA_FLAGS=--xla_force_host_
  platform_device_count``, in a subprocess), at the same tolerances.

The cases: reduced grok (E = 8, top-2) at M = 2 and 4, reduced kimi
(E = 16, top-8) at M = 2 and 4, and E = 2 at M = 4 (two virtual experts
an expert).  The children also hold the autograd collectives to their
definitions and count the block's all-reduces under the program analyzer
with and without its backward.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoECfg as RefMoECfg
from repro.models.layers import moe as ref_moe
from repro_torch import convert
from repro_torch.configs.base import MoECfg
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models.layers import moe

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

SRC = Path(__file__).resolve().parents[1] / "src"
Y_TOL, AUX_TOL = 1e-5, 1e-6
# gradients of sum(y²) + aux: y's tolerance (entries up to ~1; f32, only
# the order of the sums differs)
GRAD_TOL = 1e-5
GRADS = ("x", "wr", "wg", "wu", "wd")
D, F, B, S = 16, 32, 2, 24
# name: (experts, top-k, model-axis sizes)
CASES = {"grok": (8, 2, (2, 4)), "kimi": (16, 8, (2, 4)),
         "virtual": (2, 2, (4,))}


def _inputs(name):
    E, k, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    f32 = np.float32
    return {"x": rng.standard_normal((B, S, D)).astype(f32),
            "wr": rng.standard_normal((D, E)).astype(f32),
            "wg": (0.1 * rng.standard_normal((E, D, F))).astype(f32),
            "wu": (0.1 * rng.standard_normal((E, D, F))).astype(f32),
            "wd": (0.1 * rng.standard_normal((E, F, D))).astype(f32)}


def _cfg(name):
    E, k, _ = CASES[name]
    return MoECfg(n_experts=E, top_k=k, d_expert=F)


_CHILD = r"""
import sys
import numpy as np
import torch
pid, world, port, root = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
from repro_torch import convert
from repro_torch.configs.base import MoECfg
from repro_torch.launch import hlo
from repro_torch.launch.mesh import init_distributed, make_process_mesh
from repro_torch.models.layers import moe
from repro_torch.models.params import ParamDef
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import axis_rules, make_rules

init_distributed(pid, world, port=port, timeout_s=30)
mesh = make_process_mesh(world, device="cpu")
coords = convert.mesh_coords(mesh)
for name in sys.argv[5].split(","):
    z = np.load(f"{root}/{name}.npz")
    E, k = int(z["E"]), int(z["k"])
    cfg = type("Cfg", (), {"moe": MoECfg(n_experts=E, top_k=k,
                                         d_expert=z["wg"].shape[-1])})()
    split = moe.virtual_split(cfg.moe, world)
    w = {n: torch.from_numpy(z[n]) for n in ("x", "wr", "wg", "wu", "wd")}
    lay = convert.split_experts(
        {"layers": {n: w[n][None] for n in ("wg", "wu", "wd")}}, cfg,
        world)["layers"]
    rules = make_rules(mesh, {"experts": E * split})
    defs = {n: ParamDef(tuple(lay[n].shape), (None, "experts", None, None))
            for n in ("wg", "wu", "wd")}
    local = convert.local_params(lay, defs, rules, mesh, coords)
    seen = {}
    orig = moe.route

    def route(cfg_, xf, wr, **kw):
        out = orig(cfg_, xf, wr, **kw)
        seen["slot"], seen["C"] = out[0], out[3]
        return out

    moe.route = route
    with axis_rules(mesh, rules), torch.no_grad():
        y, aux = moe.moe_block(w["x"], w["wr"], *(local[n][0] for n in
                                                  ("wg", "wu", "wd")),
                               moe=cfg.moe)
    moe.route = orig
    # this process's dropped (token, choice) pairs: a local virtual
    # expert's pair that the capacity turned away
    T = w["x"].shape[0] * w["x"].shape[1]
    probs = torch.softmax(w["x"].reshape(T, -1) @ w["wr"], dim=-1)
    topi = torch.topk(probs, k, dim=-1).indices
    v = (topi[:, :, None] * split + torch.arange(split)).reshape(T, -1)
    E_l = E * split // world
    mine = (v // E_l) == coords["model"]
    gone = mine & (seen["slot"] == E_l * seen["C"])
    t, jj = torch.nonzero(gone, as_tuple=True)
    # the gradients of sum(y²) + aux, and the analyzer's count of the
    # block's all-reduces with and without its backward
    ins = [w["x"].clone().requires_grad_(True),
           w["wr"].clone().requires_grad_(True)] + [
        local[n][0].clone().requires_grad_(True) for n in ("wg", "wu", "wd")]
    with axis_rules(mesh, rules), hlo.analyze() as a:
        gy, gaux = moe.moe_block(*ins, moe=cfg.moe)
        grads = torch.autograd.grad((gy * gy).sum() + gaux, ins)
    with axis_rules(mesh, rules), hlo.analyze() as f, torch.no_grad():
        moe.moe_block(*ins, moe=cfg.moe)
    np.savez(f"{root}/{name}_{world}_{pid}.npz", y=y.numpy(),
             aux=aux.numpy(), t=t.numpy(), j=(jj // split).numpy(),
             **{"g" + n: g.numpy() for n, g in
                zip(("x", "wr", "wg", "wu", "wd"), grads)},
             n_fwd_bwd=a.stats.collective_counts.get("all-reduce", 0),
             n_fwd=f.stats.collective_counts.get("all-reduce", 0))

# the autograd collectives on their own: this process's value pid + 1
group = mesh.get_group("model")
out = {}
for op in ("sum", "mean", "enter"):
    t = torch.full((3,), float(pid + 1), requires_grad=True)
    r = (sharding.enter_group(t, group) if op == "enter"
         else sharding.all_reduce(t * 1.0, group, op))
    (r * float(pid + 1)).sum().backward()
    out[op] = (r.detach().numpy(), t.grad.numpy())
np.savez(f"{root}/ops_{world}_{pid}.npz",
         **{f"{op}_{k}": v[i] for op, v in out.items()
            for i, k in enumerate(("value", "grad"))})

# a remat'd expert-parallel model whose backward runs on another thread
# (as autograd's device thread runs a card's backward): the recompute
# must run under the forward's mesh and rules
import dataclasses, threading
from repro_torch.configs.base import get_config
from repro_torch.models import api
from repro_torch.models.params import init_params
cfg = dataclasses.replace(get_config("grok-1-314b").reduced(), n_layers=1,
                          remat="full")
rules = {"experts": "model"}
with axis_rules(mesh, rules):
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu",
                         local=lambda d: convert.local_block(d, rules, mesh,
                                                             coords))
tok = torch.arange(32, dtype=torch.int32).reshape(2, 16) % cfg.vocab
leaves = [params["layers"][n] for n in ("wg", "wr")]
grads = {}
for where in ("here", "thread"):
    ps = [x.detach().clone().requires_grad_(True) for x in leaves]
    params["layers"]["wg"], params["layers"]["wr"] = ps
    with axis_rules(mesh, rules):
        logits, aux = api.forward_train(cfg, params, {"tokens": tok})
        loss = (logits.float() ** 2).mean() + aux
    if where == "here":
        with axis_rules(mesh, rules):
            grads[where] = torch.autograd.grad(loss, ps)
    else:
        def run():
            grads[where] = torch.autograd.grad(loss, ps)
        th = threading.Thread(target=run)
        th.start()
        th.join()
np.savez(f"{root}/thread_{world}_{pid}.npz",
         **{f"{w}_{i}": g.numpy() for w, gs in grads.items()
            for i, g in enumerate(gs)})
print("OK", pid)
"""

_REF_MESH = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import MoECfg
from repro.launch.mesh import make_debug_mesh
from repro.models.layers import moe
from repro.parallel.sharding import axis_rules, make_rules

world, root = int(sys.argv[1]), sys.argv[2]
assert len(jax.devices()) == world, jax.devices()
mesh = make_debug_mesh(1, world)
for name in sys.argv[3].split(","):
    z = np.load(f"{root}/{name}.npz")
    cfg = MoECfg(n_experts=int(z["E"]), top_k=int(z["k"]),
                 d_expert=z["wg"].shape[-1])
    split = moe.virtual_split(cfg, world)
    E, Dm, Fm = z["wg"].shape
    Fv = Fm // split
    wg = z["wg"].reshape(E, Dm, split, Fv).transpose(0, 2, 1, 3).reshape(
        E * split, Dm, Fv)
    wu = z["wu"].reshape(E, Dm, split, Fv).transpose(0, 2, 1, 3).reshape(
        E * split, Dm, Fv)
    wd = z["wd"].reshape(E * split, Fv, Dm)
    rules = make_rules(mesh, {"experts": E * split})
    args = [jnp.asarray(a) for a in (z["x"], z["wr"], wg, wu, wd)]

    def loss(*a):
        y, aux = moe.moe_block(*a, moe=cfg)
        return jnp.sum(y * y) + aux

    with mesh, axis_rules(mesh, rules):
        y, aux = jax.jit(lambda *a: moe.moe_block(*a, moe=cfg))(*args)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    np.savez(f"{root}/{name}_ref{world}.npz", y=np.asarray(y),
             aux=np.asarray(aux),
             **{"g" + n: np.asarray(g) for n, g in
                zip(("x", "wr", "wg", "wu", "wd"), grads)})
print("OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, (f"child {i} failed (rc={rc})\n--- stdout ---\n"
                         f"{out}\n--- stderr ---\n{err[-4000:]}")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's inputs, the children's outputs at each model-axis
    size, and the reference's shard_map outputs at the same sizes."""
    root = tmp_path_factory.mktemp("moe_ep")
    for name, (E, k, _) in CASES.items():
        np.savez(root / f"{name}.npz", E=E, k=k, **_inputs(name))
    procs = []                     # both group sizes at once
    for world in (2, 4):
        names = ",".join(n for n, c in CASES.items() if world in c[2])
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(pid), str(world), str(port),
             str(root), names], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_env())
            for pid in range(world)]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REF_MESH, str(world), str(root), names],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count="
                     f"{world}")))
    _run(procs)
    return root


def _one_process(name):
    """(y, aux, dropped set) of the port's one-process block."""
    w = {n: torch.from_numpy(a) for n, a in _inputs(name).items()}
    seen = {}
    orig = moe.route

    def route(cfg_, xf, wr, **kw):
        out = orig(cfg_, xf, wr, **kw)
        seen["slot"], seen["C"] = out[0], out[3]
        return out

    moe.route = route
    try:
        with torch.no_grad():
            y, aux = moe.moe_block(w["x"], w["wr"], w["wg"], w["wu"],
                                   w["wd"], moe=_cfg(name))
    finally:
        moe.route = orig
    gone = seen["slot"] == _cfg(name).n_experts * seen["C"]
    t, j = torch.nonzero(gone, as_tuple=True)
    return y.numpy(), float(aux), set(zip(t.tolist(), j.tolist()))


def _ep(root, name, world):
    ys, auxes, dropped = [], [], set()
    for pid in range(world):
        z = np.load(root / f"{name}_{world}_{pid}.npz")
        ys.append(z["y"])
        auxes.append(float(z["aux"]))
        dropped |= set(zip(z["t"].tolist(), z["j"].tolist()))
    return ys, auxes, dropped


PAIRS = [(n, w) for n, c in CASES.items() for w in c[2]]


@pytest.mark.parametrize("name,world", PAIRS)
def test_ep_matches_the_one_process_block(runs, name, world):
    y1, aux1, drop1 = _one_process(name)
    ys, auxes, dropped = _ep(runs, name, world)
    for y, aux in zip(ys, auxes):          # every process holds the sum
        np.testing.assert_allclose(y, y1, atol=Y_TOL, rtol=0)
        assert abs(aux - aux1) <= AUX_TOL
    assert dropped == drop1
    if name == "grok":
        assert drop1, "the case should drop pairs at this capacity"


@pytest.mark.parametrize("name,world", PAIRS)
def test_ep_matches_the_reference_shard_map_block(runs, name, world):
    z = np.load(runs / f"{name}_ref{world}.npz")
    ys, auxes, _ = _ep(runs, name, world)
    for y, aux in zip(ys, auxes):
        np.testing.assert_allclose(y, z["y"], atol=Y_TOL, rtol=0)
        assert abs(aux - float(z["aux"])) <= AUX_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_process_block_matches_the_reference(name):
    E, k, _ = CASES[name]
    w = _inputs(name)
    ry, raux = ref_moe.moe_block(
        *(jnp.asarray(w[n]) for n in ("x", "wr", "wg", "wu", "wd")),
        moe=RefMoECfg(n_experts=E, top_k=k, d_expert=F))
    y, aux, _ = _one_process(name)
    np.testing.assert_allclose(y, np.asarray(ry), atol=Y_TOL, rtol=0)
    assert abs(aux - float(raux)) <= AUX_TOL


def test_split_experts_keeps_the_function():
    """A one-process block over virtual experts (every shard of every
    expert on one process) gives the same y as over the experts."""
    name = "virtual"
    w = {n: torch.from_numpy(a) for n, a in _inputs(name).items()}
    cfg = type("Cfg", (), {"moe": _cfg(name)})()
    lay = convert.split_experts({"layers": {n: w[n][None] for n in
                                            ("wg", "wu", "wd")}}, cfg, 4)
    assert tuple(lay["layers"]["wg"].shape) == (1, 4, D, F // 2)
    y1, _, _ = _one_process(name)
    with torch.no_grad():
        y, _ = moe._local_moe(w["x"], w["wr"],
                              *(lay["layers"][n][0] for n in
                                ("wg", "wu", "wd")),
                              moe=_cfg(name), split=2, msize=1, m_idx=0)
    np.testing.assert_allclose(y.numpy(), y1, atol=Y_TOL, rtol=0)


# -- the backward ---------------------------------------------------------------


def _grads_one_process(name):
    """The port's one-process gradients of sum(y²) + aux, the experts'
    cut into the virtual experts of ``world`` processes."""
    w = {n: torch.from_numpy(a).requires_grad_(True)
         for n, a in _inputs(name).items()}
    y, aux = moe.moe_block(*(w[n] for n in GRADS), moe=_cfg(name))
    g = dict(zip(GRADS, torch.autograd.grad((y * y).sum() + aux,
                                            [w[n] for n in GRADS])))
    return {n: v.detach() for n, v in g.items()}


def _virtual(g, name, world):
    cfg = type("Cfg", (), {"moe": _cfg(name)})()
    lay = convert.split_experts({"layers": {n: g[n][None] for n in
                                            ("wg", "wu", "wd")}}, cfg,
                                world)["layers"]
    return {**g, **{n: lay[n][0].numpy() for n in ("wg", "wu", "wd")},
            "x": g["x"].numpy(), "wr": g["wr"].numpy()}


def _ep_grads(root, name, world):
    """Every process's x and router gradients, and the experts' gradients
    put together from the processes' blocks in model-axis order."""
    zs = [np.load(root / f"{name}_{world}_{pid}.npz")
          for pid in range(world)]
    out = {n: np.concatenate([z["g" + n] for z in zs])
           for n in ("wg", "wu", "wd")}
    return out, [{n: z["g" + n] for n in ("x", "wr")} for z in zs]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("name,world", PAIRS)
def test_ep_gradients_match_the_one_process_block(runs, name, world):
    want = _virtual(_grads_one_process(name), name, world)
    experts, dense = _ep_grads(runs, name, world)
    for n, g in experts.items():
        _close(g, want[n], n)
    for pid, d in enumerate(dense):        # every process holds the sum
        for n, g in d.items():
            _close(g, want[n], f"{n} of process {pid}")


@pytest.mark.parametrize("name,world", PAIRS)
def test_ep_gradients_match_the_reference_shard_map_block(runs, name, world):
    z = np.load(runs / f"{name}_ref{world}.npz")
    experts, dense = _ep_grads(runs, name, world)
    for n, g in experts.items():
        _close(g, z["g" + n], n)
    for pid, d in enumerate(dense):
        for n, g in d.items():
            _close(g, z["g" + n], f"{n} of process {pid}")


@pytest.mark.parametrize("world", [2, 4])
def test_autograd_collectives(runs, world):
    """Process p holds p + 1 and weights the result by p + 1: the sum's
    backward passes p + 1 through, the mean's divides it by the group's
    size, the entry's sums every process's p + 1."""
    total = world * (world + 1) / 2
    for pid in range(world):
        z = np.load(runs / f"ops_{world}_{pid}.npz")
        np.testing.assert_array_equal(z["sum_value"], total)
        np.testing.assert_array_equal(z["sum_grad"], pid + 1)
        np.testing.assert_allclose(z["mean_value"], total / world,
                                   rtol=1e-7)
        np.testing.assert_allclose(z["mean_grad"], (pid + 1) / world,
                                   rtol=1e-7)
        np.testing.assert_array_equal(z["enter_value"], pid + 1)
        np.testing.assert_array_equal(z["enter_grad"], total)


@pytest.mark.parametrize("name,world", PAIRS)
def test_the_analyzer_counts_the_backward_all_reduces(runs, name, world):
    """Forward: y's sum and aux's mean; the backward adds the sums of x's
    and the router's gradients (the sum's and the mean's backward move
    nothing)."""
    for pid in range(world):
        z = np.load(runs / f"{name}_{world}_{pid}.npz")
        assert int(z["n_fwd"]) == 2
        assert int(z["n_fwd_bwd"]) == 4


@pytest.mark.parametrize("world", [2, 4])
def test_remat_recompute_runs_under_the_forwards_rules(runs, world):
    """A remat'd expert-parallel layer whose backward runs on another
    thread (a card's backward runs on autograd's device thread): its
    recompute takes the forward's mesh and rules, so the gradients are
    those of a backward on the forward's own thread."""
    for pid in range(world):
        z = np.load(runs / f"thread_{world}_{pid}.npz")
        for i in range(2):
            np.testing.assert_array_equal(z[f"thread_{i}"], z[f"here_{i}"])
