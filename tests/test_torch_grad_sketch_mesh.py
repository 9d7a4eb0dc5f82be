"""The gradient sketches under a model axis of processes: the DS-FD
monitor, FD compression with error feedback and the Sketchy optimizer in
``train(cfg, mesh)`` where each process holds one block of a split leaf,
held against the one-process pieces and against the reference's
``train(cfg, mesh)`` on the global arrays.

The port runs in gloo groups of 2 and 4 ``python -c`` children on the CPU
(``launch.mesh.init_distributed`` on a free localhost port,
``make_process_mesh``); the reference in subprocesses under
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` that share one
compilation cache (as ``test_torch_train_mesh.py``'s).  Everything starts
at once, each process with a 120 s limit and transports of at most 30 s.

* Pieces, in each group (M = 2, 4): the block count-sketch summed over
  the model axis equals ``project_grads`` of the whole tree for leaves
  split along dimension 0 and dimension 1 (L = 2), within 1e-6·‖row‖, and
  the reference's ``project_grads`` agrees within 1e-5·‖row‖; the FD
  summary carried across the axis equals the one-process ``fd_compress``
  of the whole leaf bit for bit, with runs that end mid-round (ℓ = 4, 96
  rows a run), zero rows at a run's boundary and an all-zero run; a leaf
  split along its last dimension raises (ROADMAP §1, the gradient
  sketches over column-split leaves); two Sketchy updates of a block equal the whole
  leaf's block within 1e-6.
* Whole runs, three steps from one seeded start (the port's draw, saved in
  the layout both read): the monitor and compression (AdamW) on reduced
  grok-1 (d_model 48, E = 4, top-2) under (1, 2) and (2, 2), and on
  reduced smollm-135m under (1, 2) the monitor alone and compression
  alone.  Each step's loss, balance loss, gradient norm and sketch
  metrics, and every leaf of the final checkpoints, within ``STEP_TOL``
  and ``SKETCH_METRIC_TOL``; every process ends with the same sketches.
* Sketchy on grok-1 under (1, 2) against the reference's
  ``build_train_step`` jitted under the same mesh with neither donation
  nor ``in_shardings`` on the optimizer state (the reference's own
  ``train()`` cannot run it: ROADMAP §3 note (y)); its step-2 checkpoint
  resumed on one process and under (2, 1).
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.fd import fd_absorb, fd_init
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.sketch import monitor
from repro_torch.sketch.sketchy import SketchyConfig, sketchy_dsfd
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import LoopConfig, train
from test_torch_train import STEP_TOL
from test_torch_train_mesh import (_COMMON, _env, _free_port, _leaves,
                                   _popen, _port_cfg)

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

SEQ, BATCH = 32, 4
SKETCH_METRIC_TOL = 1e-4
# Sketchy's momenta sum normalised updates (the diagonal path's g/√v is
# ±10 at its first step), so a rounding of a small gradient entry moves a
# momentum by its own relative size; the parameters take lr·m, and are
# held to STEP_TOL
MOM_TOL = 1e-3
PIECE_TOL = 1e-6        # the block rows' sum against the whole, × ‖row‖
REF_ROW_TOL = 1e-5      # the reference's row, × ‖row‖
# the monitor as test_torch_train_mesh.py's; 4 summary rows (FD at ℓ = 2)
# for the compression and Sketchy, since at ℓ = 1 an FD shrink zeroes the
# whole buffer: with 2 their sketches stay empty, the compression projects
# onto a zero basis and Sketchy's low-rank part is never used
# only leaves of at least MIN_SIZE are compressed: grok-1's three expert
# leaves, which the model axis splits, and smollm-135m's four largest,
# held whole (each compressed leaf adds summary_rows DS-FD updates to the
# reference's compiled step)
MONITOR = dict(d=64, eps=0.25, window=64)
COMPRESS = dict(rank=4, eps=0.25, window=8, summary_rows=4)
MIN_SIZE = {"grok": 8192, "smollm": 4096}
SKETCHY = dict(lr=2e-2, rank=4, eps=0.5, window=4, summary_rows=4,
               warmup=4)
SIZES = (2, 4)
# the pieces: leaves (L = 2, ...) split along dimension 0 or 1, and FD
# carries whose runs of 96 rows end mid-round at ℓ = 4 (8 rows, then 5 a
# round), one with zero rows across a run's boundary, one with a zero run
PIECE_D, CARRY_ELL, CARRY_RUN = 16, 4, 96
CARRIES = ("mid-round", "zero rows at a boundary", "an all-zero run")
# a Sketchy update of a block (L = 2, split along dimension 1) against the
# whole leaf's: ρ = 1 gives the low-rank part the tail's weight
PIECE_SKETCHY = dict(lr=1e-2, rank=4, eps=0.5, window=4, summary_rows=4,
                     rho=1.0, warmup=1)
SKETCHY_PIECE_TOL = 1e-6     # the blocks' sums over the axis: rounding

_RUNS = {}


def _job(name, arch, mesh, sketch="", steps=3, **extra):
    _RUNS[name] = dict(name=name, arch=arch, mesh=list(mesh), sketch=sketch,
                       steps=steps, **extra)


for _m in ((1, 2), (2, 2)):
    _job(f"mc_grok_{_m[0]}x{_m[1]}", "grok", _m, "monitor+compress",
         src="init_grok")
_job("monitor_smollm_1x2", "smollm", (1, 2), "monitor", src="init_smollm")
_job("compress_smollm_1x2", "smollm", (1, 2), "compress", src="init_smollm")
_job("sketchy_grok_1x2", "grok", (1, 2), src="init_grok", sketchy=True)
# the port's Sketchy checkpoint at step 2, resumed under (2, 1)
_job("sketchy_chain_2x1", "grok", (2, 1), src="port_sketchy_grok_1x2",
     sketchy=True, drop="step_000000003")
WHOLE = ["mc_grok_1x2", "mc_grok_2x2", "monitor_smollm_1x2",
         "compress_smollm_1x2"]

# reference processes (device count, jobs) and port groups (processes,
# jobs in order; "pieces" first)
REF_PROCS = [(2, ["mc_grok_1x2"]), (4, ["mc_grok_2x2"]),
             (2, ["monitor_smollm_1x2"]), (2, ["compress_smollm_1x2"]),
             (2, ["sketchy_grok_1x2"])]
PORT_GROUPS = [(2, ["pieces", "mc_grok_1x2", "monitor_smollm_1x2",
                    "compress_smollm_1x2", "sketchy_grok_1x2",
                    "sketchy_chain_2x1"]),
               (4, ["pieces", "mc_grok_2x2"])]

_SETTINGS = ("MONITOR, COMPRESS, SKETCHY, MIN_SIZE = %r, %r, %r, %r\n"
             "CARRIES, CARRY_ELL, PIECE_SKETCHY = %r, %r, %r\n"
             % (MONITOR, COMPRESS, SKETCHY, MIN_SIZE, CARRIES, CARRY_ELL,
                PIECE_SKETCHY))

_REF = _COMMON + _SETTINGS + r"""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.data.tokens import TokenPipeline
from repro.launch.mesh import _axis_type_kw
from repro.models import api
from repro.models.params import init_params, param_pspecs
from repro.parallel.sharding import axis_rules, make_rules
from repro.sketch import CompressConfig, SketchConfig
from repro.sketch.sketchy import SketchyConfig, sketchy_dsfd
from repro.train import checkpoint as rckpt
from repro.train import optimizer as ropt
from repro.train.loop import LoopConfig, train
from repro.train.train_step import TrainStepConfig, build_train_step


def sketchy(job, mesh, cfg, out_dir):
    # the reference's train() donates and lays out the sketch states in
    # a way its own jit refuses (ROADMAP note (y)): its step, jitted with
    # the parameters' shardings only
    rules = make_rules(mesh, api.sharding_dims(cfg))
    with mesh, axis_rules(mesh, rules):
        defs = api.param_defs(cfg)
        param_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                                param_pspecs(defs, rules),
                                is_leaf=lambda x: isinstance(x, P))
        like = init_params(defs, jax.random.PRNGKey(0))
        (params, _, _), m = rckpt.restore(
            os.path.join(root, job["src"]),
            (like, ropt.get_optimizer("adamw").init(like),
             jnp.zeros((), jnp.int32)))
        params = jax.tree.map(jax.device_put, params, param_sh)
        opt = sketchy_dsfd(SketchyConfig(**SKETCHY))
        state, step = opt.init(params), jnp.zeros((), jnp.int32)
        fn = jax.jit(build_train_step(cfg, opt, TrainStepConfig()),
                     in_shardings=(param_sh, None,
                                   NamedSharding(mesh, P()), None))
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=%(seq)d,
                             global_batch=%(batch)d)
        ds, history = m["data_state"], []
        for _ in range(job["steps"]):
            ds, b = pipe.next_batch(ds)
            params, state, step, metrics = fn(
                params, state, step, {k: jnp.asarray(v) for k, v in b.items()})
            history.append({k: float(v) for k, v in metrics.items()})
        rckpt.save(out_dir, int(step), (params, state, step),
                   data_state=ds, mesh_shape=tuple(job["mesh"]))
    return history


for name in sys.argv[2].split(","):
    job = JOBS[name]
    wait_for([job["src"] + ".done"])
    out_dir = os.path.join(root, "ref_" + name)
    d, m = job["mesh"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                             ("data", "model"), **_axis_type_kw(2))
    cfg = config(get_config, job)
    if job.get("sketchy"):
        history = sketchy(job, mesh, cfg, out_dir)
    else:
        copy_source(job, out_dir)
        kw = {}
        if "monitor" in job["sketch"]:
            kw["sketch"] = SketchConfig(**MONITOR)
        if "compress" in job["sketch"]:
            kw["compress"] = CompressConfig(**COMPRESS,
                                            min_size=MIN_SIZE[job["arch"]])
        history = train(cfg, mesh, loop=LoopConfig(steps=job["steps"],
                                                   ckpt_dir=out_dir,
                                                   ckpt_every=job["steps"]),
                        tsc=TrainStepConfig(**kw), seq_len=%(seq)d,
                        global_batch=%(batch)d)["history"]
    finish("ref_" + name, {"history": history})
print("OK")
""" % {"seq": SEQ, "batch": BATCH}

_PORT = _COMMON + _SETTINGS + r"""
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.core.fd import fd_compress
from repro_torch.launch.mesh import (init_distributed, make_process_mesh,
                                     shutdown)
from repro_torch.parallel.sharding import axis_rules, model_sharded
from repro_torch.sketch import CompressConfig, SketchConfig, monitor
from repro_torch.sketch.blocks import fd_summary
from repro_torch.sketch.sketchy import SketchyConfig, sketchy_dsfd
from repro_torch.train.checkpoint import leaves_with_paths
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.tree import leaves

pid, world, port = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
init_distributed(pid, world, port=port, timeout_s=30)


def pieces():
    # the count-sketch of a tree whose leaves are split along dimension 0
    # or 1, the FD carries, the last dimension's refusal
    mesh = make_process_mesh(world, device="cpu")
    coords = convert.mesh_coords(mesh)
    z = np.load(os.path.join(root, "pieces_%%d.npz" %% world))
    out = {"rows": {}, "carry": {}}
    cfg = SketchConfig(d=int(z["d"]))
    with axis_rules(mesh, {}):
        for dim in (0, 1):
            tree, split = {}, {}
            for name in ("a", "b", "whole"):
                x = torch.from_numpy(z[name])
                k = None if name == "whole" else dim
                spec = [None] * x.dim()
                if k is not None:
                    spec[k] = "model"
                tree[name] = x[convert.block_of(x.shape, spec, mesh,
                                                coords)].contiguous()
                split[name] = k
            out["rows"][str(dim)] = monitor.project_grads(
                cfg, {"layers": tree}, {"layers": split}).tolist()
        for i, case in enumerate(CARRIES):
            x = torch.from_numpy(z["carry_%%d" %% i])
            dim = i %% 2
            spec = [None] * x.dim()
            spec[dim] = "model"
            blk = x[convert.block_of(x.shape, spec, mesh, coords)]
            got = fd_summary(blk.contiguous(), CARRY_ELL, dim)
            want = fd_compress(x.reshape(1, -1, x.shape[-1]), CARRY_ELL)
            out["carry"][case] = [bool(torch.equal(got, want)),
                                  float((got - want).abs().max())]
        # two Sketchy updates of a block against the whole leaf's (rho 1:
        # the low-rank part weighs as much as the tail)
        opt = sketchy_dsfd(SketchyConfig(**PIECE_SKETCHY))
        x = torch.from_numpy(z["sketchy_p"])
        spec = [None] * x.dim()
        spec[1] = "model"
        blk = convert.block_of(x.shape, spec, mesh, coords)
        whole, block = {"w": x.clone()}, {"w": x[blk].contiguous()}
        sw, sb = opt.init(whole), opt.init(block)
        for k in range(2):
            g = torch.from_numpy(z["sketchy_g%%d" %% k])
            sw = opt.update({"w": g}, sw, whole, k)[1]
            with model_sharded({"w": 1}):
                sb = opt.update({"w": g[blk].contiguous()}, sb, block, k)[1]
        out["sketchy"] = {
            "p": float((block["w"] - whole["w"][blk]).abs().max()),
            "mom": float((sb.mom["w"] - sw.mom["w"][blk]).abs().max()),
            "scale": float(whole["w"].abs().max()),
            "sketch": all(torch.equal(a, b) for a, b in zip(
                leaves(sb.sketch["w"]), leaves(sw.sketch["w"])))}
        x = torch.from_numpy(z["a"])
        try:
            fd_summary(x[..., :x.shape[-1] // world].contiguous(), CARRY_ELL,
                       x.dim() - 1)
            out["last"] = None
        except NotImplementedError as e:
            out["last"] = str(e)
    return out


def digest(state):
    # the sketches this process ends with, each tensor summed; the error
    # feedback is row-local (this process's block), so it is left out
    if isinstance(state, dict):
        return [x for k in sorted(state) if k != "err"
                for x in digest(state[k])]
    if isinstance(state, tuple):
        return [x for t in state for x in digest(t)]
    if state is None or state.dtype == torch.bool:
        return []
    return [float(state.double().sum())]


for name in sys.argv[2].split(","):
    if name == "pieces":
        finish("port_pieces_%%d_%%d" %% (world, pid), pieces())
        continue
    job = JOBS[name]
    wait_for([job["src"] + ".done"])
    out_dir = os.path.join(root, "port_" + name)
    if pid == 0 and job["src"].startswith("port_"):
        copy_source(job, out_dir)
    dist.barrier()
    mesh = make_process_mesh(job["mesh"][1], device="cpu")
    kw, opt, every = {}, None, job["steps"]
    if "monitor" in job["sketch"]:
        kw["sketch"] = SketchConfig(**MONITOR)
    if "compress" in job["sketch"]:
        kw["compress"] = CompressConfig(**COMPRESS,
                                        min_size=MIN_SIZE[job["arch"]])
    if job.get("sketchy"):
        opt, every = sketchy_dsfd(SketchyConfig(**SKETCHY)), 2
    res = train(config(get_config, job), mesh, device="cpu",
                loop=LoopConfig(steps=job["steps"], ckpt_dir=out_dir,
                                ckpt_every=every),
                tsc=TrainStepConfig(**kw), opt=opt, seq_len=%(seq)d,
                global_batch=%(batch)d)
    sketches = (res["opt_state"].sketch if job.get("sketchy")
                else res["sketch_state"])
    # what the FD-fed sketches learned: their buffers' and snapshots' energy
    learned = (sketches if job.get("sketchy")
               else (sketches or {}).get("compress"))
    energy = sum(float((t.double() ** 2).sum())
                 for p, t in leaves_with_paths(learned)
                 if p.endswith((".buf", ".snap_v")))
    finish("port_%%s_%%d" %% (name, pid), {"history": res["history"],
                                        "digest": digest(sketches),
                                        "energy": energy})
    dist.barrier()
    if pid == 0:
        open(os.path.join(root, "port_" + name + ".done"), "w").close()
shutdown()
print("OK", pid)
""" % {"seq": SEQ, "batch": BATCH}


def _piece_inputs(world):
    """The pieces' arrays for a model axis of ``world``: leaves a, b of
    (L = 2, ...) whose dimensions 0 and 1 split ``world`` ways, a whole
    leaf, and one leaf per FD carry case whose runs hold ``CARRY_RUN``
    rows (split along dimension 0 for cases 0 and 2, 1 for case 1)."""
    rng = np.random.default_rng(world)
    f32 = np.float32
    z = {"d": np.int64(64),
         "a": rng.standard_normal((2 * world, 2 * world, 3, PIECE_D)),
         "b": rng.standard_normal((2 * world, 2 * world, 5)),
         "whole": rng.standard_normal((7, PIECE_D))}
    z["sketchy_p"] = rng.standard_normal((2, 2 * world, 12, PIECE_D))
    for k in range(2):
        z[f"sketchy_g{k}"] = rng.standard_normal((2, 2 * world, 12, PIECE_D))
    for i in range(len(CARRIES)):
        shape = ((world, CARRY_RUN, PIECE_D) if i % 2 == 0
                 else (2, world, CARRY_RUN, PIECE_D))
        x = rng.standard_normal(shape)
        runs = x.reshape(-1, CARRY_RUN, PIECE_D)
        if i == 1:         # the last 3 rows of a run, the first 2 of the next
            runs[0, -3:] = 0.0
            runs[1, :2] = 0.0
        if i == 2:
            runs[1] = 0.0
        z[f"carry_{i}"] = x
    return {k: (v.astype(f32) if v.dtype == np.float64 else v)
            for k, v in z.items()}


def _write_start(path, arch):
    """Step 0 of ``arch`` (reduced) with AdamW: the port's seeded draw of
    the parameters, zero moments, saved in the layout both read."""
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import adamw

    params = init_params(api.param_defs(_port_cfg(arch)),
                         torch.Generator().manual_seed(0), device="cpu")
    ckpt.save(str(path), 0, (params, adamw().init(params),
                             torch.zeros((), dtype=torch.int32)),
              data_state={"step": 0}, mesh_shape=(1, 1))
    path.with_name(path.name + ".done").touch()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's outputs, under one root."""
    root = tmp_path_factory.mktemp("grad_sketch_mesh")
    (root / "jobs.json").write_text(json.dumps(_RUNS))
    for world in SIZES:
        np.savez(root / f"pieces_{world}.npz", **_piece_inputs(world))
    for arch in ("grok", "smollm"):
        _write_start(root / f"init_{arch}", arch)
    procs = {}
    for i, (ndev, jobs) in enumerate(REF_PROCS):
        procs[f"reference {i}"] = _popen(
            [_REF, str(root), ",".join(jobs)],
            _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev} "
                 "--xla_backend_optimization_level=0",
                 JAX_COMPILATION_CACHE_DIR=str(root / "jax-cache"),
                 JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
                 JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0"))
    for world, jobs in PORT_GROUPS:
        port = _free_port()
        for pid in range(world):
            procs[f"port {world}/{pid}"] = _popen(
                [_PORT, str(root), ",".join(jobs), str(pid), str(world),
                 str(port)], _env())
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=120) + (p.returncode,)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, (out, err, rc) in outs.items():
        assert rc == 0, (f"{name} failed (rc={rc})\n--- stdout ---\n{out}"
                         f"\n--- stderr ---\n{err[-4000:]}")
    return root


def _read(root, name):
    return json.loads((root / f"{name}.json").read_text())


def _procs(job):
    d, m = _RUNS[job]["mesh"]
    return range(d * m)


def _pieces(root, world):
    return [_read(root, f"port_pieces_{world}_{pid}")
            for pid in range(world)]


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("world", SIZES)
def test_block_count_sketch_sums_to_the_whole_trees(runs, world, dim):
    """Every process's row (its blocks hashed by their global indices,
    summed over the axis, the whole leaf added once) against
    ``project_grads`` of the whole tree in one process and the
    reference's."""
    import jax.numpy as jnp

    from repro.sketch import monitor as ref_monitor

    z = _piece_inputs(world)
    tree = {"layers": {n: z[n] for n in ("a", "b", "whole")}}
    cfg = monitor.SketchConfig(d=int(z["d"]))
    want = monitor.project_grads(cfg, {"layers": {
        n: torch.from_numpy(v) for n, v in tree["layers"].items()}}).numpy()
    ref = np.asarray(ref_monitor.project_grads(
        ref_monitor.SketchConfig(d=int(z["d"])),
        {"layers": {n: jnp.asarray(v) for n, v in tree["layers"].items()}}))
    scale = float(np.linalg.norm(want))
    assert scale > 0
    np.testing.assert_allclose(want, ref, rtol=0, atol=REF_ROW_TOL * scale)
    for out in _pieces(runs, world):
        np.testing.assert_allclose(out["rows"][str(dim)], want, rtol=0,
                                   atol=PIECE_TOL * scale)


@pytest.mark.parametrize("case", CARRIES)
@pytest.mark.parametrize("world", SIZES)
def test_fd_carry_is_the_whole_leafs_fd_compress_bit_for_bit(runs, world,
                                                             case):
    for out in _pieces(runs, world):
        equal, err = out["carry"][case]
        assert equal, f"max |carry − fd_compress| = {err}"


@pytest.mark.parametrize("world", SIZES)
def test_carry_cases_end_mid_round_and_shrink(world):
    """The carries' runs end mid-round (96 rows: 8, then 5 a round at
    ℓ = 4), and every case's whole leaf shrinks its buffer."""
    assert (CARRY_RUN - 2 * CARRY_ELL) % (CARRY_ELL + 1) != 0
    z = _piece_inputs(world)
    for i in range(len(CARRIES)):
        x = torch.from_numpy(z[f"carry_{i}"]).reshape(1, -1, PIECE_D)
        st = fd_absorb(fd_init(CARRY_ELL, PIECE_D, 1, device="cpu"), x,
                       ell=CARRY_ELL)
        assert float(st.shed[0]) > 0


@pytest.mark.parametrize("world", SIZES)
def test_sketchy_update_of_a_block_is_the_whole_leafs(runs, world):
    """Two Sketchy updates of a block along dimension 1 (the summary
    carried, the gradient energy and the trust region's mean square summed
    over the axis) against the whole leaf's in one process: the block's
    parameters and momenta within 1e-6 of the whole's block, the DS-FD
    sketches bit for bit."""
    for out in _pieces(runs, world):
        got = out["sketchy"]
        assert got["sketch"]
        assert got["p"] <= SKETCHY_PIECE_TOL * got["scale"]
        assert got["mom"] <= SKETCHY_PIECE_TOL * got["scale"]


@pytest.mark.parametrize("world", SIZES)
def test_a_split_along_the_last_dimension_raises(runs, world):
    for out in _pieces(runs, world):
        assert out["last"] and ("ROADMAP §1, 'The gradient sketches over "
                                "column-split leaves'") in out["last"]


def _assert_history(port, ref):
    assert len(port) == len(ref) == 3
    for k, (p, r) in enumerate(zip(port, ref)):
        assert p.keys() == r.keys()
        for n in p:
            tol = SKETCH_METRIC_TOL if n.startswith("sketch/") else STEP_TOL
            np.testing.assert_allclose(p[n], r[n], rtol=tol, atol=tol,
                                       err_msg=f"step {k} {n}")


def _assert_leaves(port_dir, ref_dir, tol=lambda path: STEP_TOL):
    """Every leaf of the two final checkpoints whose path ``tol`` gives a
    tolerance (None: not compared) within it."""
    pm, pl = _leaves(port_dir)
    rm, rl = _leaves(ref_dir)
    assert pm["step"] == rm["step"] == 3
    assert pm["mesh_shape"] == rm["mesh_shape"]
    want = dict(zip(rm["paths"], rl))
    n = 0
    for path, a in zip(pm["paths"], pl):
        if tol(path) is not None:
            np.testing.assert_allclose(a, want[path], atol=tol(path),
                                       rtol=tol(path), err_msg=path)
            n += 1
    assert n


@pytest.mark.parametrize("job", WHOLE)
def test_monitor_and_compression_under_a_model_axis_match_the_reference(
        runs, job):
    outs = [_read(runs, f"port_{job}_{pid}") for pid in _procs(job)]
    _assert_history(outs[0]["history"], _read(runs, f"ref_{job}")["history"])
    for out in outs[1:]:
        assert out["history"] == outs[0]["history"]
        assert out["digest"] == outs[0]["digest"]
    assert outs[0]["digest"]
    # the compression's sketches learned a basis (not a zero one)
    assert ("compress" in _RUNS[job]["sketch"]) == (outs[0]["energy"] > 0)
    assert ("monitor" in _RUNS[job]["sketch"]) == any(
        k.startswith("sketch/") for k in outs[0]["history"][0])
    _assert_leaves(runs / f"port_{job}", runs / f"ref_{job}")


def test_sketchy_under_a_model_axis_matches_the_reference(runs):
    job = "sketchy_grok_1x2"
    outs = [_read(runs, f"port_{job}_{pid}") for pid in _procs(job)]
    _assert_history(outs[0]["history"], _read(runs, f"ref_{job}")["history"])
    assert outs[1]["history"] == outs[0]["history"]
    assert outs[1]["digest"] == outs[0]["digest"] and outs[0]["digest"]
    assert outs[0]["energy"] > 0
    # the parameters and diagonals within STEP_TOL, the momenta within
    # MOM_TOL; the sketches carry the stream axis here, and their SVD rows
    # are unique only up to sign
    _assert_leaves(runs / f"port_{job}", runs / f"ref_{job}",
                   tol=lambda p: MOM_TOL if ".mom" in p else STEP_TOL
                   if p.startswith("[0]") or ".diag" in p else None)


@pytest.mark.parametrize("where", ["one process", "(2, 1)"])
def test_sketchy_checkpoint_of_a_model_axis_resumes(runs, where, tmp_path):
    """The (1, 2) run's step-2 checkpoint takes step 3 on one process as
    that run took it (the loss, balance loss and gradient norm), and under
    (2, 1) with its loss (the balance loss and norm are the data shards'
    there: ROADMAP §3 note (w))."""
    want = _read(runs, "port_sketchy_grok_1x2_0")["history"][-1]
    if where == "one process":
        d = tmp_path / "one"
        shutil.copytree(runs / "port_sketchy_grok_1x2", d)
        shutil.rmtree(d / "step_000000003")
        assert ckpt.read_manifest(str(d))["mesh_shape"] == [1, 2]
        got = train(_port_cfg("grok"), device="cpu",
                    loop=LoopConfig(steps=3, ckpt_dir=str(d)),
                    opt=sketchy_dsfd(SketchyConfig(**SKETCHY)),
                    seq_len=SEQ, global_batch=BATCH)["history"]
        keys = ("loss", "aux", "grad_norm")
    else:
        got = _read(runs, "port_sketchy_chain_2x1_0")["history"]
        keys = ("loss",)
    assert len(got) == 1
    for k in keys:
        np.testing.assert_allclose(got[0][k], want[k], rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=k)


def test_sketchy_checkpoint_holds_the_sketches_whole(runs):
    """Under (1, 2) each leaf's DS-FD states are written whole (every
    process holds the same) and the momenta by their parameters' specs:
    the saved arrays have the one-process shapes."""
    m = ckpt.read_manifest(str(runs / "port_sketchy_grok_1x2"))
    opt = sketchy_dsfd(SketchyConfig(**SKETCHY))
    from repro_torch.models.params import abstract_params

    aparams = abstract_params(api.param_defs(_port_cfg("grok")),
                              torch.float32)
    want = [list(x.shape) for _, x in ckpt.leaves_with_paths(
        (aparams, opt.init(aparams), torch.zeros((), device="meta")))]
    assert m["shapes"] == want
    assert any(".sketch" in p for p in m["paths"])
