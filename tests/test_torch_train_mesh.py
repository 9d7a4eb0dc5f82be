"""Training under a mesh of processes: the port's ``train(cfg, mesh)``
held against the reference's ``train(cfg, mesh)`` under the same host
mesh, step by step from the same checkpoint, and checkpoints resumed on
another mesh in either package.

The reference runs in subprocesses under ``XLA_FLAGS=--xla_force_host_
platform_device_count=N`` (its meshes over the first devices); the port
runs in gloo groups of ``python -c`` children on the CPU
(``launch.mesh.init_distributed`` on a free localhost port,
``make_process_mesh``).  Every process starts at once; a job that needs
another's checkpoint waits for its marker file.  Each has a 120 s limit.

* The reference trains 3 steps on its (1, 1) mesh and saves: reduced
  smollm-135m with AdamW, reduced grok-1 (E = 4, top-2) with AdamW and
  with Adafactor (``momentum=0``).  Both packages resume each under the
  meshes below and train to step 6, saving at steps 5 and 6:
  smollm under (2, 1), grok under (1, 2), (2, 1) and (2, 2).  Each
  step's loss, balance loss and gradient norm, and every leaf of the
  final checkpoints (parameters and optimizer states, full arrays), within
  ``STEP_TOL`` (``test_torch_train.py``'s 2e-4: AdamW divides by √v̂, so
  a rounding of g moves an update by up to lr·δg/√v̂).  Under a data
  axis the balance loss is data coordinate 0's (ROADMAP §3 note (w)).
  Grok's width is 48: at the reduced 32 the reference's Adafactor cannot
  run under a model axis (note (x)).
* The port's checkpoint at step 5 under (1, 2) resumes on one process
  (step 6 as the run that went on) and under (2, 1) in both packages
  (the loss as that run's; the balance loss and gradient norm, which are
  the data shards' there, each package's as the other's).
* The gradient monitor and FD compression under (2, 1), against the
  reference's under (2, 1) (``test_torch_grad_sketch_train.py``'s
  settings and tolerances); under a model axis,
  ``test_torch_grad_sketch_mesh.py``.
* ``launch/train.py`` under two torchrun-style processes (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and ``--mesh pod``.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import LoopConfig, train
from test_torch_train import STEP_TOL

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

SRC = Path(__file__).resolve().parents[1] / "src"
SEQ, BATCH = 32, 4
AUX_TOL = 1e-6          # the balance loss of one shard, recomputed here
SKETCH_METRIC_TOL = 1e-4

# every job: its model, optimizer and mesh, the checkpoint it resumes
# (whose marker it waits for), the step it trains to and its saves
_RUNS = {}


def _job(name, arch, opt, mesh, src=None, steps=6, ckpt_every=5, **extra):
    _RUNS[name] = dict(name=name, arch=arch, opt=opt, mesh=list(mesh),
                       src=src, steps=steps, ckpt_every=ckpt_every,
                       needs=[src + ".done"] if src else [], **extra)


for _a, _o in (("smollm", "adamw"), ("grok", "adamw"),
               ("grok", "adafactor")):
    _job(f"base_{_a}_{_o}", _a, _o, (1, 1), steps=3, ckpt_every=3)
MESH_RUNS = [("smollm", "adamw", (2, 1))] + [
    ("grok", o, m) for o in ("adamw", "adafactor")
    for m in ((1, 2), (2, 1), (2, 2))]
for _a, _o, _m in MESH_RUNS:
    _job(f"{_a}_{_o}_{_m[0]}x{_m[1]}", _a, _o, _m, src=f"base_{_a}_{_o}")
# the step-5 checkpoint of the port's (1, 2) run, resumed elsewhere
CHAIN = "grok_adamw_1x2"
_job("chain_2x1", "grok", "adamw", (2, 1), src=f"port_{CHAIN}",
     drop="step_000000006")
_job("chain_ref", "grok", "adamw", (2, 1), src=f"port_{CHAIN}",
     drop="step_000000006")
# the sketches from a seeded start that the parent writes (their
# reference's compile is the longest, so it starts at once)
_job("sketch_2x1", "smollm", "adamw", (2, 1), src="init_smollm_adamw",
     steps=3, sketch="monitor+compress")

# who runs what: reference processes (device count, jobs in order) and
# port groups (processes, jobs in order)
REF_PROCS = [(2, ["base_grok_adamw", "grok_adamw_1x2", "grok_adamw_2x1"]),
             (2, ["base_grok_adafactor", "grok_adafactor_1x2",
                  "grok_adafactor_2x1"]),
             (2, ["base_smollm_adamw", "smollm_adamw_2x1"]),
             (2, ["sketch_2x1"]),
             (4, ["grok_adamw_2x2", "grok_adafactor_2x2", "chain_ref"])]
PORT_GROUPS = [(2, ["smollm_adamw_2x1", "sketch_2x1", "grok_adamw_1x2",
                    "chain_2x1",
                    "grok_adamw_2x1", "grok_adafactor_1x2",
                    "grok_adafactor_2x1"]),
               (4, ["grok_adamw_2x2", "grok_adafactor_2x2"])]

# the jobs' common part, in either package
_COMMON = r"""
import dataclasses, json, os, shutil, sys, time
root = sys.argv[1]
JOBS = json.loads(open(os.path.join(root, "jobs.json")).read())


def wait_for(paths):
    deadline = time.monotonic() + 110
    for p in paths:
        while not os.path.exists(os.path.join(root, p)):
            if time.monotonic() > deadline:
                raise TimeoutError(p)
            time.sleep(0.05)


def copy_source(job, dst):
    shutil.copytree(os.path.join(root, job["src"]), dst)
    if job.get("drop"):
        shutil.rmtree(os.path.join(dst, job["drop"]))


def config(get_config, job):
    cfg = get_config({"smollm": "smollm-135m",
                      "grok": "grok-1-314b"}[job["arch"]]).reduced()
    return dataclasses.replace(cfg, d_model=48) if job["arch"] == "grok" \
        else cfg


def finish(name, out):
    with open(os.path.join(root, name + ".json"), "w") as f:
        json.dump(out, f)
    open(os.path.join(root, name + ".done"), "w").close()
"""

_REF = _COMMON + r"""
import jax
import numpy as np
from repro.configs.base import get_config
from repro.launch.mesh import _axis_type_kw
from repro.sketch import CompressConfig, SketchConfig
from repro.train import optimizer as ropt
from repro.train.loop import LoopConfig, train
from repro.train.train_step import TrainStepConfig

for name in sys.argv[2].split(","):
    job = JOBS[name]
    wait_for(job["needs"])
    out_dir = os.path.join(root, ("" if job["name"].startswith("base")
                                  else "ref_") + name)
    if job["src"]:
        copy_source(job, out_dir)
    d, m = job["mesh"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                             ("data", "model"), **_axis_type_kw(2))
    opt = (ropt.get_optimizer("adafactor", momentum=0.0)
           if job["opt"] == "adafactor" else None)
    tsc = TrainStepConfig()
    if job.get("sketch"):
        tsc = TrainStepConfig(
            sketch=SketchConfig(d=64, eps=0.25, window=64),
            compress=CompressConfig(rank=4, eps=0.25, window=8,
                                    min_size=2048, summary_rows=2))
    res = train(config(get_config, job), mesh,
                loop=LoopConfig(steps=job["steps"], ckpt_dir=out_dir,
                                ckpt_every=job["ckpt_every"]),
                tsc=tsc, opt=opt, seq_len=%(seq)d, global_batch=%(batch)d)
    finish(("" if name.startswith("base") else "ref_") + name,
           {"history": res["history"]})
print("OK")
""" % {"seq": SEQ, "batch": BATCH}

_PORT = _COMMON + r"""
import torch
import torch.distributed as dist
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import (init_distributed, make_process_mesh,
                                     shutdown)
from repro_torch.sketch import CompressConfig, SketchConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.train_step import TrainStepConfig

pid, world, port = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
init_distributed(pid, world, port=port, timeout_s=30)
for name in sys.argv[2].split(","):
    job = JOBS[name]
    wait_for(job["needs"])
    out_dir = os.path.join(root, "port_" + name)
    if pid == 0:
        copy_source(job, out_dir)
    dist.barrier()
    mesh = make_process_mesh(job["mesh"][1], device="cpu")
    opt = (get_optimizer("adafactor", momentum=0.0)
           if job["opt"] == "adafactor" else None)
    kw = {}
    if "monitor" in job.get("sketch", ""):
        kw["sketch"] = SketchConfig(d=64, eps=0.25, window=64)
    if "compress" in job.get("sketch", ""):
        kw["compress"] = CompressConfig(rank=4, eps=0.25, window=8,
                                        min_size=2048, summary_rows=2)
    res = train(config(get_config, job), mesh, device="cpu",
                loop=LoopConfig(steps=job["steps"], ckpt_dir=out_dir,
                                ckpt_every=job["ckpt_every"]),
                tsc=TrainStepConfig(**kw), opt=opt, seq_len=%(seq)d,
                global_batch=%(batch)d)
    if pid == 0:
        finish("port_" + name, {"history": res["history"]})
shutdown()
print("OK", pid)
""" % {"seq": SEQ, "batch": BATCH}

_LAUNCH = r"""
import sys
from repro_torch.launch import train
train.main(["--device", "cpu", "--steps", "3", "--ckpt-dir", sys.argv[1]])
"""


def _write_start(path):
    """Step 0 of reduced smollm-135m with AdamW: the port's seeded draw
    of the parameters, zero moments, saved in the layout both read."""
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import adamw

    params = init_params(api.param_defs(_port_cfg("smollm")),
                         torch.Generator().manual_seed(0), device="cpu")
    ckpt.save(str(path), 0, (params, adamw().init(params),
                             torch.zeros((), dtype=torch.int32)),
              data_state={"step": 0}, mesh_shape=(1, 1))
    path.with_name(path.name + ".done").touch()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for k in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    env.update(extra)
    return env


def _popen(args, env):
    return subprocess.Popen([sys.executable, "-c", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's history, checkpoints and outputs, under one root."""
    root = tmp_path_factory.mktemp("train_mesh")
    (root / "jobs.json").write_text(json.dumps(_RUNS))
    _write_start(root / "init_smollm_adamw")
    procs = {}
    for i, (ndev, jobs) in enumerate(REF_PROCS):
        # one compilation cache for the run: a program that another
        # reference process compiled already (the eager init's) loads;
        # LLVM's optimizations off: its compiles take ~40 % less CPU
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
    port = _free_port()
    for pid in range(2):
        procs[f"launcher {pid}"] = _popen(
            [_LAUNCH, str(root / "launcher")],
            _env(RANK=str(pid), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)))
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
    root.joinpath("launcher.out").write_text(
        "\n".join(outs[f"launcher {pid}"][0] for pid in range(2)))
    return root


def _history(root, name):
    return json.loads((root / f"{name}.json").read_text())["history"]


def _leaves(path):
    """(manifest, every leaf as a float64 array) of a checkpoint."""
    m = ckpt.read_manifest(str(path))
    d = path / f"step_{m['step']:09d}"
    out = []
    for i, dt in enumerate(m["dtypes"]):
        a = np.load(d / f"leaf_{i:06d}.npy")
        if dt == "bfloat16":
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
                .float().numpy()
        out.append(a.astype(np.float64))
    return m, out


def _assert_history(got, want, keys=("loss", "aux", "grad_norm")):
    assert len(got) == len(want)
    for k in keys:
        np.testing.assert_allclose([h[k] for h in got], [h[k] for h in want],
                                   atol=STEP_TOL, rtol=STEP_TOL, err_msg=k)


@pytest.mark.parametrize("arch,opt,mesh", MESH_RUNS)
def test_resumed_under_a_mesh_matches_the_reference(runs, arch, opt, mesh):
    name = f"{arch}_{opt}_{mesh[0]}x{mesh[1]}"
    port, ref = _history(runs, "port_" + name), _history(runs, "ref_" + name)
    assert len(port) == 3
    _assert_history(port, ref)
    pm, pl = _leaves(runs / f"port_{name}")
    rm, rl = _leaves(runs / f"ref_{name}")
    assert pm["step"] == rm["step"] == 6
    assert pm["paths"] == rm["paths"]
    assert pm["shapes"] == rm["shapes"]
    assert pm["mesh_shape"] == rm["mesh_shape"] == list(mesh)
    for path, a, b in zip(pm["paths"], pl, rl):
        np.testing.assert_allclose(a, b, atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=path)


def _port_cfg(arch):
    cfg = get_config({"smollm": "smollm-135m",
                      "grok": "grok-1-314b"}[arch]).reduced()
    return dataclasses.replace(cfg, d_model=48) if arch == "grok" else cfg


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_balance_loss_under_a_data_axis_is_the_first_shards(runs, opt):
    """Note (w): under (2, 1) the reported balance loss of the first
    resumed step is that of data coordinate 0's half of the batch,
    recomputed here from the base checkpoint, not the other half's."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import get_optimizer

    cfg = _port_cfg("grok")
    like = init_params(api.param_defs(cfg), torch.Generator(), device="cpu")
    o = get_optimizer(opt, **({"momentum": 0.0} if opt == "adafactor"
                              else {}))
    (params, _, _), m = ckpt.restore(
        str(runs / f"base_grok_{opt}"),
        (like, o.init(like), torch.zeros((), dtype=torch.int32)),
        device="cpu")
    _, batch = TokenPipeline(vocab=cfg.vocab, seq_len=SEQ,
                             global_batch=BATCH).next_batch(m["data_state"])
    auxes = []
    for half in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH)):
        with torch.no_grad():
            _, aux = api.forward_train(cfg, params, {
                k: torch.from_numpy(v[half]) for k, v in batch.items()})
        auxes.append(float(aux))
    for pkg in ("port_", "ref_"):
        got = _history(runs, f"{pkg}grok_{opt}_2x1")[0]["aux"]
        assert abs(got - auxes[0]) <= AUX_TOL, (pkg, got, auxes)
    assert abs(auxes[1] - auxes[0]) > 100 * AUX_TOL


@pytest.mark.parametrize("where", ["one process", "(2, 1)", "reference"])
def test_a_model_axis_checkpoint_resumes_anywhere(runs, where, tmp_path):
    """The port's checkpoint at step 5 under (1, 2) takes step 6 on one
    process as the (1, 2) run that went on took it.  Under (2, 1), in the
    port and in the reference's ``train()``, the step's loss is that run's
    too, while its balance loss and gradient norm are the data shards'
    (note (w)): the two packages' are held to each other."""
    want = _history(runs, f"port_{CHAIN}")[-1]
    if where == "one process":
        d = tmp_path / "one"
        shutil.copytree(runs / f"port_{CHAIN}", d)
        shutil.rmtree(d / "step_000000006")
        assert ckpt.read_manifest(str(d))["mesh_shape"] == [1, 2]
        got = train(_port_cfg("grok"), device="cpu",
                    loop=LoopConfig(steps=6, ckpt_dir=str(d)),
                    seq_len=SEQ, global_batch=BATCH)["history"]
        assert len(got) == 1
        _assert_history(got, [want])
        return
    got = _history(runs, "port_chain_2x1" if where == "(2, 1)"
                   else "ref_chain_ref")
    assert len(got) == 1
    _assert_history(got, [want], ("loss",))
    _assert_history(got, _history(runs, "ref_chain_ref"))


def test_gradient_sketches_under_a_data_axis_match_the_reference(runs):
    port, ref = _history(runs, "port_sketch_2x1"), _history(runs,
                                                             "ref_sketch_2x1")
    assert len(port) == len(ref) == 3
    for k, (p, r) in enumerate(zip(port, ref)):
        assert p.keys() == r.keys()
        assert any(n.startswith("sketch/") for n in p)
        np.testing.assert_allclose(p["loss"], r["loss"], atol=STEP_TOL)
        for n in p:
            np.testing.assert_allclose(p[n], r[n], rtol=SKETCH_METRIC_TOL,
                                       atol=SKETCH_METRIC_TOL,
                                       err_msg=f"{k} {n}")


def test_launcher_trains_over_torchrun_processes(runs):
    """``launch/train.py`` in two processes of a torchrun-style
    environment: data-parallel over both, a checkpoint of the (2, 1)
    mesh, the losses of one process's launcher run."""
    lines = [ln for ln in (runs / "launcher.out").read_text().splitlines()
             if ln.startswith("final loss")]
    assert len(lines) == 2
    assert lines[0].split("|")[0] == lines[1].split("|")[0]
    assert "mesh {'data': 2, 'model': 1}" in lines[0]
    m = ckpt.read_manifest(str(runs / "launcher"))
    assert m["step"] == 3 and m["mesh_shape"] == [2, 1]
    one = launch_train.main(["--device", "cpu", "--steps", "3"])
    assert float(lines[0].split()[2]) == pytest.approx(
        one["history"][-1]["loss"], abs=1e-4)


def test_launcher_refuses_the_production_meshes():
    for mesh, ranks in (("pod", 256), ("multipod", 512)):
        with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
            launch_train.main(["--device", "cpu", "--mesh", mesh])
