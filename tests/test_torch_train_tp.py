"""Tensor parallelism of the transformer across processes: the port's
``train(cfg, mesh)`` held against the reference's ``train(cfg, mesh)``
under the same host mesh, step by step from the same start.

The harness is ``test_torch_train_mesh.py``'s: the reference runs in
subprocesses under ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
(GSPMD splits 'heads', 'kv', 'ff' and 'vocab' over 'model' by
``make_rules``); the port runs in gloo groups of ``python -c`` children on
the CPU, where ``train/loop.py::train_rules`` keeps those four rules and
each process holds its block (``models/transformer.py``).  Every process
starts at once, each with a 120 s limit; a job that needs another's
checkpoint waits for its marker file.

* From a seeded start (the port's draw, zero optimizer states, saved in
  the layout both packages read), both packages train 3 steps under the
  mesh and save at steps 2 and 3: reduced llama3-8b at d_model 48 (GQA 4
  query and 2 KV heads, untied) with AdamW and with Adafactor
  (``momentum=0``) under (1, 2) and (2, 2) (d_model 48: at 32 the
  reference's Adafactor cannot run under a model axis, ROADMAP §3 note
  (x)); reduced qwen1.5-0.5b at d_model 48 (MHA, tied, QKV bias) with AdamW
  under (1, 2); reduced llama3-8b with one KV head (the KV heads whole,
  the query heads split) and with 3 query heads (the attention whole, the
  FFN and vocabulary split) under (1, 2).  Each step's loss, balance loss
  and gradient norm, and every leaf of the final checkpoints, within
  ``STEP_TOL``, and the optimizer's state also at its own scale
  (``STEP_TOL`` relative, and absolute ``STEP_TOL`` times the leaf's
  largest entry).  The port's llama AdamW run at (1, 2) recomputes each layer
  (``remat="full"``), so the recompute issues the forward's all-reduces
  again in the backward (the same function: the reference runs without).
* Each process's blocks, by shape: halves of the split leaves, the rest
  whole.
* The port's step-2 checkpoint of llama AdamW under (1, 2) resumes on one
  process, and under (2, 1) in both packages, and takes step 3 as the
  (1, 2) run took it.
* A step that carries the gradient monitor under (1, 2) keeps the dense
  part whole and logs its layout; ``train_rules`` against the reference's
  ``make_rules`` on each mesh shape; Adafactor's statistics laid out by
  the dimension that is split; ``ServeEngine`` refuses tensor-parallel
  rules.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import LoopConfig, train, train_rules
from test_torch_train import STEP_TOL
from test_torch_train_mesh import _env, _free_port, _popen

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

SEQ, BATCH = 32, 4
VARIANTS = {                       # reduced configs at d_model 48
    "llama": ("llama3-8b", {}),
    "kv1": ("llama3-8b", {"n_kv": 1}),
    "h3": ("llama3-8b", {"n_heads": 3, "n_kv": 1}),
    "qwen": ("qwen1.5-0.5b", {}),
}

_RUNS = {}


def _job(name, arch, opt, mesh, src, steps=3, ckpt_every=2, **extra):
    _RUNS[name] = dict(name=name, arch=arch, opt=opt, mesh=list(mesh),
                       src=src, steps=steps, ckpt_every=ckpt_every, **extra)


MESH_RUNS = [("llama", "adamw", (1, 2)), ("llama", "adamw", (2, 2)),
             ("llama", "adafactor", (1, 2)), ("llama", "adafactor", (2, 2)),
             ("qwen", "adamw", (1, 2)), ("kv1", "adamw", (1, 2)),
             ("h3", "adamw", (1, 2))]
STARTS = sorted({(a, o) for a, o, _ in MESH_RUNS})
for _a, _o, _m in MESH_RUNS:
    _job(f"{_a}_{_o}_{_m[0]}x{_m[1]}", _a, _o, _m, f"init_{_a}_{_o}",
         port_cfg={"remat": "full"} if (_a, _o, _m) == MESH_RUNS[0] else {})
# the step-2 checkpoint of the port's (1, 2) run, resumed on (2, 1)
CHAIN = "llama_adamw_1x2"
for _n in ("chain_2x1", "chain_ref"):
    _job(_n, "llama", "adamw", (2, 1), "port_" + CHAIN,
         drop="step_000000003")
# one step with the gradient monitor: the dense part stays whole
_job("sketched_1x2", "llama", "adamw", (1, 2), "init_llama_adamw", steps=1,
     ckpt_every=1, sketch=True)

REF_PROCS = [(2, ["llama_adamw_1x2", "chain_ref"]),
             (2, ["llama_adafactor_1x2", "qwen_adamw_1x2"]),
             (2, ["kv1_adamw_1x2", "h3_adamw_1x2"]),
             (4, ["llama_adamw_2x2", "llama_adafactor_2x2"])]
PORT_GROUPS = [(2, ["llama_adamw_1x2", "chain_2x1", "llama_adafactor_1x2",
                    "qwen_adamw_1x2", "kv1_adamw_1x2", "h3_adamw_1x2",
                    "sketched_1x2"]),
               (4, ["llama_adamw_2x2", "llama_adafactor_2x2"])]

_COMMON = r"""
import dataclasses, json, os, shutil, sys, time
root = sys.argv[1]
JOBS = json.loads(open(os.path.join(root, "jobs.json")).read())
VARIANTS = json.loads(open(os.path.join(root, "variants.json")).read())


def wait_for(path):
    deadline = time.monotonic() + 110
    while not os.path.exists(os.path.join(root, path + ".done")):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.05)


def copy_source(job, dst):
    shutil.copytree(os.path.join(root, job["src"]), dst)
    if job.get("drop"):
        shutil.rmtree(os.path.join(dst, job["drop"]))


def config(get_config, job, extra=None):
    arch, kw = VARIANTS[job["arch"]]
    return dataclasses.replace(get_config(arch).reduced(), d_model=48,
                               **kw, **(extra or {}))


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
from repro.train import optimizer as ropt
from repro.train.loop import LoopConfig, train

for name in sys.argv[2].split(","):
    job = JOBS[name]
    wait_for(job["src"])
    out_dir = os.path.join(root, "ref_" + name)
    copy_source(job, out_dir)
    d, m = job["mesh"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                             ("data", "model"), **_axis_type_kw(2))
    opt = (ropt.get_optimizer("adafactor", momentum=0.0)
           if job["opt"] == "adafactor" else None)
    res = train(config(get_config, job), mesh,
                loop=LoopConfig(steps=job["steps"], ckpt_dir=out_dir,
                                ckpt_every=job["ckpt_every"]),
                opt=opt, seq_len=%(seq)d, global_batch=%(batch)d)
    finish("ref_" + name, {"history": res["history"]})
print("OK")
""" % {"seq": SEQ, "batch": BATCH}

_PORT = _COMMON + r"""
import logging
import torch
import torch.distributed as dist
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import (init_distributed, make_process_mesh,
                                     shutdown)
from repro_torch.sketch import SketchConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.train_step import TrainStepConfig


class Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


logger = logging.getLogger("repro_torch.train")
logger.setLevel(logging.INFO)
pid, world, port = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
init_distributed(pid, world, port=port, timeout_s=30)
for name in sys.argv[2].split(","):
    job = JOBS[name]
    wait_for(job["src"])
    out_dir = os.path.join(root, "port_" + name)
    if pid == 0:
        copy_source(job, out_dir)
    dist.barrier()
    mesh = make_process_mesh(job["mesh"][1], device="cpu")
    opt = (get_optimizer("adafactor", momentum=0.0)
           if job["opt"] == "adafactor" else None)
    tsc = TrainStepConfig(sketch=SketchConfig(d=64, eps=0.25, window=64)
                          if job.get("sketch") else None)
    lines = Lines()
    logger.addHandler(lines)
    try:
        res = train(config(get_config, job, job.get("port_cfg")), mesh,
                    device="cpu",
                    loop=LoopConfig(steps=job["steps"], ckpt_dir=out_dir,
                                    ckpt_every=job["ckpt_every"]),
                    tsc=tsc, opt=opt, seq_len=%(seq)d,
                    global_batch=%(batch)d)
    finally:
        logger.removeHandler(lines)
    shapes = {"embed": list(res["params"]["embed"].shape)}
    if "lm_head" in res["params"]:
        shapes["lm_head"] = list(res["params"]["lm_head"].shape)
    shapes.update({k: list(v.shape)
                   for k, v in res["params"]["layers"].items()})
    finish("port_%%s_%%d" %% (name, pid), {"history": res["history"],
                                         "shapes": shapes,
                                         "log": lines.lines})
    dist.barrier()
    if pid == 0:
        finish("port_" + name, {"history": res["history"]})
shutdown()
print("OK", pid)
""" % {"seq": SEQ, "batch": BATCH}


def _port_cfg(variant, **extra):
    arch, kw = VARIANTS[variant]
    return dataclasses.replace(get_config(arch).reduced(), d_model=48, **kw,
                               **extra)


def _write_start(path, variant, opt):
    """Step 0 of a variant: the port's seeded draw of the parameters and
    the optimizer's zero states, saved in the layout both packages read
    (Adafactor's 0-d bf16 placeholders are 0, the same in both)."""
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import get_optimizer

    params = init_params(api.param_defs(_port_cfg(variant)),
                         torch.Generator().manual_seed(0), device="cpu")
    o = get_optimizer(opt, **({"momentum": 0.0} if opt == "adafactor"
                              else {}))
    ckpt.save(str(path), 0, (params, o.init(params),
                             torch.zeros((), dtype=torch.int32)),
              data_state={"step": 0}, mesh_shape=(1, 1))
    path.with_name(path.name + ".done").touch()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's history, checkpoints and outputs, under one root."""
    root = tmp_path_factory.mktemp("train_tp")
    (root / "jobs.json").write_text(json.dumps(_RUNS))
    (root / "variants.json").write_text(json.dumps(VARIANTS))
    for variant, opt in STARTS:
        _write_start(root / f"init_{variant}_{opt}", variant, opt)
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


@pytest.mark.parametrize("variant,opt,mesh", MESH_RUNS)
def test_tensor_parallel_run_matches_the_reference(runs, variant, opt, mesh):
    name = f"{variant}_{opt}_{mesh[0]}x{mesh[1]}"
    port = _read(runs, "port_" + name)["history"]
    ref = _read(runs, "ref_" + name)["history"]
    assert len(port) == 3
    _assert_history(port, ref)
    world = mesh[0] * mesh[1]
    for pid in range(1, world):      # every process reports the same step
        assert _read(runs, f"port_{name}_{pid}")["history"] == port
    pm, pl = _leaves(runs / f"port_{name}")
    rm, rl = _leaves(runs / f"ref_{name}")
    assert pm["step"] == rm["step"] == 3
    assert pm["paths"] == rm["paths"]
    assert pm["shapes"] == rm["shapes"]
    assert pm["mesh_shape"] == rm["mesh_shape"] == list(mesh)
    for path, a, b in zip(pm["paths"], pl, rl):
        np.testing.assert_allclose(a, b, atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=path)
        # and the optimizer's statistics at their own scale (Adam's
        # moments, Adafactor's row and column means of g²), which lie far
        # under STEP_TOL, where the test above cannot see them
        if path.startswith("[1]"):
            np.testing.assert_allclose(a, b, rtol=STEP_TOL,
                                       atol=STEP_TOL * np.abs(b).max(),
                                       err_msg=path)


# the dimension each leaf is split along where its rule is on 'model'
_SPLIT_DIM = {"wq": -1, "wk": -1, "wv": -1, "bq": -1, "bk": -1, "bv": -1,
              "wo": -2, "wg": -1, "wu": -1, "wd": -2, "embed": 0,
              "lm_head": 0}
# the leaves each variant keeps whole under (1, 2)
_WHOLE = {"llama": set(), "qwen": set(), "kv1": {"wk", "wv"},
          "h3": {"wq", "wk", "wv", "wo"}}


@pytest.mark.parametrize("variant", sorted(_WHOLE))
def test_each_process_holds_half_of_the_split_leaves(runs, variant):
    from repro_torch.models.params import abstract_params

    name = f"{variant}_adamw_1x2"
    defs = api.param_defs(_port_cfg(variant))
    full = abstract_params(defs)
    whole = {"embed": list(full["embed"].shape)}
    if "lm_head" in full:
        whole["lm_head"] = list(full["lm_head"].shape)
    whole.update({k: list(v.shape) for k, v in full["layers"].items()})
    want_split = set(_SPLIT_DIM) - _WHOLE[variant]
    assert ("lm_head" in whole) == (variant != "qwen")          # tied
    assert {"bq", "bk", "bv"} <= set(whole) or variant != "qwen"
    for pid in range(2):
        got = _read(runs, f"port_{name}_{pid}")["shapes"]
        assert got.keys() == whole.keys()
        for leaf, shape in whole.items():
            want = list(shape)
            if leaf in want_split:
                want[_SPLIT_DIM[leaf]] //= 2
            assert got[leaf] == want, (variant, leaf, got[leaf], shape)


@pytest.mark.parametrize("where", ["one process", "(2, 1)", "reference"])
def test_a_tensor_parallel_checkpoint_resumes_anywhere(runs, where, tmp_path):
    """The port's step-2 checkpoint of the (1, 2) run takes step 3 on one
    process, and under (2, 1) in the port and in the reference, as the
    (1, 2) run took it."""
    want = _read(runs, "port_" + CHAIN)["history"][-1]
    if where == "one process":
        d = tmp_path / "one"
        shutil.copytree(runs / f"port_{CHAIN}", d)
        shutil.rmtree(d / "step_000000003")
        assert ckpt.read_manifest(str(d))["mesh_shape"] == [1, 2]
        got = train(_port_cfg("llama"), device="cpu",
                    loop=LoopConfig(steps=3, ckpt_dir=str(d)),
                    seq_len=SEQ, global_batch=BATCH)["history"]
    else:
        got = _read(runs, "port_chain_2x1" if where == "(2, 1)"
                    else "ref_chain_ref")["history"]
    assert len(got) == 1
    # under (2, 1) the balance loss and gradient norm are the data
    # shards' (ROADMAP §3 note (w)); the dense family's aux is 0
    _assert_history(got, [want])


def test_a_sketched_step_keeps_the_dense_part_whole(runs):
    from repro_torch.models.params import abstract_params

    full = abstract_params(api.param_defs(_port_cfg("llama")))
    for pid in range(2):
        out = _read(runs, f"port_sketched_1x2_{pid}")
        assert out["shapes"]["embed"] == list(full["embed"].shape)
        for k, v in full["layers"].items():
            assert out["shapes"][k] == list(v.shape), k
        layout = [ln for ln in out["log"] if ln.startswith("layout: ")]
        assert len(layout) == 1
        assert "dense part whole" in layout[0]
        assert "The gradient sketches over column-split leaves" in layout[0]
        assert any(k.startswith("sketch/") for k in out["history"][0])
    plain = _read(runs, "port_llama_adamw_1x2_0")["log"]
    assert [ln for ln in plain if ln.startswith("layout: ")] == [
        "layout: llama3-8b on mesh {'data': 1, 'model': 2}: heads, kv, ff, "
        "vocab split over 'model'"]


_TP = ("heads", "kv", "ff", "vocab")
_ARCHS = ("llama3-8b", "qwen1.5-0.5b", "smollm-135m", "grok-1-314b",
          "mamba2-2.7b", "whisper-large-v3")


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("sketched", [False, True])
def test_train_rules_follow_the_references_table(shape, sketched):
    from repro.configs.base import get_config as ref_get_config
    from repro.models import api as ref_api
    from repro.parallel import sharding as ref_sharding

    class Stand:
        def __init__(self, shape):
            self.shape = dict(shape)

    mesh = {"data": shape[0], "model": shape[1]}
    for arch in _ARCHS:
        for reduced in (False, True):
            cfg, rcfg = get_config(arch), ref_get_config(arch)
            if reduced:
                cfg, rcfg = cfg.reduced(), rcfg.reduced()
            stand = Stand(mesh)
            with ref_sharding.axis_rules(stand, {}):
                want = ref_sharding.make_rules(stand,
                                               ref_api.sharding_dims(rcfg))
            got = train_rules(cfg, mesh, sketched=sketched)
            assert got.keys() == want.keys()
            keep = {"batch", "experts", "expert_ff"}
            if cfg.family in ("dense", "moe") and not sketched:
                keep |= set(_TP)
            for k, v in want.items():
                w = v if k in keep else None
                if isinstance(w, tuple) and len(w) == 1:
                    w = w[0]
                g = got[k][0] if isinstance(got[k], tuple) \
                    and len(got[k]) == 1 else got[k]
                assert g == w, (arch, reduced, k, got[k], v)
    # smollm's 9 heads under a model axis of 2: the attention whole, the
    # FFN and vocabulary split
    rules = train_rules(get_config("smollm-135m"), {"data": 1, "model": 2})
    assert (rules["heads"], rules["kv"], rules["seq_attn"]) == (None,) * 3
    assert (rules["ff"], rules["vocab"]) == ("model", "model")


def test_adafactor_statistics_are_laid_out_by_the_split_dimension():
    """At llama3-8b's width ``wq`` is (32, 4096, 4096): the shape match
    of ``opt_state_pspecs`` lays its column statistics out as its rows
    (ROADMAP §3 note (x)), while a process under (1, 2) holds the columns
    of its block; the train loop's layout follows the split dimension."""
    from repro_torch.train.loop import _state_layout
    from repro_torch.train.optimizer import (FactoredState, get_optimizer,
                                             opt_state_pspecs)
    from repro_torch.models.params import abstract_params, param_pspecs
    from repro_torch.parallel.sharding import axis_rules

    cfg = get_config("llama3-8b")
    mesh = {"data": 1, "model": 2}
    rules = train_rules(cfg, mesh)
    opt = get_optimizer("adafactor", momentum=0.0)
    with axis_rules(mesh, rules):
        defs = api.param_defs(cfg)
        shapes, blocks = _state_layout(defs, opt, rules, mesh,
                                       {"data": 0, "model": 1},
                                       torch.float32)
        aparams = abstract_params(defs)
        astate = opt.init(aparams)
        pspecs = param_pspecs(defs, rules)
    paths = [p for p, _ in ckpt.leaves_with_paths(
        (aparams, astate, torch.zeros((), device="meta")))]
    at = {p: i for i, p in enumerate(paths)}
    vc, vr = at["[1].vc['layers']['wq']"], at["[1].vr['layers']['wq']"]
    assert shapes[vc] == shapes[vr] == (32, 4096)
    assert blocks[vc] == (slice(0, 32), slice(2048, 4096))
    assert blocks[vr] is None
    wo = at["[1].vr['layers']['wo']"]
    assert blocks[wo] == (slice(0, 32), slice(2048, 4096))
    assert blocks[at["[1].vc['layers']['wo']"]] is None
    by_shape = opt_state_pspecs(opt, pspecs, aparams, astate)
    assert isinstance(by_shape, FactoredState)
    assert by_shape.vc["layers"]["wq"] == (None, None)          # note (x)


def test_serve_engine_refuses_tensor_parallel_rules():
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    cfg = get_config("llama3-8b").reduced()
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    split = {"data": 1, "model": 2}
    rules = train_rules(cfg, split)
    with pytest.raises(ValueError, match="heads, kv, ff, vocab on a model "
                       "axis of 2 processes.*ROADMAP §1"):
        ServeEngine(cfg, params, EngineConfig(), device="cpu", mesh=split,
                    rules=rules)
    ep = {k: (v if k in ("batch", "experts") else None)
          for k, v in rules.items()}
    ServeEngine(cfg, params, EngineConfig(), device="cpu", mesh=split,
                rules=ep)
    one = {"data": 1, "model": 1}
    ServeEngine(cfg, params, EngineConfig(), device="cpu", mesh=one,
                rules=train_rules(cfg, one))


def test_a_restored_block_of_leading_rows_is_writable(tmp_path):
    """A block of a leaf's leading rows (an embedding split by vocabulary)
    is read from the checkpoint's memory map as a copy: a CPU tensor that
    shared the read-only mapping crashed the process at the optimizer's
    in-place update."""
    full = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    ckpt.save(str(tmp_path), 1, {"embed": full})
    tree, _ = ckpt.restore(str(tmp_path), {"embed": full}, device="cpu",
                           blocks=lambda i, shape: (slice(3, 6),
                                                    slice(0, 4)))
    got = tree["embed"]
    assert torch.equal(got, full[3:])
    got.add_(1.0)
    assert torch.equal(got, full[3:] + 1)
