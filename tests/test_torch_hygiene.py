"""Boundaries of the port: ``repro_torch`` imports neither JAX nor anything
of the reference package ``repro``, and its entry points run on the card
unless the caller names the CPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import dsfd, fd, seq_dsfd
from repro_torch import convert, tree
from repro_torch.configs.base import get_config
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api, transformer, whisper
from repro_torch.models.layers.attention import kv_cache_init
from repro_torch.models.params import init_params
from repro_torch.parallel.topology import FleetTopology, MemTransport
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine, \
    SketchFleetEngine
from repro_torch.sketch.api import agg_tree, fleet_streams, make_sketch, \
    restore_fleet, save_fleet, shard_streams
from repro_torch.sketch.compress import CompressConfig, compress_init
from repro_torch.sketch.history import HistoryPlane
from repro_torch.sketch.monitor import SketchConfig, sketch_init
from repro_torch.sketch.runner import run_sketch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.optimizer import adamw
from repro_torch.train.train_step import TrainStepConfig, init_sketch_state

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_no_jax_and_nothing_of_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 64                    # every module was imported
    assert {"repro_torch.core.seq_dsfd", "repro_torch.sketch.basis",
            "repro_torch.sketch.score", "repro_torch.sketch.capability",
            "repro_torch.sketch.query", "repro_torch.train.checkpoint",
            "repro_torch.sketch.history", "repro_torch.parallel.topology",
            "repro_torch.launch.mesh", "repro_torch.train.train_step",
            "repro_torch.train.loop", "repro_torch.train.optimizer",
            "repro_torch.data.tokens", "repro_torch.sketch.monitor",
            "repro_torch.sketch.compress", "repro_torch.sketch.sketchy",
            "repro_torch.launch.train", "repro_torch.core.baselines",
            "repro_torch.core.baselines.npfd",
            "repro_torch.core.baselines.lmfd",
            "repro_torch.core.baselines.difd",
            "repro_torch.core.baselines.sampling",
            "repro_torch.sketch.runner", "repro_torch.models.layers.moe",
            "repro_torch.configs.grok_1_314b",
            "repro_torch.configs.kimi_k2_1t_a32b",
            "repro_torch.configs.qwen2_vl_2b",
            "repro_torch.configs.mamba2_2_7b",
            "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.models.layers.ssm", "repro_torch.models.mamba2",
            "repro_torch.models.layers.rglru",
            "repro_torch.models.recurrentgemma",
            "repro_torch.configs.whisper_large_v3",
            "repro_torch.models.whisper", "repro_torch.launch.flops",
            "repro_torch.parallel.sharding", "repro_torch.launch.hlo",
            "repro_torch.launch.dryrun", "repro_torch.convert",
            "repro_torch.models.params",
            "repro_torch.models.transformer"} <= names


def _topo(S, P=2, pid=0):
    return FleetTopology(S, num_processes=P, process_id=pid,
                         transport=MemTransport())


def _tiny_model(arch="smollm-135m"):
    cfg = get_config(arch).reduced()
    return cfg, init_params(api.param_defs(cfg),
                            torch.Generator().manual_seed(0), device="cpu")


def _numpy_cache(cache):
    """A ``WhisperCache`` with numpy leaves, as the reference's converts."""
    return tree.tree_map(lambda t: t.numpy(), cache)


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a card, whatever machine runs the test."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: SketchFleetEngine("dsfd", d=8, streams=2),
    lambda: make_sketch("dsfd", d=8),
    lambda: make_sketch("fd", d=8),
    lambda: dsfd.dsfd_init(dsfd.make_config(8, 0.25, 16)),
    lambda: fd.fd_init(2, 8),
    lambda: dsfd.dsfd_run_stream(dsfd.make_config(8, 0.25, 16),
                                 np.ones((4, 8), np.float32)),
    lambda: convert.dsfd_state_from_numpy(
        dsfd.make_config(8, 0.25, 16),
        convert.dsfd_state_to_numpy(dsfd.dsfd_init(
            dsfd.make_config(8, 0.25, 16), device="cpu"))),
    lambda: ServeEngine(*_tiny_model(), EngineConfig(slots=1, s_max=32)),
    lambda: launch_serve.main(["--requests", "1"]),
    lambda: convert.model_params_from_reference({}, _tiny_model()[0]),
    lambda: api.init_cache(get_config("smollm-135m").reduced(), 1, 8),
    lambda: transformer.init_cache(get_config("smollm-135m").reduced(), 1, 8),
    lambda: kv_cache_init(1, 8, 2, 4),
    lambda: make_sketch("seq-dsfd", d=8),
    lambda: make_sketch("time-dsfd", d=8),
    lambda: make_sketch("fd", d=8, adapt_target=0.1),
    lambda: SketchFleetEngine("seq-dsfd", d=8, streams=2, R=4.0),
    lambda: SketchFleetEngine("time-dsfd", d=8, streams=2, R=4.0),
    lambda: SketchFleetEngine("dsfd", d=8, streams=2, score=True),
    lambda: agg_tree(fleet_streams(make_sketch("dsfd", d=8), 2)),
    lambda: seq_dsfd.layered_init(seq_dsfd.make_seq_config(8, 0.25, 16, 4)),
    lambda: seq_dsfd.layered_run_stream(
        seq_dsfd.make_time_config(8, 0.25, 16, 4), np.ones((4, 8)),
        np.arange(1, 5)),
    lambda: fd.adaptive_fd_init(2, 8),
    lambda: convert.layered_state_from_numpy(
        seq_dsfd.make_seq_config(8, 0.25, 16, 4),
        convert.layered_state_to_numpy(seq_dsfd.layered_init(
            seq_dsfd.make_seq_config(8, 0.25, 16, 4), device="cpu"))),
    lambda: convert.adaptive_state_from_numpy(convert.adaptive_state_to_numpy(
        fd.adaptive_fd_init(2, 8, device="cpu"))),
    lambda: SketchFleetEngine("dsfd", d=8, streams=2, history=True),
    lambda: HistoryPlane(streams=2, d=8, ell=2, window=16),
    lambda: ckpt.restore("no-such-checkpoint", {"w": 0}),
    lambda: shard_streams(make_sketch("dsfd", d=8), 2, topology=_topo(2)),
    lambda: SketchFleetEngine("dsfd", d=8, streams=2, topology=_topo(2)),
    lambda: mesh.local_device(_topo(2)),
    lambda: train(get_config("smollm-135m").reduced()),
    lambda: launch_train.main(["--steps", "1"]),
    lambda: init_sketch_state(TrainStepConfig(sketch=SketchConfig(d=8)),
                              _tiny_model()[1], adamw()),
    lambda: sketch_init(SketchConfig(d=8)),
    lambda: compress_init(CompressConfig(min_size=1), _tiny_model()[1]),
    lambda: make_sketch("lmfd", d=8),
    lambda: make_sketch("difd", d=8),
    lambda: make_sketch("swr", d=8),
    lambda: make_sketch("swor", d=8),
    lambda: run_sketch("swr", np.ones((4, 8), np.float32), eps=0.25,
                       window=4, query_every=2),
    lambda: init_params(api.param_defs(get_config("grok-1-314b").reduced()),
                        torch.Generator()),
    lambda: ServeEngine(*_tiny_model("kimi-k2-1t-a32b"),
                        EngineConfig(slots=1, s_max=32)),
    lambda: api.init_cache(get_config("qwen2-vl-2b").reduced(), 1, 8),
    lambda: api.init_cache(get_config("mamba2-2.7b").reduced(), 1, 8),
    lambda: api.init_cache(get_config("recurrentgemma-9b").reduced(), 1, 8),
    lambda: init_params(api.param_defs(get_config("qwen2-vl-2b").reduced()),
                        torch.Generator()),
    lambda: init_params(api.param_defs(get_config("mamba2-2.7b").reduced()),
                        torch.Generator()),
    lambda: init_params(api.param_defs(
        get_config("recurrentgemma-9b").reduced()), torch.Generator()),
    lambda: ServeEngine(*_tiny_model("mamba2-2.7b"),
                        EngineConfig(slots=1, s_max=32)),
    lambda: ServeEngine(*_tiny_model("recurrentgemma-9b"),
                        EngineConfig(slots=1, s_max=32)),
    lambda: init_params(api.param_defs(
        get_config("whisper-large-v3").reduced()), torch.Generator()),
    lambda: api.init_cache(get_config("whisper-large-v3").reduced(), 1, 8),
    lambda: whisper.init_cache(get_config("whisper-large-v3").reduced(), 1,
                               8),
    lambda: ServeEngine(*_tiny_model("whisper-large-v3"),
                        EngineConfig(slots=1, s_max=32)),
    lambda: launch_serve.main(["--arch", "whisper-large-v3"]),
    lambda: ServeEngine(*_tiny_model("grok-1-314b"),
                        EngineConfig(slots=1, s_max=32),
                        mesh={"data": 1, "model": 1}, rules={}),
    lambda: mesh.make_host_mesh(),
    lambda: convert.whisper_cache_from_reference(
        _numpy_cache(whisper.init_cache(
            get_config("whisper-large-v3").reduced(), 1, 8, torch.float32,
            "cpu")),
        get_config("whisper-large-v3").reduced()),
    lambda: train(get_config("grok-1-314b").reduced(),
                  {"data": 1, "model": 1}),
], ids=["engine", "make_sketch-dsfd", "make_sketch-fd", "dsfd_init",
        "fd_init", "dsfd_run_stream", "convert", "serve-engine",
        "launch-serve", "convert-model", "init-cache", "init-cache-dense",
        "kv-cache-init", "make_sketch-seq-dsfd", "make_sketch-time-dsfd",
        "make_sketch-fd-adaptive", "engine-seq-dsfd", "engine-time-dsfd",
        "engine-score", "agg_tree", "layered_init", "layered_run_stream",
        "adaptive_fd_init", "convert-layered", "convert-adaptive",
        "engine-history", "history-plane", "checkpoint-restore",
        "topology-fleet", "topology-engine", "local-device", "train",
        "launch-train", "init-sketch-state", "sketch-init", "compress-init",
        "make_sketch-lmfd", "make_sketch-difd", "make_sketch-swr",
        "make_sketch-swor", "run-sketch", "init-params-moe", "serve-moe",
        "init-cache-vlm", "init-cache-ssm", "init-cache-hybrid",
        "init-params-vlm", "init-params-ssm", "init-params-hybrid",
        "serve-ssm", "serve-hybrid", "init-params-encdec",
        "init-cache-encdec", "whisper-init-cache", "serve-encdec",
        "launch-serve-encdec", "serve-ep", "host-mesh",
        "convert-whisper-cache", "train-mesh"])
def test_entry_points_default_to_the_card(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_runs_only_when_named(no_cuda):
    eng = SketchFleetEngine("dsfd", d=8, streams=2, eps=0.25, window=16,
                            device="cpu")
    assert eng.state.main.buf.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve_device("meta")
    serve = ServeEngine(*_tiny_model(), EngineConfig(slots=1, s_max=32),
                        device="cpu")
    assert serve.caches.k.device.type == "cpu"


def test_mesh_entry_points_run_on_the_cpu_when_named(no_cuda):
    """``make_host_mesh`` and an engine under a mesh's rules run on the CPU
    when it is named; in a process with no group the host mesh is the
    plain shape of one process."""
    assert mesh.make_host_mesh(device="cpu") == {"data": 1, "model": 1}
    cfg, params = _tiny_model("grok-1-314b")
    serve = ServeEngine(cfg, params, EngineConfig(slots=1, s_max=32),
                        device="cpu", mesh={"data": 1, "model": 1},
                        rules={})
    serve.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                         max_new=2))
    assert len(serve.run()[0].out_tokens) == 3


def test_restores_run_on_the_cpu_only_when_named(no_cuda, tmp_path):
    """A fleet or engine checkpoint written on the CPU: restoring it needs
    the card unless the caller names the CPU."""
    eng = SketchFleetEngine("dsfd", d=8, streams=2, eps=0.25, window=16,
                            history=True, device="cpu")
    eng.checkpoint(str(tmp_path / "engine"))
    fleet = fleet_streams(make_sketch("dsfd", d=8, device="cpu"), 2)
    save_fleet(str(tmp_path / "fleet"), fleet, fleet.init(), 0)
    # an engine without history: its shard restores under any partition
    SketchFleetEngine("dsfd", d=8, streams=2, eps=0.25, window=16,
                      device="cpu").checkpoint(str(tmp_path / "engine2"))
    for call in (lambda **kw: restore_fleet(str(tmp_path / "fleet"), **kw),
                 lambda **kw: SketchFleetEngine.from_checkpoint(
                     str(tmp_path / "engine"), **kw),
                 lambda **kw: restore_fleet(str(tmp_path / "fleet"),
                                            topology=_topo(2, 2, 1), **kw),
                 lambda **kw: SketchFleetEngine.from_checkpoint(
                     str(tmp_path / "engine2"), topology=_topo(2, 2, 1),
                     **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    back = SketchFleetEngine.from_checkpoint(str(tmp_path / "engine"),
                                             device="cpu")
    assert back.history is not None and back.history.device.type == "cpu"


def test_training_state_runs_on_the_cpu_when_named(no_cuda):
    _, params = _tiny_model()
    tsc = TrainStepConfig(sketch=SketchConfig(d=8),
                          compress=CompressConfig(min_size=1))
    sk = init_sketch_state(tsc, params, adamw(), device="cpu")
    assert sk["monitor"]["norm_hist"].device.type == "cpu"
    assert sk["compress"]["embed"]["err"].device.type == "cpu"
    assert sketch_init(SketchConfig(d=8), "cpu")["dsfd"].main.buf.shape \
        == (1, 16, 8)
    assert init_sketch_state(TrainStepConfig(), params, adamw()) is None


def test_train_under_a_mesh_runs_on_the_cpu_when_named(no_cuda):
    """``train(cfg, mesh)`` on the plain shape of one process runs on the
    CPU when it is named; a plain shape of several processes, which has
    no process group behind it, is refused."""
    cfg = get_config("grok-1-314b").reduced()
    res = train(cfg, {"data": 1, "model": 1}, device="cpu",
                loop=LoopConfig(steps=1), seq_len=16, global_batch=2)
    assert res["params"]["embed"].device.type == "cpu"
    with pytest.raises(ValueError, match="make_process_mesh"):
        train(cfg, {"data": 2, "model": 1}, device="cpu")


def test_init_cache_runs_on_the_cpu_when_named(no_cuda):
    cfg = get_config("smollm-135m").reduced()
    caches = api.init_cache(cfg, 2, 8, torch.float32, "cpu")
    assert caches.k.shape == (cfg.n_layers, 2, 8, cfg.n_kv, cfg.dh)
    assert caches.k.device.type == "cpu" and not caches.length.any()
    assert kv_cache_init(1, 8, 2, 4, device="cpu").k.device.type == "cpu"


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "whisper-large-v3"])
def test_new_families_run_on_the_cpu_when_named(no_cuda, arch):
    cfg, params = _tiny_model(arch)
    caches = api.init_cache(cfg, 2, 8, torch.float32, "cpu")
    assert all(t.device.type == "cpu" for t in tree.leaves(caches))
    assert all(t.device.type == "cpu" for t in tree.leaves(params))
    if cfg.family != "vlm":          # the VLM's engine lacks M-RoPE ids
        eng = ServeEngine(cfg, params, EngineConfig(slots=1, s_max=32),
                          device="cpu")
        assert all(t.device.type == "cpu" for t in tree.leaves(eng.caches))


def test_launch_serve_runs_on_the_cpu_when_named(no_cuda, capsys):
    launch_serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                       "--max-new", "2", "--s-max", "48"])
    out = capsys.readouterr().out
    assert out.startswith("3 requests, 9 tokens") and "on cpu" in out


def test_convert_round_trip_and_shape_checks():
    cfg = dsfd.make_config(8, 0.25, 16, mode="krylov", use_kernel=True)
    st, _ = dsfd.dsfd_run_stream(
        cfg, np.random.default_rng(0).normal(size=(2, 40, 8)), device="cpu")
    back = convert.dsfd_state_from_numpy(cfg, convert.dsfd_state_to_numpy(st),
                                         device="cpu")
    for a, b in zip(st.main + st.aux, back.main + back.aux):
        assert a.dtype == b.dtype and torch.equal(a, b)
    other = dsfd.make_config(9, 0.25, 16)
    with pytest.raises(ValueError, match="buf"):
        convert.dsfd_state_from_numpy(other, convert.dsfd_state_to_numpy(st),
                                      device="cpu")
    fields = convert.config_to_reference_fields(cfg)
    assert fields["use_pallas"] is True

    class Ref:                                  # a reference-shaped config
        pass

    ref = Ref()
    ref.__dict__.update(fields)
    assert convert.config_from_reference(ref) == cfg


def test_convert_round_trip_layered_and_adaptive():
    """Layered states as a fleet (S, L, …) and as one stack (L, …), and
    adaptive-rank FD states, survive the trip through numpy exactly."""
    cfg = seq_dsfd.make_seq_config(8, 0.25, 16, 8.0, mode="krylov")
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(3, 40, 8)) * rng.uniform(1, 2.5, (3, 40, 1))
    st, _ = seq_dsfd.layered_run_stream(cfg, rows, np.arange(1, 41),
                                        device="cpu")
    assert st.main.buf.shape == (3, cfg.levels, cfg.base.m, 8)
    back = convert.layered_state_from_numpy(
        cfg, convert.layered_state_to_numpy(st), device="cpu")
    for a, b in zip(st.main + st.aux, back.main + back.aux):
        assert a.dtype == b.dtype and torch.equal(a, b)
    one = dsfd.DSFDState(*(type(sk)(*(x[1:2] for x in sk)) for sk in st))
    stack = convert.layered_state_to_numpy(one, fleet=False)
    assert stack.main.nbuf.shape == (cfg.levels,)
    again = convert.layered_state_from_numpy(cfg, stack, device="cpu")
    for a, b in zip(one.main + one.aux, again.main + again.aux):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="S = 1"):
        convert.layered_state_to_numpy(st, fleet=False)
    with pytest.raises(ValueError, match="buf"):
        convert.layered_state_from_numpy(
            seq_dsfd.make_seq_config(9, 0.25, 16, 8.0),
            convert.layered_state_to_numpy(st), device="cpu")

    sk = make_sketch("fd", d=8, eps=0.25, adapt_target=0.05, device="cpu")
    ast = sk.update_block(sk.init(streams=2), torch.from_numpy(
        rng.normal(size=(2, 30, 8)).astype(np.float32)),
        torch.arange(1, 31, dtype=torch.int32))
    aback = convert.adaptive_state_from_numpy(
        convert.adaptive_state_to_numpy(ast), device="cpu")
    for a, b in zip(ast, aback):
        assert a.dtype == b.dtype and torch.equal(a, b)
    single = convert.adaptive_state_from_numpy(
        type(ast)(*(x[0].numpy() for x in ast)), device="cpu")
    assert single.buf.shape == (1,) + tuple(ast.buf.shape[1:])
    with pytest.raises(ValueError, match="nbuf"):
        convert.adaptive_state_from_numpy(
            ast._replace(nbuf=ast.nbuf[:1]), device="cpu")


def test_config_guards():
    with pytest.raises(ValueError, match="mode"):
        dsfd.make_config(8, 0.25, 16, mode="lazy")
    with pytest.raises(ValueError, match="cap"):
        dsfd.DSFDConfig(d=8, ell=4, window=16, cap=6)
