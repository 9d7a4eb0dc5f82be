"""The multi-pod dry-run: trace every (architecture × input shape × mesh)
cell against the production mesh, show that its sharding is coherent, and
record the roofline inputs (peak live bytes, per-device FLOPs, HBM bytes
and collective bytes).

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 512 placeholder host devices.  Here the placeholder devices are
the ranks of a fake process group (``launch/mesh.py::init_fake_world``):
this process plays rank 0 of a (16, 16) or (2, 16, 16) ``DeviceMesh``, the
parameters, optimizer state and inputs are ``DTensor``s of ``meta``
tensors placed by the logical-axis rules (``parallel/sharding.py``), and
the cell's step (train, prefill or decode) runs once on them under
``implicit_replication`` (a plain tensor made inside the model acts as
replicated).  DTensor's sharding propagation inserts the collectives, as
GSPMD does; the program analyzer (``launch/hlo.py``) counts what rank 0
dispatches.  Nothing is allocated and nothing runs on a card.

Usage (one process; the fake group is this process's default group)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all                 # 16×16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod     # 2×16×16

Records: one JSON a cell under ``build/dryrun/<mesh>/``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.configs.base import (ModelConfig, ShapeSpec, SHAPES,
                                      all_configs, get_config, shape_cells)
from repro_torch.launch import hlo
from repro_torch.launch.flops import model_flops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models.params import (abstract_params, count_params,
                                       param_pspecs)
from repro_torch.parallel.sharding import (axis_rules, fit_spec, make_rules,
                                           mesh_shape, spec_placements,
                                           to_pspec)
from repro_torch.serve.serve_step import build_decode_step, build_prefill_step
from repro_torch.train.optimizer import get_optimizer, opt_state_pspecs
from repro_torch.train.train_step import (TrainStepConfig, auto_microbatches,
                                          build_train_step)
from repro_torch.tree import leaves, map_dicts

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# the reference's large-scale policy thresholds
FSDP_BYTES_PER_CHIP = 4e9          # bf16 params/chip above this → FSDP
ADAFACTOR_PARAMS = 50e9            # above → factored second moments
NO_MOMENTUM_PARAMS = 200e9         # above → drop bf16 momentum too
BF16_ACCUM_PARAMS = 50e9           # above → bf16 grad accumulation


def _axis_prod(mesh, names) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in names:
        if a in shape:
            n *= shape[a]
    return n


def _fit_spec(spec, shape, mesh):
    """Drop spec entries that do not divide the dimension they shard."""
    return fit_spec(spec, tuple(shape), mesh)


def _local_shape(shape, spec, mesh):
    out = []
    for n, p in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        ways = 1 if p is None else _axis_prod(
            mesh, tuple(p) if isinstance(p, (tuple, list)) else (p,))
        out.append(n // ways)
    return tuple(out)


def place(t: torch.Tensor, spec, mesh):
    """The ``meta`` tensor ``t`` as a DTensor over ``mesh`` laid out by
    ``spec`` (fitted to its shape): rank 0's local block, no storage."""
    from torch.distributed.tensor import DTensor

    spec = _fit_spec(spec, t.shape, mesh)
    local = torch.empty(_local_shape(t.shape, spec, mesh), dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, spec_placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and \
        all(isinstance(e, (str, type(None), tuple)) for e in x)


def _tree2(fn, axes, tree):
    """``fn(axes_leaf, tensor)`` over an axes tree (dicts, NamedTuples,
    tuples of names at the leaves) and the tensor tree it describes."""
    if isinstance(axes, dict):
        return {k: _tree2(fn, axes[k], tree[k]) for k in axes}
    if hasattr(axes, "_fields"):
        return type(axes)(*(_tree2(fn, a, t) for a, t in zip(axes, tree)))
    assert _is_axes_leaf(axes), axes
    return fn(axes, tree)


def batch_shardings(cfg, shape, mesh, rules, specs) -> Dict:
    """Each input's spec: its logical axes under ``rules``, fitted."""
    return _tree2(lambda ax, t: _fit_spec(to_pspec(ax, rules), t.shape, mesh),
                  api.batch_axes(cfg, shape), specs)


def scale_policy(cfg: ModelConfig, mesh) -> Dict:
    defs = api.param_defs(cfg)
    nparams = count_params(defs)
    msize = _axis_prod(mesh, ("model",))
    fsdp = nparams * 2 / max(msize, 1) > FSDP_BYTES_PER_CHIP
    opt_name = "adafactor" if nparams > ADAFACTOR_PARAMS else "adamw"
    opt_kw = {"momentum": 0.0} if nparams > NO_MOMENTUM_PARAMS else {}
    accum = "bfloat16" if nparams > BF16_ACCUM_PARAMS else "float32"
    return {"nparams": nparams, "fsdp": fsdp, "opt_name": opt_name,
            "opt_kw": opt_kw, "accum": accum}


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for x in leaves(tree):
        if isinstance(x, torch.Tensor):
            loc = x.to_local() if isinstance(x, DTensor) else x
            total += loc.numel() * loc.element_size()
    return total


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               overrides: Optional[Dict] = None):
    """Run one (arch × shape) cell's step on ``mesh`` under the analyzer.
    Returns (stats, meta, memory)."""
    from torch.distributed.tensor.experimental import implicit_replication

    pol = scale_policy(cfg, mesh)
    if overrides:
        pol.update({k: v for k, v in overrides.items() if k in pol})
    rules = make_rules(mesh, api.sharding_dims(cfg), fsdp=pol["fsdp"])
    meta = {"rules": {k: str(v) for k, v in rules.items()},
            "nparams": pol["nparams"], "fsdp": pol["fsdp"],
            "optimizer": pol["opt_name"]}

    with axis_rules(mesh, rules):
        defs = api.param_defs(cfg)
        dtype = getattr(torch, cfg.param_dtype)
        aparams = abstract_params(defs, dtype)
        pspecs = param_pspecs(defs, rules)
        params = map_dicts(lambda t, s: place(t, s, mesh), aparams, pspecs)
        batch = api.input_specs(cfg, shape)
        bspecs = batch_shardings(cfg, shape, mesh, rules, batch)
        dbatch = _place_tree(batch, bspecs, mesh)
        args_bytes = _local_bytes(params) + _local_bytes(dbatch)

        if shape.kind == "train":
            opt = get_optimizer(pol["opt_name"], **pol["opt_kw"])
            astate = opt.init(aparams)
            ospecs = opt_state_pspecs(opt, pspecs, aparams, astate)
            state = _place_tree(astate, ospecs, mesh)
            args_bytes += _local_bytes(state)
            data_shards = _axis_prod(mesh, ("pod", "data"))
            n_micro = (overrides or {}).get("n_micro") or \
                auto_microbatches(cfg, shape, data_shards, fsdp=pol["fsdp"],
                                  nparams=pol["nparams"])
            tsc = TrainStepConfig(n_micro=n_micro, accum_dtype=pol["accum"])
            meta.update({"n_micro": n_micro, "accum": pol["accum"]})
            step = torch.zeros((), dtype=torch.int32, device="meta")
            fn = build_train_step(cfg, opt, tsc)
            run = lambda: fn(params, state, step, dbatch)  # noqa: E731
        elif shape.kind == "prefill":
            fn = build_prefill_step(cfg)
            run = lambda: fn(params, dbatch)  # noqa: E731
        else:
            fn = build_decode_step(cfg)
            run = lambda: fn(params, dbatch["tokens"],  # noqa: E731
                             dbatch["caches"])
        with implicit_replication(), hlo.analyze() as an:
            out = run()
    memory = {"argument_bytes": args_bytes,
              "output_bytes": _local_bytes(out),
              "temp_bytes": max(an.stats.peak_bytes - args_bytes, 0.0),
              "alias_bytes": 0,
              "peak_per_device": an.stats.peak_bytes}
    return an.stats, meta, memory


def _place_tree(tree, specs, mesh):
    """Every tensor of ``tree`` (dicts and NamedTuples) placed by the spec
    at the same place of ``specs``."""
    if isinstance(tree, dict):
        return {k: _place_tree(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, tuple):
        return type(tree)(*(_place_tree(t, s, mesh)
                            for t, s in zip(tree, specs)))
    return place(tree, specs, mesh)


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[Dict] = None, save: bool = True, *,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeSpec] = None, mesh=None) -> Dict:
    """One cell's record.  ``cfg``, ``shape`` and ``mesh`` replace the
    registry's config, ``SHAPES[shape_name]`` and the production mesh
    (reduced cells on a small fake mesh, as the tests run them)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(tuple(mesh.shape))
    t0 = time.time()
    stats, meta, mem_d = trace_cell(cfg, shape, mesh, overrides)
    t1 = time.time()
    terms = hlo.roofline_terms(stats, chips)
    mf = model_flops(cfg, shape)

    # the achievable ideal: the model's useful FLOPs at peak, or the bytes
    # that must move (parameters for every step; optimizer state for
    # train; the caches for decode), whichever binds
    p_bytes = _tree_bytes(abstract_params(api.param_defs(cfg),
                                          getattr(torch, cfg.param_dtype)))
    cache_bytes = 0
    if shape.kind != "train":
        cache_bytes = _tree_bytes(api.input_specs(cfg, shape).get(
            "caches", ())) or _tree_bytes(api.abstract_cache(
                cfg, shape.global_batch, shape.seq_len))
    if shape.kind == "train":
        opt_bytes = 2 * p_bytes
        min_bytes = 3 * p_bytes + 2 * opt_bytes
    else:
        min_bytes = p_bytes + cache_bytes
    # the model's products run in its parameters' and activations' type
    peak = hlo.peak_flops(torch.promote_types(
        getattr(torch, cfg.param_dtype), getattr(torch, cfg.act_dtype)))
    ideal_s = max(mf / peak / chips,
                  min_bytes / chips / hlo.HBM_BW)
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"],
                1e-30)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in tuple(mesh.shape)),
        "chips": chips,
        "kind": shape.kind,
        **meta,
        "memory": mem_d,
        "hlo": {
            "matmul_flops_per_device": stats.matmul_flops,
            "hbm_bytes_per_device": stats.hbm_bytes,
            "collective_bytes_per_device": stats.collective_bytes,
            "collective_counts": stats.collective_counts,
            "collective_by_op": stats.collective_by_op,
            "dot_calls": stats.dot_calls,
            "kernel_calls": stats.kernel_calls,
            "matmul_flops_f32_per_device": stats.matmul_flops_f32,
            "matmul_by_shape": stats.matmul_by_shape,
        },
        "roofline": {
            "compute_s": terms["compute_s"],
            "memory_s": terms["memory_s"],
            "collective_s": terms["collective_s"],
            "dominant": terms["dominant"],
            "model_flops_total": mf,
            "hlo_flops_total": stats.matmul_flops * chips,
            "useful_ratio": mf / max(stats.matmul_flops * chips, 1.0),
            "step_time_bound_s": bound,
            "ideal_s": ideal_s,
            "min_bytes_per_device": min_bytes / chips,
            "compute_fraction": (mf / peak / chips) / bound,
            "roofline_fraction": ideal_s / bound,
        },
        "trace_s": t1 - t0,
    }
    if save:
        sub = ART_DIR / rec["mesh"]
        sub.mkdir(parents=True, exist_ok=True)
        path = sub / f"{arch}__{shape_name}.json"
        path.write_text(json.dumps(rec, indent=1))
        rec["artifact"] = str(path)
    return rec


def _fmt(rec: Dict) -> str:
    r = rec["roofline"]
    return (f"{rec['arch']:>18s} × {rec['shape']:<12s} [{rec['mesh']}] "
            f"mem/dev={rec['memory']['peak_per_device']/1e9:6.2f}GB "
            f"C={r['compute_s']*1e3:9.2f}ms M={r['memory_s']*1e3:9.2f}ms "
            f"L={r['collective_s']*1e3:9.2f}ms dom={r['dominant']:<10s} "
            f"MFU*={r['roofline_fraction']*100:5.1f}% "
            f"(trace {rec['trace_s']:.0f}s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in all_configs():
            for sh in shape_cells(arch):
                cells.append((arch, sh.name))
    else:
        if not args.arch:
            ap.error("--arch required without --all")
        shapes = ([args.shape] if args.shape
                  else [s.name for s in shape_cells(args.arch)])
        cells = [(args.arch, s) for s in shapes]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    overrides = {"n_micro": args.n_micro} if args.n_micro else None
    failures = []
    for multi_pod in meshes:
        for arch, shape in cells:
            try:
                rec = run_cell(arch, shape, multi_pod, overrides,
                               save=not args.no_save)
                print(_fmt(rec), flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape, multi_pod, repr(e)))
                print(f"FAIL {arch} × {shape} multi_pod={multi_pod}: {e}",
                      flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")
    print("all dry-run cells passed")


if __name__ == "__main__":
    main()
