"""The port's logical-axis sharding layer (``repro_torch.parallel.
sharding``) and every spec that reads it, held against the reference's.

For every config of ``all_configs()`` at the (16, 16), (2, 16, 16),
(2, 2) and (1, 4) meshes: ``make_rules`` (FSDP on and off),
``sharding_dims``, the parameter shapes and ``param_pspecs``,
``batch_axes`` and ``cache_axes`` of every ``SHAPES`` kind, and
``opt_state_pspecs`` of adamw, adafactor (with and without momentum) and
sgdm, as tuples.  The reference reads a mesh through ``mesh.shape``, so
its side runs under its own ``axis_rules`` with a stand-in whose
``.shape`` is the mesh's ``{axis: size}``; the port takes the dict
itself.  The reference's ``scale_policy`` and ``auto_microbatches`` come
from a subprocess, since importing ``repro.launch.dryrun`` fixes XLA's
host device count at 512 for the process.  Without a mesh ``constrain``
returns its argument: reduced llama, grok and whisper logits are bitwise
those of a plain-shape mesh of size 1.  Specs compare exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models.params import abstract_params as ref_abstract_params
from repro.models.params import param_pspecs as ref_param_pspecs
from repro.parallel import sharding as ref_sharding
from repro.train import optimizer as ref_opt
from repro_torch.configs.base import SHAPES, all_configs, get_config, \
    shape_cells
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import pin_host_threads
from repro_torch.models import api
from repro_torch.models.params import (_leaves, abstract_params,
                                       init_params, param_pspecs)
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import auto_microbatches

# torch's intra-op pool at this pytest worker's share of the cores
pin_host_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}}
ARCHS = sorted(all_configs())


class _Stand:
    """The reference's mesh as far as its rules read it: ``.shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _plain(x):
    """PartitionSpecs, NamedTuples and dicts as plain tuples and dicts."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, P):
        return tuple(_plain(e) for e in x)
    if isinstance(x, (tuple, list)):
        return tuple(_plain(e) for e in x)
    return x


def _spec(x):
    """A spec as a tuple whose one-axis tuples are the axis itself (a
    ``PartitionSpec`` writes ('data',) as 'data')."""
    return tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                 else (tuple(e) if isinstance(e, list) else e)
                 for e in x)


def _ref_flat(tree):
    """{path: spec tuple} of a reference tree whose leaves are specs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(k.key for k in path): _spec(v) for path, v in flat}


def _port_flat(tree, prefix=()):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_port_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = _spec(v)
    return out


def _both(arch, mesh, fsdp):
    """(reference rules, dims; port rules, dims) under each one's mesh."""
    stand = _Stand(mesh)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    with ref_sharding.axis_rules(stand, {}):
        rdims = ref_api.sharding_dims(rcfg)
    with sharding.axis_rules(mesh, {}):
        dims = api.sharding_dims(cfg)
    return (ref_sharding.make_rules(stand, rdims, fsdp=fsdp), rdims,
            sharding.make_rules(mesh, dims, fsdp=fsdp), dims)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_rules_and_dims(mesh, fsdp):
    for arch in ARCHS:
        rrules, rdims, rules, dims = _both(arch, MESHES[mesh], fsdp)
        assert dims == rdims, arch
        assert rules == rrules, arch
        for axes in (("batch", "seq", "embed"), ("vocab", "embed"),
                     ("batch", "kv_seq", "kv", None), ("embed", "batch"),
                     (None, "experts", "embed", "expert_ff")):
            assert _spec(sharding.to_pspec(axes, rules)) == _spec(
                ref_sharding.to_pspec(axes, rrules)), (arch, axes)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_shapes_and_pspecs(mesh):
    m = MESHES[mesh]
    stand = _Stand(m)
    for arch in ARCHS:
        rrules, _, rules, _ = _both(arch, m, arch in ("grok-1-314b",
                                                      "kimi-k2-1t-a32b"))
        with ref_sharding.axis_rules(stand, rrules):
            rdefs = ref_api.param_defs(ref_get_config(arch))
            rspecs = _ref_flat(ref_param_pspecs(rdefs, rrules))
            rshapes = {tuple(k.key for k in path): tuple(d.shape)
                       for path, d in jax.tree_util.tree_flatten_with_path(
                           rdefs, is_leaf=lambda x: hasattr(x, "axes"))[0]}
        with sharding.axis_rules(m, rules):
            defs = api.param_defs(get_config(arch))
            specs = _port_flat(param_pspecs(defs, rules))
            shapes = {path: tuple(d.shape) for path, d in _leaves(defs)}
        assert shapes == rshapes, arch
        assert specs == rspecs, arch


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_batch_and_cache_axes(kind):
    for arch in ARCHS:
        rcfg, cfg = ref_get_config(arch), get_config(arch)
        from repro.configs.base import SHAPES as REF_SHAPES
        assert _plain(api.batch_axes(cfg, SHAPES[kind])) == _plain(
            ref_api.batch_axes(rcfg, REF_SHAPES[kind])), arch
        assert _plain(api.cache_axes(cfg)) == _plain(
            ref_api.cache_axes(rcfg)), arch


OPTS = [("adamw", {}), ("adafactor", {}), ("adafactor", {"momentum": 0.0}),
        ("sgdm", {})]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_opt_state_pspecs(mesh):
    m = MESHES[mesh]
    stand = _Stand(m)
    for arch in ARCHS:
        rrules, _, rules, _ = _both(arch, m, False)
        with ref_sharding.axis_rules(stand, rrules):
            rdefs = ref_api.param_defs(ref_get_config(arch))
            rps = ref_param_pspecs(rdefs, rrules)
            rap = ref_abstract_params(rdefs)
        with sharding.axis_rules(m, rules):
            defs = api.param_defs(get_config(arch))
            ps = param_pspecs(defs, rules)
            ap = abstract_params(defs)
        for name, kw in OPTS:
            ropt = ref_opt.get_optimizer(name, **kw)
            rstate = jax.eval_shape(ropt.init, rap)
            rspec = ref_opt.opt_state_pspecs(ropt, rps, rap, rstate)
            opt = opt_mod.get_optimizer(name, **kw)
            spec = opt_mod.opt_state_pspecs(opt, ps, ap, opt.init(ap))
            if hasattr(rspec, "_fields"):
                assert type(spec).__name__ == type(rspec).__name__
                for f in rspec._fields:
                    assert _port_flat(getattr(spec, f)) == _ref_flat(
                        getattr(rspec, f)), (arch, name, kw, f)
            else:
                assert _port_flat(spec) == _ref_flat(rspec), (arch, name)


_POLICY = r"""
import json, sys
import repro.launch.dryrun as D
from repro.configs.base import all_configs, shape_cells
from repro.train.train_step import auto_microbatches


class Stand:
    def __init__(self, shape):
        self.shape = shape


out = {}
for mname, shape in json.loads(sys.argv[1]).items():
    mesh = Stand(shape)
    for arch in all_configs():
        pol = D.scale_policy(D.get_config(arch), mesh)
        ds = D._axis_prod(mesh, ("pod", "data"))
        for sh in shape_cells(arch):
            n = auto_microbatches(D.get_config(arch), sh, ds,
                                  fsdp=pol["fsdp"], nparams=pol["nparams"])
            out[f"{mname}/{arch}/{sh.name}"] = [pol, n]
print(json.dumps(out))
"""


def test_scale_policy_and_n_micro_match_the_reference():
    meshes = {k: MESHES[k] for k in ("16x16", "2x16x16")}
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _POLICY,
                          json.dumps(meshes)], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = {}
    for mname, shape in meshes.items():
        for arch in ARCHS:
            pol = dryrun.scale_policy(get_config(arch), shape)
            ds = dryrun._axis_prod(shape, ("pod", "data"))
            for sh in shape_cells(arch):
                n = auto_microbatches(get_config(arch), sh, ds,
                                      fsdp=pol["fsdp"],
                                      nparams=pol["nparams"])
                got[f"{mname}/{arch}/{sh.name}"] = [pol, n]
    assert got == want


@pytest.mark.parametrize("arch", ["llama3-8b", "grok-1-314b",
                                  "whisper-large-v3"])
def test_constrain_is_a_no_op_without_a_mesh(arch):
    cfg = get_config(arch).reduced()
    params = init_params(api.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(0.1 * rng.standard_normal(
            (2, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    x = torch.ones(2, 3)
    assert sharding.constrain(x, "batch", "embed") is x
    assert sharding.constrain_divisible(x, "batch", "embed") is x
    with torch.no_grad():
        want, _ = api.forward_train(cfg, params, batch)
        plain = {"data": 1, "model": 1}
        rules = sharding.make_rules(plain, api.sharding_dims(cfg))
        with sharding.axis_rules(plain, rules):
            assert sharding.constrain(x, "batch", "embed") is x
            got, _ = api.forward_train(cfg, params, batch)
    assert torch.equal(got, want)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    rules = {"batch": ("pod", "data"), "heads": "model", "embed": None}
    pl = sharding.placements(("batch", None, "heads"), Mesh(), rules)
    assert pl == [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements(("embed",), Mesh(), rules) == [
        Replicate(), Replicate(), Replicate()]
    assert sharding.placements(("batch",)) is None          # no mesh
    assert sharding.fit_spec(("model", None), (6, 4), {"model": 4}) == \
        (None, None)
