"""Carry configurations, states and weights between the reference and the
port.

The reference's ``DSFDState`` is a pytree of per-stream arrays; a fleet's
state carries a leading stream axis S on every leaf.  These functions take
and give that state with numpy leaves (``jax.tree.map(np.asarray, s)`` on
the reference side), so nothing here imports the reference.  The field
names and order of ``SketchState`` are the reference's.  Model weights
cross the same way: the reference's parameter tree with numpy leaves
becomes the port's nested dict of tensors, with the same keys and the
stacked ``(L, ...)`` layout.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsfd import DSFDConfig, DSFDState, SketchState
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import api
from repro_torch.models.params import ParamDef

_DTYPES = {"buf": torch.float32, "sig1": torch.float32,
           "energy": torch.float32, "snap_v": torch.float32,
           "snap_valid": torch.bool}


def config_from_reference(cfg: Any) -> DSFDConfig:
    """The port's config for a reference ``DSFDConfig`` (``use_pallas``
    becomes ``use_kernel``)."""
    return DSFDConfig(d=int(cfg.d), ell=int(cfg.ell), window=int(cfg.window),
                      cap=int(cfg.cap), mode=str(cfg.mode),
                      power_iters=int(cfg.power_iters),
                      use_kernel=bool(cfg.use_pallas))


def config_to_reference_fields(cfg: DSFDConfig) -> dict:
    """Keyword arguments of the reference's ``DSFDConfig`` for ``cfg``."""
    return dict(d=cfg.d, ell=cfg.ell, window=cfg.window, cap=cfg.cap,
                mode=cfg.mode, power_iters=cfg.power_iters,
                use_pallas=cfg.use_kernel)


def _shapes(cfg: DSFDConfig, S: int) -> dict:
    return {"buf": (S, cfg.m, cfg.d), "snap_v": (S, cfg.cap, cfg.d),
            "snap_s": (S, cfg.cap), "snap_t": (S, cfg.cap),
            "snap_valid": (S, cfg.cap)}


def _sketch_from_numpy(cfg, sk, S, dev) -> SketchState:
    shapes = _shapes(cfg, S)
    out = {}
    for name, leaf in zip(SketchState._fields, sk):
        arr = np.asarray(leaf)
        want = shapes.get(name, (S,))
        if arr.shape != want:
            raise ValueError(f"state leaf {name} has shape {arr.shape}, "
                             f"expected {want} for this config")
        out[name] = torch.from_numpy(np.array(arr)).to(
            device=dev, dtype=_DTYPES.get(name, torch.int32))
    return SketchState(**out)


def dsfd_state_from_numpy(cfg: DSFDConfig, leaves: Any,
                          device="cuda") -> DSFDState:
    """The port's state from a reference ``DSFDState`` whose leaves are
    numpy arrays with a leading stream axis S."""
    dev = resolve_device(device)
    S = int(np.asarray(leaves.main.nbuf).shape[0])
    return DSFDState(main=_sketch_from_numpy(cfg, leaves.main, S, dev),
                     aux=_sketch_from_numpy(cfg, leaves.aux, S, dev))


def dsfd_state_to_numpy(state: DSFDState) -> DSFDState:
    """The same state with numpy leaves (field order of the reference, so
    ``repro.core.dsfd.SketchState(*s.main)`` rebuilds it there)."""
    def conv(sk):
        return SketchState(*(x.detach().cpu().numpy() for x in sk))
    return DSFDState(main=conv(state.main), aux=conv(state.aux))


def _tensor(arr, dev) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":        # ml_dtypes, which torch lacks
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def model_params_from_reference(params_np: Any, cfg: ModelConfig,
                                device="cuda") -> dict:
    """The port's parameters for ``cfg`` from the reference's parameter
    tree with numpy leaves (``jax.tree.map(np.asarray, init_params(...))``):
    the same keys (``embed``, ``final_norm``, ``lm_head``, ``layers/...``),
    shapes and types.  Raises on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)

    def conv(defs, tree, path):
        if isinstance(defs, ParamDef):
            arr = np.asarray(tree)
            if arr.shape != tuple(defs.shape):
                raise ValueError(f"parameter {path} has shape {arr.shape}, "
                                 f"expected {defs.shape} for {cfg.name}")
            return _tensor(arr, dev)
        if set(defs) != set(tree):
            raise ValueError(
                f"parameters at {path or '/'} have keys {sorted(tree)}, "
                f"expected {sorted(defs)} for {cfg.name}")
        return {k: conv(defs[k], tree[k], f"{path}/{k}") for k in defs}

    return conv(api.param_defs(cfg), params_np, "")
