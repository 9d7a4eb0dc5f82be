"""Carry configurations, states and weights between the reference and the
port.

The reference's ``DSFDState`` is a pytree of per-stream arrays; a fleet's
state carries a leading stream axis S on every leaf, a layered (Seq- or
Time-DS-FD) stack a level axis L, and a layered fleet both (S, L).  These
functions take and give those states, and fixed- and adaptive-rank FD
states, with numpy leaves (``jax.tree.map(np.asarray, s)`` on the reference side), so
nothing here imports the reference.  The field names and order of the
states are the reference's, and ``fleet_state_to_numpy`` /
``fleet_state_from_numpy`` carry any registered variant's fleet state in
the reference's tree and dtypes (the leaves of a fleet checkpoint).  Model
weights
cross the same way: the reference's parameter tree with numpy leaves
becomes the port's nested dict of tensors, with the same keys and the
stacked ``(L, ...)`` layout.  Training state crosses too: optimizer
states (``AdamState``, ``FactoredState``, ``SketchyState`` with its
per-leaf DS-FD states), the gradient monitor's and the compression's
states; the reference's single-stream DS-FD states become the port's
S = 1 states.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsfd import DSFDConfig, DSFDState, SketchState, \
    make_config
from repro_torch.core.fd import AdaptiveFDState, FDState
from repro_torch.core.seq_dsfd import LayeredConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import api
from repro_torch.models.params import ParamDef
from repro_torch.tree import map_dicts

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


def layered_config_from_reference(cfg: Any) -> LayeredConfig:
    """The port's config for a reference ``LayeredConfig``."""
    return LayeredConfig(base=config_from_reference(cfg.base),
                         thetas=tuple(float(x) for x in cfg.thetas),
                         swap_energies=tuple(float(x)
                                             for x in cfg.swap_energies))


def _shapes(cfg: DSFDConfig, lead: tuple) -> dict:
    return {"buf": lead + (cfg.m, cfg.d), "snap_v": lead + (cfg.cap, cfg.d),
            "snap_s": lead + (cfg.cap,), "snap_t": lead + (cfg.cap,),
            "snap_valid": lead + (cfg.cap,)}


def _sketch_from_numpy(cfg, sk, lead: tuple, dev) -> SketchState:
    shapes = _shapes(cfg, lead)
    out = {}
    for name, leaf in zip(SketchState._fields, sk):
        arr = np.asarray(leaf)
        want = shapes.get(name, lead)
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
    lead = np.asarray(leaves.main.nbuf).shape[:1]
    return DSFDState(main=_sketch_from_numpy(cfg, leaves.main, lead, dev),
                     aux=_sketch_from_numpy(cfg, leaves.aux, lead, dev))


def _numpy(state):
    return type(state)(*(_numpy(x) if isinstance(x, tuple)
                         else x.detach().cpu().numpy() for x in state))


def dsfd_state_to_numpy(state: DSFDState) -> DSFDState:
    """The same state with numpy leaves (field order of the reference, so
    ``repro.core.dsfd.SketchState(*s.main)`` rebuilds it there)."""
    return _numpy(state)


def layered_state_from_numpy(cfg: LayeredConfig, leaves: Any,
                             device="cuda") -> DSFDState:
    """The port's (S, L, …) layered state from a reference layered state
    with numpy leaves: one stack (L, …), which becomes S = 1, or a fleet
    (S, L, …)."""
    dev = resolve_device(device)
    one = np.asarray(leaves.main.nbuf).ndim == 1

    def conv(sk):
        arrs = [np.asarray(x)[None] if one else np.asarray(x) for x in sk]
        return _sketch_from_numpy(cfg.base, arrs, arrs[1].shape[:1]
                                  + (cfg.levels,), dev)

    return DSFDState(main=conv(leaves.main), aux=conv(leaves.aux))


def layered_state_to_numpy(state: DSFDState, *,
                           fleet: bool = True) -> DSFDState:
    """The same (S, L, …) state with numpy leaves; ``fleet=False`` gives
    the reference's one-stack layout (L, …) of an S = 1 state."""
    out = _numpy(state)
    if fleet:
        return out
    if out.main.nbuf.shape[0] != 1:
        raise ValueError(f"one stack needs S = 1, got "
                         f"S = {out.main.nbuf.shape[0]}")
    return DSFDState(*(SketchState(*(x[0] for x in sk)) for sk in out))


def adaptive_state_from_numpy(leaves: Any, device="cuda") -> AdaptiveFDState:
    """The port's adaptive-rank FD state from a reference
    ``AdaptiveFDState`` with numpy leaves: one sketch (``buf`` (2ℓ, d)),
    which becomes S = 1, or a fleet (S, …)."""
    dev = resolve_device(device)
    one = np.asarray(leaves.buf).ndim == 2
    out = {}
    for name, leaf in zip(AdaptiveFDState._fields, leaves):
        arr = np.array(leaf)[None] if one else np.array(leaf)
        dtype = torch.int32 if name in ("nbuf", "ell") else torch.float32
        out[name] = torch.from_numpy(arr).to(device=dev, dtype=dtype)
    S = out["buf"].shape[0]
    for name, x in out.items():
        if name != "buf" and x.shape != (S,):
            raise ValueError(f"state leaf {name} has shape "
                             f"{tuple(x.shape)}, expected ({S},)")
    return AdaptiveFDState(**out)


def adaptive_state_to_numpy(state: AdaptiveFDState) -> AdaptiveFDState:
    """The same adaptive-rank state with numpy leaves (S, …)."""
    return _numpy(state)


def fd_state_from_numpy(leaves: Any, device="cuda") -> FDState:
    """The port's fixed-rank FD state from a reference ``FDState`` with
    numpy leaves: one sketch (``buf`` (2ℓ, d)), which becomes S = 1, or a
    fleet (S, …)."""
    dev = resolve_device(device)
    one = np.asarray(leaves.buf).ndim == 2
    out = {}
    for name, leaf in zip(FDState._fields, leaves):
        arr = np.array(leaf)[None] if one else np.array(leaf)
        dtype = torch.int32 if name == "nbuf" else torch.float32
        out[name] = torch.from_numpy(arr).to(device=dev, dtype=dtype)
    S = out["buf"].shape[0]
    for name in ("nbuf", "shed"):
        if out[name].shape != (S,):
            raise ValueError(f"state leaf {name} has shape "
                             f"{tuple(out[name].shape)}, expected ({S},)")
    return FDState(**out)


_FLOATS = frozenset(("buf", "sig1", "energy", "snap_v", "shed",
                     "shed_mark", "energy_mark"))


def _reference_dtype(name: str) -> torch.dtype:
    """The dtype the reference gives the state field ``name``."""
    if name == "snap_valid":
        return torch.bool
    return torch.float32 if name in _FLOATS else torch.int32


def fleet_state_to_numpy(sk, state):
    """A fleet state of the variant ``sk`` (any registered one) with numpy
    leaves in the reference's tree, field order and dtypes: the state part
    of a fleet checkpoint, which the reference restores as its own."""

    def conv(x):
        if isinstance(x, tuple):
            return type(x)(*(conv(v) if isinstance(v, tuple) else
                             v.detach().to(_reference_dtype(f)).cpu().numpy()
                             for f, v in zip(x._fields, x)))
        raise TypeError(f"{sk.name} state is not a NamedTuple: {type(x)}")

    return conv(state)


def fleet_state_from_numpy(sk, leaves: Any, device="cuda"):
    """The port's fleet state of the variant ``sk`` from the reference's
    fleet state with numpy leaves (S, …); shapes are checked against the
    variant's configuration."""
    meta = sk.meta
    if isinstance(meta.get("cfg"), LayeredConfig):
        return layered_state_from_numpy(meta["cfg"], leaves, device)
    if isinstance(meta.get("cfg"), DSFDConfig):
        return dsfd_state_from_numpy(meta["cfg"], leaves, device)
    if meta.get("adapt") is not None:
        st = adaptive_state_from_numpy(leaves, device)
        want = 2 * meta["adapt"]["ell_max"]
    else:
        st = fd_state_from_numpy(leaves, device)
        want = 2 * min(meta["ell"], meta["d"])
    if tuple(st.buf.shape[1:]) != (want, meta["d"]):
        raise ValueError(f"state leaf buf has shape {tuple(st.buf.shape)}, "
                         f"expected (S, {want}, {meta['d']})")
    return st


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
    the same keys (``embed``, ``final_norm``, ``lm_head``, ``layers/...``,
    the MoE family's router and expert stacks ``wr``, ``wg``, ``wu``,
    ``wd`` among them), shapes and types.  Raises on a missing, extra or
    misshapen leaf."""
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


# ---------------------------------------------------------------------------
# Training state: optimizer, monitor and compression states
# ---------------------------------------------------------------------------


def _tensors(tree, dev):
    """Nested dicts of numpy leaves as tensors on ``dev``."""
    return map_dicts(lambda x: _tensor(x, dev), tree)


def one_dsfd_state_from_numpy(cfg: DSFDConfig, leaves: Any,
                              device="cuda") -> DSFDState:
    """The port's S = 1 state from the reference's state of one DS-FD
    sketch (no stream axis) with numpy leaves."""
    lead = DSFDState(*(SketchState(*(np.asarray(x)[None] for x in sk))
                       for sk in leaves))
    return dsfd_state_from_numpy(cfg, lead, device)


def opt_state_from_reference(state: Any, device="cuda", *,
                             sketchy: Any = None):
    """An optimizer state of the reference (numpy leaves) as the port's:
    ``AdamState`` and ``FactoredState`` field by field (the bf16 momentum
    stays bf16), ``sgdm``'s plain tree, and ``SketchyState`` — whose
    per-leaf DS-FD states need the ``SketchyConfig`` that made them."""
    from repro_torch.train.optimizer import AdamState, FactoredState

    dev = resolve_device(device)
    name = type(state).__name__
    if name == "AdamState":
        return AdamState(*(_tensors(x, dev) for x in state))
    if name == "FactoredState":
        return FactoredState(*(_tensors(x, dev) for x in state))
    if name == "SketchyState":
        from repro_torch.sketch.sketchy import SketchyState
        if sketchy is None:
            raise ValueError("a SketchyState needs its SketchyConfig")

        def sk(leaf):
            if leaf is None:
                return None
            d = np.asarray(leaf.main.buf).shape[-1]
            cfg = make_config(d, sketchy.eps,
                              sketchy.window * sketchy.summary_rows,
                              mode="fast")
            return one_dsfd_state_from_numpy(cfg, leaf, dev)

        return SketchyState(sketch=map_dicts(sk, state.sketch),
                            diag=_tensors(state.diag, dev),
                            mom=_tensors(state.mom, dev))
    if isinstance(state, dict):
        return _tensors(state, dev)
    raise TypeError(f"unknown optimizer state {name}")


def monitor_state_from_reference(cfg: Any, state: Any,
                                 device="cuda") -> dict:
    """The gradient monitor's state (``sketch/monitor.py``) from the
    reference's, for the port's ``SketchConfig`` ``cfg``."""
    dev = resolve_device(device)
    dcfg = make_config(cfg.d, cfg.eps, cfg.window, mode=cfg.mode)
    return {"dsfd": one_dsfd_state_from_numpy(dcfg, state["dsfd"], dev),
            "norm_hist": _tensor(state["norm_hist"], dev)}


def compress_state_from_reference(cfg: Any, state: Any,
                                  device="cuda") -> dict:
    """The gradient compression's state (``sketch/compress.py``) from the
    reference's, for the port's ``CompressConfig`` ``cfg``."""
    dev = resolve_device(device)

    def leaf(st):
        if st is None:
            return None
        d = np.asarray(st["err"]).shape[-1]
        return {"dsfd": one_dsfd_state_from_numpy(cfg.dsfd(d), st["dsfd"],
                                                  dev),
                "err": _tensor(st["err"], dev),
                "step": _tensor(st["step"], dev)}

    def walk(tree):
        if isinstance(tree, dict) and "err" not in tree:
            return {k: walk(v) for k, v in tree.items()}
        return leaf(tree)          # a leaf's state is itself a dict

    return walk(state)
