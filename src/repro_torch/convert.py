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
weights cross the same way: the reference's parameter tree with numpy
leaves becomes the port's nested dict of tensors, with the same keys and
the stacked ``(L, ...)`` layout (Whisper's nested encoder and decoder
stacks among them), and so does a Whisper decode cache.  Training state
crosses too: optimizer states (``AdamState``, ``FactoredState``,
``SketchyState`` with its per-leaf DS-FD states), the gradient monitor's
and the compression's states; the reference's single-stream DS-FD states
become the port's S = 1 states.

Under a mesh, ``split_experts`` cuts a one-device MoE tree's experts into
the virtual experts of a model axis (``models/layers/moe.py``), and
``local_params`` gives one process its block of every leaf under
``param_pspecs``, so that the port's expert-parallel processes and the
reference's ``moe_block`` under a mesh hold the same weights.
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
from repro_torch.models.layers.moe import virtual_split
from repro_torch.models.params import ParamDef, _leaves
from repro_torch.parallel.sharding import mesh_shape
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


def whisper_cache_from_reference(cache_np: Any, cfg: ModelConfig,
                                 device="cuda"):
    """The port's ``WhisperCache`` for ``cfg`` from the reference's, with
    numpy leaves (``jax.tree.map(np.asarray, cache)``): the stacked self
    cache (Ld, B, s_max, H, dh) and its lengths (Ld, B), and the cross K/V
    (Ld, B, enc_frames, H, dh), in their own types.  Raises on a
    misshapen leaf."""
    from repro_torch.models.layers.attention import KVCache
    from repro_torch.models.whisper import WhisperCache

    dev = resolve_device(device)
    kv = cache_np.self_kv
    Ld, H, dh = cfg.n_layers, cfg.n_heads, cfg.dh
    B, s_max = np.asarray(kv.k).shape[1:3]
    cross = (Ld, B, cfg.enc_frames, H, dh)
    want = {"k": (Ld, B, s_max, H, dh), "v": (Ld, B, s_max, H, dh),
            "length": (Ld, B), "cross_k": cross, "cross_v": cross}
    got = {"k": kv.k, "v": kv.v, "length": kv.length,
           "cross_k": cache_np.cross_k, "cross_v": cache_np.cross_v}
    out = {}
    for name, leaf in got.items():
        arr = np.asarray(leaf)
        if arr.shape != want[name]:
            raise ValueError(f"cache leaf {name} has shape {arr.shape}, "
                             f"expected {want[name]} for {cfg.name}")
        out[name] = _tensor(arr, dev)
    return WhisperCache(
        self_kv=KVCache(out["k"], out["v"], out["length"]),
        cross_k=out["cross_k"], cross_v=out["cross_v"])


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


# ---------------------------------------------------------------------------
# weights under a mesh: virtual experts and one process's block
# ---------------------------------------------------------------------------


def split_experts(params: dict, cfg: ModelConfig, msize: int) -> dict:
    """``params`` with each MoE layer's experts cut into the virtual
    experts of a model axis of ``msize``: expert e's FFN columns
    ``[s·Fv, (s+1)·Fv)`` become virtual expert ``e·split + s`` (``wg``,
    ``wu`` along F, ``wd`` along its rows), as the reference's virtual
    shapes lay them out.  Without a split (E ≥ msize) the tree is returned
    as it is.  Works on torch tensors and on numpy arrays."""
    split = virtual_split(cfg.moe, msize) if cfg.moe else 1
    if split == 1:
        return params
    lay = dict(params["layers"])
    for name in ("wg", "wu"):
        w = lay[name]                                   # (L, E, D, F)
        L, E, D, F = w.shape
        w = w.reshape(L, E, D, split, F // split)
        w = (w.permute(0, 1, 3, 2, 4) if isinstance(w, torch.Tensor)
             else w.transpose(0, 1, 3, 2, 4))
        lay[name] = w.reshape(L, E * split, D, F // split)
    w = lay["wd"]                                       # (L, E, F, D)
    L, E, F, D = w.shape
    lay["wd"] = w.reshape(L, E * split, F // split, D)
    return {**params, "layers": lay}


def mesh_coords(mesh) -> dict:
    """``{axis: this process's coordinate}`` on a ``DeviceMesh``."""
    return {a: int(mesh.get_local_rank(a)) for a in mesh.mesh_dim_names}


def local_block(d: ParamDef, rules, mesh, coords: dict) -> tuple:
    """The block (a slice a dimension) of leaf ``d`` that the process at
    ``coords`` holds under ``rules``: a dimension split over mesh axes
    (major to minor) is cut into equal blocks."""
    from repro_torch.parallel.sharding import to_pspec

    return block_of(d.shape, to_pspec(d.axes, rules), mesh, coords,
                    what=str(d))


def block_of(shape, spec, mesh, coords: dict, what: str = "a leaf") -> tuple:
    """The block (a slice a dimension) of an array of ``shape`` laid out by
    ``spec`` (a mesh axis, a tuple of them or None a dimension) that the
    process at ``coords`` holds."""
    sizes = mesh_shape(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, p in zip(shape, spec):
        if p is None:
            out.append(slice(0, n))
            continue
        idx, ways = 0, 1
        for a in (tuple(p) if isinstance(p, (tuple, list)) else (p,)):
            idx, ways = idx * sizes[a] + coords[a], ways * sizes[a]
        if n % ways:
            raise ValueError(f"dimension {n} of {what} does not split "
                             f"{ways} ways")
        out.append(slice(idx * (n // ways), (idx + 1) * (n // ways)))
    return tuple(out)


def local_params(params: dict, defs, rules, mesh, coords: dict) -> dict:
    """This process's block of every leaf of ``params`` (shaped as
    ``defs`` declares) under ``rules`` (``param_pspecs``): the weights an
    expert-parallel process holds."""
    out: dict = {}
    for path, d in _leaves(defs):
        leaf = params
        for key in path:
            leaf = leaf[key]
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf[local_block(d, rules, mesh, coords)]
    return out
