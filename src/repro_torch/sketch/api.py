"""The ``SlidingSketch`` API: one protocol and a registry, batched over streams.

Counterpart of ``repro/sketch/api.py`` for ``"fd"`` (fixed or adaptive
rank), ``"dsfd"``, ``"seq-dsfd"`` and ``"time-dsfd"``, with fleet
checkpoints (:func:`save_fleet`, :func:`restore_fleet`) in the reference's
on-disk format.  The protocol is
the reference's bundle of functions::

    sk = make_sketch("dsfd", d=64, eps=1/8, window=1024, mode="fast")
    state = sk.init()                               # one stream (S = 1)
    state = sk.update_block(state, rows, ts)        # (S, B, d), (B,) int32
    B_W   = sk.query(state, t)                      # (S, 2ℓ, d)

Every function takes and gives states whose tensors carry the stream axis
first, so a single sketch is a fleet of one; :func:`fleet_streams` builds
the fleet of S streams on one device, and :func:`query_cohort` answers
aggregate queries over any :class:`Cohort` of its streams from the
fleet's cached :class:`AggTree` (``sketch/query.py``).  The optional
fields are capabilities (``sketch/capability.py``): every variant scores
rows (``score``), adaptive-rank FD reports its ranks (``ranks``), fleets
answer cohorts (``query_cohort``), and a fleet with a history plane
answers intervals of retired window content (``query_interval``,
``sketch/history.py``).  The host baselines are not ported yet.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.dsfd import dsfd_init, dsfd_merge, dsfd_query_rows, \
    dsfd_score, dsfd_update, dsfd_update_block, make_config
from repro_torch.core.fd import adaptive_fd_init, adaptive_fd_merge, \
    adaptive_fd_update, fd_compress, fd_init, fd_merge, fd_update
from repro_torch.core.seq_dsfd import layered_init, layered_merge, \
    layered_query_rows, layered_space, layered_update, layered_update_block, \
    make_seq_config, make_time_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.mesh import local_device
from repro_torch.parallel.topology import PartitionedAggTree, \
    process_runtime
from repro_torch.sketch import capability
from repro_torch.sketch.basis import residual_scores
from repro_torch.sketch.query import ALL, AggTree, Cohort  # noqa: F401
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import tree_map


class SlidingSketch(NamedTuple):
    """The sliding-sketch protocol (see ``repro/sketch/api.py``).

    ``init(t0=1, streams=1)`` gives a fresh state of ``streams`` sketches;
    ``update(s, rows, t)`` absorbs one (S, d) row per stream;
    ``update_block(s, rows, ts)`` absorbs an (S, B, d) block;
    ``query_rows(s, t)`` gives the (S, ·, d) live rows, ``query(s, t)`` the
    (S, 2ℓ, d) compressed sketches, ``space(s)`` the (S,) live-row counts
    and ``merge(s1, s2, t)`` the stream-wise merge.  ``meta`` holds ``d``,
    ``eps``, ``window``, ``ell``, ``device`` and ``spec`` (the constructor
    arguments).

    Capabilities: ``query_cohort(s, cohort, t)`` (fleets), ``score(s, X,
    t=None)`` — the (S, n) residual anomaly scores of the rows of ``X``
    ((n, d), or (S, n, d) per stream) against each window's sketch basis —
    ``ranks(s)`` (adaptive-rank FD) and ``query_interval(s, t1, t2,
    cohort)`` (a fleet with a history plane, ``sketch/history.py``).
    """

    name: str
    meta: Dict[str, Any]
    init: Callable[..., Any]
    update: Callable[[Any, Any, Any], Any]
    update_block: Callable[[Any, Any, Any], Any]
    query_rows: Callable[..., Any]
    query: Callable[..., Any]
    space: Callable[[Any], Any]
    merge: Callable[..., Any]
    query_cohort: Optional[Callable[..., Any]] = None
    query_interval: Optional[Callable[..., Any]] = None
    score: Optional[Callable[..., Any]] = None
    ranks: Optional[Callable[..., Any]] = None


class FleetSpace(NamedTuple):
    """``per_stream`` (S,) live-row counts; ``cache_rows`` the rows held by
    the fleet's cached ``AggTree`` nodes; ``total`` their sum; ``ranks``
    the (S,) working ranks of an adaptive-rank fleet, else None."""

    per_stream: Any
    total: Any
    cache_rows: int
    ranks: Any = None


_REGISTRY: Dict[str, Callable[..., SlidingSketch]] = {}
_CACHE: Dict[Tuple, SlidingSketch] = {}


def register(name: str) -> Callable:
    """Register a builder ``fn(d, eps, window, *, device, **hyper)``."""

    def deco(fn: Callable[..., SlidingSketch]) -> Callable[..., SlidingSketch]:
        _REGISTRY[name] = fn
        return fn

    return deco


def available_sketches() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _copy_meta(sk: SlidingSketch) -> SlidingSketch:
    """A copy of ``meta`` for each caller, so no caller can change what a
    later ``make_sketch`` hit of the memo hands out (``spec`` one level
    deeper)."""
    meta = dict(sk.meta)
    spec = meta.get("spec")
    if spec is not None:
        meta["spec"] = dict(spec, hyper=dict(spec.get("hyper", {})))
    return sk._replace(meta=meta)


def make_sketch(name: str, *, d: int, eps: float = 1 / 8,
                window: int = 1024, device="cuda", **hyper) -> SlidingSketch:
    """Construct a registered variant; its states live on ``device`` (the
    card by default).  Memoized on its (hashable) arguments, as in the
    reference; every call gets its own ``meta``, which carries
    ``meta["spec"]``, the constructor arguments."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown sketch {name!r}; available: {available_sketches()}")
    dev = resolve_device(device)
    try:
        key = (name, int(d), float(eps), int(window), dev,
               tuple(sorted(hyper.items())))
        cached = _CACHE.get(key)
    except TypeError:           # unhashable hyperparameter → skip the memo
        key, cached = None, None
    if cached is not None:
        return _copy_meta(cached)
    sk = _REGISTRY[name](int(d), float(eps), int(window), device=dev,
                         **hyper)
    if sk.score is None:
        # every variant scores: the residual against its own query rows
        qr = sk.query_rows
        sk = sk._replace(score=lambda state, X, t=None: residual_scores(
            qr(state, t), X))
    sk = capability.install_missing(sk)
    sk.meta["spec"] = {"name": name, "d": int(d), "eps": float(eps),
                       "window": int(window), "hyper": dict(hyper)}
    if key is not None:
        _CACHE[key] = sk
    return _copy_meta(sk)


def _block_loop(update: Callable) -> Callable:
    """Lift a one-row ``update(state, rows, t)`` to a block absorb — the
    counterpart of the reference's jitted ``_block_scan``."""

    def update_block(state, rows, ts):
        rows = torch.as_tensor(rows)
        ts = torch.as_tensor(ts, dtype=torch.int32)
        if ts.dim() == 1:
            ts = ts.expand(rows.shape[0], rows.shape[1])
        for b in range(rows.shape[1]):
            state = update(state, rows[:, b], ts[:, b])
        return state

    return update_block


@register("fd")
def _make_fd(d: int, eps: float, window: int, *, device,
             adapt_target: Optional[float] = None, ell_min: int = 2,
             ell0: Optional[int] = None) -> SlidingSketch:
    """Plain FrequentDirections, no expiry: ``window`` is ignored.

    ``adapt_target`` opts into adaptive rank: the working rank ℓ of each
    stream grows or shrinks toward the relative error ``adapt_target``
    within ``[ell_min, 1/eps]``, starting at ``ell0`` (default
    ``ell_min``); ``ranks(state)`` reports it."""
    ell = int(min(max(round(1.0 / eps), 1), d))
    meta = {"d": d, "eps": eps, "window": window, "ell": ell,
            "device": device}
    ranks = None
    if adapt_target is None:
        def update(state, rows, t):
            del t
            return fd_update(state, torch.as_tensor(rows).to(device),
                             ell=ell)

        def merge(s1, s2, t=None):
            del t               # no expiry — whole-stream semantics
            return fd_merge(s1, s2, ell=ell)

        def init(t0=1, streams=1):
            return fd_init(ell, d, streams, device=device)
    else:
        lo = int(min(max(ell_min, 1), ell))
        start = lo if ell0 is None else int(min(max(ell0, lo), ell))
        kw = dict(target=float(adapt_target), ell_min=lo, ell_max=ell)
        meta["adapt"] = {"target": float(adapt_target), "ell_min": lo,
                         "ell_max": ell, "ell0": start}

        def update(state, rows, t):
            del t
            return adaptive_fd_update(
                state, torch.as_tensor(rows, dtype=torch.float32).to(device),
                **kw)

        def merge(s1, s2, t=None):
            del t
            return adaptive_fd_merge(s1, s2, **kw)

        def init(t0=1, streams=1):
            return adaptive_fd_init(ell, d, streams, ell0=start,
                                    device=device)

        def ranks(state):
            return state.ell

    def query_rows(state, t=None):
        del t
        return state.buf

    return SlidingSketch(
        name="fd",
        meta=meta,
        init=init,
        update=update,
        update_block=_block_loop(update),
        query_rows=query_rows,
        query=query_rows,       # the FD buffer is already the 2ℓ×d sketch
        space=lambda state: state.nbuf,
        merge=merge,
        ranks=ranks,
    )


@register("dsfd")
def _make_dsfd(d: int, eps: float, window: int, *, device, mode: str = "fast",
               beta: float = 4.0, use_kernel: bool = True) -> SlidingSketch:
    """DS-FD (Algorithms 2-4; ``mode`` picks the §3.1 cadence;
    ``use_kernel`` the krylov step's norm floor, see ``DSFDConfig``)."""
    cfg = make_config(d, eps, window, mode=mode, beta=beta,
                      use_kernel=use_kernel)

    def query_rows(state, t=None):
        return dsfd_query_rows(cfg, state, now=t)

    def space(state):
        return (state.main.snap_valid.sum(dim=1) + state.main.nbuf
                + state.aux.snap_valid.sum(dim=1) + state.aux.nbuf)

    return SlidingSketch(
        name="dsfd",
        meta={"d": d, "eps": eps, "window": window, "ell": cfg.ell,
              "device": device, "cfg": cfg},
        init=lambda t0=1, streams=1: dsfd_init(cfg, t0, streams,
                                               device=device),
        update=lambda state, rows, t: dsfd_update(cfg, state, rows, t),
        update_block=lambda state, rows, ts: dsfd_update_block(
            cfg, state, rows, ts),
        query_rows=query_rows,
        query=lambda state, t=None: fd_compress(query_rows(state, t),
                                                cfg.ell),
        space=space,
        merge=lambda s1, s2, t=None: dsfd_merge(cfg, s1, s2, now=t),
        score=lambda state, X, t=None: dsfd_score(cfg, state, X, now=t),
    )


def _make_layered(name: str, cfg, d: int, eps: float, window: int,
                  device) -> SlidingSketch:
    def query_rows(state, t=None):
        if t is None:
            raise ValueError(
                f"{name} queries need an explicit query time t (layer "
                "selection is time-dependent, Algorithm 7 line 1)")
        return layered_query_rows(cfg, state, t)

    return SlidingSketch(
        name=name,
        meta={"d": d, "eps": eps, "window": window, "ell": cfg.base.ell,
              "device": device, "cfg": cfg},
        init=lambda t0=1, streams=1: layered_init(cfg, t0, streams,
                                                  device=device),
        update=lambda state, rows, t: layered_update(cfg, state, rows, t),
        update_block=lambda state, rows, ts: layered_update_block(
            cfg, state, rows, ts),
        query_rows=query_rows,
        query=lambda state, t=None: fd_compress(query_rows(state, t),
                                                cfg.base.ell),
        space=layered_space,
        merge=lambda s1, s2, t=None: layered_merge(cfg, s1, s2, now=t),
    )


@register("seq-dsfd")
def _make_seq_dsfd(d: int, eps: float, window: int, *, device,
                   R: float = 64.0, beta: float = 4.0,
                   mode: str = "fast") -> SlidingSketch:
    """Seq-DS-FD (Algorithms 5-7): unnormalized rows ‖a‖² ∈ [1, R]."""
    cfg = make_seq_config(d, eps, window, R, beta=beta, mode=mode)
    return _make_layered("seq-dsfd", cfg, d, eps, window, device)


@register("time-dsfd")
def _make_time_dsfd(d: int, eps: float, window: int, *, device,
                    R: float = 64.0, beta: float = 4.0,
                    mode: str = "fast") -> SlidingSketch:
    """Time-DS-FD (§5): time-based windows, idle ticks are zero rows."""
    cfg = make_time_config(d, eps, window, R, beta=beta, mode=mode)
    return _make_layered("time-dsfd", cfg, d, eps, window, device)


def fleet_streams(sk: SlidingSketch, streams: int) -> SlidingSketch:
    """Lift a sketch to a fleet of ``streams`` independent streams on its
    device.

    Replaces the reference's ``vmap_streams`` (one fused XLA program over
    S): the port's functions already carry the stream axis, so the fleet
    differs from its base in ``init`` (S streams), ``space`` (a
    :class:`FleetSpace`) and ``query_cohort``, served from one
    :class:`AggTree` per fleet, created at its first use
    (:func:`agg_tree`).  :func:`shard_streams` is the reference's
    device-sharded fleet."""
    S = int(streams)
    if S < 1:
        raise ValueError(f"fleet size {S} < 1")
    box: Dict[str, AggTree] = {}

    def tree() -> AggTree:
        if "tree" not in box:
            box["tree"] = AggTree(sk, S)
        return box["tree"]

    def query_cohort(state, cohort=ALL, t=None):
        return tree().query(state, cohort, t)

    def space(state):
        per = sk.space(state)
        cache_rows = tree().space()
        ranks = sk.ranks(state) if capability.has(sk, "ranks") else None
        return FleetSpace(per_stream=per, total=per.sum() + cache_rows,
                          cache_rows=cache_rows, ranks=ranks)

    return capability.install_missing(sk._replace(
        name=f"fleet[{sk.name}x{S}]",
        meta=dict(sk.meta, streams=S, base=sk, agg_tree=tree),
        init=lambda t0=1: sk.init(t0, S),
        space=space,
        query_cohort=query_cohort,
    ))


def shard_streams(sk: SlidingSketch, streams: int, *, axis: str = "streams",
                  topology=None) -> SlidingSketch:
    """The reference's device-sharded fleet of ``streams``.

    PyTorch's idiom is one process a card, so without a ``topology`` this
    is the fleet on this process's one device (:func:`fleet_streams`),
    whose checkpoints record ``sharded: true`` over one device as the
    reference's do.  A fleet over several cards is a topology with one
    process a card: each process holds its own contiguous range
    ``[topology.lo, topology.hi)`` (state, ``update_block``, ``query``,
    ``score`` and ``ranks`` on local shapes), while ``query_cohort`` takes
    global cohorts and is a collective answered through a
    :class:`~repro_torch.parallel.topology.PartitionedAggTree`, the answer
    of the fleet nobody split.  Without a topology, a multi-process
    runtime is refused, as in the reference: a global-shape fleet would
    exist on no process."""
    S = int(streams)
    if topology is not None:
        return _shard_streams_topology(sk, S, axis, topology)
    world, _ = process_runtime()
    if world > 1:
        raise ValueError(
            f"shard_streams(streams={S}) in a multi-process runtime "
            f"(world_size={world}) needs a topology: this process's fleet "
            "covers only its own device, so a global-shape fleet state "
            "would exist on no process.  Pass topology=FleetTopology("
            "streams) (repro_torch.parallel.topology) so each process owns "
            "a contiguous stream range, or build a per-process private "
            "fleet with fleet_streams.")
    fleet = fleet_streams(sk, S)
    return fleet._replace(name=f"shard[{sk.name}x{S}/1]",
                          meta=dict(fleet.meta, devices=1, axis=axis))


def _shard_streams_topology(sk: SlidingSketch, S: int, axis: str,
                            topology) -> SlidingSketch:
    """This process's share of a topology fleet: the fleet of its
    ``topology.local_size`` streams, with ``query_cohort`` over global
    stream ids through the collective ``PartitionedAggTree``."""
    if topology.S != S:
        raise ValueError(
            f"topology covers {topology.S} streams but shard_streams was "
            f"asked for {S} — build both from the same fleet size")
    local = fleet_streams(sk, topology.local_size)
    box: Dict[str, PartitionedAggTree] = {}

    def tree() -> PartitionedAggTree:
        if "tree" not in box:
            box["tree"] = PartitionedAggTree(sk, topology)
        return box["tree"]

    def query_cohort(state, cohort=ALL, t=None):
        return tree().query(state, cohort, t)

    def space(state):
        per = sk.space(state)
        cache_rows = tree().space()
        ranks = sk.ranks(state) if capability.has(sk, "ranks") else None
        return FleetSpace(per_stream=per, total=per.sum() + cache_rows,
                          cache_rows=cache_rows, ranks=ranks)

    return local._replace(
        name=(f"topo[{sk.name}x{S}@{topology.pid}/{topology.P}"
              f":{topology.lo}-{topology.hi}]"),
        meta=dict(local.meta, streams=S, devices=1, axis=axis,
                  topology=topology, local_streams=topology.local_size,
                  local_range=(topology.lo, topology.hi), agg_tree=tree),
        space=space,
        query_cohort=query_cohort,
    )


def agg_tree(fleet: SlidingSketch):
    """The fleet's query-plane tree, created at its first use: for cache
    accounting and the engine's ``advance``.  A topology fleet's is its
    collective :class:`~repro_torch.parallel.topology.PartitionedAggTree`."""
    tree = fleet.meta.get("agg_tree")
    if tree is None:
        raise ValueError(f"agg_tree needs a fleet from fleet_streams or "
                         f"shard_streams, got {fleet.name!r}")
    return tree()


def query_cohort(fleet: SlidingSketch, state, cohort=ALL, t=None):
    """ONE merged (S = 1) base state over a :class:`Cohort` of the fleet's
    streams at query time ``t`` (compress it with
    ``fleet.meta["base"].query(g, t)``), served from the fleet's cached
    :class:`AggTree`: a warm query costs O(log S) node merges."""
    if (not capability.has(fleet, "query_cohort")
            or fleet.meta.get("base") is None):
        raise ValueError(f"query_cohort needs a fleet from fleet_streams, "
                         f"got {fleet.name!r}")
    return fleet.query_cohort(state, cohort, t)


def merge_streams(fleet: SlidingSketch, state, t=None):
    """Deprecated alias of ``query_cohort(fleet, state, ALL, t)``."""
    warnings.warn(
        "merge_streams(fleet, state, t) is deprecated — call "
        "query_cohort(fleet, state, ALL, t) (same merged state, served "
        "from the fleet's cached AggTree); the uncached O(S) reduction "
        "lives on as repro_torch.sketch.query.full_reduce_streams",
        DeprecationWarning, stacklevel=2)
    return query_cohort(fleet, state, ALL, t)


def query_interval(fleet: SlidingSketch, state, t1, t2, cohort=ALL):
    """ONE compressed (2ℓ, d) sketch of every row the ``cohort``'s streams
    ingested with a timestamp in ``[t1, t2)``, from the fleet's history
    plane of retired window content (``sketch/history.py``); a fleet
    without one raises with directions (the capability raiser)."""
    fn = fleet.query_interval
    if fn is None:
        fn = capability.missing("query_interval", fleet)
    return fn(state, t1, t2, cohort)


# ---------------------------------------------------------------------------
# Fleet persistence — the reference's checkpoint layout
# ---------------------------------------------------------------------------

class FleetCheckpoint(NamedTuple):
    """What :func:`restore_fleet` gives back: the rebuilt fleet, its state
    on the restoring device, the fleet clock at the save, the auxiliary
    host arrays saved beside it, the manifest, and every shard's manifest
    in stream order (the one manifest of a plain checkpoint)."""

    fleet: SlidingSketch
    state: Any
    t: int
    aux: Dict[str, np.ndarray]
    manifest: Dict[str, Any]
    shard_manifests: Tuple[Dict[str, Any], ...] = ()


def _spec_to_disk(base: SlidingSketch) -> Dict[str, Any]:
    """The base sketch's constructor arguments as the reference names
    them: ``use_kernel`` is written ``use_pallas``, and DS-FD records the
    value in force (the two packages' defaults differ)."""
    spec = base.meta.get("spec")
    if spec is None:
        raise ValueError(
            f"fleet base {base.name!r} has no construction spec — build it "
            "via make_sketch() so the checkpoint can name it in the "
            "registry")
    hyper = dict(spec.get("hyper", {}))
    hyper.pop("use_kernel", None)
    if spec["name"] == "dsfd":
        hyper["use_pallas"] = bool(base.meta["cfg"].use_kernel)
    return dict(spec, hyper=hyper)


def _spec_from_disk(spec: Dict[str, Any]) -> Dict[str, Any]:
    """``make_sketch`` keyword arguments from a checkpoint's sketch spec,
    either package's: ``use_pallas`` becomes ``use_kernel``, absent for
    DS-FD meaning the reference's default, False."""
    hyper = dict(spec.get("hyper", {}))
    if spec["name"] == "dsfd":
        hyper["use_kernel"] = bool(hyper.pop("use_pallas", False))
    return dict(d=spec["d"], eps=spec["eps"], window=spec["window"],
                **hyper)


def save_fleet(path: str, fleet: SlidingSketch, state, t, *,
               aux: Optional[Dict[str, np.ndarray]] = None,
               spec_extra: Optional[Dict[str, Any]] = None,
               keep: int = 3) -> str:
    """Atomic checkpoint of a fleet's state at clock ``t`` under ``path``,
    in the reference's layout (``train/checkpoint.py``): the state in the
    reference's tree and dtypes, and a ``sketch_spec`` manifest section
    naming the base sketch in the registry, the fleet size and the clock,
    so either package rebuilds the fleet from the checkpoint alone.  A
    :func:`shard_streams` fleet records ``sharded: true`` over its one
    device; a topology fleet writes this process's shard, a
    self-describing checkpoint under ``path/shard-LLLLLL-HHHHHH/``, beside
    its siblings' (:func:`restore_fleet` reassembles any process count).

    ``aux``: a flat ``{name: numpy array}`` of host extras saved in the
    same checkpoint (the engine's pending rows, index arrays);
    ``spec_extra``: JSON entries merged into the ``sketch_spec``
    section."""
    base = fleet.meta.get("base")
    if base is None:
        raise ValueError(f"save_fleet needs a fleet from fleet_streams or "
                         f"shard_streams, got {fleet.name!r}")
    aux = dict(aux or {})
    devices = fleet.meta.get("devices")
    topo = fleet.meta.get("topology")
    sketch_spec: Dict[str, Any] = {
        "sketch": _spec_to_disk(base),
        "streams": int(fleet.meta["streams"]),
        "sharded": devices is not None,
        "mesh_axis": fleet.meta.get("axis"),
        "mesh_devices": None if devices is None else int(devices),
        "t": int(t),
        "aux_keys": sorted(aux),
    }
    if topo is not None:
        sketch_spec["topology"] = topo.spec()
        sketch_spec["local_streams"] = int(topo.local_size)
        path = fleet_shard_dir(path, topo.lo, topo.hi)
    if spec_extra:
        sketch_spec.update(spec_extra)
    try:
        json.dumps(sketch_spec)
    except TypeError as e:
        raise ValueError(
            f"fleet checkpoint spec is not JSON-serializable ({e}); "
            "sketch hyperparameters and spec_extra must be plain "
            "scalars/strings") from e
    tree = {"aux": {k: np.asarray(aux[k]) for k in aux},
            "state": convert.fleet_state_to_numpy(base, state)}
    return ckpt.save(path, int(t), tree, sketch_spec=sketch_spec,
                     mesh_shape=None if devices is None else (int(devices),),
                     keep=keep)


def fleet_shard_dir(path: str, lo: int, hi: int) -> str:
    """A process's shard directory of a topology fleet's checkpoint."""
    return os.path.join(str(path), f"shard-{int(lo):06d}-{int(hi):06d}")


def _fleet_shards(path: str):
    """``[(lo, hi, dir)]`` of the shard checkpoints under ``path``, in
    stream order; ``[]`` for a plain fleet checkpoint."""
    try:
        entries = sorted(os.listdir(path))
    except (FileNotFoundError, NotADirectoryError):
        return []
    out = []
    for name in entries:
        m = re.fullmatch(r"shard-(\d{6})-(\d{6})", name)
        if m and os.path.isdir(os.path.join(path, name)):
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(path, name)))
    return out


def _fleet_spec_of(manifest, path) -> Dict[str, Any]:
    ss = manifest.get("sketch_spec")
    if not ss:
        raise ValueError(
            f"checkpoint under {path!r} has no sketch_spec manifest "
            "section — not a fleet checkpoint (train states restore via "
            "repro_torch.train.checkpoint.restore)")
    return ss


def _read_leaves(path: str, ss, step: int):
    """``(state, aux)`` of one checkpoint with numpy leaves: the state in
    the reference's tree, the aux arrays at their on-disk dtypes."""
    # only the structure of the template is read: one stream on the host
    spec = ss["sketch"]
    template = make_sketch(spec["name"], device="cpu",
                           **_spec_from_disk(spec)).init()
    tree_like = {"aux": {k: 0 for k in ss.get("aux_keys", [])},
                 "state": template}
    tree, _ = ckpt.restore(path, tree_like, step=step, device="cpu",
                           host_leaves=lambda p: True)
    return tree["state"], dict(tree["aux"])


def restore_fleet(path: str, *, step: Optional[int] = None, device="cuda",
                  topology=None) -> FleetCheckpoint:
    """Rebuild a fleet from a :func:`save_fleet` checkpoint of either
    package: the base sketch from the registry through the ``sketch_spec``
    section, the state on ``device`` (the card by default; under a
    ``topology``, this process's :func:`~repro_torch.launch.mesh.
    local_device`).  The ``aux`` arrays come back as numpy at their
    on-disk dtype (float64/int64 accumulators included).  Continuing from
    ``.state`` at clock ``.t`` is the same as never having stopped.

    Process elasticity, as in the reference: the process counts at the
    save and at the restore are independent.  A plain checkpoint restored
    under a ``topology`` gives this process's slice; the shards of a
    topology fleet (``shard-LLLLLL-HHHHHH/``) restored without one are
    gathered into one fleet; restored under another process count, the
    overlapping shards are sliced and concatenated.  Every leaf is an
    exact row slice, so every reassembly is bit for bit; ``aux`` arrays
    are concatenated in stream order (consumers filter by ownership)."""
    shards = _fleet_shards(path)
    if shards:
        sources = []
        for lo, hi, sdir in shards:
            manifest = ckpt.read_manifest(sdir, step=step)
            sources.append((lo, hi, sdir, manifest,
                            _fleet_spec_of(manifest, sdir)))
    else:
        manifest = ckpt.read_manifest(path, step=step)
        ss0 = _fleet_spec_of(manifest, path)
        sources = [(0, int(ss0["streams"]), path, manifest, ss0)]
    ss = sources[0][4]
    S, t = int(ss["streams"]), int(ss["t"])
    for _, _, sdir, _, ssi in sources:
        if ssi["sketch"] != ss["sketch"] or int(ssi["streams"]) != S:
            raise ValueError(
                f"shard {sdir!r} disagrees with its siblings on the fleet "
                "spec — shards of one checkpoint must come from one fleet")
        if int(ssi["t"]) != t:
            raise ValueError(
                f"shard {sdir!r} was saved at clock {ssi['t']} but its "
                f"siblings at {t} — processes must checkpoint the same "
                "tick (the engine checkpoint path is a collective)")
    spec = ss["sketch"]
    axis = ss.get("mesh_axis") or "streams"
    if topology is not None:
        if topology.S != S:
            raise ValueError(
                f"checkpoint holds {S} streams but the topology covers "
                f"{topology.S}")
        dev = local_device(topology, device)
        tlo, thi = topology.lo, topology.hi
    else:
        dev = resolve_device(device)
        tlo, thi = 0, S
    sk = make_sketch(spec["name"], device=dev, **_spec_from_disk(spec))
    fleet = (shard_streams(sk, S, axis=axis, topology=topology)
             if shards or topology is not None or ss.get("sharded")
             else fleet_streams(sk, S))

    # the overlapping shards in stream order, each sliced to [tlo, thi),
    # each from the step its manifest was read at (a save landing
    # meanwhile must not change which checkpoint the leaves come from);
    # the manifest handed back is the one of the shard holding stream tlo
    # (the reference hands every process the first shard's, so a history
    # engine's shard restores under its own partition only on process 0)
    cover = tlo
    pieces, aux_pieces, manifests = [], [], []
    for lo, hi, sdir, m, ssi in sources:             # in stream order
        if hi <= tlo or lo >= thi:
            continue
        if lo > cover:
            break
        cover = max(cover, hi)
        manifests.append(m)
        state_np, aux = _read_leaves(sdir, ssi, int(m["step"]))
        a, b = max(tlo, lo) - lo, min(thi, hi) - lo
        pieces.append(tree_map(lambda x: x[a:b], state_np))
        aux_pieces.append(aux)
    if cover < thi:
        raise ValueError(
            f"checkpoint under {path!r} has no shard covering streams "
            f"[{cover}, {thi}) — incomplete save (a process died before "
            "its shard landed?)")
    state_np = (pieces[0] if len(pieces) == 1 else
                tree_map(lambda *xs: np.concatenate(xs, axis=0), *pieces))
    aux_out: Dict[str, np.ndarray] = {}
    for k in sorted({k for p in aux_pieces for k in p}):
        vals = [p[k] for p in aux_pieces if k in p]
        aux_out[k] = vals[0] if len(vals) == 1 else np.concatenate(vals)
    state = convert.fleet_state_from_numpy(sk, state_np, dev)
    return FleetCheckpoint(fleet, state, t, aux_out, manifests[0],
                           tuple(src[3] for src in sources))
