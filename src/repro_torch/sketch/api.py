"""The ``SlidingSketch`` API: one protocol and a registry, batched over streams.

Counterpart of ``repro/sketch/api.py`` for ``"fd"`` and ``"dsfd"``.  The
protocol is the reference's bundle of functions::

    sk = make_sketch("dsfd", d=64, eps=1/8, window=1024, mode="fast")
    state = sk.init()                               # one stream (S = 1)
    state = sk.update_block(state, rows, ts)        # (S, B, d), (B,) int32
    B_W   = sk.query(state, t)                      # (S, 2ℓ, d)

Every function takes and gives states whose tensors carry the stream axis
first, so a single sketch is a fleet of one; :func:`fleet_streams` builds
the fleet of S streams on one device.  Capabilities, scoring and
checkpoints are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.dsfd import dsfd_init, dsfd_merge, dsfd_query_rows, \
    dsfd_update, dsfd_update_block, make_config
from repro_torch.core.fd import fd_compress, fd_init, fd_merge, fd_update
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.sketch.query import merge_all


class SlidingSketch(NamedTuple):
    """The sliding-sketch protocol (see ``repro/sketch/api.py``).

    ``init(t0=1, streams=1)`` gives a fresh state of ``streams`` sketches;
    ``update(s, rows, t)`` absorbs one (S, d) row per stream;
    ``update_block(s, rows, ts)`` absorbs an (S, B, d) block;
    ``query_rows(s, t)`` gives the (S, ·, d) live rows, ``query(s, t)`` the
    (S, 2ℓ, d) compressed sketches, ``space(s)`` the (S,) live-row counts
    and ``merge(s1, s2, t)`` the stream-wise merge.  ``meta`` holds ``d``,
    ``eps``, ``window``, ``ell`` and ``device``.
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


class FleetSpace(NamedTuple):
    """``per_stream`` (S,) live-row counts, ``total`` their sum plus
    ``cache_rows`` (rows held by a query cache; 0 until the cohort cache
    is ported)."""

    per_stream: Any
    total: Any
    cache_rows: int


_REGISTRY: Dict[str, Callable[..., SlidingSketch]] = {}


def register(name: str) -> Callable:
    """Register a builder ``fn(d, eps, window, *, device, **hyper)``."""

    def deco(fn: Callable[..., SlidingSketch]) -> Callable[..., SlidingSketch]:
        _REGISTRY[name] = fn
        return fn

    return deco


def available_sketches() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_sketch(name: str, *, d: int, eps: float = 1 / 8,
                window: int = 1024, device="cuda", **hyper) -> SlidingSketch:
    """Construct a registered variant; its states live on ``device`` (the
    card by default)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown sketch {name!r}; available: {available_sketches()}")
    dev = resolve_device(device)
    return _REGISTRY[name](int(d), float(eps), int(window), device=dev,
                           **hyper)


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
def _make_fd(d: int, eps: float, window: int, *, device) -> SlidingSketch:
    """Plain FrequentDirections, no expiry: ``window`` is ignored."""
    ell = int(min(max(round(1.0 / eps), 1), d))

    def update(state, rows, t):
        del t
        return fd_update(state, torch.as_tensor(rows).to(device), ell=ell)

    def query_rows(state, t=None):
        del t
        return state.buf

    return SlidingSketch(
        name="fd",
        meta={"d": d, "eps": eps, "window": window, "ell": ell,
              "device": device},
        init=lambda t0=1, streams=1: fd_init(ell, d, streams, device=device),
        update=update,
        update_block=_block_loop(update),
        query_rows=query_rows,
        query=query_rows,       # the FD buffer is already the 2ℓ×d sketch
        space=lambda state: state.nbuf,
        merge=lambda s1, s2, t=None: fd_merge(s1, s2, ell=ell),
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
    )


def fleet_streams(sk: SlidingSketch, streams: int) -> SlidingSketch:
    """Lift a sketch to a fleet of ``streams`` independent streams on its
    device.

    Replaces the reference's ``vmap_streams`` (one fused XLA program over
    S) and ``shard_streams`` (the same over a device mesh): the port's
    functions already carry the stream axis, so the fleet differs from
    its base only in ``init`` (S streams) and ``space`` (a
    :class:`FleetSpace`); :func:`query_all` merges its streams.  Cohort
    queries and the multi-device fleet are not ported yet."""
    S = int(streams)
    if S < 1:
        raise ValueError(f"fleet size {S} < 1")

    def space(state):
        per = sk.space(state)
        return FleetSpace(per_stream=per, total=per.sum(), cache_rows=0)

    return sk._replace(
        name=f"fleet[{sk.name}x{S}]",
        meta=dict(sk.meta, streams=S, base=sk),
        init=lambda t0=1: sk.init(t0, S),
        space=space,
    )


def query_all(fleet: SlidingSketch, state, t=None):
    """ONE base state (S = 1) merging every stream of a fleet at query
    time ``t`` — the reference's ``query_cohort(fleet, state, ALL, t)``,
    with the same merge association (``repro_torch.sketch.query``)."""
    return merge_all(fleet.merge, state, t)
