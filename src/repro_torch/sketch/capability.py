"""Capability protocol for the optional ``SlidingSketch`` fields.

Counterpart of ``repro/sketch/capability.py``.  A capability is an
optional protocol field (``OPTIONAL_FIELDS``).  Where a sketch lacks one,
:func:`install_missing` fills the field with a tagged raiser whose message
follows from the sketch's context (single sketch or fleet, adaptive rank
or not), so it names a constructor the caller can use; :func:`install`
attaches a real implementation and :func:`capabilities` reports the lot.

The messages name only constructors the port has: a single sketch becomes
a fleet through ``fleet_streams`` (the reference names ``vmap_streams`` /
``shard_streams``), and a fleet records history through
``SketchFleetEngine(..., history=True)`` or
``sketch/history.py::install_query_interval``, which attaches a plane
(``meta["hist_box"]``).  A host baseline (``meta["backend"] == "host"``)
has no fleet, so its messages send the caller to a torch variant, as the
reference's send it to a JAX one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

#: The optional protocol fields, in declaration order.
OPTIONAL_FIELDS = ("query_cohort", "query_interval", "score", "ranks")


class CapabilityInfo(NamedTuple):
    """One row of :func:`capabilities`: is ``name`` available on this
    sketch, and if not, the exact error text its raiser would produce."""

    name: str
    available: bool
    reason: Optional[str]


def context(sk) -> Dict[str, Any]:
    """The facts the availability messages are derived from."""
    meta = sk.meta
    return {
        "name": sk.name,
        "fleet": meta.get("streams") is not None,
        "adaptive": meta.get("adapt") is not None,
        "backend": meta.get("backend"),
    }


def _missing_message(cap: str, ctx: Dict[str, Any]) -> str:
    """Guidance for a missing capability that names only what the
    caller's object can be fed to."""
    name = ctx["name"]
    host = ctx["backend"] == "host"
    if cap == "query_cohort":
        if host:
            return (f"{name!r} is a host-side baseline — cohort queries "
                    "are served by the torch fleet path only: lift a torch "
                    "variant with fleet_streams, then call "
                    "query_cohort(state, cohort, t)")
        if ctx["fleet"]:
            return (f"fleet {name!r} exposes no cohort query plane — "
                    "rebuild it with fleet_streams so the AggTree is "
                    "attached")
        return (f"{name!r} is a single sketch — cohort queries need a "
                "fleet: lift it with fleet_streams, then call "
                "query_cohort(state, cohort, t)")
    if cap == "query_interval":
        engine = ("SketchFleetEngine(..., history=True[, "
                  "history_hot_nodes=..., history_dir=...])")
        attach = ("repro_torch.sketch.history."
                  "install_query_interval(fleet, plane)")
        if host:
            return (f"{name!r} is a host-side baseline — query_interval "
                    "(time-travel over retired window content) is served "
                    "by the torch fleet path only: serve a torch variant "
                    "through SketchFleetEngine(..., history=True)")
        if ctx["fleet"]:
            return (f"fleet {name!r} has no history plane — time-travel "
                    "interval queries need retired window content to be "
                    f"recorded: serve the fleet through {engine} or attach "
                    f"a plane with {attach}")
        return (f"{name!r} is a single sketch — time-travel interval "
                "queries need a fleet with a history plane: serve it "
                f"through {engine}, or lift it first with fleet = "
                f"fleet_streams(sk, S) and then attach a plane with "
                f"{attach}")
    if cap == "score":
        if host:
            return (f"{name!r} exposes no residual scorer — host "
                    "baselines built via make_sketch() carry the numpy "
                    "adapter; hand-built instances can attach one with "
                    "repro_torch.sketch.capability.install(sk, 'score', "
                    "fn)")
        return (f"{name!r} exposes no residual scorer — build it via "
                "make_sketch() (every registered variant installs score) "
                "or attach one with "
                "repro_torch.sketch.capability.install(sk, 'score', fn)")
    if cap == "ranks":
        return (f"{name!r} runs at a fixed rank — per-stream adaptive "
                "rank is opt-in: build the base sketch with "
                "make_sketch('fd', ..., adapt_target=...) so ell "
                "grows/shrinks toward the target residual error and "
                "ranks(state) reports the per-stream working rank")
    return f"{name!r} does not implement capability {cap!r}"


def missing(cap: str, sk) -> Callable:
    """A tagged raiser for ``cap`` derived from ``sk``'s current context."""
    reason = _missing_message(cap, context(sk))

    def raiser(*args, **kwargs):
        raise ValueError(reason)

    raiser.capability = cap
    raiser.capability_missing = True
    raiser.capability_reason = reason
    return raiser


def is_missing(fn: Optional[Callable]) -> bool:
    """True when the field is empty or holds a tagged raiser."""
    return fn is None or getattr(fn, "capability_missing", False)


def has(sk, cap: str) -> bool:
    """True when ``sk`` carries a real implementation of ``cap``."""
    return not is_missing(getattr(sk, cap, None))


def install(sk, cap: str, impl: Callable, **meta_update):
    """Attach a real implementation of ``cap``, merging ``meta_update``
    into the sketch's meta."""
    if cap not in OPTIONAL_FIELDS:
        raise ValueError(
            f"unknown capability {cap!r}; declared: {OPTIONAL_FIELDS}")
    impl.capability = cap
    impl.capability_missing = False
    kw = {cap: impl}
    if meta_update:
        kw["meta"] = dict(sk.meta, **meta_update)
    return sk._replace(**kw)


def install_missing(sk):
    """Fill every absent capability with a context-derived raiser,
    re-deriving raisers minted for an older context (a single sketch since
    lifted into a fleet); real implementations are never touched."""
    repl = {}
    for cap in OPTIONAL_FIELDS:
        if is_missing(getattr(sk, cap, None)):
            repl[cap] = missing(cap, sk)
    return sk._replace(**repl) if repl else sk


def capabilities(sk) -> Dict[str, CapabilityInfo]:
    """Availability of every declared capability of ``sk``."""
    out: Dict[str, CapabilityInfo] = {}
    ctx = context(sk)
    for cap in OPTIONAL_FIELDS:
        fn = getattr(sk, cap, None)
        if is_missing(fn):
            reason = (getattr(fn, "capability_reason", None)
                      or _missing_message(cap, ctx))
            out[cap] = CapabilityInfo(cap, False, reason)
        else:
            out[cap] = CapabilityInfo(cap, True, None)
    return out
