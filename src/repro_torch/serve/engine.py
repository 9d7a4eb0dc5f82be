"""Batched serving engines.

Counterpart of ``repro/serve/engine.py``.  Two serving paths live here:

* ``ServeEngine`` — fixed-slot continuous batching of a language model
  over the prefill and decode steps: B slots advance in lockstep (one
  decode step per tick), and an empty slot is refilled by prefilling the
  next queued request and splicing its caches into the batch at the slot
  index.
* ``SketchFleetEngine`` — S per-user sliding-window sketches on one
  device, or this process's share of them under a ``FleetTopology``:
  admission, ticks, user and cohort queries through the cached merge
  tree, the scoring plane, the history plane of retired window content,
  and checkpoints in the reference's layout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.mesh import local_device
from repro_torch.models import api
from repro_torch.parallel.sharding import (TP_AXES, axis_rules,
                                           mesh_shape, on_model)
from repro_torch.serve.ingest import AdmissionQueue, IngestBacklogError, \
    SlabTransfer, make_pipeline
from repro_torch.serve.serve_step import build_decode_step, \
    build_prefill_step
from repro_torch.sketch import capability
from repro_torch.sketch.api import agg_tree, make_sketch, restore_fleet, \
    save_fleet, shard_streams
from repro_torch.sketch.history import HistoryPlane, install_query_interval
from repro_torch.sketch.query import as_cohort
from repro_torch.sketch.score import ScorePlane
from repro_torch.tree import leaves, take


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (len,) int32
    max_new: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    out_tokens: Optional[List[int]] = None
    latency_s: float = 0.0
    t_submit: float = 0.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    slots: int = 4                     # decode batch width
    s_max: int = 256                   # cache capacity
    prefill_buckets: tuple = (32, 64, 128)
    temperature: float = 0.0


def _refuse_tensor_parallel(mesh, rules) -> None:
    """Raise for ``rules`` that put a tensor-parallel axis on a model axis
    of ``mesh`` with more than one process."""
    if mesh is None or not rules \
            or int(mesh_shape(mesh).get("model", 1)) == 1:
        return
    split = [k for k in TP_AXES if on_model(rules.get(k))]
    if split:
        raise ValueError(
            f"ServeEngine: the rules put {', '.join(split)} on a model axis "
            f"of {int(mesh_shape(mesh)['model'])} processes; serving holds "
            "the dense part whole on each process (only 'experts' may be "
            "split): tensor-parallel serving and its decode cache are not "
            "ported (ROADMAP §1, 'Tensor parallelism: what remains', "
            "tensor-parallel serving)")


class ServeEngine:
    """Continuous batching of one model on one device.

    A prompt is right-aligned in the smallest prefill bucket that holds it,
    with token 0 before it, and the whole bucket is prefilled with no
    padding mask, as in the reference; its caches (``length`` = the bucket)
    are spliced left-aligned into the slot.  Every tick decodes all slots,
    empty ones included.  The caches are held in ``dtype`` (f32 by default,
    as in the reference).  As in the reference, the engine passes the
    decode step no generator, so it decodes greedily whatever
    ``temperature`` says.  Admission passes the prefill only tokens, as
    the reference's does, so a model whose prefill needs more (the VLM's
    M-RoPE ids, Whisper's frames) raises the prefill's ``ValueError`` at
    the first admission.  Runs on the card unless ``device="cpu"``.
    With ``mesh`` and ``rules`` every prefill and decode runs under
    ``parallel/sharding.py::axis_rules``: an expert-parallel MoE engine
    of a process that holds its experts' block of ``params`` (one of a
    group that serves the same requests in lockstep).  Rules that split
    the heads, KV heads, FFN or vocabulary over a model axis of more than
    one process raise a ``ValueError``: the reference's engine has no
    mesh, and no tensor-parallel decode cache is ported.
    """

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 dtype=torch.float32, device="cuda", *, mesh=None,
                 rules=None):
        self.device = resolve_device(device)
        _refuse_tensor_parallel(mesh, rules)
        self._rules = (contextlib.nullcontext if mesh is None else
                       functools.partial(axis_rules, mesh, rules or {}))
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.dtype = dtype
        self.queue: deque = deque()
        self.done: Dict[int, Request] = {}
        self.slot_req: List[Optional[Request]] = [None] * ecfg.slots
        self.slot_left: np.ndarray = np.zeros(ecfg.slots, np.int32)
        self.tokens = torch.zeros((ecfg.slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.caches = api.init_cache(cfg, ecfg.slots, ecfg.s_max, dtype,
                                     self.device)
        self._decode = build_decode_step(cfg, temperature=ecfg.temperature)
        self._prefill_b1 = build_prefill_step(cfg)
        self.ticks = 0

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        b_max = max(self.ecfg.prefill_buckets)
        if len(req.prompt) > b_max:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds the largest "
                f"prefill bucket ({b_max}); admitting it would silently "
                f"drop all but the last {b_max} tokens — chunk the prompt "
                "or enlarge EngineConfig.prefill_buckets")
        req.t_submit = time.perf_counter()
        req.out_tokens = []
        self.queue.append(req)

    def _bucket(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        # unreachable through submit(), which rejects over-long prompts
        raise ValueError(
            f"no prefill bucket holds {n} tokens "
            f"(buckets={self.ecfg.prefill_buckets})")

    def _admit(self, slot: int, req: Request) -> None:
        b = self._bucket(len(req.prompt))
        prompt = np.zeros((1, b), np.int32)
        prompt[0, -len(req.prompt):] = req.prompt
        with torch.no_grad(), self._rules():
            tok, caches1 = self._prefill_b1(
                self.params,
                {"tokens": torch.from_numpy(prompt).to(self.device)})
        _splice_caches(self.caches, caches1, slot)
        self.tokens[slot] = tok[0]
        self.slot_req[slot] = req
        self.slot_left[slot] = req.max_new
        req.out_tokens.append(int(tok[0, 0]))

    # -- main loop ----------------------------------------------------------

    def step(self) -> None:
        """One engine tick: refill slots, one decode step, harvest."""
        for s in range(self.ecfg.slots):
            if self.slot_req[s] is None and self.queue:
                self._admit(s, self.queue.popleft())
        if all(r is None for r in self.slot_req):
            return
        with torch.no_grad(), self._rules():
            self.tokens, self.caches = self._decode(self.params, self.tokens,
                                                    self.caches)
        self.ticks += 1
        toks = self.tokens[:, 0].cpu().numpy()
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.out_tokens.append(int(toks[s]))
            self.slot_left[s] -= 1
            hit_eos = req.eos_id is not None and toks[s] == req.eos_id
            if self.slot_left[s] <= 0 or hit_eos:
                req.latency_s = time.perf_counter() - req.t_submit
                self.done[req.uid] = req
                self.slot_req[s] = None

    def run(self, max_ticks: int = 10_000) -> Dict[int, Request]:
        """Serve until the queue and the slots are empty, at most
        ``max_ticks`` ticks of this call; warns if requests are left."""
        t0 = self.ticks
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and self.ticks - t0 < max_ticks:
            self.step()
        left = len(self.queue) + sum(r is not None for r in self.slot_req)
        if left:
            warnings.warn(
                f"ServeEngine.run() exhausted max_ticks={max_ticks} with "
                f"{left} request(s) unfinished — `done` is incomplete",
                RuntimeWarning, stacklevel=2)
        return self.done


def _score_key(name: str, lo: int, hi: int) -> str:
    """The scoring plane's aux leaf ``name`` of streams [lo, hi), keyed by
    stream range as the reference's processes key theirs."""
    return f"{name}_{lo:08d}_{hi:08d}"


def _score_aux_slice(aux: Dict[str, np.ndarray], lo: int,
                     hi: int) -> Optional[Dict[str, np.ndarray]]:
    """Streams ``[lo, hi)`` of the scoring plane's accumulators from aux
    leaves keyed ``{name}_{save_lo:08d}_{save_hi:08d}``, whatever process
    count saved them.  Streams no saved range covers start cold; None
    when the checkpoint holds no score leaves at all."""
    out: Dict[str, np.ndarray] = {}
    found = False
    for base in ScorePlane.KEYS:
        acc = None
        for k, v in aux.items():
            if not k.startswith(base + "_"):
                continue
            try:
                klo, khi = (int(p) for p in k[len(base) + 1:].split("_"))
            except ValueError:
                continue
            a, b = max(lo, klo), min(hi, khi)
            if a >= b:
                continue
            v = np.asarray(v)
            if acc is None:
                acc = np.zeros((hi - lo,), v.dtype)
            acc[a - lo:b - lo] = v[a - klo:b - klo]
            found = True
        if acc is not None:
            out[base] = acc
    if not found:
        return None
    cold = ScorePlane(hi - lo).state_dict()
    for base in ScorePlane.KEYS:
        out.setdefault(base, cold[base])
    return out


def _fleet_rows(fc, espec: Dict[str, Any]) -> int:
    """The whole fleet's ingested rows at the save.  A port shard records
    the fleet's count it was restored with (``rows_base``) and adds only
    its own rows after, so the fleet's is that base plus each shard's own;
    without a base on every shard (a plain or a reference checkpoint), the
    handed-back manifest's count."""
    engines = [m["sketch_spec"].get("engine") or {}
               for m in fc.shard_manifests]
    if not engines or not all("rows_base" in e for e in engines):
        return int(espec.get("rows_ingested", 0))
    return int(engines[0]["rows_base"]) + sum(
        int(e["rows_ingested"]) - int(e["rows_base"]) for e in engines)


def _splice_caches(big, one, slot: int) -> None:
    """Write a batch-1 prefill cache into batch slot ``slot`` of the
    engine's stacked caches, leaf by leaf with the reference's rule, for
    any cache NamedTuple (``KVCache``, ``SSMCache``, ``RGCache``,
    ``WhisperCache``, whose cross K/V over the frames match whole): each
    layer-stacked leaf (L, 1, ...) goes into ``[:, slot]``, the per-layer
    lengths (L, 1) among them; where its sequence axis (dim 2) is shorter
    than the engine's, it is left-aligned with zeros after it, so entries
    [0, b) hold the prefill and the next decode token lands at position b
    (``kv_cache_append`` writes at ``length``, ``decode_attention`` masks
    ``kpos < length``).  The reference returns a new cache; here the
    engine's own tensors are written in place, which saves a copy of the
    whole cache per admission."""
    for dst, src in zip(leaves(big), leaves(one)):
        src = src[:, 0].to(dst.dtype)
        if dst.shape[2:] != src.shape[1:]:
            n = src.shape[1]
            dst[:, slot, :n] = src
            dst[:, slot, n:] = 0
        else:
            dst[:, slot] = src


class SketchFleetEngine:
    """S per-user sketches advanced together, one ``update_block`` a tick.

    ``submit(user, row)`` admits one row through a validating, optionally
    capacity-bounded ``AdmissionQueue`` and returns ``True`` (accepted) or
    ``False`` (deferred: the queue is at ``queue_capacity``).
    ``submit_many(users, rows)`` admits a whole ``(n,) / (n, d)`` batch
    with one validation and one copy::

        users = np.repeat(np.arange(S), 8)          # 8 rows per user
        accepted = eng.submit_many(users, rows)
        eng.run()

    Each ``step()`` takes an ``(S, block, d)`` slab from the ingest
    pipeline — users with nothing queued contribute zero rows, which DS-FD
    treats as idle (expiry and swap advance, nothing is absorbed) — and
    advances every stream with one ``update_block``.  With
    ``ingest="async"`` (the default) the next slab is packed and copied to
    the card while the current tick runs; ``"sync"`` packs at dispatch.
    Both give the same state for the same submit/step interleaving.

    The fleet runs one clock.  A tick in which no user has pending rows
    is clock-neutral (a no-op) unless ``advance_time=True``: polling an
    idle engine must not expire live windows.

    Queries: ``query_user(u)`` returns that user's compressed (2ℓ, d)
    window sketch; ``query_cohort(users)`` ONE compressed sketch over a
    cohort of users (a ``Cohort``, an int, ids, or None for the whole
    fleet), served from the fleet's cached ``AggTree`` — each ``step()``
    dirties only the tree paths of the users it ingested rows for — and
    ``query_global()`` is ``query_cohort(None)``.  ``score_rows(rows,
    user)`` / ``score_cohort(rows, users)`` give residual anomaly scores
    of probe rows against one user's or a cohort's window basis.

    Anomaly flagging (``score=True``): each ingested slab is scored
    against the window basis as it was BEFORE the update, inside the tick,
    and a per-user EWMA threshold (``ScorePlane``: ``score_ema``,
    ``score_zscore``, ``score_warmup``) flags users whose per-tick peak
    score spikes; ``anomalies()`` harvests them.

    History (``history=True``): window expiry retires content into a
    time-dyadic index (``sketch/history.py``; ``history_hot_nodes`` nodes
    hot on the device, the rest spilled under ``history_dir``), and
    ``query_interval(users, t1, t2)`` answers any retired interval.

    ``checkpoint(path)`` saves the fleet state, the clock, the pending
    rows, the warm ``AggTree`` nodes, the history index and the scoring
    plane in one atomic checkpoint of the reference's layout;
    ``SketchFleetEngine.from_checkpoint(path)`` rebuilds an engine (from
    either package's checkpoint) that goes on exactly as the saved one
    would have.

    Ownership routing (a fleet across processes): with ``topology`` (a
    ``repro_torch.parallel.topology.FleetTopology``) the engine holds the
    users ``[topology.lo, topology.hi)`` on this process's
    ``launch.mesh.local_device``.  ``submit``, ``submit_many``,
    ``query_user`` and ``score_rows`` take global user ids; an id another
    process owns raises ``OwnershipError`` naming it (``submit_many``
    admits nothing of a mixed batch).  ``query_cohort``,
    ``query_global``, ``query_interval`` and ``anomalies(collective=True)``
    are collectives: every process issues the same sequence between the
    same ticks.  ``checkpoint`` writes this process's shard;
    ``from_checkpoint(..., topology=)`` takes its range from whatever
    checkpoint it finds and keeps the pending rows it now owns.
    """

    def __init__(self, name: str = "dsfd", *, d: int, streams: int,
                 eps: float = 1 / 8, window: int = 1024, block: int = 8,
                 ingest: str = "async", queue_capacity: Optional[int] = None,
                 topology=None, history: bool = False,
                 history_hot_nodes: Optional[int] = None,
                 history_dir: Optional[str] = None,
                 score: bool = False, score_ema: float = 0.05,
                 score_zscore: float = 4.0, score_warmup: int = 5,
                 device="cuda", **hyper):
        self.device = (resolve_device(device) if topology is None
                       else local_device(topology, device))
        self.base = make_sketch(name, d=d, eps=eps, window=window,
                                device=self.device, **hyper)
        self.topology = topology
        self.fleet = shard_streams(self.base, streams, topology=topology)
        self.S, self.d, self.block = int(streams), int(d), int(block)
        self.S_local = (self.S if topology is None
                        else int(topology.local_size))
        self.window = int(window)
        self.state = self.fleet.init()
        self.t = 0                                  # fleet clock (ticks)
        self.rows_ingested = 0
        self._rows_base = 0     # the fleet's count as of the last restore
        self._wire_ingest(ingest, queue_capacity)
        self.tree = agg_tree(self.fleet)  # the cohort-query cache
        self.history = None
        if history:
            self._attach_history(HistoryPlane(
                streams=self.S, d=self.d, ell=int(self.base.meta["ell"]),
                window=self.window, hot_capacity=history_hot_nodes,
                spill_dir=history_dir, topology=topology,
                device=self.device))
        self._wire_score(score, ema=score_ema, zscore=score_zscore,
                         warmup=score_warmup)

    def _wire_ingest(self, mode: str, capacity: Optional[int]) -> None:
        """The admission queue and slab pipeline (also the restore path)."""
        self.ingest = mode
        self.queue = AdmissionQueue(self.S_local, self.d, capacity=capacity)
        self.transfer = SlabTransfer(self.device)
        self.pipe = make_pipeline(mode, self.queue, block=self.block,
                                  transfer=self.transfer)
        self._zero_slab = None         # lazy zero slab for idle ticks

    def _wire_score(self, on: bool, *, ema: float, zscore: float,
                    warmup: int) -> None:
        """The per-user EWMA scoring plane, or none (also the restore
        path)."""
        self.score_plane = None
        if not on:
            return
        if not capability.has(self.fleet, "score"):
            self.fleet.score()         # the capability raiser names the fix
        self.score_plane = ScorePlane(self.S_local, ema=ema, zscore=zscore,
                                      warmup=warmup)

    def _attach_history(self, plane: HistoryPlane) -> None:
        self.history = plane
        self.fleet = install_query_interval(self.fleet, plane)

    # -- persistence --------------------------------------------------------

    def checkpoint(self, path: str, *, keep: int = 3) -> str:
        """Atomic engine checkpoint under ``path``; returns its directory.

        The clock is part of the state (the window is defined by it).
        Rows staged by the async pipeline are first unwound to the queue
        front (``flush_to_queue``), so the pending rows are the queue's
        snapshot, per-user FIFO order kept.  The warm ``AggTree`` nodes,
        the history index (hot nodes and pending units as aux leaves, the
        spill dir by path) and the scoring plane's accumulators ride in
        the same checkpoint, under the reference's names.  Under a topology
        this writes the process's shard: pending users by global id, no
        tree nodes (the partitioned plane restarts cold, its keys scoped
        by a version every process restarts in lockstep), the score
        accumulators keyed by the process's stream range."""
        self.pipe.flush_to_queue()
        users, rows = self.queue.snapshot()
        lo = 0 if self.topology is None else int(self.topology.lo)
        aux = {"pending_user": (users + np.int32(lo)).astype(np.int32),
               "pending_rows": rows}
        tree_meta = None
        if self.topology is None:
            tree_meta, tree_arrays = self.tree.state_dict(t=self.t)
            aux.update(tree_arrays)
        hist_meta = None
        if self.history is not None:
            hist_meta, hist_arrays = self.history.state_dict()
            aux.update(hist_arrays)
        score_meta = None
        if self.score_plane is not None:
            for k, v in self.score_plane.state_dict().items():
                aux[_score_key(k, lo, lo + self.S_local)] = v
            score_meta = self.score_plane.spec()
        # rows_ingested rides in the JSON spec (an unbounded integer)
        engine = {"block": self.block,
                  "rows_ingested": int(self.rows_ingested),
                  "ingest": self.ingest,
                  "queue_capacity": self.queue.capacity,
                  "agg_tree": tree_meta,
                  "history": hist_meta,
                  "score": score_meta}
        if self.topology is not None:
            # a shard counts the fleet's rows at its restore plus its own
            # since: the base lets a restore sum the shards' own rows
            engine["rows_base"] = int(self._rows_base)
        return save_fleet(path, self.fleet, self.state, self.t, aux=aux,
                          spec_extra={"engine": engine},
                          keep=keep)

    @classmethod
    def from_checkpoint(cls, path: str, *, step: Optional[int] = None,
                        device="cuda", topology=None) -> "SketchFleetEngine":
        """Rebuild an engine from :meth:`checkpoint` output of either
        package, on ``device`` (the card by default).  The clock, the
        ingested-row count, the pending rows, the history index and the
        scoring plane are restored, so what follows is the same as an
        uninterrupted run; saved ``AggTree`` nodes make the first
        aggregate queries warm (any mismatch leaves the cache cold).

        With ``topology``, this process's share, whatever process count
        saved the checkpoint (``restore_fleet``'s elastic reassembly): the
        pending rows it now owns, its slice of the score accumulators.
        The history index restores only under the saving partition, as in
        the reference.  ``rows_ingested`` comes back as the whole fleet's
        count at the save, on every process and whoever saved: the
        port's shards carry the count they were restored with, so their
        own rows sum; the reference's shards give the first shard's
        count, as the reference does."""
        fc = restore_fleet(path, step=step, device=device, topology=topology)
        ss = fc.manifest["sketch_spec"]
        espec = ss.get("engine")
        if espec is None:
            raise ValueError(
                f"checkpoint under {path!r} is a bare fleet (no engine "
                "section) — restore it with "
                "repro_torch.sketch.api.restore_fleet")
        spec = ss["sketch"]
        # assembled around the restored state: __init__ would build a
        # throwaway initial state on the device first
        eng = cls.__new__(cls)
        eng.device = fc.fleet.meta["device"]
        eng.base = fc.fleet.meta["base"]
        eng.fleet = fc.fleet
        eng.topology = topology
        eng.S = int(ss["streams"])
        eng.S_local = (eng.S if topology is None
                       else int(topology.local_size))
        eng.d = int(spec["d"])
        eng.block = int(espec["block"])
        eng.window = int(spec["window"])
        eng.state = fc.state
        eng.t = int(fc.t)
        eng.rows_ingested = eng._rows_base = _fleet_rows(fc, espec)
        eng._wire_ingest(espec.get("ingest", "async"),
                         espec.get("queue_capacity"))
        # pending users are saved by global id: keep the ones this process
        # owns now (the others' owners pick up the rest)
        users = np.asarray(fc.aux["pending_user"], np.int32).reshape(-1)
        rows = np.asarray(fc.aux["pending_rows"])
        lo = 0 if topology is None else int(topology.lo)
        owned = (users >= lo) & (users < lo + eng.S_local)
        eng.queue.load(users[owned] - np.int32(lo), rows[owned])
        eng.tree = agg_tree(eng.fleet)
        if topology is None:
            eng.tree.load_state_dict(espec.get("agg_tree"), fc.aux,
                                     eng.state)
        eng.history = None
        if espec.get("history") is not None:
            eng._attach_history(HistoryPlane.from_state_dict(
                espec["history"], fc.aux, topology=topology,
                device=eng.device))
        smeta = espec.get("score")
        eng._wire_score(smeta is not None,
                        **(smeta or dict(ema=0.0, zscore=0.0, warmup=0)))
        if smeta is not None:
            arrays = _score_aux_slice(fc.aux, lo, lo + eng.S_local)
            if arrays is not None:
                eng.score_plane.load_state_dict(arrays)
        return eng

    # -- admission ---------------------------------------------------------

    def _route(self, user) -> int:
        """A global user id as an index of this process's streams (the
        identity without a topology); ``OwnershipError`` names the owner
        of an id this process does not hold."""
        if isinstance(user, bool) or not isinstance(user, (int, np.integer)):
            raise ValueError(
                f"user id must be an integer, got {type(user).__name__} "
                f"({user!r})")
        u = int(user)
        if not 0 <= u < self.S:
            raise ValueError(f"user id {u} outside the fleet's "
                             f"[0, {self.S}) stream range")
        return u if self.topology is None else self.topology.to_local(u)

    def submit(self, user: int, row: np.ndarray) -> bool:
        """Admit one row for ``user`` (a global id); ``True`` accepted,
        ``False`` deferred (drain with ``step``/``run`` and resubmit)."""
        if self.topology is not None:
            user = self._route(user)
        return self.queue.submit(user, row)

    def submit_many(self, users, rows) -> np.ndarray:
        """Batched admission of global ids; returns the (n,) bool
        acceptance mask (at ``queue_capacity`` the longest fitting prefix
        is admitted).  Under a topology a batch holding an id another
        process owns raises ``OwnershipError`` and admits nothing."""
        if self.topology is not None:
            ua = np.asarray(users)
            if ua.ndim != 1 or (ua.size
                                and not np.issubdtype(ua.dtype, np.integer)):
                raise ValueError(
                    f"users must be a 1-D integer array, got shape "
                    f"{ua.shape} dtype {ua.dtype}")
            if ua.size:
                bad = (ua < 0) | (ua >= self.S)
                if bad.any():
                    raise ValueError(
                        f"user id {int(ua[bad][0])} outside the fleet's "
                        f"[0, {self.S}) stream range")
                owned = (ua >= self.topology.lo) & (ua < self.topology.hi)
                if not owned.all():
                    self.topology.to_local(int(ua[~owned][0]))  # raises
            users = (ua - self.topology.lo).astype(ua.dtype, copy=False)
        return self.queue.submit_many(users, rows)

    @property
    def backlog(self) -> int:
        """Admitted-but-not-ingested rows: queued + staged."""
        return self.queue.backlog + self.pipe.staged_rows

    # -- main loop ---------------------------------------------------------

    def step(self, *, advance_time: bool = False) -> int:
        """One engine tick; returns the number of rows ingested.

        A tick where NO user has pending rows is clock-neutral (a no-op)
        unless ``advance_time=True``."""
        slab, touched, counts, nrows = self.pipe.next_slab()
        if nrows == 0 and not advance_time:
            return 0
        if nrows == 0:
            if self._zero_slab is None:
                self._zero_slab = np.zeros((self.S_local, self.block,
                                            self.d), np.float32)
            slab = self._zero_slab
        rows = self.transfer.to_compute(slab)
        scores = None
        if self.score_plane is not None and nrows:
            # against the window BEFORE the update: a burst must not vouch
            # for itself
            scores = self.fleet.score(self.state, rows, self.t)
        ts = torch.arange(self.t + 1, self.t + self.block + 1,
                          dtype=torch.int32, device=self.device)
        self.state = self.fleet.update_block(self.state, rows, ts)
        self.t += self.block
        self.rows_ingested += nrows
        self.tree.advance(self.state, touched)
        if scores is not None:
            cnt = np.zeros((self.S_local,), np.int64)
            cnt[touched] = counts
            self.score_plane.observe(scores.cpu().numpy(), cnt)
        if self.history is not None:
            # record the slab's units (an idle tick's zero slab has none),
            # then retire the units this clock advance expired
            if nrows:
                self.history.observe_block(rows,
                                           first_ts=self.t - self.block + 1)
            self.history.retire_through(self.t - self.window)
        # pack + copy the NEXT slab while the device runs this one
        self.pipe.after_dispatch()
        return nrows

    def run(self, max_ticks: int = 10_000, *,
            on_budget: str = "raise") -> int:
        """Drain every pending row; returns the ticks consumed.  If
        ``max_ticks`` runs out first, raise :class:`IngestBacklogError`
        (default) or warn with ``on_budget="warn"``."""
        if on_budget not in ("raise", "warn"):
            raise ValueError(
                f"on_budget must be 'raise' or 'warn', got {on_budget!r}")
        ticks = 0
        while self.backlog and ticks < max_ticks:
            self.step()
            ticks += 1
        if self.backlog:
            msg = (f"run() exhausted max_ticks={max_ticks} with "
                   f"{self.backlog} row(s) still pending — the drain did "
                   "NOT complete")
            if on_budget == "raise":
                raise IngestBacklogError(msg, self.backlog)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return ticks

    # -- queries -----------------------------------------------------------

    def _user(self, user: int):
        """That user's (S = 1) state (``user`` a global id)."""
        u = self._route(user)
        return take(self.state, slice(u, u + 1))

    def query_user(self, user: int) -> np.ndarray:
        """That user's compressed (2ℓ, d) window sketch at the clock."""
        return self.base.query(self._user(user), self.t)[0].cpu().numpy()

    def query_cohort(self, users=None) -> np.ndarray:
        """ONE compressed (2ℓ, d) sketch over a cohort of users' windows
        (a ``Cohort``, an int, an iterable of ids, or None for all), from
        the cached ``AggTree``: repeated and overlapping cohort queries
        between ticks reuse its nodes (O(log S) merges warm).  A collective
        under a topology."""
        g = self.tree.query(self.state, as_cohort(users), self.t)
        return self.base.query(g, self.t)[0].cpu().numpy()

    def query_global(self) -> np.ndarray:
        """ONE compressed (2ℓ, d) sketch of every user's window."""
        return self.query_cohort(None)

    def query_interval(self, users, t1: int, t2: int) -> np.ndarray:
        """ONE compressed (2ℓ, d) sketch of every row the cohort's users
        (as in :meth:`query_cohort`) ingested with a timestamp in
        ``[t1, t2)``, from the history plane of retired window content
        (``history=True``): O(log(t2 − t1)) node merges warm.  Only
        intervals that have left the live window are addressable
        (``t2 − 1 <= t − window``).  Without a plane, the fleet's
        capability raiser says how to build one.  A collective under a
        topology."""
        return self.fleet.query_interval(self.state, t1, t2,
                                         as_cohort(users)).cpu().numpy()

    # -- the scoring plane ---------------------------------------------------

    def score_rows(self, rows, user: Optional[int] = None) -> np.ndarray:
        """(n,) residual anomaly scores of ``rows`` (n, d) against one
        user's window basis (the whole fleet's when ``user`` is None)."""
        if user is None:
            return self.score_cohort(rows)
        return self.base.score(self._user(user), rows,
                               self.t)[0].cpu().numpy()

    def score_cohort(self, rows, users=None) -> np.ndarray:
        """(n,) residual anomaly scores of ``rows`` (n, d) against the
        merged window basis of a cohort (``users`` as in
        :meth:`query_cohort`)."""
        g = self.tree.query(self.state, as_cohort(users), self.t)
        return self.base.score(g, rows, self.t)[0].cpu().numpy()

    def anomalies(self, *, reset: bool = False,
                  collective: bool = False) -> np.ndarray:
        """Global user ids currently flagged by the per-user EWMA
        thresholds (``score=True`` engines); ``reset=True`` clears the
        flags after reading.  Under a topology a process knows only its
        own users; ``collective=True`` gathers every process's into the
        same sorted array on all of them (a collective)."""
        if self.score_plane is None:
            raise ValueError(
                "this engine scores nothing — build it with "
                "SketchFleetEngine(..., score=True[, score_zscore=..., "
                "score_warmup=...]) to run the per-user EWMA scoring "
                "plane at ingest")
        local = np.asarray(self.score_plane.anomalies(reset=reset), np.int64)
        if self.topology is None:
            return local
        local = local + np.int64(self.topology.lo)
        if collective:
            local = np.sort(np.concatenate(
                self.topology.allgather_array("anomalies", local)))
        return local

    def ranks(self) -> np.ndarray:
        """Per-user working rank ℓ (adaptive-rank variants only,
        ``"fd"`` with ``adapt_target``); the capability raiser otherwise."""
        return self.fleet.ranks(self.state).cpu().numpy()

    def space(self) -> Dict[str, int]:
        """Live rows: the users' sketches, the cached ``AggTree`` nodes,
        their total, and with adaptive rank the sum of the ranks."""
        fs = self.fleet.space(self.state)
        out = {"per_stream_total": int(fs.per_stream.sum()),
               "cache_rows": int(fs.cache_rows), "total": int(fs.total)}
        if fs.ranks is not None:
            out["ranks_total"] = int(fs.ranks.sum())
        return out
