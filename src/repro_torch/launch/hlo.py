"""The program analyzer: per-device FLOPs, HBM bytes and collective bytes
of a torch program, counted as it is dispatched.

Counterpart of ``repro/launch/hlo.py``, which parses the partitioned HLO
text of a compiled XLA program.  PyTorch runs eagerly and has no such
text, so this module counts the program as it is *dispatched*: a
``TorchDispatchMode`` (:func:`analyze`) sees every aten op that runs, and
under ``DTensor`` it sees each device's local ops (it lets the DTensor
layer unwrap its arguments and counts what that layer runs), so every
count is per device, as the reference's SPMD module is.

* ``matmul_flops`` — 2 · |out| · |contracted| per ``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` (``einsum``, ``matmul`` and ``linear`` reach
  these), ``mv``, ``dot`` and the ``scaled_dot_product`` attentions;
  ``matmul_flops_f32`` is the part of it in 32-bit types (priced at the
  f32 rate, the rest at the bf16 tensor-core rate) and
  ``matmul_by_shape`` the FLOPs of each product by its operands' shapes.
* ``hbm_bytes`` — inputs + outputs of every op.  Views move nothing;
  copies and casts do.  Eager PyTorch fuses nothing, so every op is a
  round trip through memory: the counterpart of the reference's fusion
  boundaries.
* ``collective_bytes`` — per-device link bytes of each collective by the
  reference's ring model (all-reduce 2·(n−1)/n, all-gather and
  reduce-scatter (n−1)/n, all-to-all (n−1)/n, a permute its bytes), for
  the ``_c10d_functional`` and ``c10d`` ops (DTensor's redistributions)
  with n the op's group size, and for the port's own collectives, which
  report themselves (``kernels/dispatch.py::collective``).
* A hand-written kernel counts by its work formula, the one its bound in
  ``PERF.md`` uses: each ``ops.py`` entry reports (name, FLOPs, bytes,
  the type its arithmetic runs in) once a launch
  (``kernels/dispatch.py::kernel_work``), and nothing run inside that
  report is counted.  A launch through ``ctypes`` is
  invisible to a dispatch mode and the plain version's ops are not the
  kernel's work, so a step counts the same on the card, the CPU and
  ``meta``.
* ``peak_bytes`` — the peak of the live bytes of every storage the
  program touched (adopted when an op first reads or writes it, dropped
  when it is freed): the stand-in for XLA's ``memory_analysis``.

The reference's ``loop_trips`` has no counterpart: an eager program
dispatches every iteration of its loops, so nothing is multiplied.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import dispatch

_aten = torch.ops.aten

# (n − 1)/n factors of the ring model, by collective
_RING = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0}

# op names (the overload packet's) of the collectives, by kind
_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_out": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all", "broadcast": "broadcast",
           "broadcast_": "broadcast",
           "allreduce_": "all-reduce", "allgather_": "all-gather",
           "_allgather_base_": "all-gather",
           "allgather_into_tensor_coalesced_": "all-gather",
           "reduce_scatter_": "reduce-scatter",
           "_reduce_scatter_base_": "reduce-scatter",
           "alltoall_": "all-to-all", "alltoall_base_": "all-to-all"}
_NO_WORK = {"wait_tensor", "_wrap_tensor_autograd", "detach", "alias",
            "lift_fresh", "empty", "empty_strided", "empty_like",
            "new_empty", "new_empty_strided", "_local_scalar_dense"}


@dataclasses.dataclass
class HLOStats:
    """Per-device counts of one program (the reference's field names;
    ``loop_trips`` has no eager counterpart)."""
    matmul_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    dot_calls: float = 0.0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0
    matmul_flops_f32: float = 0.0
    matmul_by_shape: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _half(dtype: torch.dtype) -> bool:
    """Whether a product in ``dtype`` runs at the 16-bit tensor-core
    rate (anything wider at the f32 rate)."""
    return dtype in (torch.bfloat16, torch.float16)


def _shape_key(name: str, ins) -> str:
    """``matmul_by_shape``'s key of a product: the op and its operands'
    shapes, e.g. ``mm (32, 64)·(64, 128)``."""
    return f"{name} " + "·".join(str(tuple(t.shape)) for t in ins[:3])


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def matmul_flops(func, args, out) -> float:
    """2 · |out| · |contracted| of a matrix-product op, 0 for any other."""
    packet = func.overloadpacket
    if packet in (_aten.mm, _aten.addmm, _aten.mv, _aten.dot):
        a = args[1] if packet is _aten.addmm else args[0]
        k = a.shape[-1]
        return 2.0 * _numel(out.shape) * k
    if packet in (_aten.bmm, _aten.baddbmm):
        a = args[1] if packet is _aten.baddbmm else args[0]
        return 2.0 * _numel(out.shape) * a.shape[-1]
    if packet in (_aten._scaled_dot_product_flash_attention,
                  _aten._scaled_dot_product_efficient_attention,
                  _aten._scaled_dot_product_cudnn_attention,
                  _aten._scaled_dot_product_flash_attention_for_cpu):
        q, k = args[0], args[1]
        # (B, H, Sq, dh) · (B, H, Skv, dh): QKᵀ and PV
        return 4.0 * _numel(q.shape[:-1]) * k.shape[-2] * q.shape[-1]
    return 0.0


def _group_size(func, args, kwargs) -> int:
    """The group size of a collective op's process group."""
    import torch.distributed as dist

    name = func.overloadpacket.__name__
    if name in ("all_gather_into_tensor", "all_gather_into_tensor_out"):
        return int(args[1])
    if name == "reduce_scatter_tensor":
        return int(args[2])
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except Exception:         # noqa: BLE001 - not a group name
                continue
        if hasattr(a, "size") and not isinstance(a, torch.Tensor) \
                and callable(a.size):
            try:
                return int(a.size())
            except Exception:         # noqa: BLE001 - not a group
                continue
    return 1


def link_bytes(op: str, out_bytes: float, in_bytes: float, n: int) -> float:
    """Per-device link bytes of one collective by the ring model."""
    n = max(int(n), 1)
    if op == "reduce-scatter":
        return in_bytes * (n - 1) / n
    if op in _RING:
        return _RING[op] * out_bytes * (n - 1) / n
    if op == "collective-permute":
        return float(out_bytes)
    return 0.0


class Analyzer(TorchDispatchMode):
    """Counts what each device executes while it is active (see the
    module's docstring); ``stats`` holds the counts."""

    def __init__(self):
        super().__init__()
        self.stats = HLOStats()
        self._quiet = 0
        self._live = 0
        self._seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    # -- live bytes ----------------------------------------------------------

    def _adopt(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):    # no storage
            return
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self._live += n
        weakref.finalize(st, self._free, n)
        if self._live > self.stats.peak_bytes:
            self.stats.peak_bytes = float(self._live)

    def _free(self, n: int) -> None:
        self._live -= n

    # -- reports from the port's own kernels and collectives -----------------

    def _product(self, key: str, flops: float, dtype: torch.dtype) -> None:
        s = self.stats
        s.matmul_flops += flops
        if not _half(dtype):
            s.matmul_flops_f32 += flops
        s.dot_calls += 1
        s.matmul_by_shape[key] = s.matmul_by_shape.get(key, 0.0) + flops

    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, nbytes: float,
               dtype: torch.dtype):
        s = self.stats
        self._product(name, flops, dtype)
        s.hbm_bytes += nbytes
        s.kernel_calls[name] = s.kernel_calls.get(name, 0) + 1
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def _collective(self, op: str, b: float) -> None:
        s = self.stats
        s.collective_bytes += b
        s.collective_counts[op] = s.collective_counts.get(op, 0) + 1
        s.collective_by_op[op] = s.collective_by_op.get(op, 0.0) + b

    @contextlib.contextmanager
    def collective(self, op: str, nbytes: float, group_size: int):
        self._collective(op, link_bytes(op, nbytes, nbytes, group_size))
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- every dispatched op -------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # let DTensor unwrap; count its locals
        out = func(*args, **kwargs)
        if self._quiet or any(issubclass(t, FakeTensor) for t in types):
            return out
        name = func.overloadpacket.__name__
        ins = list(_tensors(list(args) + list(kwargs.values())))
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else [out]))
        for t in ins + outs:
            self._adopt(t)
        if name in _NO_WORK:
            return out
        s = self.stats
        if name in _FUNCOL:
            op = _FUNCOL[name]
            self._collective(op, link_bytes(
                op, sum(_nbytes(t) for t in outs),
                sum(_nbytes(t) for t in ins),
                _group_size(func, args, kwargs)))
            return out
        if func.is_view or not ins and not outs:
            return out
        fl = matmul_flops(func, args, outs[0]) if outs else 0.0
        if fl:
            self._product(_shape_key(name, ins), fl, ins[0].dtype)
        s.hbm_bytes += (sum(_nbytes(t) for t in ins)
                        + sum(_nbytes(t) for t in outs))
        return out


# the propagator's entry points across torch releases (2.11 calls
# ``propagate``, later ones the ``propagate_op_sharding`` pair)
_PROPAGATION = ("propagate", "propagate_op_sharding",
                "propagate_op_sharding_non_cached",
                "_propagate_tensor_meta_non_cached")


@contextlib.contextmanager
def _quiet_sharding_propagation(a: "Analyzer"):
    """DTensor infers each op's output layout by running the op on tensors
    of the global shape (``ShardingPropagator.propagate``); that is
    planning, not the device's program, so the analyzer counts none of
    it."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        yield
        return
    prop = mod.DTensor._op_dispatcher.sharding_propagator
    names = [n for n in _PROPAGATION if hasattr(prop, n)]
    saved = {n: getattr(prop, n) for n in names}

    def quiet(fn):
        def run(*args, **kwargs):
            a._quiet += 1
            try:
                return fn(*args, **kwargs)
            finally:
                a._quiet -= 1
        return run

    for n in names:
        setattr(prop, n, quiet(saved[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(prop, n, saved[n])


@contextlib.contextmanager
def analyze():
    """``with analyze() as a: ...`` counts the block's program into
    ``a.stats``; the port's kernels and collectives report to it."""
    a = Analyzer()
    prev = dispatch.WORK_HOOK
    dispatch.WORK_HOOK = a
    try:
        with _quiet_sharding_propagation(a), a:
            yield a
    finally:
        dispatch.WORK_HOOK = prev


# ---------------------------------------------------------------------------
# Roofline terms: NVIDIA H100 SXM (80 GB HBM3)
# ---------------------------------------------------------------------------

# dense bf16 tensor-core peak, FLOP/s (NVIDIA H100 datasheet, SXM5; the
# bound PERF.md's kernel table uses for bf16 work)
PEAK_FLOPS = 989e12
# f32 rate on the CUDA cores, FLOP/s (the same datasheet; the bound of the
# table's f32 kernels, and of f32 products with TF32 off)
PEAK_F32_FLOPS = 67e12
# HBM3 bandwidth, bytes/s (the same datasheet and table)
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s a card in both directions together, i.e. 450e9 B/s
# a direction (the same datasheet)
LINK_BW = 450e9


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for products in ``dtype``."""
    return PEAK_FLOPS if _half(dtype) else PEAK_F32_FLOPS


def least_time(flops: float, nbytes: float, dtype: torch.dtype):
    """(seconds, "bytes" or "operations"): the least time of work that
    moves ``nbytes`` through HBM and does ``flops`` in ``dtype``, the
    larger of the two times; the bound of every kernel in PERF.md's
    table."""
    tb, tf = nbytes / HBM_BW, flops / peak_flops(dtype)
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def roofline_terms(stats: HLOStats, chips: int,
                   cost: Optional[Dict] = None,
                   memory: Optional[Dict] = None) -> Dict:
    """The three roofline terms of one device, in seconds: its matmul
    FLOPs (the 16-bit ones at the bf16 peak, the 32-bit ones at the f32
    rate), its bytes at the HBM rate, its link bytes at the NVLink rate;
    and the largest one (``dominant``)."""
    f32 = stats.matmul_flops_f32
    compute_t = ((stats.matmul_flops - f32) / PEAK_FLOPS
                 + f32 / PEAK_F32_FLOPS)
    memory_t = stats.hbm_bytes / HBM_BW
    coll_t = stats.collective_bytes / LINK_BW
    dominant = max(
        (("compute", compute_t), ("memory", memory_t),
         ("collective", coll_t)), key=lambda kv: kv[1])[0]
    out = {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "dominant": dominant,
        "per_device_flops": stats.matmul_flops,
        "per_device_hbm_bytes": stats.hbm_bytes,
        "per_device_collective_bytes": stats.collective_bytes,
        "total_flops": stats.matmul_flops * chips,
        "chips": chips,
    }
    if cost:
        out["cost"] = cost
    if memory:
        out["memory_analysis"] = memory
    return out
