"""Logical-axis sharding: rules from logical names to mesh axes.

Counterpart of ``repro/parallel/sharding.py``.  Parameters and activations
are annotated with *logical* axis names; a rule table per run maps each
name to a mesh axis, a tuple of mesh axes or ``None`` (replicated).  The
rules are computed per architecture, so that a dimension is sharded only
where it divides the mesh axis.

A spec is a plain tuple with one entry a dimension (the reference's
``PartitionSpec``).  A mesh is read through its ``{axis: size}`` mapping
(:func:`mesh_shape`), so a ``torch.distributed.DeviceMesh``, a plain dict
and an object whose ``.shape`` is such a dict all serve as one.

Where the reference's ``with_sharding_constraint`` tells GSPMD how to lay
out a value, :func:`constrain` redistributes a ``DTensor`` to the rule's
placements (:func:`placements`); on a plain tensor, or without a mesh, it
returns its argument as it is, so the one-card path is unchanged.  The
expert-parallel MoE block (``models/layers/moe.py``) reads the model axis
of the mesh in force and reduces over its group with :func:`all_reduce`
(forward and backward, for autograd) after :func:`enter_group`, and so do
the tensor-parallel attention, SwiGLU, embedding and logits of the
transformer where the rules put 'heads', 'ff' or 'vocab' on a model axis
of processes (:func:`tp_split`); a train
step over a process mesh (``train/train_step.py``) averages its gradients
over the data axes (:func:`data_axes`) with :func:`all_reduce_flat`, and
its gradient sketches carry an FD summary from one block's owner to the
next with :func:`broadcast` (``sketch/blocks.py``).
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

_ctx = threading.local()

Spec = Tuple[object, ...]
# the logical axes that tensor parallelism splits over 'model'
TP_AXES = ("heads", "kv", "ff", "vocab")


def is_dtensor(x) -> bool:
    """True for a ``DTensor``; a process that never imported the DTensor
    package holds none, so a plain tensor costs no import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_shape(mesh) -> Mapping[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, a dict, or an object whose
    ``.shape`` is such a dict (the reference's ``Mesh``)."""
    if isinstance(mesh, Mapping):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return mesh.shape


def _axis_size(mesh, axis) -> int:
    shape = mesh_shape(mesh)
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= shape[a]
        return n
    return shape[axis]


def make_rules(mesh, dims: Dict[str, int], *,
               fsdp: bool = False) -> Dict[str, object]:
    """The logical → mesh table for one architecture.

    ``dims`` maps a logical name to its size (0 or absent: replicate).  A
    name maps to the 'model' axis only where its size divides it; 'batch'
    maps to every data-like axis of the mesh.  ``fsdp=True`` also shards
    'embed' over the data axes (weights' d_model dimension, gathered per
    layer), where it divides them.  'kv_seq' shards a KV cache's sequence
    over 'model' where the KV heads cannot be; 'seq_attn' shards the
    attention's sequence over 'model' where the query heads cannot be."""
    shape = mesh_shape(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in shape)
    model = "model" if "model" in shape else None
    dsize = 1
    for a in data_axes:
        dsize *= shape[a]
    embed = None
    if fsdp and data_axes and dims.get("embed", 0) \
            and dims.get("embed", 0) % max(dsize, 1) == 0:
        embed = data_axes
    rules: Dict[str, object] = {
        "batch": data_axes if data_axes else None,
        "seq": None, "embed": embed, "frames": None, "pos": None,
        "state": None, "conv": None, "qk": None,
    }
    msize = _axis_size(shape, model)
    for name in ("heads", "kv", "ff", "vocab", "experts", "expert_ff",
                 "lru", "inner"):
        size = dims.get(name, 0)
        rules[name] = model if (model and size and size % msize == 0) else None
    rules["kv_seq"] = model if (model and dims.get("kv", 0)
                                and rules.get("kv") is None) else None
    rules["seq_attn"] = model if (model and dims.get("heads", 0)
                                  and rules.get("heads") is None) else None
    return rules


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, object]):
    """Within the block, :func:`constrain` and the MoE block read ``mesh``
    and ``rules``."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules)
    try:
        yield
    finally:
        _ctx.state = prev


def current_mesh():
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def current_rules() -> Optional[Dict[str, object]]:
    st = getattr(_ctx, "state", None)
    return st[1] if st else None


def model_size() -> int:
    """The model axis's size in the mesh in force, 1 without one."""
    mesh = current_mesh()
    return int(mesh_shape(mesh).get("model", 1)) if mesh is not None else 1


def to_pspec(axes: Tuple[Optional[str], ...],
             rules: Optional[Dict[str, object]] = None) -> Spec:
    """The spec of logical ``axes``: each name's rule, ``None`` for an
    unnamed dimension; a mesh axis used twice keeps its first use."""
    rules = rules if rules is not None else (current_rules() or {})
    parts = [rules.get(name) if name else None for name in axes]
    seen = set()
    clean = []
    for p in parts:
        key = tuple(p) if isinstance(p, (list, tuple)) else p
        if key is not None and key in seen:
            clean.append(None)
        else:
            clean.append(p)
            if key is not None:
                seen.add(key)
    return tuple(clean)


def fit_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """``spec`` with every entry dropped whose mesh axes do not divide the
    dimension they shard."""
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, p in zip(shape, parts):
        if p is None:
            out.append(None)
            continue
        names = tuple(p) if isinstance(p, (tuple, list)) else (p,)
        n = _axis_size(mesh, names)
        out.append(p if (n and dim % n == 0) else None)
    return tuple(out)


def spec_placements(spec: Spec, mesh) -> list:
    """DTensor placements over ``mesh``'s dimensions for ``spec``: a mesh
    dimension that shards tensor dimension i is ``Shard(i)``, any other
    ``Replicate()``.  A tensor dimension over several mesh axes is split
    over them major to minor, as a ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, p in enumerate(spec):
        if p is None:
            continue
        for a in (tuple(p) if isinstance(p, (tuple, list)) else (p,)):
            out[names.index(a)] = Shard(i)
    return out


def placements(axes: Tuple[Optional[str], ...], mesh=None,
               rules: Optional[Dict[str, object]] = None) -> Optional[list]:
    """The placements of logical ``axes`` under the mesh and rules given
    (default: those in force); ``None`` without a mesh.  The counterpart
    of the reference's ``named_sharding``."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    return spec_placements(to_pspec(tuple(axes), rules), mesh)


def _redistribute(x, spec: Spec):
    if not is_dtensor(x):
        return x
    want = spec_placements(spec, x.device_mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by logical names: a DTensor is redistributed to the
    rule's placements; a plain tensor, or any tensor without a mesh, is
    returned as it is."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return x
    return _redistribute(x, to_pspec(tuple(axes), st[1]))


def constrain_divisible(x: torch.Tensor, *axes: Optional[str]
                        ) -> torch.Tensor:
    """Like :func:`constrain`, but an axis that does not divide its
    dimension is dropped (e.g. 'seq_attn' in a one-token decode)."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return x
    mesh, rules = st
    spec = to_pspec(tuple(axes), rules)
    return _redistribute(x, fit_spec(spec, tuple(x.shape), mesh))


# ---------------------------------------------------------------------------
# the model axis's group
# ---------------------------------------------------------------------------


def model_coord() -> Tuple[int, Optional[dist.ProcessGroup]]:
    """(this process's coordinate on the model axis, that axis's process
    group) of the mesh in force: (0, None) without a mesh, or where the
    mesh is a plain shape with no processes behind it."""
    mesh = current_mesh()
    if mesh is None or not hasattr(mesh, "get_group") \
            or "model" not in mesh_shape(mesh):
        return 0, None
    return int(mesh.get_local_rank("model")), mesh.get_group("model")


def tp_split(name: str, t: torch.Tensor
             ) -> Optional[Tuple[int, int, dist.ProcessGroup]]:
    """(this process's coordinate, the axis's size, its group) where the
    rules in force put logical axis ``name`` on 'model' of a process mesh
    with more than one process on that axis, and ``t`` is a plain tensor
    (this process's block of a leaf, or a value computed from one): the
    tensor-parallel layers then compute their partial results and reduce
    them themselves.  None otherwise: no mesh, a plain shape, a model axis
    of one, or DTensors (the dry-run, where DTensor places the
    collectives)."""
    rules = current_rules()
    if not rules or is_dtensor(t) or not on_model(rules.get(name)):
        return None
    m, group = model_coord()
    n = model_size()
    if group is None or n == 1:
        return None
    return m, n, group


def data_axes() -> list:
    """``[(axis, coordinate, size, group)]`` of the data axes ('pod',
    'data') of the process mesh in force whose size passes 1: the axes a
    train step averages its gradients over.  Empty without a mesh, on a
    plain shape, or where every data axis has one process."""
    mesh = current_mesh()
    if mesh is None or not hasattr(mesh, "get_group"):
        return []
    shape = mesh_shape(mesh)
    return [(a, int(mesh.get_local_rank(a)), int(shape[a]),
             mesh.get_group(a))
            for a in ("pod", "data") if int(shape.get(a, 1)) > 1]


def on_model(p) -> bool:
    """True where a spec entry or rule (a mesh axis, a tuple of them or
    None) names 'model'."""
    return "model" in (tuple(p) if isinstance(p, (tuple, list)) else (p,))


def split_dim(spec: Spec) -> Optional[int]:
    """The dimension that ``spec`` splits over 'model', or None."""
    for i, p in enumerate(spec):
        if on_model(p):
            return i
    return None


@contextlib.contextmanager
def model_sharded(dims):
    """Within the block, :func:`model_sharded_leaves` is ``dims``: a tree
    (nested dicts, as the parameters) that gives for each leaf the
    dimension along which each process holds one block of it over the
    model axis, or None for a leaf every process holds whole.  An
    optimizer whose update reduces over a whole leaf (Adafactor's update
    clipping, Sketchy's sketch and trust region) adds up such a leaf's
    blocks over the model axis's group."""
    prev = getattr(_ctx, "sharded", None)
    _ctx.sharded = dims
    try:
        yield
    finally:
        _ctx.sharded = prev


def model_sharded_leaves():
    """The split dimensions :func:`model_sharded` put in force, or None."""
    return getattr(_ctx, "sharded", None)


def _reduce(t: torch.Tensor, group, op: str) -> torch.Tensor:
    """Sum, mean or maximum of ``t`` over ``group`` as a new tensor,
    outside autograd; the active analyzer counts one all-reduce."""
    from repro_torch.kernels import dispatch

    if op not in ("sum", "mean", "max"):
        raise ValueError(f"op {op!r} not in ('sum', 'mean', 'max')")
    n = dist.get_world_size(group)
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    with dispatch.collective("all-reduce", t.numel() * t.element_size(), n):
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                               pin_memory=True)
            host.copy_(t)
            dist.all_reduce(host, op=red, group=group)
            out = host.to(t.device)
        else:
            out = t.clone()
            if out.device.type != "meta":
                dist.all_reduce(out, op=red, group=group)
        if op == "mean":
            out = out / n
    return out


class _AllReduce(torch.autograd.Function):
    """The sum (or mean) over a group; its backward passes the cotangent
    through unchanged (divided by the group's size for the mean), as
    ``psum``'s and ``pmean``'s transposes do where every process holds the
    same cotangent of the result."""

    @staticmethod
    def forward(ctx, t, group, op):
        ctx.n = dist.get_world_size(group) if op == "mean" else 1
        return _reduce(t, group, op)

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.n if ctx.n > 1 else g), None, None


class _EnterGroup(torch.autograd.Function):
    """The identity on a value every process of a group holds; its
    backward sums the processes' cotangents over the group, so the value
    takes the gradient of everything the group computed from it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), ctx.group, "sum"), None


def enter_group(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as it is, marked as an input the processes of ``group`` hold
    alike and compute partial results from: backward sums its cotangents
    over the group (one all-reduce, counted by the analyzer)."""
    return _EnterGroup.apply(t, group)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (``op="sum"``) or mean (``"mean"``) of ``t`` over ``group``,
    in ``t``'s type, as a new tensor that autograd passes through (the
    sum's cotangent unchanged, the mean's divided by the group's size).  A
    CUDA tensor is staged through a pinned host buffer, since the
    processes of one card meet in a gloo group (NCCL refuses two ranks on
    one device) and gloo reduces on the host.  The active program analyzer
    (``launch/hlo.py``) counts it as one all-reduce of ``t``'s bytes over
    the group's size, whatever the device."""
    return _AllReduce.apply(t, group, op)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``t`` over ``group``, as a new tensor
    outside autograd (no gradient flows through it), staged as in
    :func:`all_reduce`."""
    return _reduce(t.detach(), group, "max")


def all_reduce_flat(tensors, group) -> list:
    """The sum over ``group`` of every tensor of ``tensors``, outside
    autograd, with one reduction (one host round trip, one count of the
    analyzer) per dtype: the tensors of a dtype travel as one flat buffer.
    Returns the sums in ``tensors``' order and shapes."""
    out = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = _reduce(flat, group, "sum")
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """The value of ``t`` at the process of coordinate ``src`` in
    ``group``, as a new tensor on every process of it (outside autograd;
    a CUDA tensor staged through pinned host memory, as in
    :func:`all_reduce`).  The active analyzer counts one broadcast."""
    from repro_torch.kernels import dispatch

    n = dist.get_world_size(group)
    with dispatch.collective("broadcast", t.numel() * t.element_size(), n):
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=t.is_cuda)
        host.copy_(t)
        dist.broadcast(host, src=dist.get_global_rank(group, src),
                       group=group)
        return host.to(t.device)
