"""Process groups and devices of a multi-process fleet.

Counterpart of ``repro/launch/mesh.py`` (``make_local_mesh``) and of the
``jax.distributed.initialize`` step of the reference's two-process runs.
PyTorch's idiom is one process a card: a fleet over several cards is a
``FleetTopology`` (``parallel/topology.py``) with one process each, and
every process computes on its :func:`local_device`.

``init_distributed`` builds the ``torch.distributed.TCPStore`` the
processes meet through, initializes the default process group on it and
keeps the store: a multi-process topology's default transport
(``parallel/topology.py::StoreTransport``) moves node states through it as
host bytes, so no device collective is needed and two processes may share
one card.  It also splits the host's cores among the processes (torchrun's
default for processes on one host): each process's default intra-op pool,
every core, would oversubscribe the host once for every process.  Nothing
here runs at import.

The meshes of the logical-axis rules (``parallel/sharding.py``) are
``torch.distributed.DeviceMesh``es over ("data", "model") or ("pod",
"data", "model"):

* :func:`make_production_mesh` and :func:`make_debug_mesh` for the
  abstract dry-run (``launch/dryrun.py``): meshes over a *fake* default
  group (:func:`init_fake_world`), the counterpart of the reference's 512
  placeholder host devices.  Its ranks exist only as numbers: this
  process plays rank 0, and its collectives move nothing.
* :func:`make_process_mesh` and :func:`make_host_mesh` over the processes
  of :func:`init_distributed`'s gloo group: the expert-parallel MoE
  across processes (two of them may share one card).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.dispatch import resolve_device

# the store this process's default group was built on (init_distributed)
_STORE: Optional[dist.Store] = None


def host_threads(processes: int) -> int:
    """Intra-op CPU threads a process gets when ``processes`` processes
    share this host's cores (those this process may run on) evenly."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:              # no affinity mask on this platform
        cores = os.cpu_count() or 1
    return max(1, cores // max(1, int(processes)))


def pin_host_threads(processes: int) -> int:
    """Set this process's intra-op CPU threads to :func:`host_threads` of
    ``processes`` (the processes that share this host's cores) unless
    ``OMP_NUM_THREADS`` sets them; returns the count in force."""
    if "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(host_threads(processes))
    return torch.get_num_threads()


def init_distributed(rank: int, world_size: int, addr: str = "127.0.0.1",
                     port: int = 29500, backend: str = "gloo", *,
                     timeout_s: float = 300.0) -> dist.Store:
    """Join a ``world_size``-process group as process ``rank``: process 0
    serves a ``TCPStore`` on ``addr:port``, the others connect to it, and
    the default process group is initialized on that store.  Returns the
    store, which :func:`default_store` hands to the fleet's transport.
    This process's intra-op CPU threads are pinned to its share of the
    host (:func:`pin_host_threads` of ``world_size``)."""
    global _STORE
    rank, world_size = int(rank), int(world_size)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in "
                           "this process")
    pin_host_threads(world_size)
    store = dist.TCPStore(addr, int(port), world_size, rank == 0,
                          timeout=datetime.timedelta(seconds=timeout_s))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _STORE = store
    return store


def process_runtime() -> Tuple[int, int]:
    """(world size, rank) of ``torch.distributed``, (1, 0) without it."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def default_store() -> dist.Store:
    """The store :func:`init_distributed` built; raises before it ran."""
    if _STORE is None:
        raise RuntimeError(
            "no fleet store: call repro_torch.launch.mesh.init_distributed("
            "rank, world_size, addr, port) first, or pass an explicit "
            "transport (DirTransport/MemTransport) to FleetTopology")
    return _STORE


def shutdown() -> None:
    """Leave the process group and drop the store."""
    global _STORE
    if dist.is_initialized():
        dist.destroy_process_group()
    _STORE = None


def init_fake_world(world_size: int) -> None:
    """Initialize a default process group of ``world_size`` placeholder
    ranks, this process rank 0, whose collectives move nothing (torch's
    fake backend, used for abstract programs on ``meta`` tensors).  Its
    store comes from torch's testing package, the one place the port
    imports it; a torch without it raises."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:                      # pragma: no cover
        raise RuntimeError(
            "this torch has no fake process group (torch.testing._internal."
            "distributed.fake_pg); the dry-run needs it") from e
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in "
                           "this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))


def _mesh_over_world(shape: Tuple[int, ...], names: Tuple[str, ...],
                     fake_world: int):
    """A ``DeviceMesh`` of ``shape`` over ranks 0..n-1 of the default group,
    which is made a fake world of ``fake_world`` ranks when there is none;
    the group must hold the mesh's ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        init_fake_world(max(n, fake_world))
    if dist.get_world_size() < n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"default group has {dist.get_world_size()}")
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The dry-run's mesh: (16, 16) over ("data", "model"), or (2, 16, 16)
    over ("pod", "data", "model") with ``multi_pod``, on a fake world of
    512 ranks (both meshes fit it)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh_over_world(shape, axes, 512)


def make_debug_mesh(n_data: int = 2, n_model: int = 2):
    """A small ("data", "model") mesh over the first ranks of the default
    group (a fake world of that size when there is none)."""
    return _mesh_over_world((int(n_data), int(n_model)), ("data", "model"),
                            int(n_data) * int(n_model))


def make_process_mesh(n_model: int, device="cuda"):
    """The processes of :func:`init_distributed`'s group as a ("data",
    "model") mesh with ``n_model`` on the model axis: expert parallelism
    across processes.  Its group reduces on the host (gloo), so processes
    that share one card may form it; they compute on the card unless
    ``device`` names the CPU."""
    resolve_device(device)
    world, _ = process_runtime()
    if not dist.is_initialized() or world % int(n_model):
        raise ValueError(f"a model axis of {n_model} needs an initialized "
                         f"group whose size it divides (size {world})")
    return _mesh_over_world((world // int(n_model), int(n_model)),
                            ("data", "model"), world)


def make_host_mesh(device="cuda"):
    """This process's group on "data", no model parallelism (the
    reference's all local devices on 'data'): a mesh over
    :func:`init_distributed`'s group, or the plain shape ``{"data": 1,
    "model": 1}`` in a process without one."""
    resolve_device(device)
    if not dist.is_initialized():
        return {"data": 1, "model": 1}
    return make_process_mesh(1, device)


def local_device(topology, device="cuda") -> torch.device:
    """This process's device: a bare ``"cuda"`` becomes card
    ``pid % device_count`` (on one card every process shares ``cuda:0``;
    with one card a process, each gets its own), which is made the current
    device so kernels launch on its streams.  ``"cpu"`` and an indexed
    card are taken as they are."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda",
                               int(topology.pid) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev
