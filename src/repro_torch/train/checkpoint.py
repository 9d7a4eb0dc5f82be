"""Fault-tolerant checkpoints: atomic manifest + one ``.npy`` per leaf.

This package's own copy of ``repro/train/checkpoint.py``; the on-disk
layout is the same byte for byte, so each package restores the other's
checkpoints::

    <dir>/step_000123/
        manifest.json        {step, paths, dtypes, shapes, mesh_shape,
                              data_state, sketch_spec, wallclock, format}
        leaf_000000.npy ...  one file per leaf, in path order

A tree is nested dicts (keys sorted), lists, tuples and NamedTuples whose
leaves are tensors, numpy arrays or scalars; ``None`` holds no leaf.  The
leaf order and the path strings are those of ``jax.tree_util`` on the same
tree: ``['key']`` for a dict key, ``[i]`` for a sequence item, ``.field``
for a NamedTuple field.  bfloat16 is saved as its ``uint16`` bit pattern
and restored as ``torch.bfloat16``.

Writes go to ``<dir>/.tmp-<pid>-<step>`` and are ``os.replace``d into
place, so a crash mid-save never corrupts the latest checkpoint.  The
processes of a mesh save one tree together (:func:`save_sharded`, the
same files: process 0 writes the whole leaves and each block's holder
fills its block of the full array in place) and restore their own blocks
of it (``restore(blocks=)``), whatever mesh saved it.
Re-saving a step renames the old directory aside first and prunes it only
after the new one has landed (replace-then-prune).  A directory holding
:data:`HISTORY_MARKER` belongs to a history spill tier: retention never
prunes it, the sweep never collects it and a save never renames it aside.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device

_STEP_RE = re.compile(r"step_(\d+)$")
_JUNK_RE = re.compile(r"\.(?:tmp|old)-(\d+)-")
_TRASH_COUNTER = itertools.count()

# Sentinel file planted by the history plane's spill tier
# (``sketch/history.py``) in every directory it owns: such a directory is
# append-only retired history, never a replaceable checkpoint.
HISTORY_MARKER = ".sketch-history"


def _protected(path: str) -> bool:
    """True for directories claimed by a history spill tier."""
    return os.path.isfile(os.path.join(path, HISTORY_MARKER))


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:          # EPERM etc. — someone owns it, it's alive
        return True
    return True


def _sweep_stale(ckpt_dir: str) -> None:
    """Remove ``.tmp-*``/``.old-*`` save intermediates of dead pids.

    A complete orphan (its manifest, written after every leaf, is there)
    of a step with no ``step_*`` directory is promoted back to its name
    instead — ``.tmp`` first, since it holds the newer data."""
    junk = [d for d in os.listdir(ckpt_dir)
            if (m := _JUNK_RE.match(d)) and not _pid_alive(int(m.group(1)))]
    for d in sorted(junk, key=lambda s: not s.startswith(".tmp")):
        path = os.path.join(ckpt_dir, d)
        if _protected(path):           # a history tier is never debris
            continue
        mpath = os.path.join(path, "manifest.json")
        if os.path.isfile(mpath):
            try:
                with open(mpath) as f:
                    step = int(json.load(f)["step"])
                final = os.path.join(ckpt_dir, f"step_{step:09d}")
                if not os.path.exists(final):
                    os.replace(path, final)
                    continue
            except (OSError, ValueError, KeyError,
                    json.JSONDecodeError):
                pass                     # unreadable/raced → plain debris
        shutil.rmtree(path, ignore_errors=True)


# ---------------------------------------------------------------------------
# Trees: the leaf order and paths of jax.tree_util
# ---------------------------------------------------------------------------


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``[(path piece, child)]`` of a container, None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    return None


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` depth first; ``None`` holds no leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for piece, child in kids:
        out.extend(leaves_with_paths(child, prefix + piece))
    return out


def _unflatten(tree_like, it):
    """``tree_like``'s structure with its leaves taken from ``it``."""
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        return {k: _unflatten(tree_like[k], it) for k in sorted(tree_like)}
    if isinstance(tree_like, tuple) and hasattr(tree_like, "_fields"):
        return type(tree_like)(*(_unflatten(x, it) for x in tree_like))
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(x, it) for x in tree_like)
    return next(it)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (bf16 as its tagged bit pattern)."""
    if isinstance(leaf, np.ndarray):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Bf16(t.view(torch.int16).numpy().view(np.uint16))
        return t.numpy()
    return np.asarray(leaf)


class _Bf16(np.ndarray):
    """The uint16 bit pattern of a bfloat16 array, tagged so the manifest
    records ``bfloat16``."""

    def __new__(cls, bits: np.ndarray):
        return np.asarray(bits).view(cls)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if isinstance(arr, _Bf16) else str(arr.dtype)


# ---------------------------------------------------------------------------
# Save / retention / restore
# ---------------------------------------------------------------------------


def save(ckpt_dir: str, step: int, tree, *, data_state: Optional[Dict] = None,
         mesh_shape: Optional[Tuple[int, ...]] = None,
         sketch_spec: Optional[Dict] = None, keep: int = 3) -> str:
    """Blocking atomic save; returns the checkpoint's path.
    ``sketch_spec`` is the fleet section of the manifest
    (``sketch/api.py::save_fleet``)."""
    flat = leaves_with_paths(tree)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = os.path.join(ckpt_dir, f".tmp-{os.getpid()}-{step}")
    os.makedirs(tmp, exist_ok=True)
    _sweep_stale(ckpt_dir)
    manifest = {
        "step": int(step),
        "paths": [p for p, _ in flat],
        "dtypes": [], "shapes": [],
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "data_state": data_state,
        "sketch_spec": sketch_spec,
        "wallclock": time.time(),
        "format": 1,
    }
    for i, (_, leaf) in enumerate(flat):
        arr = _host(leaf)
        manifest["dtypes"].append(_dtype_name(arr))
        manifest["shapes"].append(list(arr.shape))
        np.save(os.path.join(tmp, f"leaf_{i:06d}.npy"),
                np.asarray(arr, order="C").view(np.ndarray))
    _land(ckpt_dir, step, tmp, final, manifest, keep)
    return final


def _land(ckpt_dir: str, step: int, tmp: str, final: str, manifest: Dict,
          keep: int) -> None:
    """Write the manifest into ``tmp`` (after every leaf), rename it into
    place as ``final`` and prune to the newest ``keep``."""
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # Replace-then-prune: a crash between the two renames leaves both
    # copies on disk (the old under ``.old-*``, the new under ``.tmp-*``);
    # the next save's sweep promotes the newest complete one back.
    if os.path.exists(final):
        if _protected(final):
            shutil.rmtree(tmp, ignore_errors=True)
            raise ValueError(
                f"refusing to save step {int(step)}: {final!r} is a "
                f"history spill directory (it contains {HISTORY_MARKER!r})"
                " — renaming it aside would destroy retired sketch "
                "history; save under a different checkpoint root or step")
        while True:
            trash = os.path.join(
                ckpt_dir,
                f".old-{os.getpid()}-{step}-{next(_TRASH_COUNTER)}")
            if not os.path.exists(trash):   # stale trash from a crash
                break
        os.replace(final, trash)
        os.replace(tmp, final)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.replace(tmp, final)
    # never prune the checkpoint just written (keep=0, or a save below
    # stale newer steps after a rollback)
    _retain(ckpt_dir, max(int(keep), 1), protect=int(step))


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one process's tree lies in a checkpoint's full arrays, leaf
    by leaf in leaf order: ``shapes`` the full shapes, ``blocks`` this
    process's block of each (a slice a dimension; None where it holds the
    leaf whole).  ``writer``: this process writes its blocks (one process
    of those holding a block).  The processes meet through ``store`` (a
    ``torch.distributed.Store``, not the process group, so that a save on
    a worker thread never races the train step's collectives) as process
    ``rank`` of ``world``; process 0 writes the whole leaves, the manifest
    and the rename."""
    shapes: Tuple[Tuple[int, ...], ...]
    blocks: Tuple[Optional[Tuple[slice, ...]], ...]
    writer: bool
    rank: int
    world: int
    store: Any

    def writes(self, i: int) -> bool:
        """This process writes leaf ``i`` (whole, or its block)."""
        if self.blocks[i] is None:
            return self.rank == 0
        return self.writer


def _signal(store, key: str, fn: Callable[[], Any]):
    """Run ``fn``; on a failure publish its message under ``key`` before
    raising, so that the waiting processes raise too."""
    try:
        return fn()
    except BaseException as e:
        store.set(key, "!" + repr(e))
        raise


def _await(store, key: str) -> str:
    """The value of ``key`` once it is set (the store's timeout applies);
    raises where a process published a failure there."""
    store.wait([key])
    val = store.get(key).decode()
    if val.startswith("!"):
        raise RuntimeError(f"checkpoint save failed in another process: "
                           f"{val[1:]}")
    return val


def save_sharded(ckpt_dir: str, step: int, paths: List[str],
                 arrays: List[Optional[np.ndarray]], layout: Layout,
                 key: str, *, data_state: Optional[Dict] = None,
                 mesh_shape: Optional[Tuple[int, ...]] = None,
                 keep: int = 3) -> str:
    """Blocking atomic save of a tree that the processes of a mesh hold in
    blocks, in the layout of :func:`save` (full arrays), so that any
    process count restores it.  ``arrays`` are this process's host leaves
    (those it writes, by ``layout.writes``; None elsewhere).  Process 0
    makes the temporary directory, writes every leaf it holds whole and
    lays out each split leaf as an empty ``.npy`` of its full shape; each
    writer then fills its blocks in place through ``np.lib.format.
    open_memmap``; once every process has reported to the store under
    ``key``, process 0 writes the manifest and renames.  Every process
    returns after the rename."""
    L = layout
    final = os.path.join(ckpt_dir, f"step_{step:09d}")

    def prepare() -> str:
        tmp = os.path.join(ckpt_dir, f".tmp-{os.getpid()}-{step}")
        os.makedirs(tmp, exist_ok=True)
        _sweep_stale(ckpt_dir)
        for i, (arr, block) in enumerate(zip(arrays, L.blocks)):
            path = os.path.join(tmp, f"leaf_{i:06d}.npy")
            if block is None:
                np.save(path, np.asarray(arr, order="C").view(np.ndarray))
            else:
                np.lib.format.open_memmap(path, mode="w+", dtype=arr.dtype,
                                          shape=tuple(L.shapes[i]))
        return tmp

    if L.rank == 0:
        tmp = _signal(L.store, f"{key}/tmp", prepare)
        L.store.set(f"{key}/tmp", tmp)
    else:
        tmp = _await(L.store, f"{key}/tmp")

    def fill() -> None:
        for i, (arr, block) in enumerate(zip(arrays, L.blocks)):
            if block is None or not L.writer:
                continue
            mm = np.load(os.path.join(tmp, f"leaf_{i:06d}.npy"),
                         mmap_mode="r+")
            mm[block] = np.asarray(arr).view(np.ndarray)
            mm.flush()
            del mm

    _signal(L.store, f"{key}/done/{L.rank}", fill)
    L.store.set(f"{key}/done/{L.rank}", "1")
    if L.rank != 0:
        _await(L.store, f"{key}/landed")
        return final

    def land() -> None:
        for r in range(L.world):
            _await(L.store, f"{key}/done/{r}")
        manifest = {
            "step": int(step), "paths": list(paths),
            "dtypes": [_dtype_name(a) for a in arrays],
            "shapes": [list(sh) for sh in L.shapes],
            "mesh_shape": list(mesh_shape) if mesh_shape else None,
            "data_state": data_state, "sketch_spec": None,
            "wallclock": time.time(), "format": 1,
        }
        _land(ckpt_dir, step, tmp, final, manifest, keep)

    _signal(L.store, f"{key}/landed", land)
    L.store.set(f"{key}/landed", final)
    return final


def _step_entries(ckpt_dir: str) -> List[Tuple[int, str]]:
    """``(step, dirname)`` of every ``step_<digits>`` directory that is
    not a history spill tier, by step; stray entries are ignored."""
    out = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.fullmatch(d)
        path = os.path.join(ckpt_dir, d)
        if m and os.path.isdir(path) and not _protected(path):
            out.append((int(m.group(1)), d))
    return sorted(out)


def _retain(ckpt_dir: str, keep: int, *,
            protect: Optional[int] = None) -> None:
    """Prune to the newest ``keep`` checkpoints (``keep=0`` deletes all);
    the step ``protect`` is never pruned."""
    steps = _step_entries(ckpt_dir)
    n_del = max(len(steps) - keep, 0)
    for s, d in steps[:n_del]:
        if protect is not None and s == protect:
            continue
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _step_entries(ckpt_dir)
    return steps[-1][0] if steps else None


def read_manifest(ckpt_dir: str, *, step: Optional[int] = None) -> Dict:
    """A checkpoint's manifest, without reading its leaves."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _to_tensor(arr: np.ndarray, dtype: str, dev) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = torch.from_numpy(np.asarray(arr, order="C").view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.asarray(arr, order="C")).to(dev)


def restore(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
            device="cuda",
            host_leaves: Optional[Callable[[str], bool]] = None,
            blocks: Optional[Callable[[int, Tuple[int, ...]],
                                      Optional[Tuple[slice, ...]]]] = None
            ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (only its structure is
    read); returns ``(tree, manifest)``.  Leaves become tensors on
    ``device`` at their saved dtype; leaves whose manifest path
    ``host_leaves`` accepts stay numpy arrays at their on-disk dtype.
    ``blocks(i, full_shape)`` gives the block (a slice a dimension) of
    leaf ``i`` that this process keeps, or None for all of it: the full
    arrays on disk suit any mesh, and only the block is read."""
    dev = resolve_device(device)
    manifest = read_manifest(ckpt_dir, step=step)
    path = os.path.join(ckpt_dir, f"step_{manifest['step']:09d}")
    n = len(leaves_with_paths(tree_like))
    if n != len(manifest["paths"]):
        raise ValueError(
            f"tree mismatch: {n} leaves vs manifest "
            f"{len(manifest['paths'])}")
    leaves = []
    for i in range(n):
        file = os.path.join(path, f"leaf_{i:06d}.npy")
        block = blocks(i, tuple(manifest["shapes"][i])) if blocks else None
        if block is None:
            arr = np.load(file)
        else:
            # a copy: a block of leading rows is a view of the read-only
            # mapping, which a CPU tensor would share (and an in-place
            # update then writes into)
            arr = np.array(np.load(file, mmap_mode="r")[block], order="C")
        dtype = manifest["dtypes"][i]
        if host_leaves is not None and host_leaves(manifest["paths"][i]):
            leaves.append(arr)
        else:
            leaves.append(_to_tensor(arr, dtype, dev))
    return _unflatten(tree_like, iter(leaves)), manifest


def host_copy(tree):
    """``tree`` with every leaf copied to a host numpy array (bf16 as its
    bit pattern), so a save may run while the caller goes on."""
    return _unflatten(tree, (_host(leaf).copy()
                             for _, leaf in leaves_with_paths(tree)))


class AsyncCheckpointer:
    """One-slot async saver: a save runs on a worker thread; a newer save
    waits for the previous one to land (the host copy of the tree exists
    once).  With a :class:`Layout` the processes of a mesh save one tree
    together (:func:`save_sharded`); each copies to the host only the
    leaves it writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3, *,
                 layout: Optional[Layout] = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.layout = layout
        self._saves = 0
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def save(self, step: int, tree, **kw) -> None:
        self.wait()
        # the device → host copy on the caller's thread, in its stream order
        if self.layout is None:
            host_tree = host_copy(tree)

            def run():
                return save(self.ckpt_dir, step, host_tree, keep=self.keep,
                            **kw)
        else:
            flat = leaves_with_paths(tree)
            arrays = [_host(x).copy() if self.layout.writes(i) else None
                      for i, (_, x) in enumerate(flat)]
            # the same key in every process: they save in the same order
            key = f"ckpt:{os.path.abspath(self.ckpt_dir)}:{self._saves}"
            self._saves += 1

            def run():
                return save_sharded(self.ckpt_dir, step,
                                    [p for p, _ in flat], arrays,
                                    self.layout, key, keep=self.keep, **kw)

        def work():
            try:
                self.last_path = run()
            except BaseException as e:   # noqa: BLE001 — surfaced in wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            e, self.error = self.error, None
            raise e
