"""Where a computation runs, and the build of the hand-written kernels.

Counterpart of ``repro/kernels/dispatch.py``.  There the lowering was a
choice (pallas / interpret / ref, with an environment override); here the
tensor decides and nothing else does:

- a CUDA tensor goes to the hand-written kernel, built from
  ``repro_torch/csrc/*.cu``;
- a CPU tensor goes to the kernel's plain PyTorch version (``ref.py``);
- any other device raises.

There is no override and no fallback: a kernel that fails to build or to
launch raises.

The build is route (b) of a CUDA C++ port: ``nvcc`` compiles each source
into a shared library with a plain C interface under ``build/repro_torch/``
of the checkout, and ``ctypes`` loads it.  It runs at the first call on a
CUDA tensor (or an explicit :func:`build`), never at import, so the package
imports on machines without ``nvcc``.  Library names carry a digest of the
source, the headers under ``csrc/`` (``*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.

Each kernel's ``ops.py`` entry also tells the program analyzer
(``launch/hlo.py``), when one is active, the work of one launch by the
formula its bound uses (:func:`kernel_work`): a launch through ``ctypes``
is invisible to a dispatch mode, and the plain version's own ops are not
the kernel's work, so a step counts the same on the card, the CPU and
``meta``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# an H100's opt-in shared memory a block (bytes) and its SMs: the limits
# the launch plans assume for CPU tensors and where no card is given
H100_SMEM_PER_BLOCK, H100_SMS = 232_448, 132

_LIBS: Dict[str, ctypes.CDLL] = {}

# the program analyzer in force (launch/hlo.py::analyze sets it), or None
WORK_HOOK = None


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source; the message holds its output."""


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (hand-written kernel), False for a CPU tensor
    (plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for device {t.device}")


def kernel_work(name: str, flops: float, nbytes: float,
                dtype: torch.dtype = torch.float32):
    """A context around one launch of kernel ``name`` (or its plain
    version) doing ``flops`` operations in ``dtype`` (the type its
    arithmetic runs in) and moving ``nbytes``: the active analyzer counts
    that work once and none of the ops inside."""
    hook = WORK_HOOK
    if hook is None:
        return _CURRENT
    return hook.kernel(name, float(flops), float(nbytes), dtype)


def collective(op: str, nbytes: float, group_size: int):
    """A context around one collective ``op`` ("all-reduce", ...) of
    ``nbytes`` over ``group_size`` processes that the port issues itself
    (``parallel/sharding.py::all_reduce``): the active analyzer counts it
    by the ring model and none of the ops inside (the host staging)."""
    hook = WORK_HOOK
    if hook is None:
        return _CURRENT
    return hook.collective(op, float(nbytes), int(group_size))


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  The default is the card; the
    CPU runs only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise KernelBuildError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin); the "
        "CUDA kernels of repro_torch need the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def sources() -> list:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all), one ``nvcc`` per source,
    all started together.  Returns ``{name: library path}``; the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept next
    to each library as ``<lib>.log``."""
    names = sources() if names is None else list(names)
    out: Dict[str, Path] = {}
    jobs = []
    for name in names:
        lib = _library_path(name)
        out[name] = lib
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, lib))
    failures = []
    for name, proc, tmp, lib in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, lib)
        lib.with_name(lib.name + ".log").write_text(text)
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


def cuda_stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as the ``void*`` a kernel
    entry takes.  Read with the private ``torch._C._cuda_getCurrentRawStream``
    (what ``torch.cuda.current_stream`` builds its ``Stream`` from), which
    skips building that object on every launch; known to work with torch
    2.11 (CUDA 12.8)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


_CURRENT = contextlib.nullcontext()


def on_device(t: torch.Tensor):
    """A context in which ``t``'s card is the current one, for every kernel
    wrapper's launch; a no-op when it already is."""
    if t.device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(t.device)


def check_cuda_tensor(t: torch.Tensor, what: str, dtypes, dim: int,
                      device: Optional[torch.device] = None) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dim``-d CUDA
    tensor of one of ``dtypes`` (on ``device`` when given)."""
    if not t.is_cuda or (device is not None and t.device != device) \
            or t.dtype not in dtypes or t.dim() != dim \
            or not t.is_contiguous():
        names = " or ".join(str(x).replace("torch.", "") for x in dtypes)
        raise ValueError(
            f"{what} must be a contiguous {dim}-d {names} CUDA tensor"
            f"{'' if device is None else f' on {device}'}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def raise_on_launch(err: int, error_string, name: str) -> None:
    """Raise if a kernel entry returned a nonzero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{error_string(err).decode()}")
