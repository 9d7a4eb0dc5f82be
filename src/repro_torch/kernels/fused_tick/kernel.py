"""ctypes binding of ``csrc/fused_tick.cu`` (one CTA per stream).

Each wrapper checks what the kernel takes (a contiguous f32 CUDA slab, a
buffer the route sends to one CTA: ``fused_tick_smem_bytes`` within the
card's limit), allocates the outputs, launches on PyTorch's current stream
without synchronising, raises on a nonzero ``cudaGetLastError()``, and
adds one to its ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = {}


def _lib() -> ctypes.CDLL:
    lib = _bound.get("lib")
    if lib is None:
        lib = dispatch.load("fused_tick")
        lib.fused_tick_smem_bytes.argtypes = [_I, _I]
        lib.fused_tick_smem_bytes.restype = ctypes.c_size_t
        lib.fused_tick_kernel_smem.argtypes = [_I, _I, _I]
        lib.fused_tick_kernel_smem.restype = ctypes.c_size_t
        lib.fused_tick_max_smem.argtypes = [_I]
        lib.fused_tick_max_smem.restype = _I
        lib.fused_tick_error_string.argtypes = [_I]
        lib.fused_tick_error_string.restype = ctypes.c_char_p
        lib.fused_tick_gram_power.argtypes = [_P, _P, _P] + [_I] * 5 + [_P]
        lib.fused_tick_gram_power.restype = _I
        lib.fused_tick_step.argtypes = [_P] * 7 + [_I] * 5 + [_P]
        lib.fused_tick_step.restype = _I
        _bound["lib"] = lib
    return lib


def _check(lib, D: torch.Tensor, name: str) -> None:
    if not D.is_cuda or D.dtype != torch.float32 or D.dim() != 3 \
            or not D.is_contiguous():
        raise ValueError(
            f"{name} takes a contiguous float32 CUDA tensor (S, m, d), got "
            f"{tuple(D.shape)} {D.dtype} on {D.device}"
            f"{'' if D.is_contiguous() else ' (not contiguous)'}")
    _, m, d = D.shape
    need = lib.fused_tick_smem_bytes(m, d)
    have = max_smem(D.device)
    if need > have:
        raise ValueError(
            f"{name}: a buffer of m={m} rows by d={d} needs {need} B of shared "
            f"memory for D and K in one CTA, more than the {have} B this card "
            "gives a block; ops.gram_power and ops.fused_krylov_step take "
            "the split path for such buffers")


def max_smem(device: torch.device) -> int:
    """Shared memory a block may opt in to on ``device`` (bytes)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    have = _lib().fused_tick_max_smem(index)
    if have < 0:
        raise RuntimeError(f"cannot read the shared-memory limit of {device}")
    return have


def smem_bytes(m: int, d: int) -> int:
    """``fused_tick_smem_bytes`` of the C library (the card tests hold the
    Python copy of the formula in ``ops`` to it)."""
    return _lib().fused_tick_smem_bytes(m, d)


def kernel_smem(m: int, d: int, step: bool) -> int:
    """Shared memory (bytes) a launch of the step (``step``) or of
    gram_power requests for an (m, d) buffer, 0 where it has no layout
    (``fused_tick_kernel_smem``; the card tests hold it within
    ``smem_bytes`` at every shape the route sends to the kernels)."""
    return _lib().fused_tick_kernel_smem(m, d, int(step))


def gram_power_cuda(D: torch.Tensor, iters: int, floor_norm: bool = False):
    """(λ̂ (S,), û (S, m)) of K = DDᵀ per stream, on the card.
    ``floor_norm`` as in ``ops``."""
    lib = _lib()
    _check(lib, D, "gram_power")
    S, m, d = D.shape
    lam = torch.empty((S,), dtype=torch.float32, device=D.device)
    u = torch.empty((S, m), dtype=torch.float32, device=D.device)
    if S:
        with dispatch.on_device(D):
            err = lib.fused_tick_gram_power(D.data_ptr(), lam.data_ptr(),
                                            u.data_ptr(), S, m, d, int(iters),
                                            int(floor_norm),
                                            dispatch.cuda_stream(D))
        dispatch.raise_on_launch(err, lib.fused_tick_error_string,
                                 "gram_power")
        gram_power_cuda.launches += 1
    return lam, u


gram_power_cuda.launches = 0


def fused_krylov_step_cuda(D: torch.Tensor, lam: torch.Tensor,
                           u: torch.Tensor, iters: int,
                           floor_norm: bool = False):
    """One krylov dump step per stream, on the card.  Returns
    (snap (S, d), D′ (S, m, d), λ̂′ (S,), û′ (S, m))."""
    lib = _lib()
    _check(lib, D, "fused_krylov_step")
    S, m, d = D.shape
    for t, shape, nm in ((lam, (S,), "lam"), (u, (S, m), "u")):
        if not t.is_cuda or t.device != D.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_krylov_step: {nm} must be a contiguous float32 tensor "
                f"{shape} on {D.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    snap = torch.empty((S, d), dtype=torch.float32, device=D.device)
    D2 = torch.empty_like(D)
    lam2 = torch.empty((S,), dtype=torch.float32, device=D.device)
    u2 = torch.empty((S, m), dtype=torch.float32, device=D.device)
    if S:
        with dispatch.on_device(D):
            err = lib.fused_tick_step(
                D.data_ptr(), lam.data_ptr(), u.data_ptr(), snap.data_ptr(),
                D2.data_ptr(), lam2.data_ptr(), u2.data_ptr(), S, m, d,
                int(iters), int(floor_norm), dispatch.cuda_stream(D))
        dispatch.raise_on_launch(err, lib.fused_tick_error_string,
                                 "fused_krylov_step")
        fused_krylov_step_cuda.launches += 1
    return snap, D2, lam2, u2


fused_krylov_step_cuda.launches = 0
