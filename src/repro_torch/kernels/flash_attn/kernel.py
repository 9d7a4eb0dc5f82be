"""ctypes bindings of ``csrc/flash_attn.cu`` (the forward: bf16 on the
tensor cores, f32 on the CUDA cores; one CTA per (bh, q-tile)) and
``csrc/flash_attn_bwd.cu`` (the backward: bf16 on the tensor cores, f32 on
the CUDA cores; both share ``csrc/hopper_tc.cuh``'s wgmma and TMA
helpers).

``flash_fwd`` and ``flash_bwd`` check what their kernels take (contiguous
bf16 or f32 CUDA tensors of one type and device, dh ∈ {64, 128}, S a
multiple of the kernel's tile, tiles that fit one CTA's shared memory),
allocate the outputs and scratch, launch on PyTorch's current stream
without synchronising, raise on a nonzero ``cudaGetLastError()``, and add
one to ``flash_fwd.launches`` or ``flash_bwd.launches``.

:func:`f32_plan` and :func:`bwd_plan` are the C libraries' launch plans of
the f32 kernels (``flash_attn_f32_plan``, ``flash_attn_bwd_plan``) in
Python, for the CPU and the tests; :func:`plan` asks the library on the
card, with the resident CTAs a SM that only the card knows.
:func:`tc_bwd_smem` mirrors the bf16 backward's shared memory
(``flash_attn_bwd_tc_smem_bytes``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import dispatch

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = {}
_fit = {}            # (wrapper, dh, card) -> (tile, smem needed, smem given)
HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _lib() -> ctypes.CDLL:
    lib = _bound.get("lib")
    if lib is None:
        lib = dispatch.load("flash_attn")
        lib.flash_attn_tile.argtypes = []
        lib.flash_attn_tile.restype = _I
        lib.flash_attn_smem_bytes.argtypes = [_I]
        lib.flash_attn_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attn_max_smem.argtypes = [_I]
        lib.flash_attn_max_smem.restype = _I
        lib.flash_attn_error_string.argtypes = [_I]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        lib.flash_attn_f32_plan.argtypes = [_I, _I, _I,
                                            ctypes.POINTER(_I)]
        lib.flash_attn_f32_plan.restype = _I
        lib.flash_attn_fwd.argtypes = [_P] * 5 + [_I] * 6 + [ctypes.c_float,
                                                             _P]
        lib.flash_attn_fwd.restype = _I
        _bound["lib"] = lib
    return lib


STREAM = 64         # rows of a streamed tile: S must be a multiple


def _row(w: int, dh: int) -> int:
    """Floats a row of a row-major tile ``w`` wide takes (``row_floats``
    of ``csrc/flash_f32.cuh``: padded by 4 at dh = 64)."""
    return w + 4 if dh == 64 else w


def f32_plan(dh: int, S: int, BH: int) -> tuple:
    """``flash_attn_f32_plan`` of ``csrc/flash_attn.cu``: (threads, query
    rows a CTA, dynamic shared memory in bytes, grid.x, grid.y) of the f32
    forward at head dimension ``dh``: Q transposed (dh × 128), the K ring
    (2 tiles), the V tile and P (a tile's keys × 128), in f32; a KV tile
    is 128 keys at dh = 64 and 64 at dh = 128."""
    rows, kv = 128, (128 if dh == 64 else 64)
    smem = 4 * (dh * rows + 3 * kv * _row(dh, dh) + kv * _row(rows, dh))
    return 256, rows, smem, BH, -(-S // rows)


def bwd_plan(dh: int, S: int, BH: int, BHkv: int) -> tuple:
    """``flash_attn_bwd_plan`` of ``csrc/flash_attn_bwd.cu``: the tiled
    kernel's (threads, rows of a kept tile, dynamic shared memory in
    bytes, dK/dV CTAs, dQ CTAs).  256 threads and 128 rows at dh = 64, 128
    and 64 at dh = 128; the shared memory is the larger of the two roles':
    dQ keeps Q and dO (dh × rows each), the K and V rings, dS, lse and D;
    dK/dV keeps K and V, the Q and dO rings, P and dS, and the lse and D
    rings."""
    threads = 256 if dh == 64 else 128
    rows = threads // 2
    tiles = -(-S // rows)
    ring = 4 * STREAM * _row(dh, dh)
    dq = 4 * (2 * dh * rows + ring + STREAM * _row(rows, dh) + 2 * rows)
    dkv = 4 * (2 * dh * rows + ring + 2 * STREAM * _row(rows, dh)
               + 4 * STREAM)
    return threads, rows, max(dq, dkv), BHkv * tiles, BH * tiles


def tc_bwd_smem(dh: int) -> int:
    """``flash_attn_bwd_tc_smem_bytes`` of ``csrc/flash_attn_bwd.cu``: the
    bf16 backward's dynamic shared memory at head dimension ``dh``, in
    bytes: two consumers' kept tiles A and B and three stages of streamed
    tiles X and Y, each 64 rows of dh bf16 values (8 KB a 64-column
    panel), three stages of lse and D (64 f32 each), seven mbarriers and
    1 KB to align the base to the 128-byte swizzle's 1024 bytes."""
    tile = (dh // 64) * 64 * 128
    return 2 * 2 * tile + 3 * 2 * tile + 3 * 2 * 64 * 4 + 8 * 7 + 1024


def waves(ctas: int, resident: int, sms: int = dispatch.H100_SMS) -> float:
    """Waves of a grid of ``ctas`` CTAs over ``sms`` SMs at ``resident``
    CTAs a SM."""
    return ctas / (sms * resident)


def plan(dh: int, S: int, BH: int, BHkv: int,
         device: torch.device) -> dict:
    """The C libraries' plans on ``device``'s card: {"fwd": (threads,
    rows, shared memory, grid.x, grid.y, resident CTAs a SM), "bwd":
    (threads, rows, shared memory, dK/dV CTAs, dQ CTAs, resident CTAs a
    SM)}."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    with torch.cuda.device(index):
        f = (ctypes.c_int * 6)()
        dispatch.raise_on_launch(_lib().flash_attn_f32_plan(dh, S, BH, f),
                                 _lib().flash_attn_error_string,
                                 "flash_fwd plan")
        b = (ctypes.c_int * 6)()
        dispatch.raise_on_launch(
            _bwd_lib().flash_attn_bwd_plan(dh, S, BH, BHkv, b),
            _bwd_lib().flash_attn_bwd_error_string, "flash_bwd plan")
    return {"fwd": tuple(f), "bwd": tuple(b)}


def _check_tensors(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   name: str = "flash_fwd") -> None:
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or t.dtype != q.dtype \
                or t.dtype not in _DTYPES or t.dim() != 3 \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {what} must be a contiguous 3-d bfloat16 or "
                f"float32 CUDA tensor of q's type and device, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    BH, S, dh = q.shape
    BHkv = k.shape[0]
    if tuple(k.shape) != (BHkv, S, dh) or tuple(v.shape) != tuple(k.shape) \
            or BHkv == 0 or BH % BHkv or BH > 65535:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} with k {tuple(k.shape)} and v "
            f"{tuple(v.shape)}: k and v must be (BHkv, S, dh) with BHkv "
            "dividing BH (at most 65535)")


def _check_fit(lib, q: torch.Tensor, name: str = "flash_fwd",
               prefix: str = "flash_attn") -> None:
    _, S, dh = q.shape
    key = (name, dh, q.device.index)
    fit = _fit.get(key)
    if fit is None:
        fit = _fit[key] = (getattr(lib, f"{prefix}_tile")(),
                           getattr(lib, f"{prefix}_smem_bytes")(dh),
                           getattr(lib, f"{prefix}_max_smem")(
                               q.device.index))
    tile, need, have = fit
    if dh not in HEAD_DIMS or S % tile:
        raise ValueError(
            f"{name}: the kernel takes dh in {HEAD_DIMS} and S a multiple "
            f"of {tile}, got dh={dh}, S={S}")
    if need > have:
        raise ValueError(f"{name}: tiles at dh={dh} need {need} B of "
                         f"shared memory, this card gives a block {have} B")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True):
    """(o (BH, S, dh) in q's type, lse (BH, S) f32) on the card."""
    _check_tensors(q, k, v)
    lib = _lib()
    _check_fit(lib, q)
    BH, S, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    if BH and S:
        with dispatch.on_device(q):
            err = lib.flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), BH, k.shape[0], S, dh, _DTYPES[q.dtype],
                int(causal), 1.0 / math.sqrt(dh), dispatch.cuda_stream(q))
        dispatch.raise_on_launch(err, lib.flash_attn_error_string,
                                 "flash_fwd")
        flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def _bwd_lib() -> ctypes.CDLL:
    lib = _bound.get("bwd")
    if lib is None:
        lib = dispatch.load("flash_attn_bwd")
        lib.flash_attn_bwd_tile.argtypes = []
        lib.flash_attn_bwd_tile.restype = _I
        lib.flash_attn_bwd_smem_bytes.argtypes = [_I]
        lib.flash_attn_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attn_bwd_tc_smem_bytes.argtypes = [_I]
        lib.flash_attn_bwd_tc_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attn_bwd_max_smem.argtypes = [_I]
        lib.flash_attn_bwd_max_smem.restype = _I
        lib.flash_attn_bwd_error_string.argtypes = [_I]
        lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_attn_bwd_plan.argtypes = [_I, _I, _I, _I,
                                            ctypes.POINTER(_I)]
        lib.flash_attn_bwd_plan.restype = _I
        lib.flash_attn_bwd.argtypes = [_P] * 10 + [_I] * 6 + [
            ctypes.c_float, _P]
        lib.flash_attn_bwd.restype = _I
        _bound["bwd"] = lib
    return lib


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True):
    """(dq, dk, dv) of the flash forward's residuals (q, k, v, o, lse) and
    dO on the card, in q's type; ``lse`` (BH, S) f32 is the forward's.
    The bf16 kernel reads ``lse`` by 16-byte bulk copies, so an ``lse``
    that does not start on 16 bytes is copied first."""
    _check_tensors(q, k, v, "flash_bwd")
    for name, t in (("o", o), ("do", do)):
        dispatch.check_cuda_tensor(t, f"flash_bwd: {name}", (q.dtype,), 3,
                                   q.device)
        if t.shape != q.shape:
            raise ValueError(f"flash_bwd: {name} {tuple(t.shape)} must have "
                             f"q's shape {tuple(q.shape)}")
    dispatch.check_cuda_tensor(lse, "flash_bwd: lse", (torch.float32,), 2,
                               q.device)
    if lse.shape != q.shape[:2]:
        raise ValueError(f"flash_bwd: lse {tuple(lse.shape)} must be "
                         f"(BH, S) = {tuple(q.shape[:2])}")
    lib = _bwd_lib()
    _check_fit(lib, q, "flash_bwd", "flash_attn_bwd")
    if lse.data_ptr() % 16:
        lse = lse.clone()
    BH, S, dh = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    D = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    if BH and S:
        with dispatch.on_device(q):
            err = lib.flash_attn_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), D.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), BH, k.shape[0], S, dh,
                _DTYPES[q.dtype], int(causal), 1.0 / math.sqrt(dh),
                dispatch.cuda_stream(q))
        dispatch.raise_on_launch(err, lib.flash_attn_bwd_error_string,
                                 "flash_bwd")
        flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0
