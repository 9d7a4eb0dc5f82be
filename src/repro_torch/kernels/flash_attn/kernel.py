"""ctypes binding of ``csrc/flash_attn.cu`` (bf16 on the tensor cores, f32
on the CUDA cores; one CTA per (bh, q-tile)).

``flash_fwd`` checks what the kernel takes (contiguous bf16 or f32 CUDA
tensors of one type and device, dh ∈ {64, 128}, S a multiple of the
kernel's tile, tiles that fit one CTA's shared memory), allocates the
outputs, launches on PyTorch's current stream without synchronising,
raises on a nonzero ``cudaGetLastError()``, and adds one to
``flash_fwd.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import dispatch

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = {}
_fit = {}                    # (dh, card) -> (tile, smem needed, smem given)
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
        lib.flash_attn_fwd.argtypes = [_P] * 5 + [_I] * 6 + [ctypes.c_float,
                                                             _P]
        lib.flash_attn_fwd.restype = _I
        _bound["lib"] = lib
    return lib


def _check_tensors(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or t.dtype != q.dtype \
                or t.dtype not in _DTYPES or t.dim() != 3 \
                or not t.is_contiguous():
            raise ValueError(
                f"flash_fwd: {name} must be a contiguous 3-d bfloat16 or "
                f"float32 CUDA tensor of q's type and device, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    BH, S, dh = q.shape
    BHkv = k.shape[0]
    if tuple(k.shape) != (BHkv, S, dh) or tuple(v.shape) != tuple(k.shape) \
            or BHkv == 0 or BH % BHkv or BH > 65535:
        raise ValueError(
            f"flash_fwd: q {tuple(q.shape)} with k {tuple(k.shape)} and v "
            f"{tuple(v.shape)}: k and v must be (BHkv, S, dh) with BHkv "
            "dividing BH (at most 65535)")


def _check_fit(lib, q: torch.Tensor) -> None:
    _, S, dh = q.shape
    key = (dh, q.device.index)
    fit = _fit.get(key)
    if fit is None:
        fit = _fit[key] = (lib.flash_attn_tile(),
                           lib.flash_attn_smem_bytes(dh),
                           lib.flash_attn_max_smem(q.device.index))
    tile, need, have = fit
    if dh not in HEAD_DIMS or S % tile:
        raise ValueError(
            f"flash_fwd: the kernel takes dh in {HEAD_DIMS} and S a multiple "
            f"of {tile}, got dh={dh}, S={S}")
    if need > have:
        raise ValueError(f"flash_fwd: tiles at dh={dh} need {need} B of "
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
