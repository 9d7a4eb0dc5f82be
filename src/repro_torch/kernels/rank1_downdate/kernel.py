"""ctypes binding of ``csrc/rank1_downdate.cu`` (one warp per row of D).

``rank1_downdate_cuda`` checks what the kernel takes (a contiguous f32 or
bf16 CUDA slab D and an f32 v on its device), allocates D′, launches on
PyTorch's current stream without synchronising, raises on a nonzero
``cudaGetLastError()``, and adds one to ``rank1_downdate_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = {}
DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _bound.get("lib")
    if lib is None:
        lib = dispatch.load("rank1_downdate")
        lib.rank1_downdate_error_string.argtypes = [_I]
        lib.rank1_downdate_error_string.restype = ctypes.c_char_p
        lib.rank1_downdate.argtypes = [_P, _P, _P] + [_I] * 4 + [_P]
        lib.rank1_downdate.restype = _I
        _bound["lib"] = lib
    return lib


def rank1_downdate_cuda(D: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """D′ = D − (D v) vᵀ per stream, in D's dtype, on the card.  D (S, m, d)
    f32 or bf16, v (S, d) f32."""
    dispatch.check_cuda_tensor(D, "rank1_downdate: D", DTYPES, 3)
    dispatch.check_cuda_tensor(v, "rank1_downdate: v", (torch.float32,), 2,
                               device=D.device)
    S, m, d = D.shape
    if tuple(v.shape) != (S, d):
        raise ValueError(f"rank1_downdate: v must be {(S, d)} for D "
                         f"{tuple(D.shape)}, got {tuple(v.shape)}")
    lib = _lib()
    out = torch.empty_like(D)
    if S and m and d:
        with dispatch.on_device(D):
            err = lib.rank1_downdate(D.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), S, m, d,
                                     int(D.dtype == torch.bfloat16),
                                     dispatch.cuda_stream(D))
        dispatch.raise_on_launch(err, lib.rank1_downdate_error_string,
                                 "rank1_downdate")
        rank1_downdate_cuda.launches += 1
    return out


rank1_downdate_cuda.launches = 0
