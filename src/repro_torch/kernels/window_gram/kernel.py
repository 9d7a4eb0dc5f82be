"""ctypes binding of ``csrc/window_gram.cu`` (one CTA per 64×64
upper-triangle tile of G per stream, an 8×8 patch of the tile per thread).

``window_gram_cuda`` checks what the kernel takes (a contiguous f32 or
bf16 CUDA slab), allocates G, launches on PyTorch's current stream without
synchronising, raises on a nonzero ``cudaGetLastError()``, and adds one to
``window_gram_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = {}
DTYPES = (torch.float32, torch.bfloat16)
MAX_STREAMS = 65535          # the grid's y extent


def _lib() -> ctypes.CDLL:
    lib = _bound.get("lib")
    if lib is None:
        lib = dispatch.load("window_gram")
        lib.window_gram_error_string.argtypes = [_I]
        lib.window_gram_error_string.restype = ctypes.c_char_p
        lib.window_gram_ata.argtypes = [_P, _P] + [_I] * 4 + [_P]
        lib.window_gram_ata.restype = _I
        _bound["lib"] = lib
    return lib


def window_gram_cuda(A: torch.Tensor) -> torch.Tensor:
    """G (S, d, d) = AᵀA per stream of A (S, n, d), in f32, on the card."""
    dispatch.check_cuda_tensor(A, "window_gram: A", DTYPES, 3)
    lib = _lib()
    S, n, d = A.shape
    if S > MAX_STREAMS:
        raise ValueError(f"window_gram: S={S} streams, more than "
                         f"{MAX_STREAMS} in one launch")
    G = torch.empty((S, d, d), dtype=torch.float32, device=A.device)
    if S and d:
        with dispatch.on_device(A):
            err = lib.window_gram_ata(A.data_ptr(), G.data_ptr(), S, n, d,
                                      int(A.dtype == torch.bfloat16),
                                      dispatch.cuda_stream(A))
        dispatch.raise_on_launch(err, lib.window_gram_error_string,
                                 "window_gram")
        window_gram_cuda.launches += 1
    return G


window_gram_cuda.launches = 0
