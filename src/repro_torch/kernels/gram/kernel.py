"""ctypes binding of ``csrc/gram.cu`` (one CTA per upper-triangle tile of
K per stream, an 8×8 patch of the tile per thread).

``gram_cuda`` checks what the kernel takes (a contiguous f32 or bf16 CUDA
slab), allocates K, launches on PyTorch's current stream without
synchronising, raises on a nonzero ``cudaGetLastError()``, and adds one to
``gram_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = {}
DTYPES = (torch.float32, torch.bfloat16)
MAX_TILES = 65535            # the grid's y extent


def _lib() -> ctypes.CDLL:
    lib = _bound.get("lib")
    if lib is None:
        lib = dispatch.load("gram")
        lib.gram_tiles.argtypes = [_I]
        lib.gram_tiles.restype = _I
        lib.gram_error_string.argtypes = [_I]
        lib.gram_error_string.restype = ctypes.c_char_p
        lib.gram_xxt.argtypes = [_P, _P] + [_I] * 4 + [_P]
        lib.gram_xxt.restype = _I
        _bound["lib"] = lib
    return lib


def gram_cuda(X: torch.Tensor) -> torch.Tensor:
    """K (S, m, m) = X Xᵀ per stream of X (S, m, d), in X's dtype, on the
    card."""
    dispatch.check_cuda_tensor(X, "gram: X", DTYPES, 3)
    lib = _lib()
    S, m, d = X.shape
    if lib.gram_tiles(m) > MAX_TILES:
        raise ValueError(f"gram: m={m} needs more than {MAX_TILES} tiles")
    K = torch.empty((S, m, m), dtype=X.dtype, device=X.device)
    if S and m:
        with dispatch.on_device(X):
            err = lib.gram_xxt(X.data_ptr(), K.data_ptr(), S, m, d,
                               int(X.dtype == torch.bfloat16),
                               dispatch.cuda_stream(X))
        dispatch.raise_on_launch(err, lib.gram_error_string, "gram")
        gram_cuda.launches += 1
    return K


gram_cuda.launches = 0
