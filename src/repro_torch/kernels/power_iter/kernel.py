"""ctypes binding of ``csrc/power_iter.cu`` (one CTA per stream, the first
rows of K in shared memory, the rest read from device memory each step).

``power_iter_cuda`` checks what the kernel takes (a contiguous f32 CUDA
slab of square matrices), allocates the outputs, launches on PyTorch's
current stream without synchronising, raises on a nonzero
``cudaGetLastError()``, and adds one to ``power_iter_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = {}
MAX_M = 8192                 # u and w must fit one CTA's shared memory


def _lib() -> ctypes.CDLL:
    lib = _bound.get("lib")
    if lib is None:
        lib = dispatch.load("power_iter")
        lib.power_iter_resident_rows.argtypes = [_I, _I]
        lib.power_iter_resident_rows.restype = _I
        lib.power_iter_error_string.argtypes = [_I]
        lib.power_iter_error_string.restype = ctypes.c_char_p
        lib.power_iter_topvec.argtypes = [_P, _P, _P] + [_I] * 5 + [_P]
        lib.power_iter_topvec.restype = _I
        _bound["lib"] = lib
    return lib


def resident_rows(m: int, device: torch.device) -> int:
    """Rows of an (m, m) K that the kernel keeps in shared memory."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _lib().power_iter_resident_rows(m, index)


def power_iter_cuda(K: torch.Tensor, iters: int, floor_norm: bool = False):
    """(λ̂ (S,), û (S, m)) of each PSD K (S, m, m), on the card.
    ``floor_norm`` as in ``ops``."""
    dispatch.check_cuda_tensor(K, "power_iter: K", (torch.float32,), 3)
    S, m, m2 = K.shape
    if m != m2 or m > MAX_M:
        raise ValueError(f"power_iter: K must be (S, m, m) with m ≤ {MAX_M},"
                         f" got {tuple(K.shape)}")
    if iters < 0:
        raise ValueError(f"power_iter: iters={iters} < 0")
    lib = _lib()
    lam = torch.empty((S,), dtype=torch.float32, device=K.device)
    u = torch.empty((S, m), dtype=torch.float32, device=K.device)
    if S and m:
        with dispatch.on_device(K):
            err = lib.power_iter_topvec(K.data_ptr(), lam.data_ptr(),
                                        u.data_ptr(), S, m, int(iters),
                                        int(floor_norm), K.device.index,
                                        dispatch.cuda_stream(K))
        dispatch.raise_on_launch(err, lib.power_iter_error_string,
                                 "power_iter")
        power_iter_cuda.launches += 1
    return lam, u


power_iter_cuda.launches = 0
