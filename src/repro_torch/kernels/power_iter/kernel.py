"""ctypes binding of ``csrc/power_iter.cu`` (a thread-block cluster of c
CTAs per stream, each holding its slice of K's rows in shared memory and
exchanging w through distributed shared memory).

``power_iter_cuda`` checks what the kernel takes (a contiguous f32 CUDA
slab of square matrices), allocates the outputs, launches on PyTorch's
current stream without synchronising, raises on a nonzero error (a
refused cluster launch included), and adds one to
``power_iter_cuda.launches``.  :func:`cluster_plan` is the C library's
``power_iter_plan`` in Python, for the CPU and the tests.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = {}
MAX_M = 8192                 # the two x buffers must fit one CTA
# csrc/power_iter.cu's constants
_MAX_CLUSTER, _ROWS_PER_CTA, _BAR_BYTES = 8, 8, 16


def _lib() -> ctypes.CDLL:
    lib = _bound.get("lib")
    if lib is None:
        lib = dispatch.load("power_iter")
        lib.power_iter_plan.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.power_iter_plan.restype = _I
        lib.power_iter_error_string.argtypes = [_I]
        lib.power_iter_error_string.restype = ctypes.c_char_p
        lib.power_iter_topvec.argtypes = [_P, _P, _P] + [_I] * 5 + [_P]
        lib.power_iter_topvec.restype = _I
        _bound["lib"] = lib
    return lib


def cluster_plan(m: int, S: int, smem: int = dispatch.H100_SMEM_PER_BLOCK,
                 sms: int = dispatch.H100_SMS) -> tuple:
    """(c, rows, resident) for S streams of an (m, m) K on a card with
    ``smem`` bytes of shared memory a block and ``sms`` SMs: the cluster
    size, the rows of K a CTA owns, and how many of them it keeps in
    shared memory (-1 if not even the two x buffers fit).  The formula of
    ``plan_for`` in ``csrc/power_iter.cu``: the smallest power of two c
    whose ⌈m/c⌉ rows (at a stride of m rounded up to 4 floats, beside two
    mbarriers and two x buffers) fit, then the widest c ≤ 8 whose c·S
    CTAs fit one wave, but no wider than ⌈m/8⌉."""
    ld = (m + 3) // 4 * 4
    fixed, row = _BAR_BYTES + 4 * 2 * ld, 4 * ld
    c = 1
    while c < _MAX_CLUSTER and fixed + -(-m // c) * row > smem:
        c *= 2
    wide = 1
    while wide < _MAX_CLUSTER and 2 * wide * S <= sms:
        wide *= 2
    cap = 1
    while cap < _MAX_CLUSTER and 2 * cap * _ROWS_PER_CTA < m + _ROWS_PER_CTA:
        cap *= 2
    c = max(c, min(wide, cap))
    rows = -(-m // c)
    fit = (smem - fixed) // row if smem >= fixed else -1
    return c, rows, -1 if fit < 0 else min(fit, rows)


def plan(m: int, S: int, device: torch.device) -> tuple:
    """(c, rows, resident) of the C library on ``device``'s card."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    out = (_I * 3)()
    lib = _lib()
    dispatch.raise_on_launch(lib.power_iter_plan(m, S, index, out),
                             lib.power_iter_error_string, "power_iter plan")
    return tuple(out)


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
