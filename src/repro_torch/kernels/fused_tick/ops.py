"""Public wrappers of the fused krylov-tick kernels, batched over streams.

Counterpart of ``repro/kernels/fused_tick/ops.py``.  The reference wrote
its wrappers for one stream and got the fleet from ``jax.vmap``; these take
the stream axis explicitly: D (S, m, d), λ̂ (S,), û (S, m).  No padding is
needed: every kernel bounds its loops by the true m and d.

Two routes compute the same function, picked by :func:`route` from (m, d)
alone:

* ``"fused"``, where one stream's D and K fit one CTA's shared memory
  (:func:`fused_tick_smem_bytes` against the card's opt-in limit): one
  launch of the fused kernel (``kernel.py``, one CTA per stream);
* ``"split"``, where they do not (m = 2ℓ = 256 at d = 300, i.e. ε = 1/128;
  m = 128 at d ≥ 318): the chain of the reference's inline krylov branch
  (``repro/core/dsfd.py:190-264``), ``power_iter(gram(D))`` for
  ``gram_power`` and, for ``fused_krylov_step``, the v-extraction (a
  torch reduction in f32, as the reference computes it outside any
  kernel), then ``rank1_downdate``, ``gram`` and ``power_iter``.

Within either route a CUDA tensor launches the hand-written kernels and a
CPU tensor runs their plain versions (``ref.py`` of each kernel).  On the
CPU the route compares against the H100's limit, so the CPU and the card
take the same route at the same shape.

``floor_norm`` picks the norm floor: False is the fused path's
``sqrt(max(Σw², 1e-30))``, True the reference's inline path's
``max(‖w‖, 1e-30)``.
"""

from __future__ import annotations

import torch

# H100_SMEM_PER_BLOCK: the limit the route compares against for a CPU tensor
from repro_torch.kernels.dispatch import (H100_SMEM_PER_BLOCK, kernel_work,
                                          use_kernel)
from repro_torch.kernels.fused_tick import kernel, ref
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.power_iter.ops import power_iter
from repro_torch.kernels.power_iter.ref import normalise
from repro_torch.kernels.rank1_downdate.ops import rank1_downdate

# csrc/fused_tick.cu's block: threads and warps (scratch of the reductions)
_THREADS, _WARPS = 256, 8


def fused_tick_smem_bytes(m: int, d: int) -> int:
    """Dynamic shared memory the fused kernel needs for an (m, d) buffer:
    D at an odd row stride, K, u, w, p, v and the reduction scratch (the
    formula of ``fused_tick_smem_bytes`` in ``csrc/fused_tick.cu``)."""
    return 4 * (m * (d | 1) + m * m + 3 * m + d + _THREADS + _WARPS)


def route(m: int, d: int, device=None) -> str:
    """``"fused"`` where one stream's (m, d) buffer fits one CTA of the
    card that ``device`` names (an H100 for the CPU or None), else
    ``"split"``."""
    dev = torch.device("cpu" if device is None else device)
    limit = (kernel.max_smem(dev) if dev.type == "cuda"
             else H100_SMEM_PER_BLOCK)
    return "fused" if fused_tick_smem_bytes(m, d) <= limit else "split"


def _slab(D: torch.Tensor) -> torch.Tensor:
    if D.dim() != 3:
        raise ValueError(f"expected an (S, m, d) slab, got shape "
                         f"{tuple(D.shape)}")
    return D.to(torch.float32).contiguous()


def work(name: str, S: int, m: int, d: int, iters: int):
    """(f32 operations, bytes) of one launch of ``name`` at (S, m, d), as
    its bound counts them: every input read and output written once; a
    symmetric K's m(m+1)/2 dot products of length d."""
    power = (iters + 1) * 2 * m * m + iters * 3 * m + 2 * m
    gram_ops = m * (m + 1) * d
    if name == "gram_power":
        return S * (gram_ops + power), 4 * S * (m * d + 1 + m)
    return (S * (6 * m * d + 3 * d + gram_ops + power),
            4 * S * ((m * d + 1 + m) + (d + m * d + 1 + m)))


def gram_power(D: torch.Tensor, *, iters: int = 24, floor_norm: bool = False):
    """(λ̂ (S,), û (S, m)) of K = DDᵀ for every stream."""
    D = _slab(D)
    if route(D.shape[1], D.shape[2], D.device) == "split":
        return power_iter(gram(D), iters=iters, floor_norm=floor_norm)
    with kernel_work("gram_power", *work("gram_power", *D.shape, iters)):
        if use_kernel(D):
            return kernel.gram_power_cuda(D, iters, floor_norm)
        return ref.gram_power_ref(D, iters, floor_norm)


def fused_krylov_step(D: torch.Tensor, lam: torch.Tensor, u: torch.Tensor,
                      *, iters: int = 24, floor_norm: bool = False):
    """One krylov dump step for every stream: v-extraction, snapshot,
    rank-1 downdate, Gram and power iteration.
    Returns (snap (S, d), D′ (S, m, d), λ̂′ (S,), û′ (S, m))."""
    D = _slab(D)
    lam = lam.to(torch.float32).contiguous()
    u = u.to(torch.float32).contiguous()
    if route(D.shape[1], D.shape[2], D.device) == "split":
        return _split_step(D, lam, u, iters, floor_norm)
    with kernel_work("fused_krylov_step",
                     *work("fused_krylov_step", *D.shape, iters)):
        if use_kernel(D):
            return kernel.fused_krylov_step_cuda(D, lam, u, iters,
                                                 floor_norm)
        return ref.fused_krylov_step_ref(D, lam, u, iters, floor_norm)


def _split_step(D, lam, u, iters, floor_norm):
    """``ref.fused_krylov_step_ref`` line for line, through the unfused
    kernels.  uᵀD is an elementwise product and a sum, so it stays f32
    whatever the process's TF32 setting."""
    sigma = torch.sqrt(torch.clamp(lam, min=1e-30))
    v = normalise(torch.sum(u.unsqueeze(-1) * D, dim=1) / sigma[:, None],
                  floor_norm)
    snap = sigma[:, None] * v
    D2 = rank1_downdate(D, v)
    lam2, u2 = power_iter(gram(D2), iters=iters, floor_norm=floor_norm)
    return snap, D2, lam2, u2
