"""Public flash-attention wrappers (forward only).

Counterpart of ``repro/kernels/flash_attn/ops.py``.  A CUDA tensor
launches the hand-written kernel (``kernel.py``, ``csrc/flash_attn.cu``);
a CPU tensor runs the plain version (``ref.py``).  There is no other path.

``cq`` and ``ckv`` are the reference's Pallas tile sizes.  They stay in
the signatures, and S is held to them as the reference holds it (a
multiple of ``min(cq, S)`` and ``min(ckv, S)``); the CUDA kernel tiles by
its own 64 rows, which must divide S too.

The backward is not ported: the reference's custom VJP becomes a
``torch.autograd.Function`` in the training slice (ROADMAP item 15).  Until
then a call that autograd would record raises instead of differentiating
the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.flash_attn import kernel, ref


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True):
    """(o, lse) of q (BH, S, dh) against k, v (BHkv, S, dh)."""
    if use_kernel(q):
        return kernel.flash_fwd(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal)
    return ref.flash_ref(q, k, v, causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, cq: int = 256,
                    ckv: int = 256) -> torch.Tensor:
    """q: (BH, S, dh); k, v: (BHkv, S, dh).  Returns (BH, S, dh)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward in repro_torch yet: the flash "
            "backward comes with the training slice (ROADMAP.md, item 15); "
            "call it under torch.no_grad() or on tensors that do not "
            "require grad")
    S = q.shape[1]
    cq, ckv = min(cq, S), min(ckv, S)
    if S % cq or S % ckv:
        raise ValueError(f"S={S} is not a multiple of the tiles cq={cq}, "
                         f"ckv={ckv}")
    o, _ = flash_forward(q, k, v, causal=causal)
    return o


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, cq: int = 256,
                         ckv: int = 256) -> torch.Tensor:
    """Layout wrapper: q (B, S, H, dh), k/v (B, S, Hkv, dh) → o in q's
    layout."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, S, dh)
    kf = k.transpose(1, 2).reshape(B * Hkv, S, dh)
    vf = v.transpose(1, 2).reshape(B * Hkv, S, dh)
    o = flash_attention(qf, kf, vf, causal, cq, ckv)
    return o.reshape(B, H, S, dh).transpose(1, 2)
