"""Public flash-attention wrappers, differentiable in q, k and v.

Counterpart of ``repro/kernels/flash_attn/ops.py``.  A CUDA tensor
launches the hand-written kernels (``kernel.py``: ``csrc/flash_attn.cu``
forward, ``csrc/flash_attn_bwd.cu`` backward); a CPU tensor runs the plain
versions (``ref.py``).  There is no other path.

The reference's custom VJP becomes ``_FlashAttention``, a
``torch.autograd.Function``: its forward saves only (q, k, v, o, lse),
never an S×S tensor, and its backward recomputes P from the forward's
``lse`` tile by tile (the kernel) or at once (the plain version).

``cq`` and ``ckv`` are the reference's Pallas tile sizes.  They stay in
the signatures, and S is held to them as the reference holds it (a
multiple of ``min(cq, S)`` and ``min(ckv, S)``); the CUDA kernels tile by
their own 64 rows, which must divide S too.
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


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   causal: bool = True):
    """(dq, dk, dv) from the forward's residuals and dO."""
    if use_kernel(q):
        return kernel.flash_bwd(*(t.contiguous()
                                  for t in (q, k, v, o, lse, do)), causal)
    return ref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``jax.custom_vjp``: forward (o, lse), backward the
    flash identities from the residuals (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = flash_forward(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, cq: int = 256,
                    ckv: int = 256) -> torch.Tensor:
    """q: (BH, S, dh); k, v: (BHkv, S, dh).  Returns (BH, S, dh)."""
    S = q.shape[1]
    cq, ckv = min(cq, S), min(ckv, S)
    if S % cq or S % ckv:
        raise ValueError(f"S={S} is not a multiple of the tiles cq={cq}, "
                         f"ckv={ckv}")
    return _FlashAttention.apply(q, k, v, causal)


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
