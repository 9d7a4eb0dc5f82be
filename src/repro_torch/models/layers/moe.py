"""Mixture-of-Experts: capacity-bounded sort-free dispatch, grouped SwiGLU.

Counterpart of ``repro/models/layers/moe.py`` on one device, i.e. its
``_local_moe`` at model-axis size 1 (no ``shard_map``, no ``psum``).  The
reference's expert parallelism over a mesh, and virtual experts at
model-axis sizes above the expert count, come with the port's mesh tooling;
``virtual_split`` and ``virtual_expert_shapes`` are ported whole so that
the parameter shapes follow the same rule.

The dispatch is the reference's, step for step:

* the router's logits are f32 (TF32 stays off), softmax, top-k, the
  weights renormalised over the k choices with a 1e-9 floor;
* the Switch balance loss E · Σₑ fₑ · P̄ₑ on the top-1 choice;
* a (token, choice) pair takes slot ``e·C + p`` of expert e's buffer of C
  rows, p its rank among the pairs routed to e in token-major,
  choice-minor order; pairs ranked C or later are dropped, so the same
  pairs drop as in the reference;
* the products over the (E, C, D) buffers are ``torch.bmm``;
* the combine sums each token's kept slots in ascending slot order, the
  order the reference's scatter-add sums them in, with gathers only: no
  atomics, so the output is the same bit for bit from run to run on the
  card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg


def virtual_split(moe: MoECfg, msize: int) -> int:
    """How many column shards each expert is cut into on a model axis of
    ``msize`` devices (1 when there are at least as many experts)."""
    if moe.n_experts >= msize:
        assert moe.n_experts % msize == 0, (moe.n_experts, msize)
        return 1
    assert msize % moe.n_experts == 0, (moe.n_experts, msize)
    return msize // moe.n_experts


def virtual_expert_shapes(moe: MoECfg, d_model: int, msize: int):
    """(E_v, Fv): the virtual expert count and each one's FFN width."""
    del d_model
    split = virtual_split(moe, msize)
    E_v = moe.n_experts * split
    Fv = moe.d_expert // split
    return E_v, Fv


def capacity(moe: MoECfg, tokens: int) -> int:
    """C, the rows of each expert's buffer for ``tokens`` tokens."""
    C = max(8, int((tokens * moe.top_k) / moe.n_experts
                   * moe.capacity_factor) + 1)
    return min(C, tokens)


def route(moe: MoECfg, xf: torch.Tensor, wr: torch.Tensor):
    """The router and the capacity: ``(slot, weight, aux, C)`` for the
    (T, D) tokens ``xf``.  ``slot`` (T, k) is each (token, choice) pair's
    row of the flattened (E·C, D) buffers, ``E·C`` where the capacity
    dropped it; ``weight`` (T, k) f32 its renormalised router weight."""
    T = xf.shape[0]
    E, k = moe.n_experts, moe.top_k
    probs = torch.softmax(torch.matmul(xf.float(), wr.float()), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)                 # (T, k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    # the Switch balance loss: E · Σ_e f_e · P̄_e (top-1 assignments)
    ohe = F.one_hot(topi[:, 0], E).float()
    aux = E * torch.mean(torch.mean(ohe, dim=0) * torch.mean(probs, dim=0))

    # each pair's rank among the pairs routed to its expert, in the
    # flattened token-major, choice-minor order (the reference's running
    # one-hot count): a stable sort by expert keeps that order in a group
    C = capacity(moe, T)
    e = topi.reshape(-1)
    order = torch.argsort(e, stable=True)
    counts = torch.bincount(e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(e)
    rank[order] = torch.arange(e.numel(), device=e.device) - starts[e[order]]
    slot = torch.where(rank < C, e * C + rank, E * C)
    return slot.reshape(T, k), topw, aux, C


def moe_block(x: torch.Tensor, wr: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, *, moe: MoECfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D); wr (D, E); wg, wu (E, D, F); wd (E, F, D).  Returns
    (y (B, S, D) in x's type, the f32 balance loss)."""
    B, S, D = x.shape
    T = B * S
    E = moe.n_experts
    xf = x.reshape(T, D)
    slot, topw, aux, C = route(moe, xf, wr)
    k = slot.shape[1]
    flat = slot.reshape(-1)
    keep = flat < E * C

    # slot → token (T: the zero row) and slot → weight; only kept pairs
    # write, each to a slot of its own
    tok = torch.arange(T * k, device=x.device) // k
    src = torch.full((E * C,), T, dtype=torch.long, device=x.device)
    src[flat[keep]] = tok[keep]
    wslot = torch.zeros((E * C,), dtype=torch.float32,
                        device=x.device).index_put(
        (flat[keep],), topw.reshape(-1)[keep])

    xpad = torch.cat([xf, xf.new_zeros((1, D))])
    ebuf = xpad[src].reshape(E, C, D)
    t = torch.promote_types(ebuf.dtype, wg.dtype)
    g = torch.bmm(ebuf.to(t), wg.to(t))
    u = torch.bmm(ebuf.to(t), wu.to(t))
    h = F.silu(g.float()).to(x.dtype) * u
    t = torch.promote_types(h.dtype, wd.dtype)
    out = torch.bmm(h.to(t), wd.to(t))                        # (E, C, D)

    weighted = out.reshape(E * C, D) * wslot[:, None].to(out.dtype)
    wpad = torch.cat([weighted, weighted.new_zeros((1, D))])  # E·C: dropped
    ordered = torch.sort(slot, dim=1).values                  # (T, k)
    y = wpad[ordered[:, 0]]
    for j in range(1, k):
        y = y + wpad[ordered[:, j]]
    return y.reshape(B, S, D).to(x.dtype), aux
