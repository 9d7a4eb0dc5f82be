"""Mixture-of-Experts: capacity-bounded sort-free dispatch, grouped SwiGLU,
expert parallelism over the mesh's model axis.

Counterpart of ``repro/models/layers/moe.py``.  Tokens arrive replicated
over the 'model' axis and the experts are sharded over it.  Each process
(the reference's device in its ``shard_map`` body ``_local_moe``) routes
every token, keeps the (token, choice) pairs of its own experts, runs the
dispatch and the grouped SwiGLU over them, and the sum of y over the
model axis (the reference's ``psum``; ``parallel/sharding.py::
all_reduce``) adds the processes' partial outputs; the balance loss is
averaged over it (``pmean``).  Both pass autograd through as the
reference's transposes do (the sum's cotangent unchanged, the mean's
divided by the axis's size), and x and the router's weights enter the
body through ``enter_group``, whose backward sums their partial
gradients over the axis: a train step gets the one-process gradients.
Under a data axis at model size 1 a process routes its own batch shard,
so capacity and the balance loss are per shard, as in the reference.

**Virtual experts**: where the model axis M outnumbers the experts E,
each expert is cut into ``M / E`` column shards of its FFN
(``virtual_split``): a token routed to expert e visits all of e's shards
and the sum adds their partial outputs.  Without a mesh (one card), M = 1
and the block is today's one-process body, bit for bit.  Under a mesh
the block reads the model axis's coordinate and group from the mesh in
force: a real gloo group of processes (the card's path, plain tensors
holding this process's experts) or, in the dry-run, DTensors over a fake
group, where the body runs in ``local_map``.

The dispatch is the reference's, step for step:

* the router's logits are f32 (TF32 stays off), softmax, top-k, the
  weights renormalised over the k choices with a 1e-9 floor;
* the Switch balance loss E · Σₑ fₑ · P̄ₑ on the top-1 choice;
* a (token, choice) pair takes slot ``e·C + p`` of local expert e's buffer
  of C rows, p its rank among the pairs routed to e in token-major,
  choice-minor order; pairs ranked C or later are dropped, so the same
  pairs drop as in the reference, on every process;
* the products over the (E, C, D) buffers are ``torch.bmm``;
* the combine sums each token's kept slots in ascending slot order, the
  order the reference's scatter-add sums them in, with gathers only: no
  atomics, so the output is the same bit for bit from run to run on the
  card.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg
from repro_torch.parallel.sharding import (all_reduce, current_rules,
                                           enter_group, fit_spec,
                                           is_dtensor, model_coord,
                                           model_size, spec_placements)


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


def route(moe: MoECfg, xf: torch.Tensor, wr: torch.Tensor, *,
          split: int = 1, msize: int = 1, m_idx: int = 0):
    """The router and the capacity: ``(slot, weight, aux, C)`` for the
    (T, D) tokens ``xf``.  ``slot`` (T, k·split) is each (token, virtual
    choice) pair's row of this process's flattened (E_l·C, D) buffers,
    ``E_l·C`` where the capacity dropped it or another process holds its
    expert (E_l = E·split / msize local virtual experts, this process the
    ``m_idx``-th on the model axis); ``weight`` (T, k·split) f32 its
    renormalised router weight."""
    T = xf.shape[0]
    E, k = moe.n_experts, moe.top_k
    probs = torch.softmax(torch.matmul(xf.float(), wr.float()), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)                 # (T, k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    # the Switch balance loss: E · Σ_e f_e · P̄_e (top-1 assignments)
    # (a comparison, not F.one_hot, whose ops differ by device: the
    # program analyzer counts the same tick on the card and on meta)
    ohe = (topi[:, :1] == torch.arange(E, device=xf.device)).float()
    aux = E * torch.mean(torch.mean(ohe, dim=0) * torch.mean(probs, dim=0))

    # virtual assignments: choice e visits e's split shards e·split + s
    E_v = E * split
    E_l = E_v // msize
    if split > 1:
        v_ids = (topi[:, :, None] * split
                 + torch.arange(split, device=xf.device)).reshape(T, -1)
        topw = torch.repeat_interleave(topw, split, dim=1)
    else:
        v_ids = topi

    # each pair's rank among the pairs routed to its local expert, in the
    # flattened token-major, choice-minor order (the reference's running
    # one-hot count): a stable sort by expert keeps that order in a group;
    # pairs of other processes' experts go to the bucket E_l
    C = capacity(moe, T)
    e = v_ids.reshape(-1)
    if msize > 1:
        e = torch.where(e // E_l == m_idx, e - m_idx * E_l, E_l)
    order = torch.argsort(e, stable=True)
    counts = torch.zeros(E_l + 1, dtype=e.dtype, device=e.device) \
        .index_add_(0, e, torch.ones_like(e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(e)
    rank[order] = torch.arange(e.numel(), device=e.device) - starts[e[order]]
    slot = torch.where((rank < C) & (e < E_l), e * C + rank, E_l * C)
    return slot.reshape(T, -1), topw, aux, C


def _local_moe(x: torch.Tensor, wr: torch.Tensor, wg: torch.Tensor,
               wu: torch.Tensor, wd: torch.Tensor, *, moe: MoECfg,
               split: int, msize: int, m_idx: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One process's body: x (B, S, D) every token; wg, wu (E_l, D, Fv),
    wd (E_l, Fv, D) its local virtual experts.  Returns (this process's
    partial y in x's type, the f32 balance loss)."""
    B, S, D = x.shape
    T = B * S
    E_l = moe.n_experts * split // msize
    xf = x.reshape(T, D)
    slot, topw, aux, C = route(moe, xf, wr, split=split, msize=msize,
                               m_idx=m_idx)
    k = slot.shape[1]
    flat = slot.reshape(-1)
    keep = flat < E_l * C

    # slot → token (T: the zero row) and slot → weight; a kept pair writes
    # a slot of its own, the others the spare slot E_l·C, which is cut off
    # (no data-dependent shapes, as the reference's ``.at[slot].set``)
    tok = torch.arange(T * k, device=x.device) // k
    src = torch.full((E_l * C + 1,), T, dtype=torch.long,
                     device=x.device).index_put_(
        (flat,), torch.where(keep, tok, T))[:E_l * C]
    wslot = torch.zeros((E_l * C + 1,), dtype=torch.float32,
                        device=x.device).index_put_(
        (flat,), torch.where(keep, topw.reshape(-1), 0.0))[:E_l * C]

    xpad = torch.cat([xf, xf.new_zeros((1, D))])
    ebuf = xpad[src].reshape(E_l, C, D)
    t = torch.promote_types(ebuf.dtype, wg.dtype)
    g = torch.bmm(ebuf.to(t), wg.to(t))
    u = torch.bmm(ebuf.to(t), wu.to(t))
    h = F.silu(g.float()).to(x.dtype) * u
    t = torch.promote_types(h.dtype, wd.dtype)
    out = torch.bmm(h.to(t), wd.to(t))                        # (E_l, C, D)

    weighted = out.reshape(E_l * C, D) * wslot[:, None].to(out.dtype)
    wpad = torch.cat([weighted, weighted.new_zeros((1, D))])  # E_l·C: none
    ordered = torch.sort(slot, dim=1).values                  # (T, k)
    y = wpad[ordered[:, 0]]
    for j in range(1, k):
        y = y + wpad[ordered[:, j]]
    return y.reshape(B, S, D).to(x.dtype), aux


def _ep_body(x, wr, wg, wu, wd, *, moe: MoECfg, split: int, msize: int):
    """The expert-parallel body over local tensors: the local experts'
    partial y summed over the model axis's group, aux averaged over it
    (at model size 1, the one-process body)."""
    if msize == 1:
        return _local_moe(x, wr, wg, wu, wd, moe=moe, split=1, msize=1,
                          m_idx=0)
    m_idx, group = model_coord()
    if group is None:
        raise RuntimeError("expert parallelism over a model axis of "
                           f"{msize} needs a mesh with process groups "
                           "(launch/mesh.py), not a plain shape")
    # every process routes every token: x's and the router's gradients
    # are the sums of the processes' partial ones (the router's in f32,
    # the type its product runs in, rounded once to the weight's type)
    x, wr = enter_group(x, group), enter_group(wr.float(), group)
    y, aux = _local_moe(x, wr, wg, wu, wd, moe=moe, split=split,
                        msize=msize, m_idx=m_idx)
    return all_reduce(y, group, "sum"), all_reduce(aux, group, "mean")


def moe_block(x: torch.Tensor, wr: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, *, moe: MoECfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D); wr (D, E).  Without a mesh (or at model-axis size 1)
    wg, wu (E, D, F) and wd (E, F, D) are every expert and this is the
    one-process body.  Under a mesh of model size M, the experts are the
    (E_v, D, Fv) / (E_v, Fv, D) virtual ones (``virtual_expert_shapes``):
    as DTensors sharded over 'model' (the dry-run), or as plain tensors
    holding this process's E_v / M of them (processes on a card).
    Returns (y (B, S, D) in x's type, the f32 balance loss)."""
    msize = model_size()
    if msize == 1 and not is_dtensor(wg):
        return _local_moe(x, wr, wg, wu, wd, moe=moe, split=1, msize=1,
                          m_idx=0)
    split = virtual_split(moe, msize)
    body = functools.partial(_ep_body, moe=moe, split=split, msize=msize)
    if not is_dtensor(wg):
        E_l = moe.n_experts * split // msize
        if wg.shape[0] != E_l:
            raise ValueError(f"expert parallelism over {msize} processes: "
                             f"each holds {E_l} of the {moe.n_experts * split}"
                             f" virtual experts, got {wg.shape[0]}")
        return body(x, wr, wg, wu, wd)

    from torch.distributed.tensor.experimental import local_map

    mesh = wg.device_mesh
    rules = current_rules() or {}
    x_pl = spec_placements(fit_spec((rules.get("batch"), None, None),
                                    tuple(x.shape), mesh), mesh)
    e_pl = spec_placements(("model", None, None), mesh)
    rep = spec_placements((), mesh)
    fn = local_map(body, out_placements=(x_pl, rep),
                   in_placements=(x_pl, rep, e_pl, e_pl, e_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, wr, wg, wu, wd)
