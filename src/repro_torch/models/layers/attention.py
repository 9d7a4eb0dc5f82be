"""Attention: GQA in full, chunked (online softmax) and flash form, and the
KV cache of the decode path.

Counterpart of ``repro/models/layers/attention.py``.  The reference's
``lax.scan`` over KV blocks becomes a Python loop.  Under a mesh whose rules
shard the attention's sequence over 'model' ('seq_attn'), the q blocks are
aligned with the shards, as in the reference, so that no score tile crosses
a shard; on one device nothing changes.  KV heads
are repeated to the full head count per block (``repeat_interleave``, so q
head h reads KV head h // G), and caches stay at n_kv width.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.parallel.sharding import (constrain_divisible,
                                           current_rules, fit_spec,
                                           is_dtensor, mesh_shape,
                                           spec_placements, to_pspec)

NEG_INF = -1e30


def _rep_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, q_offset=0,
                      kv_valid_len: Optional[torch.Tensor] = None,
                      chunk_q: int = 512, chunk_kv: int = 1024,
                      ) -> torch.Tensor:
    """Memory-efficient attention.

    q: (B, Sq, H, dh);  k, v: (B, Skv, Hkv, dh);  H = Hkv·G.
    ``q_offset``: absolute position of q[0] (decode / continued prefill).
    ``window`` > 0: local attention (key position > query position − window).
    ``kv_valid_len``: mask out cache slots ≥ this length.
    Returns (B, Sq, H, dh).
    """
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    scale = dh ** -0.5
    dev = q.device

    cq = min(chunk_q, Sq)
    ckv = min(chunk_kv, Skv)
    pad_q = (-Sq) % cq
    pad_kv = (-Skv) % ckv
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q)) * scale
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nq, nkv = qp.shape[1] // cq, kp.shape[1] // ckv

    q_pos0 = torch.as_tensor(q_offset, dtype=torch.int32, device=dev)
    kv_len = torch.as_tensor(Skv if kv_valid_len is None else kv_valid_len,
                             dtype=torch.int32, device=dev)
    blocks = []
    for qi in range(nq):
        qblk = qp[:, qi * cq:(qi + 1) * cq]                 # (B, cq, H, dh)
        qpos = q_pos0 + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, dh), dtype=torch.float32, device=dev)
        for ki in range(nkv):
            kblk = _rep_kv(kp[:, ki * ckv:(ki + 1) * ckv], G)
            vblk = _rep_kv(vp[:, ki * ckv:(ki + 1) * ckv], G)
            kpos = ki * ckv + torch.arange(ckv, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qblk.float(), kblk.float())
            mask = (kpos[None, :] < kv_len).expand(cq, ckv)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vblk.dtype).float(),
                              vblk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        blocks.append(out.transpose(1, 2))                  # (B, cq, H, dh)
    out = torch.cat(blocks, dim=1)[:, :Sq]
    return out.to(q.dtype)


def _model_index(mesh) -> int:
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.get_local_rank("model")) if "model" in names else 0


def _on_blocks(q, k, v, body, *, seq_ok: bool):
    """``body(q, k, v, q_offset)`` over each device's local block of
    DTensors q (B, Sq, H, dh), k, v (B, Skv, Hkv, dh), in ``local_map``:
    the batch split over the data axes, the query heads over 'model' where
    the rules shard them, else the query sequence over 'model'
    ('seq_attn', where ``seq_ok``): each device then owns whole q blocks
    (the reference's sequence-parallel alignment) and sees every key.
    Where the query heads are split but the KV heads are not, each device
    repeats the KV heads to its query heads.  Attention is independent
    over batch, heads and queries, so no collective is needed."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    q_spec = fit_spec(to_pspec(("batch", "seq_attn" if seq_ok else None,
                                "heads", None)), q.shape, mesh)
    heads_split = q_spec[2] is not None
    kv_spec = fit_spec(to_pspec(("batch", None,
                                 "kv" if heads_split else None, None)),
                       k.shape, mesh)
    kv_split = kv_spec[2] is not None
    G = q.shape[2] // k.shape[2]

    def local(ql, kl, vl):
        m = _model_index(mesh)
        if heads_split and not kv_split:
            H_l = ql.shape[2]
            kl = _rep_kv(kl, G)[:, :, m * H_l:(m + 1) * H_l]
            vl = _rep_kv(vl, G)[:, :, m * H_l:(m + 1) * H_l]
        off = m * ql.shape[1] if q_spec[1] is not None else 0
        return body(ql, kl, vl, off)

    q_pl = spec_placements(q_spec, mesh)
    kv_pl = spec_placements(kv_spec, mesh)
    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def full_attention(q, k, v, *, causal: bool, window: int = 0) -> torch.Tensor:
    """Plain einsum attention for short sequences.  P is cast to v's type
    before P·V, as in the reference.  DTensors run on each device's local
    block (``_on_blocks``; the whole sequence a device)."""
    if is_dtensor(q):
        return _on_blocks(q, k, v, lambda ql, kl, vl, off: full_attention(
            ql, kl, vl, causal=causal, window=window), seq_ok=False)
    B, Sq, H, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    kr, vr = _rep_kv(k, G), _rep_kv(v, G)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * dh ** -0.5
    if causal or window:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr)


def attention_any(q, k, v, *, causal: bool, window: int = 0,
                  q_offset=0, kv_valid_len=None,
                  chunk_threshold: int = 2048,
                  chunk_q: int = 512, chunk_kv: int = 1024,
                  use_flash: bool = False) -> torch.Tensor:
    """Dispatch, with the reference's gate for the flash kernel: causal, no
    window, no cache mask, self-attention, S a multiple of 256 and
    dh ∈ {64, 128}.  Other short sequences take the one-shot path.
    DTensors (the dry-run) run on each device's local block
    (``_on_blocks``): with the sequence split over 'model', each device's
    queries are one aligned block of ``chunked_attention`` at their
    offset."""
    if is_dtensor(q) and kv_valid_len is None:
        mesh, rules = q.device_mesh, current_rules() or {}
        msz = mesh_shape(mesh).get("model", 1)
        seq_ok = bool(rules.get("seq_attn")) and q.shape[1] == k.shape[1] \
            and msz > 1 and q.shape[1] % msz == 0

        def body(ql, kl, vl, off):
            if off or ql.shape[1] != q.shape[1]:
                # sequence-parallel: this shard's whole q blocks
                return chunked_attention(
                    ql, kl, vl, causal=causal, window=window,
                    q_offset=q_offset + off, chunk_q=min(chunk_q,
                                                         ql.shape[1]),
                    chunk_kv=chunk_kv)
            return attention_any(ql, kl, vl, causal=causal, window=window,
                                 q_offset=q_offset,
                                 chunk_threshold=chunk_threshold,
                                 chunk_q=chunk_q, chunk_kv=chunk_kv,
                                 use_flash=use_flash)

        out = _on_blocks(q, k, v, body, seq_ok=seq_ok)
        return constrain_divisible(out, "batch", "seq_attn", "heads", None)
    S = q.shape[1]
    if (use_flash and causal and not window and kv_valid_len is None
            and q.shape[1] == k.shape[1] and S % 256 == 0
            and q.shape[-1] in (64, 128)):
        return constrain_divisible(
            flash_ops.flash_attention_bshd(q, k, v, causal=True),
            "batch", "seq_attn", "heads", None)
    if (q.shape[1] <= chunk_threshold and k.shape[1] <= chunk_threshold
            and kv_valid_len is None):
        return full_attention(q, k, v, causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_valid_len=kv_valid_len,
                             chunk_q=chunk_q, chunk_kv=chunk_kv)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, Hkv, dh)
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32 — positions ever appended


def kv_cache_init(batch: int, s_max: int, n_kv: int, dh: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    """An empty cache, on the card unless ``device`` names the CPU."""
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros((batch, s_max, n_kv, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, s_max, n_kv, dh), dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def kv_cache_append(cache: KVCache, k_new: torch.Tensor,
                    v_new: torch.Tensor, *, ring: bool = False) -> KVCache:
    """Append S_new positions; returns a new cache.  ``ring=True`` wraps
    the write position to ``length mod s_max`` (the local-attention caches
    of RecurrentGemma).  One token (decode) is written per sequence at its
    own position through a select, so without ``ring`` a slot whose length
    has reached s_max is left as it is; several tokens (prefill) start at
    the position of sequence 0, which every sequence shares."""
    s_max = cache.k.shape[1]
    if is_dtensor(cache.k) and k_new.shape[1] == 1:
        return _append_on_blocks(cache, k_new, v_new, ring)
    start = torch.remainder(cache.length, s_max) if ring else cache.length
    if k_new.shape[1] == 1:
        pos = torch.arange(s_max, dtype=torch.int32, device=start.device)
        sel = pos[None, :, None, None] == start[:, None, None, None]
        k = torch.where(sel, k_new.to(cache.k.dtype), cache.k)
        v = torch.where(sel, v_new.to(cache.v.dtype), cache.v)
    else:
        # lax.dynamic_update_slice clamps the start so the slice fits
        n = k_new.shape[1]
        s0 = min(max(int(start[0]), 0), s_max - n)
        k, v = cache.k.clone(), cache.v.clone()
        k[:, s0:s0 + n] = k_new.to(k.dtype)
        v[:, s0:s0 + n] = v_new.to(v.dtype)
    return KVCache(k, v, cache.length + k_new.shape[1])


def _seq_offset(t) -> int:
    """Where this device's block of DTensor ``t`` starts along dim 1."""
    mesh, off = t.device_mesh, 0
    for name, pl in zip(mesh.mesh_dim_names, t.placements):
        if pl.is_shard(1):
            off = off * mesh.size(mesh.mesh_dim_names.index(name)) \
                + mesh.get_local_rank(name)
    return off * t.to_local().shape[1]


def _append_on_blocks(cache: KVCache, k_new, v_new, ring: bool) -> KVCache:
    """One-token :func:`kv_cache_append` of DTensor caches on each
    device's block, in the caches' own placements: a device writes the
    token where its block of slots holds the sequence's position, so a
    cache split over its slots is never gathered."""
    from torch.distributed.tensor.experimental import local_map

    s_max = cache.k.shape[1]
    off = _seq_offset(cache.k)

    def local(kl, vl, length, kn, vn):
        start = torch.remainder(length, s_max) if ring else length
        pos = off + torch.arange(kl.shape[1], dtype=torch.int32,
                                 device=kl.device)
        sel = pos[None, :, None, None] == start[:, None, None, None]
        return (torch.where(sel, kn.to(kl.dtype), kl),
                torch.where(sel, vn.to(vl.dtype), vl))

    from torch.distributed.tensor import Replicate

    c_pl = list(cache.k.placements)
    # the new token: the cache's placements but for the slots' split
    n_pl = [Replicate() if pl.is_shard(1) else pl for pl in c_pl]
    k, v = local_map(local, out_placements=(c_pl, c_pl),
                     in_placements=(c_pl, c_pl, list(cache.length.placements),
                                    n_pl, n_pl),
                     device_mesh=cache.k.device_mesh,
                     redistribute_inputs=True)(cache.k, cache.v, cache.length,
                                               k_new, v_new)
    return KVCache(k, v, cache.length + 1)


def decode_attention(q: torch.Tensor, cache: KVCache, *,
                     window: int = 0) -> torch.Tensor:
    """One-token decode: q (B, 1, H, dh) against the cache; GQA is
    contracted group-wise so the KV tensors are never repeated to full
    head count.  Without ``window`` a sequence sees its slots
    ``kpos < length``.  With ``window`` and a ring cache no longer than
    it (``s_max <= window``), every live slot is in the window: the mask
    is ``kpos < min(length, s_max)``.  With a longer cache the window
    mask ``kpos > length - 1 - window`` is added."""
    if is_dtensor(q):
        return _decode_on_blocks(q, cache, window)
    B, _, H, dh = q.shape
    s_max = cache.k.shape[1]
    Hkv = cache.k.shape[2]
    G = H // Hkv
    qg = (q * dh ** -0.5).reshape(B, Hkv, G, dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                     cache.k.float())                       # (B, Hkv, G, S)
    kpos = torch.arange(s_max, device=q.device)
    length = cache.length.expand(B)
    if window and s_max <= window:
        mask = kpos[None, :] < torch.clamp(length, max=s_max)[:, None]
    else:
        mask = kpos[None, :] < length[:, None]
        if window:
            mask = mask & (kpos[None, :] > (length - 1 - window)[:, None])
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    p = (p / torch.clamp(l, min=1e-30)).to(cache.v.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", p, cache.v)
    return out.reshape(B, 1, H, dh).to(q.dtype)


def _decode_on_blocks(q, cache: KVCache, window: int) -> torch.Tensor:
    """:func:`decode_attention` of DTensors on each device's local block
    (``local_map``).  Where the rules split the cache's KV heads over
    'model' (with the query heads), every device attends over its own
    heads.  Where they split its sequence instead ('kv_seq'), every device
    holds every query head and a block of slots: the softmax's max and sum
    and the output are all-reduced over 'model', the reference's tiny
    collectives of a sequence-sharded decode."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    B, _, H, dh = q.shape
    s_max, Hkv = cache.k.shape[1], cache.k.shape[2]
    G = H // Hkv
    c_spec = fit_spec(to_pspec(("batch", "kv_seq", "kv", None)),
                      cache.k.shape, mesh)
    heads = c_spec[2] is not None
    q_spec = fit_spec(to_pspec(("batch", None, "heads" if heads else None,
                                None)), q.shape, mesh)
    if heads and q_spec[2] is None:
        c_spec = c_spec[:2] + (None, None)
        heads = False
    seq = c_spec[1] is not None
    len_spec = c_spec[:1]

    def local(ql, kl, vl, length):
        Bl, H_l = ql.shape[0], ql.shape[2]
        S_l = kl.shape[1]
        qg = (ql * dh ** -0.5).reshape(Bl, kl.shape[2], G, dh)
        s = torch.einsum("bhgd,bshd->bhgs", qg.float(), kl.float())
        off = _model_index(mesh) * S_l if seq else 0
        kpos = off + torch.arange(S_l, device=ql.device)
        length = length.expand(Bl)
        if window and s_max <= window:
            mask = kpos[None, :] < torch.clamp(length, max=s_max)[:, None]
        else:
            mask = kpos[None, :] < length[:, None]
            if window:
                mask = mask & (kpos[None, :] > (length - 1 - window)[:, None])
        s = torch.where(mask[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m = torch.amax(s, dim=-1, keepdim=True)
        group = mesh.get_group("model") if seq else None
        if seq:
            m = funcol.all_reduce(m, "max", group)
        p = torch.exp(s - m)
        lsum = torch.sum(p, dim=-1, keepdim=True)
        if seq:
            lsum = funcol.all_reduce(lsum, "sum", group)
        p = (p / torch.clamp(lsum, min=1e-30)).to(vl.dtype)
        out = torch.einsum("bhgs,bshd->bhgd", p, vl)
        if seq:
            out = funcol.all_reduce(out, "sum", group)
        return out.reshape(Bl, 1, H_l, dh).to(ql.dtype)

    q_pl = spec_placements(q_spec, mesh)
    c_pl = spec_placements(c_spec, mesh)
    fn = local_map(local, out_placements=q_pl,
                   in_placements=(q_pl, c_pl, c_pl,
                                  spec_placements(len_spec, mesh)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, cache.k, cache.v, cache.length)
