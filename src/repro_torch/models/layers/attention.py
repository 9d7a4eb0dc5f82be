"""Attention: GQA in full, chunked (online softmax) and flash form, and the
KV cache of the decode path.

Counterpart of ``repro/models/layers/attention.py``.  The reference's
``lax.scan`` over KV blocks becomes a Python loop; its sequence-parallel
branch serves a device mesh and has no counterpart on one device.  KV heads
are repeated to the full head count per block (``repeat_interleave``, so q
head h reads KV head h // G), and caches stay at n_kv width.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.flash_attn import ops as flash_ops

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


def full_attention(q, k, v, *, causal: bool, window: int = 0) -> torch.Tensor:
    """Plain einsum attention for short sequences.  P is cast to v's type
    before P·V, as in the reference."""
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
    dh ∈ {64, 128}.  Other short sequences take the one-shot path."""
    S = q.shape[1]
    if (use_flash and causal and not window and kv_valid_len is None
            and q.shape[1] == k.shape[1] and S % 256 == 0
            and q.shape[-1] in (64, 128)):
        return flash_ops.flash_attention_bshd(q, k, v, causal=True)
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


def decode_attention(q: torch.Tensor, cache: KVCache, *,
                     window: int = 0) -> torch.Tensor:
    """One-token decode: q (B, 1, H, dh) against the cache; GQA is
    contracted group-wise so the KV tensors are never repeated to full
    head count.  Without ``window`` a sequence sees its slots
    ``kpos < length``.  With ``window`` and a ring cache no longer than
    it (``s_max <= window``), every live slot is in the window: the mask
    is ``kpos < min(length, s_max)``.  With a longer cache the window
    mask ``kpos > length - 1 - window`` is added."""
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
