"""Mamba2's SSD block (state-space duality, arXiv:2405.21060): the chunked
form for training and prefill and the O(1)-state recurrent form for
decode.

Counterpart of ``repro/models/layers/ssm.py``.  The reference's
``lax.scan`` over the chunk summaries is a Python loop over the chunks;
its in-projection is split per role (``wz``, ``wx``, ``wbc``, ``wdt``) as
there.  Products run in f32 where the reference asks for f32 results
(``preferred_element_type``), with its casts to the input's type between
them.

The reference's intra-chunk decay matrix is exp(cum_t − cum_t) = 1 (its
two transposes of the running sum give the same (…, L, 1) tensor), so the
intra-chunk term carries no decay; the inter-chunk states and the decode
recurrence do.  The port computes the same function (ROADMAP §3 note
(m)).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.layers.common import matmul, rms_norm
from repro_torch.parallel.sharding import (constrain, fit_spec, is_dtensor,
                                           spec_placements, to_pspec)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, then SiLU in f32.  x: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu((out + b).float()).to(x.dtype)


def ssd_chunked(xh, Bc, Cc, dt, A, D_skip, chunk: int):
    """SSD over whole sequences.

    xh: (B, S, H, P); Bc, Cc: (B, S, G, N), each group shared by H/G heads;
    dt: (B, S, H) after the softplus; A: (H,) negative.  Returns y
    (B, S, H, P) in xh's type and the final state (B, H, N, P) in f32.
    """
    if is_dtensor(xh) and Bc.shape[2] == 1:
        return _ssd_on_blocks(xh, Bc, Cc, dt, A, D_skip, chunk)
    Bsz, S, H, P = xh.shape
    G, N = Bc.shape[2], Bc.shape[3]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = xh.shape[1] // L
    dtype = xh.dtype
    xh = xh.reshape(Bsz, nc, L, H, P)
    Bh = Bc.reshape(Bsz, nc, L, G, N).repeat_interleave(H // G, dim=3)
    Ch = Cc.reshape(Bsz, nc, L, G, N).repeat_interleave(H // G, dim=3)
    dt = dt.reshape(Bsz, nc, L, H).float()

    cum = torch.cumsum(dt * A, dim=2)                    # (B, nc, L, H) ≤ 0
    total = cum[:, :, -1:, :]                            # (B, nc, 1, H)
    dx = xh * dt[..., None].to(dtype)                    # dt·x

    # intra-chunk: M[t, s] = C_t·B_s for s ≤ t (no decay: see the module
    # docstring)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch.float(), Bh.float())
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=xh.device))
    M = torch.where(causal, scores, torch.zeros((), device=xh.device))
    y_intra = torch.einsum("bchls,bcshp->bclhp", M.to(dtype).float(),
                           dx.float())

    # chunk summary states: S_c = Σ_s exp(total − cum_s) · B_s ⊗ dx_s
    w_end = torch.exp(total - cum).to(dtype).float()     # (B, nc, L, H)
    states = torch.einsum("bclhn,bclhp->bchnp", Bh.float() * w_end[..., None],
                          dx.float())

    # inter-chunk recurrence: H_c = H_{c-1}·exp(total_c) + S_c
    tot = torch.exp(total[:, :, 0, :])                   # (B, nc, H)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                # state before chunk c
        h = h * tot[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1).to(dtype).float()  # (B,nc,H,N,P)

    w_start = torch.exp(cum).to(dtype).float()           # decay since start
    y_inter = torch.einsum("bclhn,bchnp->bclhp",
                           Ch.float() * w_start[..., None], h_prevs)

    y = (y_intra + y_inter).to(dtype)
    y = y + xh * D_skip[None, None, None, :, None].to(dtype)
    return y.reshape(Bsz, nc * L, H, P)[:, :S], h


def _ssd_on_blocks(xh, Bc, Cc, dt, A, D_skip, chunk: int):
    """:func:`ssd_chunked` of DTensors on each device's local block
    (``local_map``): the scan is independent over the batch and the heads
    (one group, shared by every head), so no collective is needed."""
    from torch.distributed.tensor.experimental import local_map

    mesh = xh.device_mesh
    b, q, h, _ = fit_spec(to_pspec(("batch", "seq", "heads", None)),
                          xh.shape, mesh)
    x_pl = spec_placements((b, q, h, None), mesh)
    h_pl = spec_placements((b, h, None, None), mesh)
    bc_pl = spec_placements((b, q, None, None), mesh)
    dt_pl = spec_placements((b, q, h), mesh)
    a_pl = spec_placements((h,), mesh)
    fn = local_map(functools.partial(ssd_chunked, chunk=chunk),
                   out_placements=(x_pl, h_pl),
                   in_placements=(x_pl, bc_pl, bc_pl, dt_pl, a_pl, a_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(xh, Bc, Cc, dt, A, D_skip)


class SSMCache(NamedTuple):
    conv_x: torch.Tensor    # (B, K-1, d_inner) the conv's last inputs
    conv_bc: torch.Tensor   # (B, K-1, 2·G·N)
    state: torch.Tensor     # (B, H, N, P) f32


def _dims(cfg: ModelConfig):
    """(d_inner, G·N, heads H)."""
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    return di, ssm.n_groups * ssm.d_state, di // ssm.headdim


def _project(cfg: ModelConfig, p, x: torch.Tensor):
    """The input projections and causal convs.  x: (B, S, D).  Returns
    (z, xs, bc, dt, conv_x_in, conv_bc_in): xs and bc after their convs,
    conv_*_in the convs' inputs (the cache's tails)."""
    z = matmul(x, p["wz"])
    xs = matmul(x, p["wx"])
    bc = matmul(x, p["wbc"])
    dt = matmul(x, p["wdt"])
    z = constrain(z, "batch", "seq", "inner")
    xs = constrain(xs, "batch", "seq", "inner")
    dt = constrain(dt, "batch", "seq", "heads")
    conv_x_in, conv_bc_in = xs, bc
    xs = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
    bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"])
    return z, xs, bc, dt, conv_x_in, conv_bc_in


def _dt_softplus(p, dt: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt.float() + p["dt_bias"].float())


def _gate_norm_out(cfg: ModelConfig, p, y: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """y·SiLU(z), the gated RMSNorm's gain, the out-projection."""
    y = y * F.silu(z.float()).to(y.dtype)
    return matmul(rms_norm(y, p["norm"], cfg.norm_eps), p["out_proj"])


def mamba_block(cfg: ModelConfig, p, x: torch.Tensor, *,
                return_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """The Mamba2 mixer over whole sequences.  x: (B, S, D) → ((B, S, D),
    the decode cache when ``return_cache``)."""
    ssm = cfg.ssm
    di, _, H = _dims(cfg)
    Bsz, S = x.shape[0], x.shape[1]
    P, N = ssm.headdim, ssm.d_state

    z, xs, bc, dt, conv_x_in, conv_bc_in = _project(cfg, p, x)
    Bc, Cc = torch.chunk(bc, 2, dim=-1)
    A = -torch.exp(p["A_log"].float())
    xh = constrain(xs.reshape(Bsz, S, H, P), "batch", "seq", "heads", None)
    y, h_final = ssd_chunked(
        xh, Bc.reshape(Bsz, S, ssm.n_groups, N),
        Cc.reshape(Bsz, S, ssm.n_groups, N), _dt_softplus(p, dt), A,
        p["D_skip"], ssm.chunk)
    out = _gate_norm_out(cfg, p, y.reshape(Bsz, S, di), z)
    out = constrain(out, "batch", "seq", "embed")
    if not return_cache:
        return out, None
    K = ssm.d_conv
    act = getattr(torch, cfg.act_dtype)
    cache = SSMCache(conv_x=conv_x_in[:, S - (K - 1):, :].to(act),
                     conv_bc=conv_bc_in[:, S - (K - 1):, :].to(act),
                     state=h_final)
    return out, cache


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda") -> SSMCache:
    """An empty cache, on the card unless ``device`` names the CPU."""
    ssm = cfg.ssm
    di, gn, H = _dims(cfg)
    device = resolve_device(device)
    return SSMCache(
        conv_x=torch.zeros((batch, ssm.d_conv - 1, di), dtype=dtype,
                           device=device),
        conv_bc=torch.zeros((batch, ssm.d_conv - 1, 2 * gn), dtype=dtype,
                            device=device),
        state=torch.zeros((batch, H, ssm.d_state, ssm.headdim),
                          dtype=torch.float32, device=device))


def mamba_decode_step(cfg: ModelConfig, p, x: torch.Tensor,
                      cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One token of the recurrence.  x: (B, 1, D)."""
    ssm = cfg.ssm
    di, gn, H = _dims(cfg)
    Bsz = x.shape[0]
    P, N, K = ssm.headdim, ssm.d_state, ssm.d_conv

    z = matmul(x, p["wz"])
    xs = matmul(x, p["wx"])
    bc = matmul(x, p["wbc"])
    dt = matmul(x, p["wdt"])
    win_x = torch.cat([cache.conv_x, xs.to(cache.conv_x.dtype)], dim=1)
    win_bc = torch.cat([cache.conv_bc, bc.to(cache.conv_bc.dtype)], dim=1)

    def conv_tap(win, w, b):
        out = sum(win[:, i, :] * w[i] for i in range(K)) + b
        return F.silu(out.float()).to(x.dtype)

    xs1 = conv_tap(win_x, p["conv_x_w"], p["conv_x_b"])        # (B, di)
    bc1 = conv_tap(win_bc, p["conv_bc_w"], p["conv_bc_b"])     # (B, 2gn)
    rep = H // ssm.n_groups
    Bh = bc1[:, :gn].reshape(Bsz, ssm.n_groups, N).repeat_interleave(rep, 1)
    Ch = bc1[:, gn:].reshape(Bsz, ssm.n_groups, N).repeat_interleave(rep, 1)
    xh = xs1.reshape(Bsz, H, P)
    A = -torch.exp(p["A_log"].float())
    dtp = _dt_softplus(p, dt)[:, 0]                             # (B, H)
    decay = torch.exp(dtp * A[None, :])
    upd = (Bh.float()[..., :, None] * xh.float()[..., None, :]
           * dtp[..., None, None])
    state = cache.state * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), state)
    y = y + xh.float() * p["D_skip"].float()[None, :, None]
    y = y.reshape(Bsz, 1, di).to(x.dtype)
    out = _gate_norm_out(cfg, p, y, z)
    return out, SSMCache(conv_x=win_x[:, 1:], conv_bc=win_bc[:, 1:],
                         state=state)
