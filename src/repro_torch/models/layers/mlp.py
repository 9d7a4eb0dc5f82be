"""Feed-forward blocks: SwiGLU (the dense family) and GELU (Whisper).

Counterpart of ``repro/models/layers/mlp.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import matmul
from repro_torch.parallel.sharding import constrain


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D); the SiLU runs in f32 and is cast back to
    x's type before the gating product."""
    g = matmul(x, w_gate)
    u = matmul(x, w_up)
    h = constrain(F.silu(g.float()).to(x.dtype) * u, "batch", "seq", "ff")
    return constrain(matmul(h, w_down), "batch", "seq", "embed")


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D) with biases; the GELU is the tanh
    approximation (``jax.nn.gelu``'s default, ``approximate=True``), in
    f32, cast back to x's type before the second product."""
    h = matmul(x, w_in) + b_in
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    h = constrain(h, "batch", "seq", "ff")
    return constrain(matmul(h, w_out) + b_out, "batch", "seq", "embed")
