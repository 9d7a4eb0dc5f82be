"""Feed-forward block of the dense family: SwiGLU.

Counterpart of ``repro/models/layers/mlp.py::swiglu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import matmul


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D); the SiLU runs in f32 and is cast back to
    x's type before the gating product."""
    g = matmul(x, w_gate)
    u = matmul(x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return matmul(h, w_down)
