"""Model configurations: one frozen dataclass per architecture.

Counterpart of ``repro/configs/base.py``, with the same fields, defaults and
``reduced()``.  The port registers the four dense configurations and the
two MoE ones (grok-1, kimi-k2); the other families of the reference (VLM,
SSM, hybrid, encoder-decoder) are known by name and raise
``NotImplementedError`` until their slice lands (ROADMAP item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int                     # per-expert FFN hidden dim
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUCfg:
    lru_width: int = 0                # 0 → d_model
    conv_k: int = 4
    local_window: int = 2048
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")   # 1 attn : 2 rec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | encdec | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    qkv_bias: bool = False
    tied_embeddings: bool = True
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rglru: Optional[RGLRUCfg] = None
    enc_layers: int = 0               # whisper encoder depth
    enc_frames: int = 1500            # stub conv frontend output length
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    sub_quadratic: bool = False       # can run long_500k
    remat: str = "full"               # the reference's; eager serving ignores it
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    attn_full_threshold: int = 2048
    # route causal self-attention through the flash kernel
    # (kernels/flash_attn; csrc/flash_attn.cu on the card)
    use_flash: bool = False

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's rule:
        GQA ratio kept, at most 4 heads, d_model 32, head_dim 8, f32)."""
        kv = max(1, min(self.n_kv, 2))
        heads = max(kv * max(1, self.n_heads // max(self.n_kv, 1)), kv)
        heads = min(heads, 4)
        kv = min(kv, heads)
        moe = None
        if self.moe:
            moe = MoECfg(n_experts=4, top_k=min(2, self.moe.top_k),
                         d_expert=32)
        ssm = None
        if self.ssm:
            ssm = SSMCfg(d_state=16, d_conv=4, headdim=8, chunk=16,
                         n_groups=1)
        rglru = None
        if self.rglru:
            rglru = RGLRUCfg(lru_width=0, conv_k=4, local_window=8,
                             pattern=self.rglru.pattern)
        mrope = (2, 1, 1) if self.mrope_sections else None  # dh=8 → half=4
        return dataclasses.replace(
            self, n_layers=len(self.rglru.pattern) + 1 if self.rglru else 2,
            d_model=32, n_heads=heads, n_kv=kv, d_ff=64, vocab=128,
            head_dim=8, moe=moe, ssm=ssm, rglru=rglru, mrope_sections=mrope,
            enc_layers=min(self.enc_layers, 2), enc_frames=16,
            param_dtype="float32", act_dtype="float32", remat="none")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (sequence length, global batch) cell of a workload, as the
    reference's; ``train/train_step.py::auto_microbatches`` reads it."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # 'train' | 'prefill' | 'decode'


_REGISTRY: Dict[str, ModelConfig] = {}

# configurations of the reference whose family the port does not run yet
NOT_PORTED = {
    "qwen2-vl-2b": "vlm", "mamba2-2.7b": "ssm",
    "recurrentgemma-9b": "hybrid", "whisper-large-v3": "encdec",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: the port runs the dense "
        "and MoE families only (ROADMAP.md, item 15 of the modules still to "
        "port)")


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    if name in NOT_PORTED:
        raise not_ported(f"{name} ({NOT_PORTED[name]} family)")
    return _REGISTRY[name]


def load_all() -> None:
    from repro_torch.configs import (smollm_135m, qwen1_5_0_5b,  # noqa
                                     minitron_4b, llama3_8b, grok_1_314b,
                                     kimi_k2_1t_a32b)
