"""grok-1-314b [moe] — 8 experts top-2 (hf:xai-org/grok-1)."""
from repro_torch.configs.base import ModelConfig, MoECfg, register

CONFIG = register(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_ff=32768, vocab=131072,
    moe=MoECfg(n_experts=8, top_k=2, d_expert=32768),
    tied_embeddings=False, rope_theta=10_000.0))
