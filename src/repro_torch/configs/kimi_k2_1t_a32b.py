"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8
(arXiv:2501.kimi2, paper-table spec)."""
from repro_torch.configs.base import ModelConfig, MoECfg, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_ff=2048, vocab=163840,
    moe=MoECfg(n_experts=384, top_k=8, d_expert=2048),
    tied_embeddings=False, rope_theta=50_000.0))
