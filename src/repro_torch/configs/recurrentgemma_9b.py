"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2
(arXiv:2402.19427)."""
from repro_torch.configs.base import ModelConfig, RGLRUCfg, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288, vocab=256000,
    head_dim=256,
    rglru=RGLRUCfg(lru_width=0, conv_k=4, local_window=2048,
                   pattern=("rec", "rec", "attn")),
    tied_embeddings=True, sub_quadratic=True, rope_theta=10_000.0))
