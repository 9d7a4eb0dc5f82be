"""qwen2-vl-2b [vlm] — M-RoPE backbone; vision patch frontend is a STUB:
the caller passes precomputed (B, S, 3) M-RoPE position ids
(arXiv:2409.12191)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960, vocab=151936,
    qkv_bias=True, mrope_sections=(16, 24, 24), tied_embeddings=True,
    rope_theta=1_000_000.0))
