"""qwen1.5-0.5b [dense] — QKV bias (hf:Qwen/Qwen1.5-0.5B)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=2816, vocab=151936,
    qkv_bias=True, tied_embeddings=True, rope_theta=1_000_000.0))
