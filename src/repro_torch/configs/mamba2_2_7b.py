"""mamba2-2.7b [ssm] — SSD, attention-free (arXiv:2405.21060)."""
from repro_torch.configs.base import ModelConfig, SSMCfg, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv=0, d_ff=0, vocab=50280,
    ssm=SSMCfg(d_state=128, d_conv=4, headdim=64, expand=2, chunk=256),
    tied_embeddings=True, sub_quadratic=True))
