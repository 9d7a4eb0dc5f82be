"""whisper-large-v3 [audio] — enc-dec backbone; the conv audio frontend is a
STUB: the caller passes precomputed (B, 1500, d) frame embeddings
(arXiv:2212.04356)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, d_ff=5120, vocab=51866,
    enc_layers=32, enc_frames=1500,
    tied_embeddings=True, rope_theta=0.0))  # whisper uses learned positions
