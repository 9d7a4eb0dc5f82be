"""Flash-attention forward: the CUDA kernel, its plain version, wrappers."""
