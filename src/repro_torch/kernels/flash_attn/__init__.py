"""Flash attention, forward and backward: the CUDA kernels, their plain
versions, wrappers."""
