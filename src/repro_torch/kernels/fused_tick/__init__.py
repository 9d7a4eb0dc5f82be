"""The fused krylov-tick kernels (gram_power, fused_krylov_step)."""
