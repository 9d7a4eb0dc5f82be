"""Layers of the dense transformer: norms, RoPE, attention, MLP."""
