"""K = X Xᵀ of each stream's buffer (the split dump step's Gram)."""
