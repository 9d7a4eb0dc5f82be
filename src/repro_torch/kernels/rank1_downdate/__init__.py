"""Rank-1 downdate D − (Dv)vᵀ of each stream's buffer."""
