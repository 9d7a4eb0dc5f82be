"""Exact window covariance G = AᵀA of each stream's window."""
