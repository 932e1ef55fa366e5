"""Tensor operators of the tracker's hot path (PyTorch)."""
