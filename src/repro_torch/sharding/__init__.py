"""Tensor-parallel layout of the serving state."""
