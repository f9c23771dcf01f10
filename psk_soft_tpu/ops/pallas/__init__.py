"""Pallas kernels for NVIDIA GPUs (Triton route)."""
