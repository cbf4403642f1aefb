"""Operators of the port: hand-written CUDA kernels under ``cuda/``."""
