"""Functional ops of the port (the inference subset)."""
from .attention import scaled_dot_product_attention
from .norm import rms_norm

__all__ = ["scaled_dot_product_attention", "rms_norm"]
