"""Functional ops of the port (the Llama training subset)."""
from .attention import scaled_dot_product_attention
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["scaled_dot_product_attention", "rms_norm", "cross_entropy"]
