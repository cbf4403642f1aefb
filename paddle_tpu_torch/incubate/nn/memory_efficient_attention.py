"""``memory_efficient_attention``: the xformers-style entry point.

Counterpart of ``paddle_tpu/incubate/nn/memory_efficient_attention.py``:
``(query, key, value, attn_bias, p, scale)`` in layout ``[B, S, H, D]``
through the port's ``scaled_dot_product_attention``, so the flash
kernels run where its gate passes. As in the reference, a custom
``scale`` is folded into q (SDPA applies ``1 / sqrt(D)`` itself), and an
``AttentionBias`` is materialised into a full ``[B, H, Sq, Sk]`` fp32
mask on q's device, which takes SDPA's plain masked path; a tensor bias
is passed as it is. Dropout (``p`` in training) draws from
``generator=``.
"""
from __future__ import annotations

import math

from ...nn.functional.attention import scaled_dot_product_attention
from .attn_bias import AttentionBias

__all__ = ["memory_efficient_attention"]


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True, generator=None):
    q = query
    if scale is not None:
        q = q * (float(scale) / (1.0 / math.sqrt(q.shape[-1])))
    mask = attn_bias
    if isinstance(attn_bias, AttentionBias):
        b, sq, h, _ = q.shape
        mask = attn_bias.materialize((b, h, sq, key.shape[1]),
                                     dtype="float32", device=q.device)
    return scaled_dot_product_attention(q, key, value, attn_mask=mask,
                                        dropout_p=p, is_causal=False,
                                        training=training,
                                        generator=generator)
