"""``paddle.incubate.nn``: the fused transformer layers, the functional
fused ops, the attention-bias descriptors and
``memory_efficient_attention``.

Counterpart of ``paddle_tpu/incubate/nn/__init__.py``, with its
``__all__``.
"""
from . import attn_bias, functional
from .layer import (FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd,
                    FusedEcMoe, FusedFeedForward, FusedLinear,
                    FusedMultiHeadAttention, FusedMultiTransformer,
                    FusedTransformerEncoderLayer)
from .memory_efficient_attention import memory_efficient_attention

__all__ = [
    "FusedMultiHeadAttention", "FusedFeedForward",
    "FusedTransformerEncoderLayer", "FusedMultiTransformer", "FusedLinear",
    "FusedBiasDropoutResidualLayerNorm", "FusedEcMoe", "FusedDropoutAdd",
    "functional", "attn_bias", "memory_efficient_attention",
]
