"""``paddle.incubate.nn.functional`` subset the Llama path uses.

Counterpart of ``paddle_tpu/incubate/nn/functional/__init__.py``:
``_rope_tables``, ``fused_rotary_position_embedding``, ``swiglu`` and
``fused_ec_moe``. The reference leaves all four to XLA, so here they are
plain PyTorch.
``fused_linear_cross_entropy`` lives in ``fused_linear_ce.py`` and the
serving attention ops (``block_multihead_attention`` over the paged and
varlen kernels, ``masked_multihead_attention``, ``blha_get_max_len``,
``variable_length_memory_efficient_attention``,
``fused_dot_product_attention``) in ``inference_attention.py``, as in the
reference.
"""
from __future__ import annotations

import torch

from ._rope_common import rotate_half
from .fused_linear_ce import fused_linear_cross_entropy
from .inference_attention import (blha_get_max_len,
                                  block_multihead_attention,
                                  fused_dot_product_attention,
                                  masked_multihead_attention,
                                  variable_length_memory_efficient_attention)

__all__ = ["fused_rotary_position_embedding", "swiglu", "fused_ec_moe",
           "rotate_half",
           "fused_linear_cross_entropy", "masked_multihead_attention",
           "blha_get_max_len", "block_multihead_attention",
           "variable_length_memory_efficient_attention",
           "fused_dot_product_attention"]


def _rope_tables(s, d, base, use_neox, dtype, device=None):
    """cos/sin tables [s, d], computed in fp32 and cast to ``dtype``."""
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=device) / d))
    t = torch.arange(s, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    if use_neox:
        emb = torch.cat([freqs, freqs], dim=-1)
    else:
        emb = torch.repeat_interleave(freqs, 2, dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """Apply RoPE to q (and k), layout [B, S, H, D]; returns (q, k, v).
    Tables are cast to q's dtype and the rotation runs in that dtype, as
    in the reference."""
    b, s, h, d = q.shape
    if cos is None or sin is None:
        cos_a, sin_a = _rope_tables(s, d, rotary_emb_base,
                                    use_neox_rotary_style, q.dtype, q.device)
    else:
        cos_a = cos.reshape(-1, d)[:s]
        sin_a = sin.reshape(-1, d)[:s]
    if position_ids is not None:
        pos = position_ids.long()
        cos_a = cos_a[pos][:, :, None, :]            # [B, S, 1, D]
        sin_a = sin_a[pos][:, :, None, :]
    else:
        cos_a = cos_a[None, :, None, :]
        sin_a = sin_a[None, :, None, :]
    qo = q * cos_a + rotate_half(q, use_neox_rotary_style) * sin_a
    if k is None:
        return qo, None, v
    ko = k * cos_a + rotate_half(k, use_neox_rotary_style) * sin_a
    return qo, ko, v


def swiglu(x, y=None, name=None):
    """silu(x) * y; with one argument, splits the last dim in two."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return torch.nn.functional.silu(x) * y


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu"):
    """The softmax-weighted sum of every expert's FFN: x [B, S, d], gate
    logits [B, S, E], stacked expert weights ``bmm0`` [E, d, h] and
    ``bmm1`` [E, h, d] with biases [E, 1, h] / [E, 1, d] (or None).
    ``act_type`` is ``"gelu"`` (exact) or ``"relu"``."""
    if act_type not in ("gelu", "relu"):
        raise ValueError(f"fused_ec_moe: unsupported act_type {act_type!r}")
    probs = torch.softmax(gate, dim=-1)                 # [B, S, E]
    h = torch.einsum("bsd,edh->bseh", x, bmm0_weight)
    if bmm0_bias is not None:
        h = h + bmm0_bias.reshape(bmm0_bias.shape[0], bmm0_bias.shape[-1])
    h = (torch.nn.functional.gelu(h) if act_type == "gelu"
         else torch.relu(h))
    y = torch.einsum("bseh,ehd->bsed", h, bmm1_weight)
    if bmm1_bias is not None:
        y = y + bmm1_bias.reshape(bmm1_bias.shape[0], bmm1_bias.shape[-1])
    return torch.einsum("bse,bsed->bsd", probs, y)
