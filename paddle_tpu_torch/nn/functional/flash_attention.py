"""``paddle.nn.functional.flash_attention`` submodule.

Counterpart of ``paddle_tpu/nn/functional/flash_attention.py``:
``flash_attn_unpadded`` over the varlen kernels
(``ops/cuda/flash_attention_varlen.py``), and the dense entry points
re-exported from ``attention.py``.
"""
from __future__ import annotations

import torch

from ...core.autocast import white_list_inputs
from ...core.generator import draw_seed
from ...ops.cuda.flash_attention_varlen import flash_attn_varlen
from .attention import (  # noqa: F401
    flash_attention, scaled_dot_product_attention, sdp_kernel,
)

__all__ = ["flash_attn_unpadded", "flash_attention",
           "scaled_dot_product_attention", "sdp_kernel"]


def _cu(t, device):
    if isinstance(t, torch.Tensor):
        return t.to(device)
    return torch.as_tensor(t, dtype=torch.int32, device=device)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, generator=None):
    """Varlen flash attention over packed [total_tokens, H, D] tensors:
    returns ``(out [total_tokens, H, D], None)``.

    ``cu_seqlens_*`` ([n_seqs + 1], int32 or int64) give each sequence's
    start; they stay on the device (the number of sequences comes from
    their shape). GQA (H a multiple of the kv heads) and bottom-right
    causal masking per sequence are supported; ``max_seqlen_*`` are
    accepted and change nothing, as in the reference. ``scale`` is
    required. Dropout (``training`` and ``dropout`` > 0) runs in the
    kernel: ``fixed_seed_offset`` pins its int32 seed, else one seed is
    drawn from ``generator`` (a ``torch.Generator`` on the tensors'
    device), the port's explicit stand-in for the reference's named
    stream ``rng_name``; the backward regenerates the same bits. Under
    autocast fp32 q, k, v run in the autocast dtype (the reference's amp
    white list)."""
    q, k, v = white_list_inputs(query, key, value)
    p = float(dropout) if training else 0.0
    if p >= 1.0:
        raise ValueError("flash_attn_unpadded: dropout must be < 1.0, "
                         f"got {dropout}")
    scale = float(scale)
    cu_q, cu_k = _cu(cu_seqlens_q, q.device), _cu(cu_seqlens_k, q.device)
    seed = None
    if p > 0.0:
        if fixed_seed_offset is not None:
            seed = torch.tensor([int(fixed_seed_offset)], dtype=torch.int32,
                                device=q.device)
        elif generator is None:
            raise ValueError(
                "flash_attn_unpadded: dropout > 0 needs fixed_seed_offset or "
                "a torch.Generator for the in-kernel counter hash's seed")
        else:
            seed = draw_seed(generator, q.device)
    out = flash_attn_varlen(q, k, v, cu_q, cu_k, seed, causal=bool(causal),
                            scale=scale, dropout_rate=p)
    return out, None
