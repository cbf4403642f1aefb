"""Attention functional ops (``scaled_dot_product_attention``).

Counterpart of ``paddle_tpu/nn/functional/attention.py``. Layout is
paddle's [batch, seqlen, num_heads, head_dim]. Routing follows the
reference: the flash kernels (forward and backward, through
``_FlashAttention``) when the gate passes, the plain
composition (``_sdpa_plain`` / ``_sdpa_mask_plain``, the reference's
``_sdpa_xla`` / ``_sdpa_mask_xla``) otherwise.

The port's gate states what ``csrc/flash_attention.cu`` accepts, not the
TPU's tile rule (D % 64, S % 128): the ``use_cuda_flash_attention`` flag
is on, D is 64 or 128, q/k/v share a dtype among float32, bfloat16 and
float16, the q heads are a multiple of the kv heads, and dropout is
below 1. Any sequence lengths pass. A mask goes to the kernel as a key
bias when it is key-only (``[B|1, 1, 1, Sk]``) and takes no gradient;
the reference's TPU-measured crossover (masks go to flash only at
Sk >= 1024) is not carried over. A CPU tensor that passes the gate runs
the kernel's plain version (``ops/cuda/flash_attention``).
"""
from __future__ import annotations

import math

import torch

from ...core.autocast import white_list_inputs
from ...core.flags import get_flag, set_flags
from ...core.generator import use_generator
from ...ops.cuda.flash_attention import (KERNEL_HEAD_DIMS,
                                         flash_attention_fused)

__all__ = ["scaled_dot_product_attention", "flash_attention", "sdp_kernel"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _attn_dropout(probs, generator, dropout_p):
    # dropout on the attention WEIGHTS (softmax output), as the reference
    if dropout_p > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs a torch.Generator")
        keep = torch.rand(probs.shape, generator=use_generator(generator),
                          device=probs.device) < (1.0 - dropout_p)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return probs


def _repeat_kv(q, k, v):
    qh, kh = q.shape[2], k.shape[2]
    if kh != qh:
        k = torch.repeat_interleave(k, qh // kh, dim=2)
        v = torch.repeat_interleave(v, qh // kh, dim=2)
    return k, v


def _sdpa_plain(q, k, v, generator, *, causal, scale, dropout_p):
    """q, k, v: [B, S, H, D]; GQA by repeat. Logits in q's dtype, fp32
    softmax, as the reference's XLA composition."""
    k, v = _repeat_kv(q, k, v)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(s, t, dtype=torch.bool,
                          device=q.device).tril(t - s)
        # an fp32 fill (the reference's np.float32 finfo.min promotes the
        # logits to fp32 here too; it overflows bf16)
        logits = torch.where(mask, logits.float(),
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    probs = _attn_dropout(probs, generator, dropout_p)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _sdpa_mask_plain(q, k, v, mask, generator, *, scale, dropout_p):
    k, v = _repeat_kv(q, k, v)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    logits = logits + mask.to(logits.dtype)
    # safe softmax: a row whose keys are ALL masked to -inf outputs zeros
    # instead of NaN (the flash kernel's l == 0 convention)
    lf = logits.float()
    row_max = lf.amax(dim=-1, keepdim=True)
    dead = row_max == float("-inf")
    e = torch.exp(lf - torch.where(dead, 0.0, row_max))
    denom = e.sum(dim=-1, keepdim=True)
    probs = torch.where(dead, 0.0, e / torch.where(dead, 1.0, denom))
    probs = _attn_dropout(probs.to(q.dtype), generator, dropout_p)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _use_flash(q, k, v) -> bool:
    return (get_flag("use_cuda_flash_attention") and q.ndim == 4
            and q.shape[-1] in KERNEL_HEAD_DIMS and q.dtype in _DTYPES
            and k.dtype == q.dtype and v.dtype == q.dtype
            and q.shape[2] % k.shape[2] == 0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` in layout
    [B, S, H, D]. Dropout applies to the attention weights; with
    ``dropout_p > 0`` (and ``training``) a ``generator`` is required —
    the kernel draws its counter-hash seed from it. Under autocast fp32
    q, k, v run in the autocast dtype (the reference's amp white list)."""
    q, k, v = white_list_inputs(query, key, value)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = float(dropout_p) if training else 0.0
    if attn_mask is not None:
        m = attn_mask
        if (_use_flash(q, k, v) and p < 1.0 and m.ndim == 4
                and m.shape[1] == 1 and m.shape[2] == 1
                and m.shape[3] == k.shape[1]
                and m.shape[0] in (1, q.shape[0])
                and not m.requires_grad):
            # [B|1, 1, 1, Sk] additive padding mask -> per-key logit
            # bias; causal=False because the mask path gives the mask
            # precedence over is_causal (both routes must agree)
            bias = m.reshape(m.shape[0], m.shape[3])
            return flash_attention_fused(q, k, v, causal=False, scale=scale,
                                         dropout_p=p, generator=generator,
                                         key_bias=bias)
        return _sdpa_mask_plain(q, k, v, m, generator, scale=scale,
                                dropout_p=p)
    if _use_flash(q, k, v) and p < 1.0:
        return flash_attention_fused(q, k, v, causal=bool(is_causal),
                                     scale=scale, dropout_p=p,
                                     generator=generator)
    return _sdpa_plain(q, k, v, generator, causal=bool(is_causal),
                       scale=scale, dropout_p=p)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None, generator=None):
    """``paddle.nn.functional.flash_attention.flash_attention``: attention
    in layout [B, S, H, D] through :func:`scaled_dot_product_attention`,
    returning ``(out, None)``. As in the reference, ``fixed_seed_offset``
    and ``rng_name`` are not passed on; dropout draws from
    ``generator``."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training, generator=generator)
    return out, None


class sdp_kernel:
    """Context manager selecting the attention kernel, as paddle's: with
    ``enable_flash=False`` the flash kernels are off inside it (the
    ``use_cuda_flash_attention`` flag), and the previous setting comes
    back on exit. ``enable_math`` and ``enable_mem_efficient`` are
    accepted and change nothing, as in the reference."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        self.enable_flash = enable_flash
        self._prev = None

    def __enter__(self):
        self._prev = set_flags(
            {"use_cuda_flash_attention": self.enable_flash})
        return self

    def __exit__(self, *exc):
        set_flags(self._prev)
        return False
