"""Functional ops of the port: the activations, ``linear``, ``dropout``,
``embedding``, ``one_hot``, ``layer_norm`` and ``rms_norm``, the whole
loss module and the flash-attention entry points. ``flash_attention``
here is the submodule, as in paddle (``flash_attention.flash_attention``
is the dense function, ``flash_attention.flash_attn_unpadded`` the varlen
one)."""
import torch

from . import flash_attention
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation_all
from .attention import scaled_dot_product_attention, sdp_kernel
from .common import dropout, embedding, linear, one_hot
from .flash_attention import flash_attn_unpadded
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss_all
from .norm import layer_norm, rms_norm

__all__ = ["scaled_dot_product_attention", "sdp_kernel", "flash_attention",
           "flash_attn_unpadded", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked", "rms_norm", "layer_norm", "linear",
           "dropout", "embedding", "one_hot", *_activation_all, *_loss_all]


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         fixed_seed_offset=None, rng_name="", training=True,
                         name=None, generator=None):
    """``flash_attention`` over a packed qkv [B, S, 3, H, D]; returns
    ``(out [B, S, H, D], None)``. As in the reference,
    ``fixed_seed_offset`` and ``rng_name`` are not passed on."""
    q, k, v = torch.unbind(qkv, 2)
    return flash_attention.flash_attention(
        q, k, v, dropout=dropout, causal=causal, return_softmax=return_softmax,
        training=training, generator=generator)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale=None, dropout=0.0,
                                causal=False, return_softmax=False,
                                fixed_seed_offset=None, rng_name="",
                                varlen_padded=True, training=True, name=None,
                                generator=None):
    """``flash_attn_unpadded`` over a packed varlen qkv [T, 3, H, D]; q, k
    and v are read in place from it. As in the reference, ``scale`` is
    passed on as given, so the default ``None`` raises ``TypeError``, and
    ``fixed_seed_offset`` and ``rng_name`` are not passed on."""
    q, k, v = torch.unbind(qkv, 1)
    return flash_attn_unpadded(
        q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
        scale=scale, dropout=dropout, causal=causal,
        return_softmax=return_softmax, training=training, generator=generator)
