"""Functional ops of the port: every public name of the reference's
``paddle_tpu/nn/functional``: the activations and their in-place forms,
``common.py`` (``linear``, the dropouts, ``embedding``, ``pad``,
``interpolate`` and its neighbours), the convolutions and their
transposes, the pools (``extra_pooling.py``: unpooling, power-average
and fractional max pooling), the norms, the losses (``loss.py`` and
``extra_loss.py``), ``vision.py`` (sampling grids, ``temporal_shift``,
``gather_tree``) and the attention entry points. ``flash_attention``
here is the submodule, as in paddle (``flash_attention.flash_attention``
is the dense function, ``flash_attention.flash_attn_unpadded`` the varlen
one).

The in-place activations (``elu_``, ``hardtanh_``, ``leaky_relu_``,
``softmax_``, ``tanh_``, ``thresholded_relu_``) write the result into
``x`` and return it; on a tensor that needs a gradient, autograd sees
``x`` as the result (the op runs on a copy, so nothing it saved is
overwritten). On a leaf that requires grad torch raises, where the
reference rebinds the graph (``paddle_tpu/ops/math.py::_make_inplace``).
"""
import math

import torch

from . import extra_loss, extra_pooling, flash_attention, vision
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation_all
from .activation import (elu, hardtanh, leaky_relu, softmax, tanh,
                         thresholded_relu)
from ...core.generator import use_generator
from .attention import scaled_dot_product_attention, sdp_kernel
from .common import *  # noqa: F401,F403
from .common import __all__ as _common_all
from .common import _alpha_mix
from .extra_loss import *  # noqa: F401,F403
from .extra_loss import __all__ as _extra_loss_all
from .extra_pooling import *  # noqa: F401,F403
from .extra_pooling import __all__ as _extra_pooling_all
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .flash_attention import flash_attn_unpadded
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss_all
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize, rms_norm)
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling_all
from .vision import *  # noqa: F401,F403
from .vision import __all__ as _vision_all

__all__ = ["scaled_dot_product_attention", "sdp_kernel", "flash_attention",
           "flash_attn_unpadded", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked", "flash_attention_with_sparse_mask",
           "sparse_attention", "rms_norm", "layer_norm",
           "conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
           "batch_norm", "instance_norm", "group_norm", "normalize",
           "local_response_norm", "feature_alpha_dropout", "elu_",
           "hardtanh_", "leaky_relu_", "softmax_", "tanh_",
           "thresholded_relu_", *[n for n in _common_all if n != "Embedding"],
           *_pooling_all, *_extra_pooling_all, *_activation_all, *_loss_all,
           *_extra_loss_all, *_vision_all]


def _make_inplace(op):
    def inplace(x, *args, **kwargs):
        src = x.clone() if x.requires_grad else x
        return x.copy_(op(src, *args, **kwargs))

    inplace.__name__ = op.__name__ + "_"
    inplace.__doc__ = f"In-place ``{op.__name__}``: writes into ``x``, " \
                      f"returns ``x``."
    return inplace


elu_ = _make_inplace(elu)
hardtanh_ = _make_inplace(hardtanh)
leaky_relu_ = _make_inplace(leaky_relu)
softmax_ = _make_inplace(softmax)
tanh_ = _make_inplace(tanh)
thresholded_relu_ = _make_inplace(thresholded_relu)


def feature_alpha_dropout(x, p=0.5, training=True, name=None,
                          generator=None):
    """``alpha_dropout`` of whole channel maps: one draw per (sample,
    channel) of axis 1. A draw needs ``generator``."""
    p = float(p)
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("feature_alpha_dropout draws a keep mask: pass "
                         "generator= (a torch.Generator on the input's "
                         "device)")
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.ndim - 2)
    keep = torch.rand(shape, generator=use_generator(generator),
                      device=x.device) < (1.0 - p)
    return _alpha_mix(x, keep, p)


def _csr_mask(offsets, columns, s):
    """[B, H, S, S] fp32 additive mask, 0 at each (row, column) of the
    CSR pattern and -1e9 elsewhere, built on the device: entry j of a
    (batch, head) belongs to the row whose offset range holds it."""
    b, h = offsets.shape[:2]
    offs = offsets.long()
    cols = columns.long()
    j = torch.arange(cols.shape[-1], device=cols.device).expand(b, h, -1)
    rows = torch.searchsorted(offs.contiguous(), j.contiguous(),
                              right=True) - 1
    valid = j < offs[..., -1:]
    bh = torch.arange(b * h, device=cols.device).reshape(b, h, 1)
    flat = ((bh * s + rows.clamp(0, s - 1)) * s + cols.clamp(0, s - 1))
    flat = torch.where(valid, flat, b * h * s * s)       # spare entry
    mask = torch.full((b * h * s * s + 1,), -1e9, dtype=torch.float32,
                      device=cols.device)
    mask.index_fill_(0, flat.reshape(-1), 0.0)
    return mask[:-1].reshape(b, h, s, s)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Attention over a CSR sparsity pattern, q / k / v ``[B, H, S, D]``,
    the pattern ``sparse_csr_offset`` ``[B, H, S + 1]`` and
    ``sparse_csr_columns`` ``[B, H, nnz]``: the pattern as an additive
    mask (built on the device), ``key_padding_mask`` ``[B, S]`` and
    ``attn_mask`` ``[S, S]`` added (both additive), softmax and the
    products in fp32, the output in ``query``'s dtype."""
    q, k, v = query.float(), key.float(), value.float()
    d = q.shape[-1]
    scores = (torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
              + _csr_mask(sparse_csr_offset, sparse_csr_columns,
                          q.shape[2]))
    if key_padding_mask is not None:
        scores = scores + key_padding_mask.float()[:, None, None, :]
    if attn_mask is not None:
        scores = scores + attn_mask.float()[None, None]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).to(query.dtype)


def flash_attention_with_sparse_mask(query, key, value,
                                     attn_mask_start_row_indices=None,
                                     attn_mask_start_row=0, dropout_p=0.0,
                                     is_causal=True, training=True,
                                     name=None, generator=None):
    """Attention in layout [B, S, H, D]. Without
    ``attn_mask_start_row_indices`` it is
    ``scaled_dot_product_attention(..., is_causal)`` (the flash kernels
    where the gate passes). With them (``[B, H, S]``: the query row from
    which each key column is masked) the reference's ``[B, H, S, S]``
    mask, causal and that one summed and clamped at -1e9, goes through
    the plain masked path, as in the reference; ``is_causal`` and
    ``attn_mask_start_row`` are then not read."""
    if attn_mask_start_row_indices is None:
        return scaled_dot_product_attention(query, key, value, None,
                                            dropout_p, is_causal, training,
                                            generator=generator)
    s = query.shape[1]
    dev = query.device
    rows = torch.arange(s, device=dev)[:, None]
    keys = torch.arange(s, device=dev)[None, :]
    causal = torch.where(rows >= keys, 0.0, -1e9)
    start = attn_mask_start_row_indices[:, :, None, :].to(dev)
    sparse = torch.where(rows[None, None] < start, 0.0, -1e9)
    mask = torch.clamp_min(causal[None, None] + sparse, -1e9)
    return scaled_dot_product_attention(query, key, value, mask, dropout_p,
                                        False, training, generator=generator)


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
