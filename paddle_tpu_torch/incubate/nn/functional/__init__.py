"""``paddle.incubate.nn.functional``: the fused ops.

Counterpart of ``paddle_tpu/incubate/nn/functional/__init__.py``, with
its names, arguments and ``__all__``: the norms (``fused_rms_norm``,
``fused_layer_norm``), the linear ops (``fused_linear``,
``fused_matmul_bias``, ``fused_linear_activation``, ``fused_bias_act``,
``swiglu``), ``fused_dropout_add``, the transformer blocks
(``fused_feedforward``, ``fused_multi_head_attention``,
``fused_bias_dropout_residual_layer_norm``, ``fused_multi_transformer``),
rope (``_rope_tables``, ``fused_rotary_position_embedding``) and
``fused_ec_moe``. ``fused_linear_cross_entropy`` lives in
``fused_linear_ce.py`` and the serving attention ops
(``block_multihead_attention`` over the paged and varlen kernels,
``masked_multihead_attention``, ``blha_get_max_len``,
``variable_length_memory_efficient_attention``,
``fused_dot_product_attention``) in ``inference_attention.py``, as in
the reference.

The reference composes every op of this file in XLA, so here they are
plain torch around the port's functional ops, which reach the kernels:
``fused_rms_norm`` calls ``nn.functional.norm.rms_norm`` (the RMSNorm
kernels forward and backward on a CUDA tensor), and the attention of
``fused_multi_head_attention`` and ``fused_multi_transformer`` is
``nn.functional.scaled_dot_product_attention`` with the reference's
arguments, so its gate routes a head dim of 64 or 128 to the flash
kernels (a key-only ``[B|1, 1, 1, S]`` mask as their key bias) and
anything else to the plain composition. Weights keep paddle's ``[in,
out]`` layout; ``qkv_weight`` is ``[3, H, D, E]`` (``[E, 3HD]`` with
``transpose_qkv_wb``).

Dropout draws its masks from an explicit ``generator=`` (a
``torch.Generator`` on the input's device), as the port's ``dropout``
does; a training call with a rate above 0 and no generator raises. The
masks are the port's own stream, not ``jax.random``'s.

The reference's quirks are kept: ``fused_rms_norm`` ignores
``norm_bias`` and ``begin_norm_axis``; ``fused_multi_head_attention``
ignores ``cache_kv`` and ``ring_id``; ``fused_multi_transformer`` passes
one ``dropout_rate`` as the attention and the output dropout and
``ln_scales[i]`` as the pre-LN and the post-LN scale, and raises
``NotImplementedError`` on ``cache_kvs``, ``pre_caches``, ``time_step``
and ``trans_qkvw=False``.
"""
from __future__ import annotations

import torch

from ....nn.functional.activation import gelu, relu, silu
from ....nn.functional.attention import scaled_dot_product_attention
from ....nn.functional.common import dropout, linear
from ....nn.functional.norm import layer_norm, rms_norm
from ._rope_common import rotate_half
from .fused_linear_ce import fused_linear_cross_entropy
from .inference_attention import (blha_get_max_len,
                                  block_multihead_attention,
                                  fused_dot_product_attention,
                                  masked_multihead_attention,
                                  variable_length_memory_efficient_attention)

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_rotary_position_embedding", "fused_linear", "swiglu",
           "fused_bias_act", "fused_dropout_add", "fused_feedforward",
           "fused_multi_head_attention", "fused_matmul_bias",
           "fused_linear_activation", "masked_multihead_attention",
           "blha_get_max_len", "block_multihead_attention",
           "variable_length_memory_efficient_attention",
           "fused_dot_product_attention", "fused_ec_moe",
           "fused_linear_cross_entropy",
           "fused_bias_dropout_residual_layer_norm",
           "fused_multi_transformer"]


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
    qo, ko = _rotate_qk(q, k, cos_a, sin_a, position_ids,
                        use_neox_rotary_style)
    return qo, ko, v


def _rotate_qk(q, k, cos_a, sin_a, position_ids, use_neox):
    """q and k (or None), [B, S, H, D], rotated by the [rows, D] tables
    at ``position_ids`` (else at 0 .. S - 1)."""
    if position_ids is not None:
        pos = position_ids.long()
        cos_a = cos_a[pos][:, :, None, :]            # [B, S, 1, D]
        sin_a = sin_a[pos][:, :, None, :]
    else:
        cos_a = cos_a[None, :q.shape[1], None, :]
        sin_a = sin_a[None, :q.shape[1], None, :]
    qo = q * cos_a + rotate_half(q, use_neox) * sin_a
    if k is None:
        return qo, None
    return qo, k * cos_a + rotate_half(k, use_neox) * sin_a


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


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **kw):
    """``x (+ bias) (+ residual)``, then RMSNorm over the last dim through
    ``rms_norm`` (the kernels on a CUDA tensor). With ``residual``
    returns ``(out, residual_out)``, the sum before the norm. As in the
    reference, ``norm_bias``, ``begin_norm_axis`` and ``quant_scale``
    are ignored."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
        return rms_norm(x, norm_weight, epsilon), x
    return rms_norm(x, norm_weight, epsilon)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=1, bias=None, residual=None, **kw):
    """``x (+ bias) (+ residual)``, then LayerNorm over the dims from
    ``begin_norm_axis`` on (the last dim when it is negative); the weight
    and bias hold that many elements. With ``residual`` returns ``(out,
    residual_out)``."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    shape = tuple(x.shape[begin_norm_axis:] if begin_norm_axis >= 0
                  else x.shape[-1:])
    out = layer_norm(
        x, shape, None if norm_weight is None else norm_weight.reshape(shape),
        None if norm_bias is None else norm_bias.reshape(shape), epsilon)
    if residual is not None:
        return out, x
    return out


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``, or ``[out,
    in]`` with ``transpose_weight``."""
    return linear(x, weight.t() if transpose_weight else weight, bias)


def _t(x, flag):
    return x.transpose(-1, -2) if flag else x


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``op(x) @ op(y) + bias``, ``op`` transposing the last two dims where
    asked."""
    out = torch.matmul(_t(x, transpose_x), _t(y, transpose_y))
    return out if bias is None else out + bias


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation=None):
    """:func:`fused_matmul_bias`, then ``"gelu"`` (exact), ``"relu"`` or
    nothing (``None`` / ``"none"``)."""
    if activation is None:
        activation = "none"
    out = fused_matmul_bias(x, y, bias, trans_x, trans_y)
    if activation == "none":
        return out
    return {"gelu": gelu, "relu": relu}[activation](out)


def fused_bias_act(x, bias=None, act_method="gelu", **kw):
    """``act(x + bias)``: ``"gelu"`` (exact), ``"relu"``, ``"silu"``, or
    the gated ``"swiglu"`` / ``"geglu"`` over the two halves of the last
    dim."""
    if bias is not None:
        x = x + bias
    if act_method == "swiglu":
        return swiglu(x)
    if act_method == "geglu":
        a, b = torch.chunk(x, 2, dim=-1)
        return gelu(a) * b
    return {"gelu": gelu, "relu": relu, "silu": silu}[act_method](x)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None, generator=None):
    """``dropout(x) + y`` (the mask from ``generator``)."""
    return dropout(x, p, training=training, mode=mode,
                   generator=generator) + y


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      name=None, generator=None):
    """The FFN block: ``x + dropout2(linear2(dropout1(act(linear1(ln1(x))))))``
    with the LayerNorm before (``pre_layer_norm``, ``ln1``) or after the
    residual (``ln2``); ``activation`` is ``"relu"`` or ``"gelu"``."""
    residual = x
    d = x.shape[-1]
    if pre_layer_norm:
        x = layer_norm(x, [d], ln1_scale, ln1_bias, ln1_epsilon)
    h = linear(x, linear1_weight, linear1_bias)
    h = {"relu": relu, "gelu": gelu}[activation](h)
    h = dropout(h, dropout1_rate, training=training, generator=generator)
    h = linear(h, linear2_weight, linear2_bias)
    h = dropout(h, dropout2_rate, training=training, generator=generator)
    out = residual + h
    if not pre_layer_norm:
        out = layer_norm(out, [d], ln2_scale, ln2_bias, ln2_epsilon)
    return out


def _rope_neox(q, k, rotary_embs):
    """The rotation of ``fused_multi_transformer``'s rope layout:
    ``rotary_embs`` ``[2, B, S, 1, D]`` holds cos at 0 and sin at 1;
    neox style, in q's dtype."""
    hd = rotary_embs.shape[-1]
    cos = rotary_embs[0].reshape(rotary_embs.shape[1], -1, 1, hd)
    sin = rotary_embs[1].reshape(rotary_embs.shape[1], -1, 1, hd)
    return (q * cos + rotate_half(q, True) * sin,
            k * cos + rotate_half(k, True) * sin)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=None,
                               transpose_qkv_wb=False, rotary_embs=None,
                               name=None, generator=None):
    """The attention block on ``x`` ``[B, S, E]``: the pre-LN (or the
    post-LN after the residual), the packed q|k|v projection
    (``qkv_weight`` ``[3, H, D, E]`` with ``qkv_bias`` ``[3, H, D]``, or
    ``[E, 3HD]`` and ``[3HD]`` with ``transpose_qkv_wb`` and
    ``num_heads``), rope from ``rotary_embs``, then
    ``scaled_dot_product_attention(q, k, v, attn_mask,
    attn_dropout_rate, is_causal=False, training)``, the output
    projection ``linear_weight`` ``[HD, E]``, its dropout and the
    residual. ``cache_kv`` and ``ring_id`` are ignored, as in the
    reference."""
    residual = x
    b, s, d = x.shape
    if pre_layer_norm:
        x = layer_norm(x, [d], pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    if transpose_qkv_wb:
        nh = num_heads
        hd = d // nh
        qkv = linear(x, qkv_weight, qkv_bias)
    else:
        _, nh, hd, _ = qkv_weight.shape
        qkv = torch.nn.functional.linear(
            x, qkv_weight.reshape(3 * nh * hd, d),
            None if qkv_bias is None else qkv_bias.reshape(3 * nh * hd))
    q, k, v = qkv.reshape(b, s, 3, nh, hd).unbind(2)
    if rotary_embs is not None:
        q, k = _rope_neox(q, k, rotary_embs)
    out = scaled_dot_product_attention(q, k, v, attn_mask, attn_dropout_rate,
                                       False, training, generator=generator)
    out = linear(out.reshape(b, s, nh * hd), linear_weight, linear_bias)
    out = dropout(out, dropout_rate, training=training, mode=mode,
                  generator=generator)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = layer_norm(out, [d], ln_scale, ln_bias, ln_epsilon)
    return out


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None, generator=None):
    """``LayerNorm(residual + dropout(x + bias))``."""
    h = x if bias is None else x + bias
    h = residual + dropout(h, dropout_rate, training=training, mode=mode,
                           generator=generator)
    return layer_norm(h, [h.shape[-1]], ln_scale, ln_bias, ln_epsilon)


def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True,
        epsilon=1e-5, cache_kvs=None, pre_caches=None, rotary_embs=None,
        time_step=None, attn_mask=None, dropout_rate=0.0,
        rotary_emb_dims=0, activation="gelu", training=False,
        mode="upscale_in_train", trans_qkvw=True, ring_id=-1, name=None,
        generator=None):
    """A stack of decoder blocks from per-layer weight lists: each layer
    is :func:`fused_multi_head_attention` (``qkv_weights[i]`` ``[3, H, D,
    E]``; ``ln_scales[i]`` / ``ln_biases[i]`` as its pre-LN and post-LN,
    ``dropout_rate`` as its attention and output dropout), then the FFN
    (``ffn_ln_*`` LayerNorm, ``ffn1`` with :func:`fused_bias_act`,
    ``ffn2``) with its residual. Generation-time caches raise
    ``NotImplementedError``: cached decode is
    ``masked_multihead_attention`` / ``block_multihead_attention``."""
    for unsupported, argname in ((cache_kvs, "cache_kvs"),
                                 (pre_caches, "pre_caches"),
                                 (time_step, "time_step")):
        if unsupported is not None:
            raise NotImplementedError(
                f"fused_multi_transformer: generation-time {argname} is "
                "the caller's responsibility — use "
                "masked_multihead_attention / block_multihead_attention")
    if not trans_qkvw:
        raise NotImplementedError("only trans_qkvw=True layout is supported")
    out = x
    d = out.shape[-1]
    for i in range(len(qkv_weights)):
        attn_out = fused_multi_head_attention(
            out, qkv_weights[i], linear_weights[i],
            pre_layer_norm=pre_layer_norm,
            pre_ln_scale=ln_scales[i], pre_ln_bias=ln_biases[i],
            ln_scale=ln_scales[i], ln_bias=ln_biases[i],
            pre_ln_epsilon=epsilon,
            qkv_bias=qkv_biases[i] if qkv_biases else None,
            linear_bias=linear_biases[i] if linear_biases else None,
            attn_mask=attn_mask, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate, ln_epsilon=epsilon,
            training=training, num_heads=qkv_weights[i].shape[1],
            rotary_embs=rotary_embs, generator=generator)
        h = attn_out
        if pre_layer_norm:
            h = layer_norm(h, [d], ffn_ln_scales[i], ffn_ln_biases[i],
                           epsilon)
        h = fused_bias_act(linear(h, ffn1_weights[i]),
                           ffn1_biases[i] if ffn1_biases else None,
                           act_method=activation)
        h = linear(h, ffn2_weights[i], ffn2_biases[i] if ffn2_biases else None)
        out = attn_out + h
        if not pre_layer_norm:
            out = layer_norm(out, [d], ffn_ln_scales[i], ffn_ln_biases[i],
                             epsilon)
    return out
