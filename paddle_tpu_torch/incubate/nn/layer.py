"""The fused transformer layers, as ``torch.nn.Module``s.

Counterpart of ``paddle_tpu/incubate/nn/layer.py``: ``FusedLinear``,
``FusedDropoutAdd``, ``FusedEcMoe``, ``FusedBiasDropoutResidualLayerNorm``,
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer`` and ``FusedMultiTransformer``. Each
forward is the functional op of ``incubate/nn/functional`` on the
layer's parameters, so the layers reach the kernels those ops reach.

Parameters are raw ``nn.Parameter``s in the reference's layout and under
its state names, so ``convert.load_paddle_tpu_state`` carries them
across unchanged: ``qkv_weight`` ``[3, H, D, E]`` (``[E, 3HD]`` with
``transpose_qkv_wb``), ``linear_weight`` and the FFN weights ``[in,
out]``, ``FusedLinear.weight`` ``[in, out]`` (``[out, in]`` with
``transpose_weight``), ``FusedFeedForward``'s ``_linear1_weight`` and
friends, and ``FusedMultiTransformer``'s ``layer_{i}_p{j}`` (j 0-11: LN
scale and bias, qkv weight and bias, output weight and bias, FFN LN
scale and bias, ffn1 weight and bias, ffn2 weight and bias), whose list
views (``qkv_weights``, ...) read the same tensors.

Each layer is made on an explicit ``device`` (``None`` is the card and
raises without one; ``device="cpu"`` for the CPU) in ``dtype``, its
weights drawn from ``seed`` as the reference's defaults are
(Xavier-normal weights, zero biases, unit LayerNorm scales). Dropout
draws from the layer's ``generator`` (a ``torch.Generator`` on its
device, or None); a training forward with a rate above 0 and no
generator raises, as the port's ``dropout`` does. The ``*_attr``
arguments take ``None`` (and ``False`` where the reference reads it as
"no bias"); a ``ParamAttr`` raises ``NotImplementedError`` until the
port has the layer surface.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.generator import make_generator
from ...core.place import resolve_device
from . import functional as IF

__all__ = [
    "FusedLinear", "FusedDropoutAdd", "FusedEcMoe",
    "FusedBiasDropoutResidualLayerNorm", "FusedMultiHeadAttention",
    "FusedFeedForward", "FusedTransformerEncoderLayer",
    "FusedMultiTransformer",
]


def _check_attr(name, attr):
    """``None`` or ``False``: a ``False`` bias attribute makes no
    parameter where the reference reads it so, and is the default
    elsewhere, as the reference's ``create_parameter`` takes it.
    Anything else (a ``ParamAttr``, an initializer, a name) raises."""
    if attr is None or attr is False:
        return
    raise NotImplementedError(
        f"{name}={attr!r}: ParamAttr arguments wait for the port's layer "
        f"surface (ROADMAP.md queue A item 6); pass None or False")


def _require(ok, what):
    """Raise ``ValueError`` naming ``what`` unless ``ok`` (the reference
    asserts these)."""
    if not ok:
        raise ValueError(what)


def _fans(shape):
    """The reference's fan rule: ``[in, out]`` for 2-D, ``[out, in,
    *receptive]`` above."""
    if len(shape) < 2:
        f = math.prod(shape) if shape else 1
        return f, f
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class _FusedLayer(nn.Module):
    """Parameter making on one device and dtype from one seeded
    generator."""

    def __init__(self, device, dtype, seed, generator):
        super().__init__()
        self._factory = dict(device=resolve_device(device), dtype=dtype)
        self._init = make_generator(seed, self._factory["device"])
        self.generator = generator

    @torch.no_grad()
    def _param(self, name, shape, kind="weight"):
        """Register ``name``: a Xavier-normal ``"weight"``, a zero
        ``"bias"`` or a ``"ones"`` scale. Returns it."""
        shape = tuple(int(n) for n in shape)
        p = torch.empty(shape, **self._factory)
        if kind == "weight":
            fi, fo = _fans(shape)
            p.normal_(0.0, math.sqrt(2.0 / (fi + fo)), generator=self._init)
        else:
            p.fill_(1.0 if kind == "ones" else 0.0)
        self.register_parameter(name, nn.Parameter(p))
        return getattr(self, name)

    def _maybe(self, name, shape, attr, kind="bias"):
        """``_param`` unless ``attr`` is False (then the name holds
        None)."""
        if attr is False:
            self.register_parameter(name, None)
            return None
        return self._param(name, shape, kind)


class FusedLinear(_FusedLayer):
    """``x @ weight + bias``; ``weight`` ``[in, out]``, or ``[out, in]``
    with ``transpose_weight``; ``bias_attr=False``: no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__(device, dtype, seed, None)
        _check_attr("weight_attr", weight_attr)
        _check_attr("bias_attr", bias_attr)
        self._param("weight", [out_features, in_features] if transpose_weight
                    else [in_features, out_features])
        self._maybe("bias", [out_features], bias_attr)
        self.transpose_weight = transpose_weight

    def forward(self, input):
        return IF.fused_linear(input, self.weight, self.bias,
                               self.transpose_weight)


class FusedDropoutAdd(nn.Module):
    """``dropout(x) + y``, the mask from ``generator``."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.generator = generator

    def forward(self, x, y):
        return IF.fused_dropout_add(x, y, p=self.p, training=self.training,
                                    mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class FusedEcMoe(_FusedLayer):
    """The softmax-weighted sum of every expert's FFN
    (``functional.fused_ec_moe``) over stacked expert weights
    ``bmm_weight0`` ``[E, d, h]`` and ``bmm_weight1`` ``[E, h, d]``."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__(device, dtype, seed, None)
        if act_type not in ("gelu", "relu"):
            raise ValueError(f"unsupported act_type {act_type!r}")
        _check_attr("weight_attr", weight_attr)
        _check_attr("bias_attr", bias_attr)
        self.act_type = act_type
        self._param("bmm_weight0", [num_experts, hidden_size, inter_size])
        self._param("bmm_bias0", [num_experts, 1, inter_size], "bias")
        self._param("bmm_weight1", [num_experts, inter_size, hidden_size])
        self._param("bmm_bias1", [num_experts, 1, hidden_size], "bias")

    def forward(self, x, gate):
        return IF.fused_ec_moe(x, gate, self.bmm_weight0, self.bmm_bias0,
                               self.bmm_weight1, self.bmm_bias1,
                               self.act_type)


class FusedBiasDropoutResidualLayerNorm(_FusedLayer):
    """``LayerNorm(residual + dropout(x + linear_bias))``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None,
                 dtype=torch.float32, seed=0, generator=None):
        super().__init__(device, dtype, seed, generator)
        _require(embed_dim > 0, f"embed_dim must be > 0, got {embed_dim}")
        _check_attr("weight_attr", weight_attr)
        _check_attr("bias_attr", bias_attr)
        self.embed_dim = embed_dim
        self._dropout_rate = dropout_rate
        self._epsilon = epsilon
        self._param("linear_bias", [embed_dim], "bias")
        self._param("ln_scale", [embed_dim], "ones")
        self._param("ln_bias", [embed_dim], "bias")

    def forward(self, x, residual):
        return IF.fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            self._dropout_rate, self._epsilon, training=self.training,
            generator=self.generator)

    def extra_repr(self):
        return (f"embed_dim={self.embed_dim}, "
                f"dropout_rate={self._dropout_rate}, epsilon={self._epsilon}")


class FusedMultiHeadAttention(_FusedLayer):
    """The pre- or post-LN attention block
    (``functional.fused_multi_head_attention``) with the packed
    ``qkv_weight`` ``[3, H, D, E]`` (``[E, 3HD]`` with
    ``transpose_qkv_wb``)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, transpose_qkv_wb=False, name=None, *,
                 device=None, dtype=torch.float32, seed=0, generator=None):
        super().__init__(device, dtype, seed, generator)
        _require(embed_dim > 0 and num_heads > 0,
                 f"embed_dim and num_heads must be > 0, got {embed_dim}, "
                 f"{num_heads}")
        _require(need_weights is False, "Only need_weights=False is supported")
        for n, a in (("qkv_weight_attr", qkv_weight_attr),
                     ("qkv_bias_attr", qkv_bias_attr),
                     ("linear_weight_attr", linear_weight_attr),
                     ("linear_bias_attr", linear_bias_attr),
                     ("pre_ln_scale_attr", pre_ln_scale_attr),
                     ("pre_ln_bias_attr", pre_ln_bias_attr),
                     ("ln_scale_attr", ln_scale_attr),
                     ("ln_bias_attr", ln_bias_attr)):
            _check_attr(n, a)
        self.embed_dim = embed_dim
        self.head_dim = embed_dim // num_heads
        _require(self.head_dim * num_heads == embed_dim,
                 f"embed_dim {embed_dim} is not a multiple of num_heads "
                 f"{num_heads}")
        _require(num_heads % nranks == 0,
                 f"num_heads {num_heads} is not a multiple of nranks {nranks}")
        self.num_heads = num_heads // nranks
        self.normalize_before = normalize_before
        self._dropout_rate = dropout_rate
        self._attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        self.transpose_qkv_wb = transpose_qkv_wb
        hd = self.num_heads * self.head_dim
        if transpose_qkv_wb:
            qkv_w, qkv_b = [embed_dim, 3 * hd], [3 * hd]
        else:
            qkv_w = [3, self.num_heads, self.head_dim, embed_dim]
            qkv_b = [3, self.num_heads, self.head_dim]
        self._param("qkv_weight", qkv_w)
        self._maybe("qkv_bias", qkv_b, qkv_bias_attr)
        self._param("linear_weight", [hd, embed_dim])
        self._maybe("linear_bias", [embed_dim], linear_bias_attr)
        pre, post = ("pre_ln", "ln") if normalize_before else ("ln", "pre_ln")
        self._param(f"{pre}_scale", [embed_dim], "ones")
        self._maybe(f"{pre}_bias", [embed_dim],
                    pre_ln_bias_attr if normalize_before else ln_bias_attr)
        self.register_parameter(f"{post}_scale", None)
        self.register_parameter(f"{post}_bias", None)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return IF.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, cache_kv=cache,
            attn_mask=attn_mask, dropout_rate=self._dropout_rate,
            attn_dropout_rate=self._attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            num_heads=self.num_heads, transpose_qkv_wb=self.transpose_qkv_wb,
            generator=self.generator)

    def extra_repr(self):
        return (f"embed_dim={self.embed_dim}, num_heads={self.num_heads}, "
                f"normalize_before={self.normalize_before}")


class FusedFeedForward(_FusedLayer):
    """The pre- or post-LN FFN block (``functional.fused_feedforward``)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None, *, device=None,
                 dtype=torch.float32, seed=0, generator=None):
        super().__init__(device, dtype, seed, generator)
        _require(d_model > 0 and dim_feedforward > 0,
                 f"d_model and dim_feedforward must be > 0, got {d_model}, "
                 f"{dim_feedforward}")
        for n, a in (("linear1_weight_attr", linear1_weight_attr),
                     ("linear1_bias_attr", linear1_bias_attr),
                     ("linear2_weight_attr", linear2_weight_attr),
                     ("linear2_bias_attr", linear2_bias_attr),
                     ("ln1_scale_attr", ln1_scale_attr),
                     ("ln1_bias_attr", ln1_bias_attr),
                     ("ln2_scale_attr", ln2_scale_attr),
                     ("ln2_bias_attr", ln2_bias_attr)):
            _check_attr(n, a)
        _require(dim_feedforward % nranks == 0,
                 f"dim_feedforward {dim_feedforward} is not a multiple of "
                 f"nranks {nranks}")
        dim_feedforward //= nranks
        self._d_model = d_model
        self._dim_feedforward = dim_feedforward
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        self._act_method = activation
        self._normalize_before = normalize_before
        self._epsilon = epsilon
        self._param("_linear1_weight", [d_model, dim_feedforward])
        self._param("_linear1_bias", [dim_feedforward], "bias")
        self._param("_linear2_weight", [dim_feedforward, d_model])
        self._param("_linear2_bias", [d_model], "bias")
        used, unused = ("_ln1", "_ln2") if normalize_before else ("_ln2",
                                                                 "_ln1")
        self._param(f"{used}_scale", [d_model], "ones")
        self._param(f"{used}_bias", [d_model], "bias")
        self.register_parameter(f"{unused}_scale", None)
        self.register_parameter(f"{unused}_bias", None)

    def forward(self, src, cache=None):
        return IF.fused_feedforward(
            src, self._linear1_weight, self._linear2_weight,
            self._linear1_bias, self._linear2_bias, self._ln1_scale,
            self._ln1_bias, self._ln2_scale, self._ln2_bias,
            dropout1_rate=self._act_dropout_rate,
            dropout2_rate=self._dropout_rate,
            activation=self._act_method, ln1_epsilon=self._epsilon,
            ln2_epsilon=self._epsilon,
            pre_layer_norm=self._normalize_before, training=self.training,
            generator=self.generator)

    def extra_repr(self):
        return (f"d_model={self._d_model}, "
                f"dim_feedforward={self._dim_feedforward}, "
                f"activation={self._act_method}")


class FusedTransformerEncoderLayer(nn.Module):
    """``FusedMultiHeadAttention`` (``fused_attn``) then
    ``FusedFeedForward`` (``ffn``), sharing one ``generator``;
    ``weight_attr`` and ``bias_attr`` as the reference passes them."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=torch.float32, seed=0, generator=None):
        super().__init__()
        _require(d_model > 0 and nhead > 0 and dim_feedforward > 0,
                 f"d_model, nhead and dim_feedforward must be > 0, got "
                 f"{d_model}, {nhead}, {dim_feedforward}")
        _check_attr("weight_attr", weight_attr)
        _check_attr("bias_attr", bias_attr)
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        act_dropout_rate = (dropout_rate if act_dropout_rate is None
                            else act_dropout_rate)
        self.normalize_before = normalize_before
        factory = dict(device=device, dtype=dtype, generator=generator)
        # bias_attr=False drops the attention's biases only: the FFN's
        # create_parameter takes False as the default, as the reference's
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, qkv_bias_attr=bias_attr,
            linear_bias_attr=bias_attr, seed=seed, **factory)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, seed=seed + 1, **factory)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask, cache=cache))


#: the parameters of one ``FusedMultiTransformer`` layer, in the
#: reference's ``layer_{i}_p{j}`` order: (list view, kind)
_MT_PARAMS = (("ln_scales", "ones"), ("ln_biases", "bias"),
              ("qkv_weights", "weight"), ("qkv_biases", "bias"),
              ("linear_weights", "weight"), ("linear_biases", "bias"),
              ("ffn_ln_scales", "ones"), ("ffn_ln_biases", "bias"),
              ("ffn1_weights", "weight"), ("ffn1_biases", "bias"),
              ("ffn2_weights", "weight"), ("ffn2_biases", "bias"))


class FusedMultiTransformer(_FusedLayer):
    """A stack of ``num_layers`` decoder blocks
    (``functional.fused_multi_transformer``) with per-layer parameters
    ``layer_{i}_p{j}``; ``qkv_weights`` and the other list views read
    them. Generation-time caches raise ``NotImplementedError``: cached
    decode is ``functional.block_multihead_attention`` /
    ``masked_multihead_attention``."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None, epsilon=1e-5,
                 num_layers=-1, nranks=1, trans_qkvw=True, ring_id=-1,
                 name=None, *, device=None, dtype=torch.float32, seed=0,
                 generator=None):
        super().__init__(device, dtype, seed, generator)
        _require(embed_dim > 0 and num_heads > 0 and dim_feedforward > 0,
                 f"embed_dim, num_heads and dim_feedforward must be > 0, got "
                 f"{embed_dim}, {num_heads}, {dim_feedforward}")
        attrs = dict(ln_scale_attrs=ln_scale_attrs,
                     ln_bias_attrs=ln_bias_attrs,
                     qkv_weight_attrs=qkv_weight_attrs,
                     qkv_bias_attrs=qkv_bias_attrs,
                     linear_weight_attrs=linear_weight_attrs,
                     linear_bias_attrs=linear_bias_attrs,
                     ffn_ln_scale_attrs=ffn_ln_scale_attrs,
                     ffn_ln_bias_attrs=ffn_ln_bias_attrs,
                     ffn1_weight_attrs=ffn1_weight_attrs,
                     ffn1_bias_attrs=ffn1_bias_attrs,
                     ffn2_weight_attrs=ffn2_weight_attrs,
                     ffn2_bias_attrs=ffn2_bias_attrs)
        for n, a in attrs.items():
            for one in (a if isinstance(a, (list, tuple)) else [a]):
                _check_attr(n, one)
        if num_layers < 0:
            num_layers = (len(qkv_weight_attrs)
                          if isinstance(qkv_weight_attrs, (list, tuple))
                          else 1)
        if not trans_qkvw:
            raise NotImplementedError(
                "only trans_qkvw=True layout is supported")
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        _require(num_heads % nranks == 0,
                 f"num_heads {num_heads} is not a multiple of nranks {nranks}")
        self.num_heads = num_heads // nranks
        self.head_dim = embed_dim // num_heads
        self._dropout_rate = dropout_rate
        self._epsilon = epsilon
        self._act = activation
        self.normalize_before = normalize_before
        nh, hd, ff = self.num_heads, self.head_dim, dim_feedforward // nranks
        shapes = ([embed_dim], [embed_dim], [3, nh, hd, embed_dim],
                  [3, nh, hd], [nh * hd, embed_dim], [embed_dim],
                  [embed_dim], [embed_dim], [embed_dim, ff], [ff],
                  [ff, embed_dim], [embed_dim])
        for i in range(num_layers):
            for j, ((_, kind), shape) in enumerate(zip(_MT_PARAMS, shapes)):
                self._param(f"layer_{i}_p{j}", shape, kind)

    def _view(self, j):
        return [getattr(self, f"layer_{i}_p{j}")
                for i in range(self.num_layers)]

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None):
        for unsupported, argname in ((caches, "caches"),
                                     (pre_caches, "pre_caches"),
                                     (time_step, "time_step"),
                                     (seq_lens, "seq_lens")):
            if unsupported is not None:
                raise NotImplementedError(
                    f"FusedMultiTransformer: generation-time {argname} is "
                    "the caller's responsibility — use "
                    "functional.block_multihead_attention / "
                    "masked_multihead_attention for cached decode.")
        return IF.fused_multi_transformer(
            src, *(self._view(j) for j in range(len(_MT_PARAMS))),
            pre_layer_norm=self.normalize_before, epsilon=self._epsilon,
            rotary_embs=rotary_embs, attn_mask=attn_mask,
            dropout_rate=self._dropout_rate, activation=self._act,
            training=self.training, generator=self.generator)


for _j, (_view_name, _) in enumerate(_MT_PARAMS):
    setattr(FusedMultiTransformer, _view_name,
            property(lambda self, j=_j: self._view(j),
                     doc=f"layer_{{i}}_p{_j} of every layer"))
