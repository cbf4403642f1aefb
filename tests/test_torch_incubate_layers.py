"""The layers of ``paddle_tpu_torch.incubate.nn`` (and ``attn_bias`` and
``memory_efficient_attention``) against the reference package's, on the
CPU in fp32.

- ``LAYERS``: each class in each parameter layout; its state names and
  shapes equal the reference layer's ``state_dict()``, and after
  ``load_paddle_tpu_state`` of the reference's weights the forward (eval
  mode) is within 1e-5 of the output's largest magnitude and the input
  gradients of ``sum(out * w)`` within 1e-4 of each gradient's.
- A 2-layer ``FusedMultiTransformer``: forward and every parameter's
  gradient against the reference; its list views read its
  ``layer_{i}_p{j}`` parameters.
- ``attn_bias``: every descriptor's ``materialize`` equal to the
  reference's, ``split`` and ``from_tensor_list``; and
  ``memory_efficient_attention`` with no bias, a tensor bias, each
  descriptor and a custom ``scale``, forward and gradients.
- The refusals: a ``ParamAttr``, the generation-time arguments of
  ``FusedMultiTransformer``, ``trans_qkvw=False``, a training forward
  with dropout and no generator.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.incubate import nn as JNN
from paddle_tpu.incubate.nn import attn_bias as jab

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.incubate import nn as TNN
from paddle_tpu_torch.incubate.nn import attn_bias as tab

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
E, H, FF = 16, 2, 32


def _close(got, want, tol, what):
    scale = max(1e-30, float(np.abs(want).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


#: name -> (class name, constructor args, constructor kwargs, inputs)
LAYERS = {
    "linear": ("FusedLinear", (E, 24), {}, ("x",)),
    "linear-transposed-nobias": ("FusedLinear", (E, 24),
                                 dict(transpose_weight=True,
                                      bias_attr=False), ("x",)),
    "dropout_add": ("FusedDropoutAdd", (), dict(p=0.3), ("x", "x")),
    "ec_moe-gelu": ("FusedEcMoe", (E, FF, 4, "gelu"), {}, ("x", "gate")),
    "ec_moe-relu": ("FusedEcMoe", (E, FF, 4, "relu"), {}, ("x", "gate")),
    "bias_dropout_residual_ln": ("FusedBiasDropoutResidualLayerNorm", (E,),
                                 {}, ("x", "x")),
    "mha-post": ("FusedMultiHeadAttention", (E, H), {}, ("x",)),
    "mha-pre-transposed": ("FusedMultiHeadAttention", (E, H),
                           dict(normalize_before=True,
                                transpose_qkv_wb=True), ("x",)),
    "mha-pre-nobias": ("FusedMultiHeadAttention", (E, H),
                       dict(normalize_before=True, qkv_bias_attr=False,
                            linear_bias_attr=False, pre_ln_bias_attr=False),
                       ("x",)),
    "feedforward-post-relu": ("FusedFeedForward", (E, FF), {}, ("x",)),
    "feedforward-pre-gelu": ("FusedFeedForward", (E, FF),
                             dict(normalize_before=True, activation="gelu"),
                             ("x",)),
    "encoder-post": ("FusedTransformerEncoderLayer", (E, H, FF), {},
                     ("x",)),
    "encoder-pre-gelu-nobias": ("FusedTransformerEncoderLayer", (E, H, FF),
                                dict(normalize_before=True,
                                     activation="gelu", bias_attr=False),
                                ("x",)),
    "multi_transformer-pre": ("FusedMultiTransformer", (E, H, FF),
                              dict(num_layers=2), ("x",)),
    "multi_transformer-post-relu": ("FusedMultiTransformer", (E, H, FF),
                                    dict(num_layers=2,
                                         normalize_before=False,
                                         activation="relu"), ("x",)),
}

_SHAPES = {"x": (2, 6, E), "gate": (2, 6, 4)}


def _state(jm, seed):
    """The reference's state with its zero biases and unit scales
    perturbed, so a mixed-up name shows."""
    out = {}
    for i, (k, v) in enumerate(jm.state_dict().items()):
        a = np.asarray(v._value)
        out[k] = a + _rand(a.shape, seed + i, 0.05)
        v.set_value(out[k])
    return out


def _pair(case, seed=0):
    cls, args, kw, _ = LAYERS[case]
    paddle.seed(seed)
    jm = getattr(JNN, cls)(*args, **kw)
    where = {} if cls == "FusedDropoutAdd" else dict(device="cpu")
    tm = getattr(TNN, cls)(*args, **kw, **where)
    jm.eval()
    tm.eval()
    state = _state(jm, 100 + seed)
    load_paddle_tpu_state(tm, state)
    return jm, tm


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_state_names_and_shapes_match_reference(case):
    jm, tm = _pair(case)
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert list(got) == list(want)                  # and their order


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_forward_and_input_gradients_match_reference(case):
    jm, tm = _pair(case)
    xs = [_rand(_SHAPES[n], 7 + i) for i, n in enumerate(LAYERS[case][3])]
    jx = [paddle.to_tensor(x, stop_gradient=False) for x in xs]
    tx = [torch.from_numpy(x.copy()).requires_grad_() for x in xs]
    jout, tout = jm(*jx), tm(*tx)
    want = np.asarray(jout.numpy())
    _close(tout.detach().numpy(), want, FWD_TOL, f"{case} output")
    w = _rand(want.shape, 99)
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()
    for i, (j, t) in enumerate(zip(jx, tx)):
        _close(t.grad.numpy(), np.asarray(j.grad.numpy()), GRAD_TOL,
               f"{case} gradient of input {i}")


def test_multi_transformer_forward_and_backward():
    jm, tm = _pair("multi_transformer-pre", seed=3)
    x = _rand((2, 6, E), 5)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    mask = np.zeros((2, 1, 6, 6), np.float32)
    mask[..., 4:] = -1e9
    jout = jm(jx, attn_mask=paddle.to_tensor(mask))
    tout = tm(tx, attn_mask=torch.from_numpy(mask))
    want = np.asarray(jout.numpy())
    _close(tout.detach().numpy(), want, FWD_TOL, "output")
    w = _rand(want.shape, 6)
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()
    _close(tx.grad.numpy(), np.asarray(jx.grad.numpy()), GRAD_TOL, "dx")
    jp = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), np.asarray(jp[name].grad.numpy()), GRAD_TOL,
               f"grad {name}")
    assert tm.qkv_weights[1] is tm.layer_1_p2
    assert tm.ffn2_biases[0] is tm.layer_0_p11
    assert [len(getattr(tm, n)) for n in ("ln_scales", "ffn1_weights")] == [
        2, 2]


def test_multi_transformer_num_layers_from_attr_lists():
    m = TNN.FusedMultiTransformer(E, H, FF, qkv_weight_attrs=[None] * 3,
                                  device="cpu")
    assert m.num_layers == 3 and len(m.qkv_biases) == 3


def test_layers_default_init_on_the_cpu():
    m = TNN.FusedMultiHeadAttention(E, H, device="cpu", seed=1)
    assert torch.equal(m.ln_scale, torch.ones(E))
    assert torch.equal(m.qkv_bias, torch.zeros(3, H, E // H))
    std = float(m.linear_weight.detach().std())
    assert 0.5 * (2 / (2 * E)) ** 0.5 < std < 1.5 * (2 / (2 * E)) ** 0.5
    again = TNN.FusedMultiHeadAttention(E, H, device="cpu", seed=1)
    assert torch.equal(m.qkv_weight, again.qkv_weight)
    bf = TNN.FusedFeedForward(E, FF, device="cpu", dtype=torch.bfloat16)
    assert bf._linear1_weight.dtype == torch.bfloat16


def test_dropout_layers_draw_from_their_generator():
    x = torch.from_numpy(_rand((2, 6, E), 0))
    for make in (lambda g: TNN.FusedDropoutAdd(0.4, generator=g),
                 lambda g: TNN.FusedTransformerEncoderLayer(
                     E, H, FF, device="cpu", generator=g),
                 lambda g: TNN.FusedMultiTransformer(
                     E, H, FF, dropout_rate=0.2, num_layers=2, device="cpu",
                     generator=g)):
        args = (x, x) if isinstance(make(None), TNN.FusedDropoutAdd) else (x,)
        a = make(torch.Generator().manual_seed(1))(*args)
        b = make(torch.Generator().manual_seed(1))(*args)
        c = make(torch.Generator().manual_seed(2))(*args)
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="(?i)generator"):
            make(None)(*args)
        layer = make(None).eval()
        layer(*args)                         # inference draws nothing


@pytest.mark.parametrize("make", [
    lambda: TNN.FusedLinear(E, 8, weight_attr="w", device="cpu"),
    lambda: TNN.FusedMultiHeadAttention(E, H, qkv_weight_attr=object(),
                                        device="cpu"),
    lambda: TNN.FusedFeedForward(E, FF, ln2_scale_attr="s", device="cpu"),
    lambda: TNN.FusedMultiTransformer(E, H, FF, qkv_weight_attrs=["a"],
                                      device="cpu"),
    lambda: TNN.FusedMultiTransformer(E, H, FF, trans_qkvw=False,
                                      device="cpu")],
    ids=["linear-attr", "mha-attr", "ffn-attr", "mt-attr-list",
         "mt-trans_qkvw"])
def test_refusals_at_construction(make):
    with pytest.raises(NotImplementedError):
        make()


@pytest.mark.parametrize("arg", ["caches", "pre_caches", "time_step",
                                 "seq_lens"])
def test_multi_transformer_refuses_generation_arguments(arg):
    jm, tm = _pair("multi_transformer-pre")
    x = _rand((2, 6, E), 0)
    with pytest.raises(NotImplementedError, match=arg):
        jm(paddle.to_tensor(x), **{arg: [paddle.to_tensor(x)]})
    with pytest.raises(NotImplementedError, match=arg):
        tm(torch.from_numpy(x), **{arg: [torch.from_numpy(x)]})


# --- attn_bias and memory_efficient_attention -----------------------------

def _biases(pkg, bias):
    return {
        "lower": pkg.LowerTriangularMask(),
        "lower+bias": pkg.LowerTriangularMask().add_bias(bias),
        "block": pkg.BlockDiagonalMask.from_seqlens([2, 3, 1]),
        "block-kv": pkg.BlockDiagonalMask.from_seqlens([2, 3, 1], [1, 2, 3]),
        "block-causal": pkg.BlockDiagonalMask.from_seqlens(
            [2, 3, 1]).make_causal(),
        "block-causal-kv": pkg.BlockDiagonalCausalMask.from_seqlens(
            [3, 2, 1], [2, 2, 2]),
    }


@pytest.mark.parametrize("which", ["lower", "lower+bias", "block",
                                   "block-kv", "block-causal",
                                   "block-causal-kv"])
def test_attn_bias_materialize_matches_reference(which):
    bias = _rand((2, 2, 6, 6), 3)
    want = np.asarray(_biases(jab, paddle.to_tensor(bias))[which]
                      .materialize((2, 2, 6, 6)).numpy())
    got = _biases(tab, torch.from_numpy(bias))[which].materialize(
        (2, 2, 6, 6), device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    half = _biases(tab, torch.from_numpy(bias))[which].materialize(
        (2, 2, 6, 6), dtype="bfloat16", device="cpu")
    # a tensor bias is added after the cast, in both packages: bf16 + fp32
    assert half.dtype == (torch.float32 if which == "lower+bias"
                          else torch.bfloat16)


def test_seqlen_info_and_split():
    info = tab.SeqLenInfo.from_seqlens([2, 3, 1])
    assert info.seqstart_py == [0, 2, 5, 6] and info.max_seqlen == 3
    assert info.seqstart.tolist() == [0, 2, 5, 6]
    padded = tab.PaddedSeqLenInfo.from_seqlens_padded([2, 3], 4)
    assert list(padded.intervals()) == [(0, 2), (4, 7)]
    assert padded.seqlen.tolist() == [2, 3]
    with pytest.raises(NotImplementedError):
        tab.PaddedSeqLenInfo.from_seqlens([2])
    a = torch.from_numpy(_rand((2, 3, 4), 0))
    b = torch.from_numpy(_rand((1, 5, 4), 1))
    mask, cat = tab.BlockDiagonalMask.from_tensor_list([a, b])
    jmask, jcat = jab.BlockDiagonalMask.from_tensor_list(
        [paddle.to_tensor(a.numpy()), paddle.to_tensor(b.numpy())])
    np.testing.assert_array_equal(cat.numpy(), np.asarray(jcat.numpy()))
    assert mask.q_seqinfo.seqstart_py == jmask.q_seqinfo.seqstart_py
    parts = mask.split(cat)
    assert [tuple(p.shape) for p in parts] == [(2, 3, 4), (1, 5, 4)]
    assert torch.equal(parts[0], a) and torch.equal(parts[1], b)
    np.testing.assert_array_equal(
        mask.materialize((1, 1, 11, 11), device="cpu").numpy(),
        np.asarray(jmask.materialize((1, 1, 11, 11)).numpy()))


@pytest.mark.parametrize("which", [None, "tensor", "lower", "block",
                                   "block-causal", "scale", "d64"])
def test_memory_efficient_attention_matches_reference(which):
    d = 64 if which == "d64" else 8
    q, k, v = (_rand((2, 6, 2, d), s) for s in (0, 1, 2))
    tensor_bias = _rand((2, 2, 6, 6), 3)
    kw = dict(scale=0.2) if which == "scale" else {}
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v))
    if which == "tensor":
        jb, tb = paddle.to_tensor(tensor_bias), torch.from_numpy(tensor_bias)
    elif which in ("lower", "block", "block-causal"):
        jb = _biases(jab, paddle.to_tensor(tensor_bias))[which]
        tb = _biases(tab, torch.from_numpy(tensor_bias))[which]
    else:
        jb = tb = None
    jout = JNN.memory_efficient_attention(jq, jk, jv, jb, training=False,
                                          **kw)
    tout = TNN.memory_efficient_attention(tq, tk, tv, tb, training=False,
                                          **kw)
    want = np.asarray(jout.numpy())
    _close(tout.detach().numpy(), want, FWD_TOL, "output")
    w = _rand(want.shape, 9)
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()
    for n, j, t in (("q", jq, tq), ("k", jk, tk), ("v", jv, tv)):
        _close(t.grad.numpy(), np.asarray(j.grad.numpy()), GRAD_TOL,
               f"d{n}")


def test_materialize_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tab.LowerTriangularMask().materialize((1, 1, 4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TNN.FusedLinear(4, 4)


@pytest.mark.parametrize("make", [
    lambda: TNN.FusedMultiHeadAttention(E, 3, device="cpu"),
    lambda: TNN.FusedMultiHeadAttention(E, H, need_weights=True,
                                        device="cpu"),
    lambda: TNN.FusedFeedForward(E, 0, device="cpu"),
    lambda: TNN.FusedMultiTransformer(E, 3, FF, nranks=2, device="cpu"),
    lambda: tab.PaddedSeqLenInfo.from_seqlens_padded([2, 5], 4),
    lambda: tab.BlockDiagonalMask.from_seqlens([2, 3]).materialize(
        (1, 1, 5, 6), device="cpu")],
    ids=["heads", "need_weights", "ffn-width", "nranks", "padding",
         "materialize-shape"])
def test_bad_arguments_raise(make):
    """The reference asserts these; the port raises ``ValueError``."""
    with pytest.raises(ValueError):
        make()
