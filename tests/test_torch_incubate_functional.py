"""The fused ops of ``paddle_tpu_torch.incubate.nn.functional`` against the
reference package's, on the CPU in fp32, from the same numpy inputs.

``CASES`` holds one case per function and variant: the norms
(``fused_rms_norm`` with bias and residual, ``fused_layer_norm`` over
one and two trailing dims), the linear ops (transposes, no bias, each
activation of ``fused_linear_activation`` and ``fused_bias_act``, the
gated ones), ``fused_dropout_add`` where it draws nothing, and the
transformer blocks: ``fused_feedforward`` pre- and post-LN,
``fused_multi_head_attention`` over ``pre_layer_norm``,
``transpose_qkv_wb``, ``rotary_embs``, a key-only and a full mask, no
biases, no residual, and head dim 64 at S 16 (the port goes through
``flash_attention_fused``'s plain version there, the reference stays on
XLA), ``fused_bias_dropout_residual_layer_norm`` and
``fused_multi_transformer`` (2 layers, pre- and post-LN, rope, a mask).
Each output is held within 1e-5 of its largest magnitude, and the
gradient of ``sum(out * w)`` (a fixed random ``w``) for every float
input within 1e-4 of that gradient's largest magnitude.

Dropout cannot be held against ``jax.random``: its masks are held within
the port (one seed twice equal, ``p=1`` zeros, ``downscale_in_infer``,
the kept share), and a training call with a rate and no generator
raises. The reference's quirks are pinned: ``fused_rms_norm`` ignores
``norm_bias`` and ``begin_norm_axis``, ``fused_multi_head_attention``
ignores ``cache_kv`` and ``ring_id``, ``fused_multi_transformer`` takes
``ln_scales[i]`` as the post-LN scale and raises on the cache
arguments and ``trans_qkvw=False``.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF

from paddle_tpu_torch.incubate.nn import functional as TIF

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _close(got, want, tol, what):
    scale = max(1e-30, float(np.abs(want).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _key_mask(b, s, seed):
    """Additive key-only mask [B, 1, 1, S]: the last keys of each row
    masked out."""
    m = np.zeros((b, 1, 1, s), np.float32)
    for r, n in enumerate(np.random.default_rng(seed).integers(1, s // 2, b)):
        m[r, ..., s - n:] = -1e9
    return m


def _full_mask(b, h, s, seed):
    m = np.where(np.random.default_rng(seed).random((b, h, s, s)) < 0.3,
                 -1e9, 0.0).astype(np.float32)
    m[..., 0] = 0.0                           # every row sees a key
    return m


def _rotary(b, s, d):
    pos = np.arange(s, dtype=np.float32)[:, None]
    inv = 1.0 / 10000 ** (np.arange(0, d, 2, dtype=np.float32) / d)
    ang = np.concatenate([pos * inv, pos * inv], axis=-1)      # [S, D]
    rot = np.stack([np.cos(ang), np.sin(ang)])[:, None, :, None, :]
    return np.ascontiguousarray(np.broadcast_to(rot, (2, b, s, 1, d)))


def _mha_args(e, h, transpose, bias, seed, pre=True):
    d = e // h
    a = dict(qkv_weight=_rand([e, 3 * e] if transpose else [3, h, d, e],
                              seed, 0.2),
             linear_weight=_rand([e, e], seed + 1, 0.2),
             linear_bias=_rand([e], seed + 2, 0.1) if bias else None,
             qkv_bias=(_rand([3 * e] if transpose else [3, h, d], seed + 3,
                             0.1) if bias else None))
    ln = ("pre_ln_scale", "pre_ln_bias") if pre else ("ln_scale", "ln_bias")
    a[ln[0]] = 1.0 + _rand([e], seed + 4, 0.1)
    a[ln[1]] = _rand([e], seed + 5, 0.1)
    return a


def _mt_args(e, h, ff, layers, seed):
    d = e // h
    names = (("ln_scales", [e], 1.0), ("ln_biases", [e], 0.0),
             ("qkv_weights", [3, h, d, e], 0.0),
             ("qkv_biases", [3, h, d], 0.0),
             ("linear_weights", [e, e], 0.0), ("linear_biases", [e], 0.0),
             ("ffn_ln_scales", [e], 1.0), ("ffn_ln_biases", [e], 0.0),
             ("ffn1_weights", [e, ff], 0.0), ("ffn1_biases", [ff], 0.0),
             ("ffn2_weights", [ff, e], 0.0), ("ffn2_biases", [e], 0.0))
    return {n: [base + _rand(shape, seed + 13 * i + j, 0.15)
                for i in range(layers)]
            for j, (n, shape, base) in enumerate(names)}


B, S, E, H = 2, 6, 16, 2

CASES = {
    "rms_norm": ("fused_rms_norm", dict(x=_rand([B, S, E], 0),
                                         norm_weight=1 + _rand([E], 1, .1))),
    "rms_norm-bias-residual": ("fused_rms_norm", dict(
        x=_rand([B, S, E], 0), norm_weight=1 + _rand([E], 1, .1),
        bias=_rand([E], 2), residual=_rand([B, S, E], 3), epsilon=1e-5)),
    "rms_norm-residual": ("fused_rms_norm", dict(
        x=_rand([8, E], 0), norm_weight=1 + _rand([E], 1, .1),
        residual=_rand([8, E], 3))),
    "layer_norm-2d": ("fused_layer_norm", dict(
        x=_rand([8, E], 0), norm_weight=1 + _rand([E], 1, .1),
        norm_bias=_rand([E], 2))),
    "layer_norm-axis1-3d": ("fused_layer_norm", dict(
        x=_rand([B, S, E], 0), norm_weight=1 + _rand([S * E], 1, .1),
        norm_bias=_rand([S * E], 2))),
    "layer_norm-last-bias-residual": ("fused_layer_norm", dict(
        x=_rand([B, S, E], 0), norm_weight=1 + _rand([E], 1, .1),
        norm_bias=_rand([E], 2), begin_norm_axis=-1, bias=_rand([E], 4),
        residual=_rand([B, S, E], 5), epsilon=1e-6)),
    "linear": ("fused_linear", dict(x=_rand([B, S, E], 0),
                                    weight=_rand([E, 24], 1),
                                    bias=_rand([24], 2))),
    "linear-transpose-nobias": ("fused_linear", dict(
        x=_rand([B, S, E], 0), weight=_rand([24, E], 1),
        transpose_weight=True)),
    "matmul_bias": ("fused_matmul_bias", dict(x=_rand([B, S, E], 0),
                                              y=_rand([E, 24], 1),
                                              bias=_rand([24], 2))),
    "matmul_bias-tx-ty": ("fused_matmul_bias", dict(
        x=_rand([B, E, S], 0), y=_rand([24, E], 1), bias=_rand([24], 2),
        transpose_x=True, transpose_y=True)),
    "matmul_bias-nobias": ("fused_matmul_bias", dict(x=_rand([S, E], 0),
                                                     y=_rand([E, 24], 1))),
    "linear_activation-gelu": ("fused_linear_activation", dict(
        x=_rand([S, E], 0), y=_rand([E, 24], 1), bias=_rand([24], 2),
        activation="gelu")),
    "linear_activation-relu-ty": ("fused_linear_activation", dict(
        x=_rand([S, E], 0), y=_rand([24, E], 1), bias=_rand([24], 2),
        trans_y=True, activation="relu")),
    "linear_activation-none": ("fused_linear_activation", dict(
        x=_rand([S, E], 0), y=_rand([E, 24], 1), bias=_rand([24], 2))),
    **{f"bias_act-{act}": ("fused_bias_act", dict(
        x=_rand([B, S, 2 * E], 0), bias=_rand([2 * E], 1), act_method=act))
       for act in ("gelu", "relu", "silu", "swiglu", "geglu")},
    "bias_act-nobias": ("fused_bias_act", dict(x=_rand([B, S, E], 0))),
    "dropout_add-p0": ("fused_dropout_add", dict(
        x=_rand([B, S, E], 0), y=_rand([B, S, E], 1), p=0.0)),
    "dropout_add-infer": ("fused_dropout_add", dict(
        x=_rand([B, S, E], 0), y=_rand([B, S, E], 1), p=0.3,
        training=False)),
    "dropout_add-infer-downscale": ("fused_dropout_add", dict(
        x=_rand([B, S, E], 0), y=_rand([B, S, E], 1), p=0.3,
        training=False, mode="downscale_in_infer")),
    "dropout_add-p1": ("fused_dropout_add", dict(
        x=_rand([B, S, E], 0), y=_rand([B, S, E], 1), p=1.0)),
    **{f"feedforward-{'pre' if pre else 'post'}-{act}": (
        "fused_feedforward", dict(
            x=_rand([B, S, E], 0), linear1_weight=_rand([E, 32], 1, .3),
            linear2_weight=_rand([32, E], 2, .3),
            linear1_bias=_rand([32], 3, .1), linear2_bias=_rand([E], 4, .1),
            **({"ln1_scale": 1 + _rand([E], 5, .1),
                "ln1_bias": _rand([E], 6, .1)} if pre else
               {"ln2_scale": 1 + _rand([E], 5, .1),
                "ln2_bias": _rand([E], 6, .1)}),
            activation=act, pre_layer_norm=pre, training=False))
       for pre in (True, False) for act in ("relu", "gelu")},
    "feedforward-nobias-dropout0": ("fused_feedforward", dict(
        x=_rand([B, S, E], 0), linear1_weight=_rand([E, 32], 1, .3),
        linear2_weight=_rand([32, E], 2, .3), dropout1_rate=0.0,
        dropout2_rate=0.0)),
    **{f"mha-{'pre' if pre else 'post'}-{'t' if tr else 'packed'}"
       f"-{'bias' if bias else 'nobias'}": ("fused_multi_head_attention",
                                            dict(
        x=_rand([B, S, E], 0), **_mha_args(E, H, tr, bias, 10, pre),
        pre_layer_norm=pre, transpose_qkv_wb=tr, training=False,
        **({"num_heads": H} if tr else {})))
       for pre in (True, False) for tr in (False, True)
       for bias in (True, False)},
    "mha-rotary": ("fused_multi_head_attention", dict(
        x=_rand([B, S, E], 0), **_mha_args(E, H, False, True, 10),
        pre_layer_norm=True, rotary_embs=_rotary(B, S, E // H),
        training=False)),
    "mha-key-mask": ("fused_multi_head_attention", dict(
        x=_rand([B, S, E], 0), **_mha_args(E, H, False, True, 10),
        pre_layer_norm=True, attn_mask=_key_mask(B, S, 7), training=False)),
    "mha-full-mask-post": ("fused_multi_head_attention", dict(
        x=_rand([B, S, E], 0), **_mha_args(E, H, True, True, 10, False),
        transpose_qkv_wb=True, num_heads=H, attn_mask=_full_mask(B, H, S, 8),
        training=False)),
    "mha-no-residual-dropout0": ("fused_multi_head_attention", dict(
        x=_rand([B, S, E], 0), **_mha_args(E, H, False, True, 10),
        pre_layer_norm=True, add_residual=False, dropout_rate=0.0,
        attn_dropout_rate=0.0)),
    "mha-d64-s16": ("fused_multi_head_attention", dict(
        x=_rand([B, 16, 128], 0), **_mha_args(128, 2, False, True, 20),
        pre_layer_norm=True, training=False)),
    "mha-d64-s16-key-mask": ("fused_multi_head_attention", dict(
        x=_rand([B, 16, 128], 0), **_mha_args(128, 2, False, True, 20),
        pre_layer_norm=True, attn_mask=_key_mask(B, 16, 9),
        training=False)),
    "bias_dropout_residual_ln": ("fused_bias_dropout_residual_layer_norm",
                                 dict(x=_rand([B, S, E], 0),
                                      residual=_rand([B, S, E], 1),
                                      bias=_rand([E], 2),
                                      ln_scale=1 + _rand([E], 3, .1),
                                      ln_bias=_rand([E], 4, .1),
                                      training=False)),
    "bias_dropout_residual_ln-nobias-p0": (
        "fused_bias_dropout_residual_layer_norm",
        dict(x=_rand([B, S, E], 0), residual=_rand([B, S, E], 1),
             dropout_rate=0.0)),
    "multi_transformer-pre": ("fused_multi_transformer", dict(
        x=_rand([B, S, E], 0), **_mt_args(E, H, 32, 2, 30))),
    "multi_transformer-post-relu": ("fused_multi_transformer", dict(
        x=_rand([B, S, E], 0), **_mt_args(E, H, 32, 2, 30),
        pre_layer_norm=False, activation="relu")),
    "multi_transformer-rotary-mask": ("fused_multi_transformer", dict(
        x=_rand([B, S, E], 0), **_mt_args(E, H, 32, 2, 30),
        rotary_embs=_rotary(B, S, E // H), attn_mask=_full_mask(B, 1, S, 3))),
    "multi_transformer-d64-key-mask": ("fused_multi_transformer", dict(
        x=_rand([B, 16, 128], 0), **_mt_args(128, 2, 64, 2, 40),
        attn_mask=_key_mask(B, 16, 4))),
}

#: inputs that are masks or tables, not differentiated
_NO_GRAD = {"attn_mask", "rotary_embs"}


def _both(v, grad):
    """(reference tensor, port tensor) of a numpy array; lists map."""
    if isinstance(v, list):
        pairs = [_both(a, grad) for a in v]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    if not isinstance(v, np.ndarray):
        return v, v
    return (paddle.to_tensor(v, stop_gradient=not grad),
            torch.from_numpy(v.copy()).requires_grad_(grad))


def _leaves(name, j, t):
    if isinstance(j, list):
        for i, (a, b) in enumerate(zip(j, t)):
            yield from _leaves(f"{name}[{i}]", a, b)
    elif isinstance(t, torch.Tensor):
        yield name, j, t


def run_case(fn, kw, grads=True):
    jkw, tkw, leaves = {}, {}, []
    for k, v in kw.items():
        jkw[k], tkw[k] = _both(v, grads and k not in _NO_GRAD)
        if k not in _NO_GRAD:
            leaves += list(_leaves(k, jkw[k], tkw[k]))
    jout = getattr(JIF, fn)(**jkw)
    tout = getattr(TIF, fn)(**tkw)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    touts = tout if isinstance(tout, tuple) else (tout,)
    assert len(jouts) == len(touts)
    jsum = tsum = 0
    for i, (jo, to) in enumerate(zip(jouts, touts)):
        want = np.asarray(jo.numpy())
        assert tuple(to.shape) == want.shape, fn
        _close(to.detach().numpy(), want, FWD_TOL, f"{fn} output {i}")
        w = _rand(want.shape, 99 + i)
        jsum = jsum + (jo * paddle.to_tensor(w)).sum()
        tsum = tsum + (to * torch.from_numpy(w)).sum()
    if not grads:
        return
    jsum.backward()
    tsum.backward()
    for name, j, t in leaves:
        if t.grad is None and j.grad is None:
            continue
        _close(t.grad.numpy(), np.asarray(j.grad.numpy()), GRAD_TOL,
               f"{fn} gradient of {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_op_matches_reference(case):
    fn, kw = CASES[case]
    run_case(fn, kw)


def test_rms_norm_ignores_norm_bias_and_begin_norm_axis():
    x, w = torch.from_numpy(_rand([B, S, E], 0)), torch.ones(E)
    base = TIF.fused_rms_norm(x, w)
    assert torch.equal(TIF.fused_rms_norm(x, w, norm_bias=torch.ones(E),
                                          begin_norm_axis=1), base)
    run_case("fused_rms_norm", dict(x=_rand([B, S, E], 0),
                                    norm_weight=_rand([E], 1),
                                    norm_bias=_rand([E], 2),
                                    begin_norm_axis=1))


def test_mha_ignores_cache_kv_and_ring_id():
    kw = dict(CASES["mha-pre-packed-bias"][1])
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in kw.items()}
    base = TIF.fused_multi_head_attention(**t)
    other = TIF.fused_multi_head_attention(
        **t, cache_kv=torch.ones(2, B, H, S, E // H), ring_id=3)
    assert torch.equal(base, other)


def test_multi_transformer_post_ln_takes_ln_scales():
    """Post-LN: the attention block's LayerNorm is ``ln_scales[i]`` /
    ``ln_biases[i]`` (the pre-LN slots), as the reference passes them."""
    kw = dict(CASES["multi_transformer-post-relu"][1])
    t = {k: ([torch.from_numpy(a) for a in v] if isinstance(v, list) else
             torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in kw.items()}
    base = TIF.fused_multi_transformer(**t)
    t["ln_scales"] = [s * 2.0 for s in t["ln_scales"]]
    assert not torch.allclose(TIF.fused_multi_transformer(**t), base)


@pytest.mark.parametrize("arg", ["cache_kvs", "pre_caches", "time_step",
                                 "trans_qkvw"])
def test_multi_transformer_refusals(arg):
    kw = dict(CASES["multi_transformer-pre"][1])
    t = {k: ([torch.from_numpy(a) for a in v] if isinstance(v, list) else
             torch.from_numpy(v)) for k, v in kw.items()}
    j = {k: ([paddle.to_tensor(a) for a in v] if isinstance(v, list) else
             paddle.to_tensor(v)) for k, v in kw.items()}
    extra = {"trans_qkvw": False} if arg == "trans_qkvw" else {
        arg: torch.zeros(1)}
    jextra = {"trans_qkvw": False} if arg == "trans_qkvw" else {
        arg: paddle.to_tensor(np.zeros(1, np.float32))}
    with pytest.raises(NotImplementedError):
        JIF.fused_multi_transformer(**j, **jextra)
    with pytest.raises(NotImplementedError):
        TIF.fused_multi_transformer(**t, **extra)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("fn", ["fused_dropout_add", "fused_feedforward",
                                "fused_multi_head_attention",
                                "fused_bias_dropout_residual_layer_norm"])
def test_dropout_draws_from_the_generator(fn):
    """One seed twice gives the same output, another seed another one,
    and a training call with a rate and no generator raises."""
    kw = {"fused_dropout_add": CASES["dropout_add-p0"][1],
          "fused_feedforward": CASES["feedforward-pre-gelu"][1],
          "fused_multi_head_attention": CASES["mha-pre-packed-bias"][1],
          "fused_bias_dropout_residual_layer_norm":
              CASES["bias_dropout_residual_ln"][1]}[fn]
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in kw.items()}
    t["training"] = True
    rate = {"fused_dropout_add": dict(p=0.4),
            "fused_feedforward": dict(dropout1_rate=0.4, dropout2_rate=0.4),
            "fused_multi_head_attention": dict(dropout_rate=0.4,
                                               attn_dropout_rate=0.4),
            "fused_bias_dropout_residual_layer_norm": dict(
                dropout_rate=0.4)}[fn]
    t.update(rate)
    f = getattr(TIF, fn)
    a, b, c = (f(**t, generator=_gen(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="(?i)generator"):
        f(**t)


def test_dropout_add_masks():
    x = torch.from_numpy(_rand([64, 256], 0))
    y = torch.from_numpy(_rand([64, 256], 1))
    p = 0.3
    out = TIF.fused_dropout_add(x, y, p=p, generator=_gen(5))
    kept = (out - y) != 0
    share = float(kept.float().mean())
    sd = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(share - (1 - p)) < 4 * sd
    torch.testing.assert_close((out - y)[kept], (x / (1 - p))[kept],
                               rtol=1e-6, atol=1e-6)
    down = TIF.fused_dropout_add(x, y, p=p, mode="downscale_in_infer",
                                 generator=_gen(5))
    kept_d = (down - y) != 0
    assert torch.equal(kept_d, kept)        # one seed: one mask
    torch.testing.assert_close((down - y)[kept], x[kept], rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(TIF.fused_dropout_add(x, y, p=1.0), y + 0 * x)


def test_head_dim_64_runs_the_flash_entry_point(monkeypatch):
    """At D 64 the port's gate takes ``flash_attention_fused`` (its plain
    version on a CPU tensor), the key-only mask as its key bias; at D 8
    the plain composition."""
    from paddle_tpu_torch.nn.functional import attention as ta

    seen = []
    real = ta.flash_attention_fused

    def spy(*a, **k):
        seen.append(k.get("key_bias") is not None)
        return real(*a, **k)

    monkeypatch.setattr(ta, "flash_attention_fused", spy)
    for case, want in (("mha-d64-s16", [False]),
                       ("mha-d64-s16-key-mask", [True]),
                       ("multi_transformer-d64-key-mask", [True, True]),
                       ("mha-key-mask", [])):
        seen.clear()
        run_case(*CASES[case], grads=False)
        assert seen == want, case
