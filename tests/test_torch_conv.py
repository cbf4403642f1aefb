"""The port's convolutions and spatial resampling
(paddle_tpu_torch/nn/functional/conv.py and common.py's ``interpolate``,
``pixel_shuffle``, ``pixel_unshuffle``, ``channel_shuffle``, ``unfold``,
``fold``, ``zeropad2d``) against the reference package's
(paddle_tpu/nn/functional/conv.py, common.py), on the CPU, from the same
numpy inputs, one case per function and option (``CONV_CASES``,
``RESAMPLE_CASES``): every padding form, NHWC, groups, dilation, the
transposes' ``output_padding`` (zeros appended, as the reference) and
``output_size`` (ignored, as the reference), every ``interpolate`` mode
with and without ``align_corners``.

Tolerances, fp32: every output within 5e-6 of its own max |value| and
every input gradient within 5e-6 of its own max |g| (sums of up to a few
hundred products in another order). bf16 forward: within 2 ** -7 of the
output's max |value| (one bf16 rounding of a sum taken in fp32 on both
sides may land one ulp apart).
"""
import contextlib
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import conv as conv_mod
from paddle_tpu_torch.nn.functional.conv import Conv2d

TOL = 5e-6
BF16_TOL = 2.0 ** -7


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def run_case(fn, arrays, kw, dtype="float32", grad=True, seed=0):
    """``fn`` of both packages (a name in both ``nn.functional``s, or a
    (reference, port) pair of callables) on the same inputs (None passes
    through): the outputs compared, then with ``grad`` the gradients of
    every input under a random cotangent."""
    jfn, tfn = ((getattr(JF, fn), getattr(TF, fn)) if isinstance(fn, str)
                else fn)
    jin = [None if a is None else paddle.to_tensor(
        a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a,
        stop_gradient=not grad) for a in arrays]
    tin = [None if a is None else torch.from_numpy(a).to(
        getattr(torch, dtype)).requires_grad_(grad) for a in arrays]
    jout = jfn(*jin, **kw)
    tout = tfn(*tin, **kw)
    tol = TOL if dtype == "float32" else BF16_TOL
    if isinstance(jout, (tuple, list)):
        for j, t in zip(jout, tout):
            _close(t.detach().float(), np.asarray(j._value).astype(np.float32),
                   tol, f"{fn} output")
            assert str(np.asarray(j._value).dtype) == str(t.dtype).split(".")[1]
        return
    want = np.asarray(jout._value).astype(np.float32)
    _close(tout.detach().float(), want, tol, f"{fn} output")
    if not grad:
        return
    g = np.random.default_rng(seed + 7).normal(size=want.shape).astype(
        np.float32)
    (jout * paddle.to_tensor(g)).sum().backward()
    (tout * torch.from_numpy(g)).sum().backward()
    for i, (j, t) in enumerate(zip(jin, tin)):
        if j is not None:
            _close(t.grad, np.asarray(j.grad._value), tol, f"{fn} grad {i}")


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [None if s is None else rng.normal(size=s).astype(np.float32)
            for s in shapes]


#: (function, shapes of x / weight / bias, keyword arguments)
CONV_CASES = {
    "2d-int-padding": ("conv2d", [(2, 4, 9, 9), (6, 4, 3, 3), (6,)],
                       dict(padding=1)),
    "2d-per-dim-padding": ("conv2d", [(2, 4, 9, 8), (6, 4, 3, 5), (6,)],
                           dict(padding=[1, 2], stride=2)),
    "2d-flat-asymmetric": ("conv2d", [(2, 4, 9, 8), (6, 4, 3, 3), None],
                           dict(padding=[0, 1, 2, 1])),
    "2d-pairs": ("conv2d", [(2, 4, 8, 8), (6, 4, 3, 3), (6,)],
                 dict(padding=[[2, 1], [1, 0]])),
    "2d-same-even-kernel-stride-dilation": ("conv2d", [(2, 4, 11, 10),
                                                       (6, 4, 4, 2), (6,)],
                                            dict(padding="SAME", stride=2,
                                                 dilation=2)),
    "2d-same-lowercase": ("conv2d", [(1, 3, 7, 7), (5, 3, 3, 3), None],
                          dict(padding="same", stride=2)),
    "2d-valid": ("conv2d", [(2, 4, 9, 9), (6, 4, 3, 3), (6,)],
                 dict(padding="VALID", stride=3)),
    "2d-nhwc-groups": ("conv2d", [(2, 9, 8, 4), (6, 2, 3, 3), (6,)],
                       dict(padding=[[1, 1], [2, 0]], groups=2,
                            data_format="NHWC")),
    "2d-depthwise": ("conv2d", [(2, 6, 9, 9), (6, 1, 3, 3), (6,)],
                     dict(padding=1, groups=6)),
    "2d-dilation-stride": ("conv2d", [(2, 4, 12, 12), (6, 4, 3, 3), (6,)],
                           dict(padding=2, dilation=2, stride=2)),
    "2d-resnet-stem": ("conv2d", [(1, 3, 32, 32), (8, 3, 7, 7), None],
                       dict(padding=3, stride=2)),
    "1d-asymmetric-nlc": ("conv1d", [(2, 11, 4), (6, 4, 3), (6,)],
                          dict(padding=[1, 2], data_format="NLC")),
    "1d-same": ("conv1d", [(2, 4, 11), (6, 4, 4), (6,)],
                dict(padding="SAME", stride=2)),
    "3d-same": ("conv3d", [(1, 2, 5, 6, 7), (4, 2, 3, 2, 3), (4,)],
                dict(padding="SAME", stride=2)),
    "3d-ndhwc-pairs-with-batch-channel": (
        "conv3d", [(1, 5, 6, 7, 2), (4, 2, 3, 3, 3), (4,)],
        dict(padding=[[0, 0], [1, 0], [1, 1], [0, 2], [0, 0]],
             data_format="NDHWC")),
    "1d-pairs-with-batch-channel": ("conv1d", [(2, 4, 9), (6, 4, 3), (6,)],
                                    dict(padding=[[0, 0], [0, 0], [2, 1]])),
    "2dT-output-padding": ("conv2d_transpose", [(2, 4, 5, 5), (4, 6, 3, 3),
                                                (6,)],
                           dict(stride=2, padding=1, output_padding=1)),
    "2dT-output-size-ignored": ("conv2d_transpose", [(2, 4, 5, 5),
                                                     (4, 6, 3, 3), (6,)],
                                dict(stride=2, padding=1,
                                     output_size=[10, 10])),
    "2dT-same": ("conv2d_transpose", [(2, 4, 5, 6), (4, 6, 3, 3), (6,)],
                 dict(stride=2, padding="SAME")),
    "2dT-same-wide-kernel": ("conv2d_transpose", [(2, 4, 5, 6),
                                                  (4, 6, 5, 4), None],
                             dict(stride=2, padding="SAME")),
    "2dT-valid-stride-over-kernel": ("conv2d_transpose", [(2, 4, 4, 5),
                                                          (4, 6, 2, 2),
                                                          (6,)],
                                     dict(stride=3, padding="VALID")),
    "2dT-groups-dilation-asymmetric": ("conv2d_transpose", [(2, 4, 5, 5),
                                                            (4, 3, 3, 3),
                                                            (6,)],
                                       dict(stride=2, padding=[1, 0, 0, 2],
                                            groups=2, dilation=2)),
    "2dT-nhwc": ("conv2d_transpose", [(2, 5, 5, 4), (4, 6, 3, 3), (6,)],
                 dict(stride=2, padding=1, output_padding=[1, 0],
                      data_format="NHWC")),
    "1dT": ("conv1d_transpose", [(2, 4, 7), (4, 3, 4), (3,)],
            dict(stride=2, padding=1)),
    "3dT": ("conv3d_transpose", [(1, 2, 3, 4, 3), (2, 3, 3, 3, 2), (3,)],
            dict(stride=2, padding=[1, 1, 0], output_padding=1)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_reference(case):
    fn, shapes, kw = CONV_CASES[case]
    run_case(fn, _arrays(shapes, zlib.crc32(case.encode()) % 1000), kw)


def test_conv2d_batch_channel_pairs_raise_as_the_reference():
    """In 2-D the four pairs of the batch-and-channel form are as many
    entries as the flat ``[lo0, hi0, lo1, hi1]`` form, which the
    reference's ``_pad_spec`` reads first: both packages raise."""
    x, w = _arrays([(1, 2, 5, 5), (3, 2, 3, 3)], 1)
    pad = [[0, 0], [0, 0], [1, 1], [1, 1]]
    with pytest.raises(TypeError):
        JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), padding=pad)
    with pytest.raises(TypeError):
        TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=pad)


@pytest.mark.parametrize("case", ["2d-int-padding", "2d-nhwc-groups",
                                  "2dT-output-padding", "2d-resnet-stem"])
def test_conv_bf16_forward_matches_reference(case):
    fn, shapes, kw = CONV_CASES[case]
    run_case(fn, _arrays(shapes, 5), kw, dtype="bfloat16", grad=False)


def test_conv_module_runs_deterministic_cudnn(monkeypatch):
    """``Conv2d`` is ``conv2d`` on the module's weights, forward and
    backward; both run with cuDNN's deterministic setting on, and the
    setting it had comes back after."""
    seen = []
    real = conv_mod._deterministic_cudnn

    @contextlib.contextmanager
    def spy():
        with real():
            seen.append(torch.backends.cudnn.deterministic)
            yield

    monkeypatch.setattr(conv_mod, "_deterministic_cudnn", spy)
    before = torch.backends.cudnn.deterministic
    torch.manual_seed(0)
    m = Conv2d(4, 6, 3, stride=2, padding=1)
    x = torch.randn(2, 4, 9, 9, requires_grad=True)
    y = m(x)
    y.backward(torch.ones_like(y))
    assert seen == [True, True]
    assert torch.backends.cudnn.deterministic == before
    xr = x.detach().requires_grad_()
    want = torch.nn.functional.conv2d(xr, m.weight, m.bias, 2, 1)
    want.backward(torch.ones_like(want))
    torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(x.grad, xr.grad, rtol=0, atol=1e-6)


#: (function, input shape, keyword arguments, check gradients)
RESAMPLE_CASES = {
    "nearest-2x": ("interpolate", (2, 3, 5, 4),
                   dict(scale_factor=2.0, mode="nearest"), True),
    "nearest-up-ragged": ("interpolate", (2, 3, 7, 5),
                          dict(size=[10, 8], mode="nearest"), True),
    "nearest-down": ("interpolate", (2, 3, 10, 9),
                     dict(size=[7, 4], mode="nearest"), False),
    "nearest-align-corners-ignored": ("interpolate", (1, 2, 5, 5),
                                      dict(size=[8, 8], mode="nearest",
                                           align_corners=True), False),
    "nearest-nhwc": ("interpolate", (2, 5, 4, 3),
                     dict(scale_factor=[2, 3], mode="nearest",
                          data_format="NHWC"), False),
    "nearest-1d": ("interpolate", (2, 3, 6), dict(size=[9], mode="nearest"),
                   False),
    "nearest-3d": ("interpolate", (1, 2, 3, 4, 5),
                   dict(scale_factor=2, mode="nearest"), False),
    "bilinear-2x": ("interpolate", (2, 3, 5, 4),
                    dict(scale_factor=2.0, mode="bilinear"), True),
    "bilinear-ragged": ("interpolate", (2, 3, 5, 7),
                        dict(size=[8, 9], mode="bilinear"), False),
    "bilinear-down-antialiased": ("interpolate", (2, 3, 9, 11),
                                  dict(size=[4, 5], mode="bilinear"), True),
    "bilinear-align-corners": ("interpolate", (2, 3, 5, 4),
                               dict(size=[9, 7], mode="bilinear",
                                    align_corners=True), True),
    "bilinear-align-corners-down": ("interpolate", (1, 2, 9, 8),
                                    dict(size=[4, 1], mode="bilinear",
                                         align_corners=True), False),
    "bicubic-up": ("interpolate", (2, 3, 5, 6),
                   dict(size=[11, 9], mode="bicubic"), True),
    "bicubic-down": ("interpolate", (1, 2, 12, 10),
                     dict(size=[5, 7], mode="bicubic"), False),
    "bicubic-align-corners": ("interpolate", (1, 2, 5, 6),
                              dict(size=[9, 11], mode="bicubic",
                                   align_corners=True), False),
    "linear-1d": ("interpolate", (2, 3, 7), dict(size=[12], mode="linear"),
                  False),
    "trilinear": ("interpolate", (1, 2, 3, 4, 5),
                  dict(size=[5, 6, 4], mode="trilinear"), False),
    "area": ("interpolate", (1, 2, 6, 6), dict(size=[4, 9], mode="area"),
             False),
    "upsample-bilinear-nhwc": ("upsample", (2, 4, 5, 3),
                               dict(scale_factor=2, mode="bilinear",
                                    data_format="NHWC"), False),
    "pixel_shuffle": ("pixel_shuffle", (2, 8, 3, 4),
                      dict(upscale_factor=2), True),
    "pixel_shuffle-nhwc": ("pixel_shuffle", (2, 3, 4, 9),
                           dict(upscale_factor=3, data_format="NHWC"),
                           False),
    "pixel_unshuffle": ("pixel_unshuffle", (2, 2, 6, 4),
                        dict(downscale_factor=2), True),
    "pixel_unshuffle-nhwc": ("pixel_unshuffle", (2, 6, 4, 2),
                             dict(downscale_factor=2, data_format="NHWC"),
                             False),
    "channel_shuffle": ("channel_shuffle", (2, 6, 3, 3), dict(groups=3),
                        True),
    "channel_shuffle-nhwc": ("channel_shuffle", (2, 3, 3, 6),
                             dict(groups=2, data_format="NHWC"), False),
    "unfold": ("unfold", (2, 3, 7, 6),
               dict(kernel_sizes=[3, 2], strides=[2, 1], paddings=1,
                    dilations=[1, 2]), True),
    "fold": ("fold", (2, 12, 15),
             dict(output_sizes=[5, 6], kernel_sizes=2, strides=[2, 1],
                  paddings=[1, 0]), True),
    "zeropad2d": ("zeropad2d", (2, 3, 4, 5), dict(padding=[1, 2, 0, 3]),
                  True),
    "zeropad2d-nhwc": ("zeropad2d", (2, 4, 5, 3),
                       dict(padding=[2, 0, 1, 1], data_format="NHWC"),
                       False),
}


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_matches_reference(case):
    fn, shape, kw, grad = RESAMPLE_CASES[case]
    run_case(fn, _arrays([shape], zlib.crc32(case.encode()) % 1000), kw, grad=grad)


@pytest.mark.parametrize("case", ["nearest-2x", "nearest-up-ragged"])
def test_nearest_bf16_is_exact(case):
    fn, shape, kw, _ = RESAMPLE_CASES[case]
    (x,) = _arrays([shape], 3)
    jout = getattr(JF, fn)(paddle.to_tensor(x.astype(ml_dtypes.bfloat16)),
                           **kw)
    tout = getattr(TF, fn)(torch.from_numpy(x).to(torch.bfloat16), **kw)
    np.testing.assert_array_equal(
        tout.float().numpy(), np.asarray(jout._value).astype(np.float32))
