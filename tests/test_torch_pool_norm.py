"""The port's pools and norms (paddle_tpu_torch/nn/functional/pooling.py
and norm.py's ``batch_norm``, ``instance_norm``, ``group_norm``,
``normalize``, ``local_response_norm``, the ``BatchNorm`` and
``GroupNorm`` modules) against the reference package's
(paddle_tpu/nn/functional/pooling.py, norm.py, nn/norm_layers.py), on
the CPU, from the same numpy inputs, one case per function and option
(``POOL_CASES``, ``NORM_CASES``): ``ceil_mode`` (ignored, as the
reference), ``exclusive``, ``return_mask``, every padding form, NHWC,
the adaptive pools' equal and unequal windows; ``batch_norm``'s running
statistics after 3 training calls (paddle's momentum, the unbiased
variance) and its eval mode; ``group_norm`` / ``instance_norm`` in fp32
and bf16.

Tolerances as ``tests/test_torch_conv.py``: fp32 outputs and gradients
within 5e-6 of their own max |value|; bf16 within 2 ** -7 of it (one
rounding of an fp32 result on each side). Running statistics: fp32
within 5e-6 of their max, bf16 within 2 ** -7.
"""
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional.norm import BatchNorm, GroupNorm
from test_torch_conv import BF16_TOL, TOL, _arrays, _close, run_case

#: (function, input shape, keyword arguments, check gradients)
POOL_CASES = {
    "max2d-resnet": ("max_pool2d", (2, 3, 12, 12),
                     dict(kernel_size=3, stride=2, padding=1), True),
    "max2d-mask": ("max_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding=1,
                        return_mask=True), False),
    "max2d-same": ("max_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding="SAME"), True),
    "max2d-same-mask": ("max_pool2d", (2, 3, 9, 8),
                        dict(kernel_size=2, stride=2, padding="SAME",
                             return_mask=True), False),
    "max2d-flat-asymmetric": ("max_pool2d", (2, 3, 9, 8),
                              dict(kernel_size=[3, 2], stride=[2, 1],
                                   padding=[0, 1, 1, 0]), True),
    "max2d-wide-padding-mask": ("max_pool2d", (1, 2, 7, 7),
                                dict(kernel_size=3, stride=1, padding=2,
                                     return_mask=True), False),
    "max2d-ceil-mode-ignored": ("max_pool2d", (2, 3, 10, 10),
                                dict(kernel_size=3, stride=2, ceil_mode=True),
                                True),
    "max2d-nhwc-mask": ("max_pool2d", (2, 8, 9, 3),
                        dict(kernel_size=2, stride=2, return_mask=True,
                             data_format="NHWC"), False),
    "max2d-valid": ("max_pool2d", (2, 3, 9, 9),
                    dict(kernel_size=2, padding="VALID"), True),
    "max1d": ("max_pool1d", (2, 3, 11),
              dict(kernel_size=3, stride=2, padding=1), True),
    "max1d-mask-nlc": ("max_pool1d", (2, 11, 3),
                       dict(kernel_size=3, stride=2, return_mask=True,
                            data_format="NLC"), False),
    "max3d": ("max_pool3d", (1, 2, 6, 7, 5),
              dict(kernel_size=3, stride=2, padding=1), True),
    "avg2d-exclusive": ("avg_pool2d", (2, 3, 9, 9),
                        dict(kernel_size=3, stride=2, padding=1), True),
    "avg2d-inclusive": ("avg_pool2d", (2, 3, 9, 9),
                        dict(kernel_size=3, stride=2, padding=1,
                             exclusive=False), True),
    "avg2d-same-exclusive": ("avg_pool2d", (2, 3, 9, 8),
                             dict(kernel_size=3, stride=2, padding="SAME"),
                             True),
    "avg2d-flat-asymmetric-inclusive": ("avg_pool2d", (2, 3, 9, 8),
                                        dict(kernel_size=3, stride=2,
                                             padding=[1, 0, 2, 1],
                                             exclusive=False), True),
    "avg2d-flat-asymmetric-exclusive": ("avg_pool2d", (2, 3, 9, 8),
                                        dict(kernel_size=3, stride=2,
                                             padding=[1, 0, 2, 1]), True),
    "avg2d-ceil-divisor-ignored": ("avg_pool2d", (2, 3, 10, 10),
                                   dict(kernel_size=3, stride=2,
                                        ceil_mode=True, divisor_override=2),
                                   False),
    "avg2d-nhwc": ("avg_pool2d", (2, 8, 8, 3),
                   dict(kernel_size=2, stride=2, padding=1,
                        data_format="NHWC"), True),
    "avg1d": ("avg_pool1d", (2, 3, 11),
              dict(kernel_size=4, stride=3, padding=[2, 1]), True),
    "avg1d-nlc": ("avg_pool1d", (2, 11, 3),
                  dict(kernel_size=3, padding=1, data_format="NLC"), False),
    "avg3d": ("avg_pool3d", (1, 2, 6, 7, 5),
              dict(kernel_size=2, stride=2, padding=1, exclusive=False),
              True),
    "adaptive-avg2d-global": ("adaptive_avg_pool2d", (2, 6, 7, 7),
                              dict(output_size=1), True),
    "adaptive-avg2d-equal-windows": ("adaptive_avg_pool2d", (2, 3, 8, 12),
                                     dict(output_size=[4, 3]), True),
    "adaptive-avg2d-unequal": ("adaptive_avg_pool2d", (2, 3, 7, 9),
                               dict(output_size=[3, 4]), True),
    "adaptive-avg2d-none": ("adaptive_avg_pool2d", (2, 3, 7, 9),
                            dict(output_size=[None, 4]), False),
    "adaptive-avg2d-nhwc": ("adaptive_avg_pool2d", (2, 7, 9, 3),
                            dict(output_size=[3, 3], data_format="NHWC"),
                            False),
    "adaptive-avg1d": ("adaptive_avg_pool1d", (2, 3, 10),
                       dict(output_size=4), True),
    "adaptive-avg3d": ("adaptive_avg_pool3d", (1, 2, 5, 6, 4),
                       dict(output_size=[2, 3, 1]), False),
    "adaptive-max2d": ("adaptive_max_pool2d", (2, 3, 7, 9),
                       dict(output_size=[3, 4]), True),
    "adaptive-max2d-equal-windows": ("adaptive_max_pool2d", (2, 3, 8, 8),
                                     dict(output_size=2), False),
    "adaptive-max1d": ("adaptive_max_pool1d", (2, 3, 10),
                       dict(output_size=3), False),
    "adaptive-max3d": ("adaptive_max_pool3d", (1, 2, 5, 6, 4),
                       dict(output_size=2), False),
}


def _seed(case):
    return zlib.crc32(case.encode()) % 1000


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_reference(case):
    fn, shape, kw, grad = POOL_CASES[case]
    run_case(fn, _arrays([shape], _seed(case)), kw, grad=grad)


@pytest.mark.parametrize("case", ["max2d-resnet", "avg2d-exclusive",
                                  "adaptive-avg2d-global"])
def test_pool_bf16_matches_reference(case):
    fn, shape, kw, _ = POOL_CASES[case]
    run_case(fn, _arrays([shape], _seed(case)), kw, dtype="bfloat16",
             grad=False)


#: (function, input shape, keyword arguments)
NORM_CASES = {
    "group_norm": ("group_norm", (2, 8, 5, 6), dict(num_groups=4)),
    "group_norm-nhwc": ("group_norm", (2, 5, 6, 8),
                        dict(num_groups=2, data_format="NHWC")),
    "group_norm-3d": ("group_norm", (2, 6, 7), dict(num_groups=3)),
    "instance_norm": ("instance_norm", (2, 4, 5, 6), dict()),
    "instance_norm-nhwc": ("instance_norm", (2, 5, 6, 4),
                           dict(data_format="NHWC")),
    "normalize": ("normalize", (3, 5, 4), dict()),
    "normalize-p1-last": ("normalize", (3, 5, 4), dict(p=1, axis=-1)),
    "local_response_norm": ("local_response_norm", (2, 7, 4, 5),
                            dict(size=5)),
    "local_response_norm-nhwc": ("local_response_norm", (2, 4, 5, 6),
                                 dict(size=3, alpha=0.01, beta=0.5, k=2.0,
                                      data_format="NHWC")),
}


def _affine(case, x_shape, kw):
    """The norm's ``weight`` and ``bias`` keyword arrays, where it has
    them."""
    fn = NORM_CASES[case][0]
    if fn not in ("group_norm", "instance_norm"):
        return {}
    c = x_shape[1] if kw.get("data_format", "NC").startswith("NC") \
        else x_shape[-1]
    w, b = _arrays([(c,), (c,)], _seed(case) + 1)
    return dict(weight=w + 1.0, bias=b)


def _run_norm(case, dtype):
    fn, shape, kw = NORM_CASES[case]
    (x,) = _arrays([shape], _seed(case))
    affine = _affine(case, shape, kw)
    grad = dtype == "float32"
    names = list(affine)
    arrays = [x] + [affine[n] for n in names]

    def bind(f):            # the affine goes in by keyword
        return lambda x, *wb, **k: f(x, **dict(zip(names, wb)), **k)

    run_case((bind(getattr(JF, fn)), bind(getattr(TF, fn))), arrays, kw,
             dtype=dtype, grad=grad)


@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_norm_matches_reference(case):
    _run_norm(case, "float32")


@pytest.mark.parametrize("case", ["group_norm", "group_norm-nhwc",
                                  "instance_norm", "instance_norm-nhwc"])
def test_norm_bf16_matches_reference(case):
    _run_norm(case, "bfloat16")


def _bf16(a, dtype):
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


@pytest.mark.parametrize("shape, fmt", [
    ((4, 3, 5, 6), "NCHW"), ((4, 5, 6, 3), "NHWC"), ((16, 3), "NCHW"),
    ((4, 3, 7), "NCL")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_running_statistics(shape, fmt, dtype):
    """Three training calls on new batches: each output and the running
    mean and variance after each call; then an eval call on the running
    statistics and a training call under ``use_global_stats``."""
    c = shape[1] if fmt.startswith("NC") else shape[-1]
    rng = np.random.default_rng(len(shape) * 10 + c)
    w = _bf16(rng.normal(size=c).astype(np.float32) + 1.0, dtype)
    b = _bf16(rng.normal(size=c).astype(np.float32), dtype)
    jm = paddle.to_tensor(_bf16(np.zeros(c, np.float32), dtype))
    jv = paddle.to_tensor(_bf16(np.ones(c, np.float32), dtype))
    td = getattr(torch, dtype)
    tm, tv = torch.zeros(c, dtype=td), torch.ones(c, dtype=td)
    jw, jb = paddle.to_tensor(w), paddle.to_tensor(b)
    tw = torch.from_numpy(np.asarray(w, np.float32)).to(td)
    tb = torch.from_numpy(np.asarray(b, np.float32)).to(td)
    tol = TOL if dtype == "float32" else BF16_TOL
    calls = [dict(training=True)] * 3 + [
        dict(training=False), dict(training=True, use_global_stats=True)]
    for i, kw in enumerate(calls):
        x = (rng.normal(size=shape) * (1 + i) + i).astype(np.float32)
        kw = dict(kw, momentum=0.9, epsilon=1e-5, data_format=fmt)
        jy = JF.batch_norm(paddle.to_tensor(_bf16(x, dtype)), jm, jv, jw, jb,
                           **kw)
        ty = TF.batch_norm(torch.from_numpy(x).to(td), tm, tv, tw, tb, **kw)
        _close(ty.float(), np.asarray(jy._value).astype(np.float32), tol,
               f"batch_norm output, call {i}")
        _close(tm.float(), np.asarray(jm._value).astype(np.float32), tol,
               f"running mean after call {i}")
        _close(tv.float(), np.asarray(jv._value).astype(np.float32), tol,
               f"running variance after call {i}")
        assert tm.dtype == td and tv.dtype == td


def test_batch_norm_gradients():
    x, w, b = _arrays([(4, 3, 5, 6), (3,), (3,)], 11)
    rm, rv = np.zeros(3, np.float32), np.ones(3, np.float32)

    def fn(pkg, t):
        return lambda x, w, b, **kw: pkg.batch_norm(
            x, t(rm.copy()), t(rv.copy()), w, b, **kw)

    run_case((fn(JF, paddle.to_tensor), fn(TF, torch.from_numpy)),
             [x, w + 1.0, b], dict(training=True))


def _bridge(tmod, jlayer):
    load_paddle_tpu_state(tmod, {k: np.asarray(v._value).astype(np.float32)
                                 for k, v in jlayer.state_dict().items()})


def test_batch_norm_module_matches_reference_layer():
    """``BatchNorm`` against the reference's ``BatchNorm2D``: the same
    names (``weight``, ``bias``, ``_mean``, ``_variance``), three
    training-mode forwards, then eval."""
    paddle.seed(2)
    jl = jnn.BatchNorm2D(4)
    tl = BatchNorm(4, device="cpu")
    assert set(dict(tl.named_parameters())) | set(dict(tl.named_buffers())) \
        == set(jl.state_dict())
    _bridge(tl, jl)
    rng = np.random.default_rng(4)
    for i in range(4):
        if i == 3:
            jl.eval()
            tl.eval()
        x = rng.normal(size=(3, 4, 5, 5)).astype(np.float32) * 2 + 1
        _close(tl(torch.from_numpy(x)).detach(),
               np.asarray(jl(paddle.to_tensor(x))._value), TOL, f"call {i}")
    for name, buf in tl.named_buffers():
        _close(buf, np.asarray(jl.state_dict()[name]._value), TOL, name)


def test_group_norm_module_matches_reference_layer():
    paddle.seed(5)
    jl = jnn.GroupNorm(4, 8)
    tl = GroupNorm(4, 8)
    _bridge(tl, jl)
    x = np.random.default_rng(6).normal(size=(2, 8, 4, 4)).astype(np.float32)
    _close(tl(torch.from_numpy(x)).detach(),
           np.asarray(jl(paddle.to_tensor(x))._value), TOL, "group_norm")
