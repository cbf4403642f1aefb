"""The port's RMSNorm forward (paddle_tpu_torch/ops/cuda/rms_norm.py and
nn/functional/norm.py) against the reference package's Pallas kernel
(paddle_tpu/ops/pallas/rms_norm.py::_rms_fwd, run under the Pallas
interpreter off TPU), on the CPU.

Same numpy inputs. Tolerances: fp32 2e-6 absolute (both compute
x * rsqrt(mean(x^2) + eps) * w in fp32; only the mean's summation order
differs); bf16 one bf16 ulp at |y| < 4 (1.6e-2), since the two round
the same fp32 value and may land on either side of a rounding edge.
The CUDA kernel is held against the same plain version on the card by
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas import rms_norm as jrn

from paddle_tpu_torch.core.flags import flags_scope
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import rms_norm as trn


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(8, 128), (2, 12, 256), (5, 64)])
def test_plain_matches_pallas_kernel_fp32(shape):
    x, w = _inputs(1, shape)
    want = np.asarray(jrn._rms_fwd(jnp.asarray(x), jnp.asarray(w), eps=1e-6))
    got = trn.rms_norm_fwd(torch.from_numpy(x), torch.from_numpy(w),
                           eps=1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_plain_matches_pallas_kernel_bf16():
    x, w = _inputs(2, (16, 256))
    want = np.asarray(jrn._rms_fwd(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(w, jnp.bfloat16), eps=1e-5))
    got = trn.rms_norm_fwd(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(w).bfloat16(), eps=1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=0, atol=1.6e-2)


def test_functional_routes_and_agrees():
    x, w = _inputs(3, (4, 6, 128))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = trn.launches
    routed = TF.rms_norm(xt, wt, 1e-6)           # gate passes: kernel wrapper
    with flags_scope(use_cuda_rms_norm=False):
        plain = TF.rms_norm(xt, wt, 1e-6)        # the composition
    assert trn.launches == before                # CPU never launches
    want = np.asarray(jrn._rms_fwd(jnp.asarray(x), jnp.asarray(w), eps=1e-6))
    np.testing.assert_allclose(routed.numpy(), want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=2e-6)


def test_shape_errors():
    with pytest.raises(ValueError, match="hidden"):
        trn.rms_norm_fwd(torch.zeros(2, 8), torch.ones(4), eps=1e-6)
