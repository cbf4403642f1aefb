"""The port's RMSNorm (paddle_tpu_torch/ops/cuda/rms_norm.py and
nn/functional/norm.py) against the reference package's Pallas kernels
(paddle_tpu/ops/pallas/rms_norm.py::_rms_fwd and _rms_bwd, run under the
Pallas interpreter off TPU), on the CPU.

Same numpy inputs. Tolerances: fp32 2e-6 absolute (both compute
x * rsqrt(mean(x^2) + eps) * w in fp32; only the mean's summation order
differs); bf16 one bf16 ulp at |y| < 4 (1.6e-2), since the two round
the same fp32 value and may land on either side of a rounding edge.
Backward, fp32: dx 2e-6 absolute, dw 1e-5 absolute (dw sums up to 24
rows of magnitude ~1 in another order); bf16: one bf16 ulp of each
output (dx 1.6e-2 at |dx| < 4, dw 6.3e-2 at |dw| < 16). The CUDA kernels
are held against the same plain versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

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


@pytest.mark.parametrize("shape", [(8, 128), (2, 12, 256)])
def test_backward_plain_matches_pallas_kernel_fp32(shape):
    x, w = _inputs(4, shape)
    g = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    jdx, jdw = jrn._rms_bwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                            eps=1e-6)
    dx, dw = trn.rms_norm_bwd(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(g), eps=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0, atol=2e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=0, atol=1e-5)


def test_backward_plain_matches_pallas_kernel_bf16():
    x, w = _inputs(6, (16, 256))
    g = np.random.default_rng(7).normal(size=(16, 256)).astype(np.float32)
    jdx, jdw = jrn._rms_bwd(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16),
                            jnp.asarray(g, jnp.bfloat16), eps=1e-5)
    dx, dw = trn.rms_norm_bwd(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w).bfloat16(),
                              torch.from_numpy(g).bfloat16(), eps=1e-5)
    assert dx.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx).astype(np.float32),
                               rtol=0, atol=1.6e-2)
    np.testing.assert_allclose(dw.float().numpy(),
                               np.asarray(jdw).astype(np.float32),
                               rtol=0, atol=6.3e-2)


def test_autograd_kernel_route_vs_plain():
    # rms_norm's kernel route (the autograd function over the plain
    # backward) against autograd through the plain composition
    x, w = _inputs(8, (3, 5, 128))
    g = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def grads(kernel):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        with flags_scope(use_cuda_rms_norm=kernel):
            (TF.rms_norm(xt, wt, 1e-6) * torch.from_numpy(g)).sum().backward()
        return xt.grad.numpy(), wt.grad.numpy()

    before = (trn.launches, trn.bwd_launches)
    (kdx, kdw), (pdx, pdw) = grads(True), grads(False)
    assert (trn.launches, trn.bwd_launches) == before
    np.testing.assert_allclose(kdx, pdx, rtol=0, atol=2e-6)
    np.testing.assert_allclose(kdw, pdw, rtol=0, atol=1e-5)
