"""The port's paged decode attention (paddle_tpu_torch/ops/cuda/
paged_attention.py) against the reference package's
(paddle_tpu/ops/pallas/paged_attention.py), on the CPU.

The same numpy inputs go through the reference's jnp gather program
(and, for one small case, its Pallas kernel under the interpreter) and
the port's plain version — which is what a CPU tensor runs. Tolerance:
2e-6 absolute in fp32 (both are one fp32 softmax over the same values;
only the summation order differs). The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import jax.numpy as jnp
from paddle_tpu.ops.pallas import paged_attention as jpa

from paddle_tpu_torch.ops.cuda import paged_attention as tpa

TOL = 2e-6


def _case(seed, b=4, nh=4, kvh=4, dh=16, page=8, pps=3, pages=16,
          lens=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nh, dh)).astype(np.float32)
    kp = rng.normal(size=(kvh, pages, page, dh)).astype(np.float32)
    vp = rng.normal(size=(kvh, pages, page, dh)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, pps * page + 1, size=b)
    lens = np.asarray(lens, np.int32)
    tbl = rng.permutation(pages)[:b * pps].reshape(b, pps).astype(np.int32)
    return q, kp, vp, lens, tbl


def _jax(args, **kw):
    return np.asarray(jpa.paged_attention_decode(
        *(jnp.asarray(a) for a in args), **kw))


def _torch(args, **kw):
    return tpa.paged_attention_decode(
        *(torch.from_numpy(a) for a in args), **kw).numpy()


@pytest.mark.parametrize("kvh", [4, 2, 1])
def test_plain_matches_reference_gqa(kvh):
    args = _case(seed=kvh, kvh=kvh)
    np.testing.assert_allclose(_torch(args), _jax(args, backend="reference"),
                               rtol=0, atol=TOL)


def test_zero_length_rows_and_page_edges():
    # idle serving slots carry length 0 -> exact zeros, never NaN; lengths
    # on exact page edges (8, 16) and one past (9) read the right pages
    args = _case(seed=7, b=5, lens=[0, 8, 9, 16, 0])
    out = _torch(args)
    assert np.isfinite(out).all()
    assert (out[0] == 0).all() and (out[4] == 0).all()
    np.testing.assert_allclose(out, _jax(args, backend="reference"),
                               rtol=0, atol=TOL)


def test_plain_matches_pallas_kernel_interpreted():
    args = _case(seed=11, b=2, nh=2, kvh=1, dh=8, page=4, pps=2, pages=6,
                 lens=[3, 8])
    np.testing.assert_allclose(_torch(args), _jax(args, backend="interpret"),
                               rtol=0, atol=TOL)


def test_bf16_inputs_return_bf16():
    q, kp, vp, lens, tbl = _case(seed=3)
    out = tpa.paged_attention_decode(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(lens),
        torch.from_numpy(tbl))
    ref = _jax((q.astype(jnp.bfloat16), kp.astype(jnp.bfloat16),
                vp.astype(jnp.bfloat16), lens, tbl), backend="reference")
    assert out.dtype == torch.bfloat16
    # both round one fp32 result to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32),
                               rtol=0, atol=8e-3)


@pytest.mark.parametrize("bad, match", [
    ("q2d", "q must be"), ("pool", "k_pages/v_pages"), ("dh", "head_dim"),
    ("group", "multiple of kv heads"), ("lens", "lengths"),
    ("tbl", "block_tables"),
])
def test_check_shapes_errors_match_reference(bad, match):
    q, kp, vp, lens, tbl = _case(seed=5, kvh=2)
    if bad == "q2d":
        q = q[0]
    elif bad == "pool":
        vp = vp[:, :-1]
    elif bad == "dh":
        kp, vp = kp[..., :-1], vp[..., :-1]
    elif bad == "group":
        q = q[:, :3]
    elif bad == "lens":
        lens = lens[:-1]
    elif bad == "tbl":
        tbl = tbl[:-1]
    args = (q, kp, vp, lens, tbl)
    with pytest.raises(ValueError, match=match):
        _jax(args, backend="reference")
    with pytest.raises(ValueError, match=match):
        _torch(args)


def test_backend_routing_on_cpu():
    args = _case(seed=9)
    before = tpa.launches
    _torch(args, backend="auto")
    _torch(args, backend="reference")
    assert tpa.launches == before          # a CPU tensor never launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        _torch(args, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        _torch(args, backend="interpret")
