"""Head dims of the port's varlen flash attention (paddle_tpu_torch/ops/
cuda/flash_attention_varlen.py), on the CPU.

The kernels are compiled for every multiple of 32 from 32 to 256 (the
"compiled" route); above 256 every dtype takes the wide kernels (the
"wide" route, head dim at run time, up to 1536). Any other head dim runs
at the next multiple of 32, with q, k, v (and out, dO) zero-padded and the
results sliced back; a head dim below 1 or above 1536 raises. Held here:
the head-dim rule (``_kernel_head_dim``); the padding step of
``_vflash_fwd_kernel`` / ``_vflash_bwd_kernel``, run with the plain version
in place of the launch, against the plain version at the caller's D (fp32;
2e-6 on out and lse, 2e-5 on gradients: zero columns only change the order
of the fp32 sums), on both routes; and the port's plain version against
the reference's interpreted Pallas kernels at D 32, 96, 256, 288 and 512,
at the tolerances of test_torch_flash_varlen.py (out, lse 2e-6) and
test_torch_flash_varlen_backward.py (dq, dk, dv 2e-5).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention_varlen as tvf
from test_torch_flash_varlen import TOL, _both, _close
from test_torch_flash_varlen_backward import (GRAD_TOL, _bwd_both, _cu,
                                              _grads_close, _pack)


@pytest.mark.parametrize("d, want", [(1, 32), (16, 32), (32, 32), (40, 64),
                                     (64, 64), (80, 96), (96, 96),
                                     (128, 128), (200, 224), (256, 256)])
def test_kernel_head_dim_is_the_next_multiple_of_32(d, want):
    assert tvf._kernel_head_dim(d) == (want, "compiled")
    assert want in tvf.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("d, want", [(257, 288), (288, 288), (300, 320),
                                     (512, 512), (1000, 1024), (1024, 1024),
                                     (1536, 1536)])
def test_kernel_head_dim_names_the_wide_route_above_256(d, want):
    assert tvf._kernel_head_dim(d) == (want, "wide")


@pytest.mark.parametrize("d", [0, 1537, 2048])
def test_kernel_head_dim_raises_outside_the_compiled_range(d):
    # the kernels' range, compiled and wide: 1 ... WIDE_MAX_HEAD_DIM
    assert tvf.WIDE_MAX_HEAD_DIM == 1536
    with pytest.raises(ValueError, match="1536"):
        tvf._kernel_head_dim(d)


def test_kernel_wrappers_raise_above_1536_before_any_launch():
    q, k, v, do = (torch.from_numpy(a) for a in _pack(0, 8, 8, 2, 2, 1568))
    cu = torch.from_numpy(_cu([3, 5]))
    st = dict(causal=True, scale=1568 ** -0.5, dropout_rate=0.0)
    with pytest.raises(ValueError, match="1536"):
        tvf._vflash_fwd_kernel(q, k, v, cu, cu, None, **st)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="1536"):
        tvf._vflash_bwd_kernel(q, k, v, cu, cu, q, lse, do, None, **st)


@pytest.fixture
def plain_launches(monkeypatch):
    """The kernel wrappers with the plain version in place of each launch:
    records the head dim every launch was given."""
    seen = []

    def fwd(q, k, v, cu_q, cu_k, seed, **kw):
        seen.append(q.shape[-1])
        return tvf._vflash_fwd_reference(q, k, v, cu_q, cu_k, seed, **kw)

    def bwd(q, k, v, cu_q, cu_k, out, lse, do, seed, **kw):
        seen.append(q.shape[-1])
        assert out.shape[-1] == do.shape[-1] == q.shape[-1]
        return tvf._vflash_bwd_reference(q, k, v, cu_q, cu_k, out, lse, do,
                                         seed, **kw)

    monkeypatch.setattr(tvf, "_vflash_fwd_launch", fwd)
    monkeypatch.setattr(tvf, "_vflash_bwd_launch", bwd)
    return seen


@pytest.mark.parametrize("d", [16, 40, 80, 200, 300])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, rate=0.2)],
                         ids=["causal", "noncausal", "causal dropout"])
def test_padding_step_equals_the_plain_version_at_d(plain_launches, d, kw):
    lq, lk = [37, 1, 50, 12], [30, 4, 50, 20]
    q, k, v, do = (torch.from_numpy(a) for a in
                   _pack(d, sum(lq) + 5, sum(lk), 4, 2, d))
    cu_q, cu_k = torch.from_numpy(_cu(lq)), torch.from_numpy(_cu(lk))
    rate = kw.get("rate", 0.0)
    seed = torch.tensor([7], dtype=torch.int32) if rate else None
    st = dict(causal=kw["causal"], scale=d ** -0.5, dropout_rate=rate)
    args = (q, k, v, cu_q, cu_k)
    out, lse = tvf._vflash_fwd_kernel(*args, seed, **st)
    want_out, want_lse = tvf._vflash_fwd_reference(*args, seed, **st)
    assert out.shape == q.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=0,
                               atol=TOL)
    got = tvf._vflash_bwd_kernel(*args, want_out, want_lse, do, seed, **st)
    want = tvf._vflash_bwd_reference(*args, want_out, want_lse, do, seed,
                                     **st)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.is_contiguous(), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
    assert plain_launches == [tvf._kernel_head_dim(d)[0]] * 2


def test_kernel_wrappers_send_wide_head_dims_to_the_wide_kernels(
        plain_launches):
    # D 288: GQA 4/2, causal, segment boundaries inside 32-row tiles; the
    # launches get D 288 unpadded, which the C entry points route to the
    # wide kernels, and equal the plain version
    lq, lk = [37, 1, 50, 12], [30, 4, 50, 20]
    q, k, v, do = (torch.from_numpy(a) for a in
                   _pack(5, sum(lq), sum(lk), 4, 2, 288))
    cu_q, cu_k = torch.from_numpy(_cu(lq)), torch.from_numpy(_cu(lk))
    st = dict(causal=True, scale=288 ** -0.5, dropout_rate=0.0)
    args = (q, k, v, cu_q, cu_k)
    out, lse = tvf._vflash_fwd_kernel(*args, None, **st)
    want_out, want_lse = tvf._vflash_fwd_reference(*args, **st)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    got = tvf._vflash_bwd_kernel(*args, out, lse, do, None, **st)
    want = tvf._vflash_bwd_reference(*args, out, lse, do, **st)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [tvf._kernel_head_dim(x) for x in plain_launches] == \
        [(288, "wide")] * 2


def test_padding_step_leaves_compiled_head_dims_alone(plain_launches):
    q, k, v, _ = (torch.from_numpy(a) for a in _pack(1, 20, 20, 2, 2, 96))
    cu = torch.from_numpy(_cu([9, 11]))
    out, _ = tvf._vflash_fwd_kernel(q, k, v, cu, cu, None, causal=True,
                                    scale=0.1, dropout_rate=0.0)
    want, _ = tvf._vflash_fwd_reference(q, k, v, cu, cu, causal=True,
                                        scale=0.1)
    assert plain_launches == [96] and torch.equal(out, want)


@pytest.mark.parametrize("d", [32, 96, 256, 288, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_pallas_kernels_at_head_dim(d, causal):
    # GQA 4/2, segment boundaries inside tiles, len_k != len_q
    cu_q, cu_k = _cu([37, 1, 50, 12]), _cu([30, 4, 50, 20])
    q, k, v, do = _pack(30 + d, int(cu_q[-1]), int(cu_k[-1]), 4, 2, d)
    want, got = _both(q, k, v, cu_q, cu_k, causal=causal)
    _close(got, want)
    _grads_close(*_bwd_both(q, k, v, do, cu_q, cu_k, causal=causal))
