"""The port's varlen flash-attention forward (paddle_tpu_torch/ops/cuda/
flash_attention_varlen.py and the entry points flash_attn_unpadded /
flash_attn_varlen_qkvpacked) against the reference package's Pallas
kernel (paddle_tpu/ops/pallas/flash_attention_varlen.py), on the CPU; the
backward is held in test_torch_flash_varlen_backward.py.

The reference runs its kernel under the Pallas interpreter here (as its
own tests do off TPU); the port runs its plain version, which is what a
CPU tensor takes. Same numpy inputs, fp32. Tolerances: out and lse 2e-6
absolute (one fp32 online softmax tile by tile vs one dense softmax: only
the order of the sums differs). The reference pads lse to [H, Tq_pad];
its first Tq columns are compared. The dropout keep bits are compared bit
for bit. The CUDA kernels are held against the same plain version on the
card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.functional.flash_attention as JFA
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import flash_attention_varlen as jvf

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core.generator import make_generator
from paddle_tpu_torch.ops.cuda import flash_attention_varlen as tvf

TOL = 2e-6


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _pack(seed, tq, tk, h, hkv, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(tq, h, d)).astype(np.float32),
            rng.normal(size=(tk, hkv, d)).astype(np.float32),
            rng.normal(size=(tk, hkv, d)).astype(np.float32))


def _both(q, k, v, cu_q, cu_k, *, causal, seed=None, rate=0.0):
    """(out, lse) of the reference's interpreted kernel and of the port's
    plain version on the same inputs; the reference's lse cut to Tq."""
    scale = q.shape[-1] ** -0.5
    j_out, j_lse = jvf.flash_attn_varlen_thd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cu_q),
        jnp.asarray(cu_k),
        None if seed is None else jnp.asarray([seed], jnp.int32),
        causal=causal, scale=scale, dropout_rate=rate)
    t_out, t_lse = tvf.flash_attn_varlen_thd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(cu_q), torch.from_numpy(cu_k),
        None if seed is None else torch.tensor([seed], dtype=torch.int32),
        causal=causal, scale=scale, dropout_rate=rate)
    return ((np.asarray(j_out), np.asarray(j_lse)[:, :q.shape[0]]),
            (t_out.numpy(), t_lse.numpy()))


def _close(got, want):
    (jo, jl), (to, tl) = want, got
    np.testing.assert_allclose(to, jo, rtol=0, atol=TOL, err_msg="out")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL, err_msg="lse")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h, hkv", [(4, 4), (4, 2), (4, 1)])
def test_forward_matches_pallas_kernel(causal, h, hkv):
    lens = [37, 1, 50, 12]               # boundaries inside tiles
    cu = _cu(lens)
    q, k, v = _pack(1, sum(lens), sum(lens), h, hkv)
    want, got = _both(q, k, v, cu, cu, causal=causal)
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_zero_length_segment(causal):
    lens = [7, 0, 12, 0, 5]
    cu = _cu(lens)
    q, k, v = _pack(2, sum(lens), sum(lens), 2, 2)
    want, got = _both(q, k, v, cu, cu, causal=causal)
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_cross_lengths_bottom_right_causal(causal):
    # len_k != len_q per segment: longer, shorter (rows that see no key
    # under causal: lse -inf, out 0) and an empty key segment
    cu_q, cu_k = _cu([5, 9, 3, 4]), _cu([8, 4, 3, 0])
    q, k, v = _pack(3, int(cu_q[-1]), int(cu_k[-1]), 4, 2)
    want, got = _both(q, k, v, cu_q, cu_k, causal=causal)
    _close(got, want)
    out, lse = got
    assert (out[17:] == 0).all() and np.isinf(lse[:, 17:]).all()
    if causal:                           # segment 1: rows 5..9 see no key
        assert np.isinf(lse[:, 5:10]).all() and (out[5:10] == 0).all()


def test_rows_past_the_last_segment():
    # the packed tensors are longer than cu_seqlens[-1]: those rows see
    # nothing and those keys are never seen
    cu = _cu([10, 15])
    q, k, v = _pack(4, 32, 30, 2, 2)
    want, got = _both(q, k, v, cu, cu, causal=True)
    _close(got, want)
    assert (got[0][25:] == 0).all()


def test_int64_cu_seqlens():
    cu = _cu([9, 14])
    q, k, v = _pack(5, 23, 23, 2, 1)
    want = tvf.flash_attn_varlen_thd(
        *(torch.from_numpy(a) for a in (q, k, v, cu, cu)), causal=True)
    got = tvf.flash_attn_varlen_thd(
        *(torch.from_numpy(a) for a in (q, k, v)),
        *(torch.from_numpy(cu.astype(np.int64)) for _ in range(2)),
        causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_same_bits(causal):
    lens = [20, 13, 31]
    cu = _cu(lens)
    q, k, v = _pack(6, sum(lens), sum(lens), 4, 2)
    want, got = _both(q, k, v, cu, cu, causal=causal, seed=77, rate=0.3)
    _close(got, want)
    # the keep bits themselves, per q head over every (row, col)
    t = int(cu[-1])
    keep = tvf._varlen_keep(torch.tensor([77], dtype=torch.int32), 4, t, t,
                            0.3, torch.device("cpu")) > 0
    for h in range(4):
        j_keep = np.asarray(jfa._dropout_keep(
            jnp.int32(77), jnp.int32(h), 0, 0, t, t, 0.3)) > 0
        np.testing.assert_array_equal(keep[h].numpy(), j_keep)
    assert 0.6 < float(keep.float().mean()) < 0.8


def _ref_entry(fn, *args, **kw):
    out, sm = fn(*args, **kw)
    assert sm is None
    return out.numpy()


def test_flash_attn_unpadded_matches_reference():
    lens = [11, 4, 17]
    cu = _cu(lens)
    q, k, v = _pack(7, sum(lens), sum(lens), 4, 2)
    scale = 0.3
    for kw in (dict(causal=True), dict(causal=False),
               dict(causal=True, dropout=0.2, fixed_seed_offset=123)):
        want = _ref_entry(JFA.flash_attn_unpadded,
                          *(paddle.to_tensor(a) for a in (q, k, v, cu, cu)),
                          17, 17, scale, **kw)
        got, sm = TF.flash_attn_unpadded(
            *(torch.from_numpy(a) for a in (q, k, v, cu, cu)), 17, 17, scale,
            **kw)
        assert sm is None
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL,
                                   err_msg=str(kw))


def test_flash_attn_varlen_qkvpacked_matches_reference():
    lens = [9, 14, 6]
    cu = _cu(lens)
    qkv = np.random.default_rng(8).normal(
        size=(sum(lens), 3, 4, 16)).astype(np.float32)
    want = _ref_entry(JF.flash_attn_varlen_qkvpacked, paddle.to_tensor(qkv),
                      paddle.to_tensor(cu), paddle.to_tensor(cu), 14, 14,
                      scale=0.25, causal=True)
    got, sm = TF.flash_attn_varlen_qkvpacked(
        torch.from_numpy(qkv), torch.from_numpy(cu), torch.from_numpy(cu),
        14, 14, scale=0.25, causal=True)
    assert sm is None
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the unbound q, k, v are strided views of qkv; the output equals the
    # call on contiguous copies
    q, k, v = (torch.from_numpy(np.ascontiguousarray(qkv[:, i]))
               for i in range(3))
    ref, _ = TF.flash_attn_unpadded(q, k, v, torch.from_numpy(cu),
                                    torch.from_numpy(cu), 14, 14, 0.25,
                                    causal=True)
    assert torch.equal(got, ref)


def test_training_false_means_no_dropout():
    cu = _cu([12, 20])
    q, k, v = (torch.from_numpy(a) for a in _pack(9, 32, 32, 2, 2))
    cut = torch.from_numpy(cu)
    kw = dict(causal=True, generator=make_generator(0, "cpu"))
    off, _ = TF.flash_attn_unpadded(q, k, v, cut, cut, 20, 20, 0.25,
                                    dropout=0.5, training=False, **kw)
    plain, _ = TF.flash_attn_unpadded(q, k, v, cut, cut, 20, 20, 0.25, **kw)
    assert torch.equal(off, plain)
    on, _ = TF.flash_attn_unpadded(q, k, v, cut, cut, 20, 20, 0.25,
                                   dropout=0.5, **kw)
    assert not torch.allclose(on, plain)


def test_fixed_seed_offset_pins_the_seed_and_generator_draws_one():
    cu = _cu([12, 20])
    q, k, v = (torch.from_numpy(a) for a in _pack(10, 32, 32, 2, 2))
    cut = torch.from_numpy(cu)

    def run(**kw):
        return TF.flash_attn_unpadded(q, k, v, cut, cut, 20, 20, 0.25,
                                      dropout=0.3, **kw)[0]

    assert torch.equal(run(fixed_seed_offset=5), run(fixed_seed_offset=5))
    assert not torch.equal(run(fixed_seed_offset=5), run(fixed_seed_offset=6))
    a = run(generator=make_generator(3, "cpu"))
    assert torch.equal(a, run(generator=make_generator(3, "cpu")))
    with pytest.raises(ValueError, match="fixed_seed_offset or a"):
        run()


def test_dropout_one_raises_value_error_like_the_reference():
    cu = _cu([4, 4])
    q, k, v = _pack(11, 8, 8, 2, 2)
    with pytest.raises(ValueError, match="dropout must be < 1.0"):
        JFA.flash_attn_unpadded(
            *(paddle.to_tensor(a) for a in (q, k, v, cu, cu)), 4, 4, 0.25,
            dropout=1.0)
    with pytest.raises(ValueError, match="dropout must be < 1.0"):
        TF.flash_attn_unpadded(
            *(torch.from_numpy(a) for a in (q, k, v, cu, cu)), 4, 4, 0.25,
            dropout=1.0)


def test_qkvpacked_scale_none_raises_type_error_like_the_reference():
    cu = _cu([4, 4])
    qkv = np.zeros((8, 3, 2, 16), np.float32)
    with pytest.raises(TypeError):
        JF.flash_attn_varlen_qkvpacked(paddle.to_tensor(qkv),
                                       paddle.to_tensor(cu),
                                       paddle.to_tensor(cu), 4, 4)
    with pytest.raises(TypeError):
        TF.flash_attn_varlen_qkvpacked(torch.from_numpy(qkv),
                                       torch.from_numpy(cu),
                                       torch.from_numpy(cu), 4, 4)


def test_dense_flash_attention_and_sdp_kernel():
    # the dense entries of the flash_attention module: flash_attention is
    # sdpa returning (out, None); sdp_kernel(enable_flash=False) turns the
    # kernel route off inside it and restores it after
    from paddle_tpu_torch.core.flags import get_flag
    from paddle_tpu_torch.nn.functional.flash_attention import (
        flash_attention, sdp_kernel)

    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(2, 24, 4, 64)).astype(np.float32)
               for _ in range(3))
    want, _ = JFA.flash_attention(*(paddle.to_tensor(a) for a in (q, k, v)),
                                  causal=True)
    got, sm = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True)
    assert sm is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    packed, _ = TF.flash_attn_qkvpacked(
        torch.from_numpy(np.stack([q, k, v], axis=2)), causal=True)
    assert torch.equal(packed, got)
    assert get_flag("use_cuda_flash_attention")
    with sdp_kernel(enable_flash=False):
        assert not get_flag("use_cuda_flash_attention")
        plain, _ = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=True)
    assert get_flag("use_cuda_flash_attention")
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=0, atol=1e-5)


# The kernels read packed q, k, v in place at their token stride. The bf16
# and fp16 forward runs on the tensor cores and copies each token's head in
# 16-byte pieces, so the wrapper (_packed) reads such a tensor in place
# only where it starts on a 16-byte boundary and its token stride is a
# multiple of 8 elements; anything else is copied first.

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_packed_reads_aligned_views_in_place(dtype):
    qkv = torch.randn(40, 3, 4, 64).to(dtype)
    for i in range(3):                  # token stride 3 * H * D
        view = qkv[:, i]
        assert tvf._packed(view).data_ptr() == view.data_ptr()
    wide = torch.randn(40, 17, 128).to(dtype)[:, :16]    # token stride 2176
    assert tvf._packed(wide).data_ptr() == wide.data_ptr()
    dense = torch.randn(40, 4, 64).to(dtype)
    assert tvf._packed(dense) is dense


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_packed_copies_views_the_tensor_cores_cannot_read(dtype):
    odd_stride = torch.randn(40, 4 * 64 + 4).to(dtype)[:, :256].unflatten(
        1, (4, 64))                     # token stride 260: not a multiple of 8
    off16 = torch.randn(40 * 256 + 1).to(dtype)[1:].view(40, 4, 64)
    assert odd_stride.stride(0) % 8 and off16.data_ptr() % 16
    for view in (odd_stride, off16):
        got = tvf._packed(view)
        assert got.data_ptr() != view.data_ptr()
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, view)


def test_packed_fp32_reads_any_token_stride_in_place():
    # the fp32 forward runs on the CUDA cores and reads element by element
    odd_stride = torch.randn(40, 4 * 64 + 4)[:, :256].unflatten(1, (4, 64))
    assert tvf._packed(odd_stride).data_ptr() == odd_stride.data_ptr()
    # heads not contiguous: copied in every dtype
    split_heads = torch.randn(40, 64, 4).transpose(1, 2)
    assert tvf._packed(split_heads).is_contiguous()
