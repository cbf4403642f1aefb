"""Head dims of the port's varlen flash attention (paddle_tpu_torch/ops/
cuda/flash_attention_varlen.py), on the CPU.

The kernels are compiled for every multiple of 32 from 32 to 256 (the
"compiled" route); above 256 every dtype takes the wide kernels (the
"wide" route, head dim at run time), whose fp32 accumulator takes at most
1536 columns: above that its columns are cut into ranges, one block each
(``_wide_column_ranges``). Any other head dim runs at the next multiple of
32, with q, k, v (and out, dO) zero-padded and the results sliced back; a
head dim below 1 raises. Held here: the head-dim rule
(``_kernel_head_dim``) and the column-range plan; the padding step of
``_vflash_fwd_kernel`` / ``_vflash_bwd_kernel``, run with the plain version
in place of the launch, against the plain version at the caller's D (fp32;
2e-6 on out and lse, 2e-5 on gradients: zero columns only change the order
of the fp32 sums), on both routes and above 1536; a model of the wide
kernels' column split (each range takes the products over the full D and
keeps its own columns, the lse from the first range) against the
reference's interpreted Pallas kernels at D 2048; and the port's plain
version against the same kernels at D 32, 96, 256, 288 and 512, at the
tolerances of test_torch_flash_varlen.py (out, lse 2e-6) and
test_torch_flash_varlen_backward.py (dq, dk, dv 2e-5).
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

from paddle_tpu_torch.ops.cuda import flash_attention_varlen as tvf
import jax.numpy as jnp
from paddle_tpu.ops.pallas import flash_attention_varlen as jvf

from test_torch_flash_varlen import TOL, _both, _close
from test_torch_flash_varlen_backward import (GRAD_TOL, _bwd_both, _cu,
                                              _grads_close, _htd, _pack)


@pytest.mark.parametrize("d, want", [(1, 32), (16, 32), (32, 32), (40, 64),
                                     (64, 64), (80, 96), (96, 96),
                                     (128, 128), (200, 224), (256, 256)])
def test_kernel_head_dim_is_the_next_multiple_of_32(d, want):
    assert tvf._kernel_head_dim(d) == (want, "compiled")
    assert want in tvf.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("d, want", [(257, 288), (288, 288), (300, 320),
                                     (512, 512), (1000, 1024), (1024, 1024),
                                     (1536, 1536), (1537, 1568), (2048, 2048),
                                     (3072, 3072)])
def test_kernel_head_dim_names_the_wide_route_above_256(d, want):
    assert tvf._kernel_head_dim(d) == (want, "wide")


@pytest.mark.parametrize("d", [0, -1, -32])
def test_kernel_head_dim_raises_outside_the_compiled_range(d):
    # the kernels' range, compiled and wide: every head dim from 1 up
    with pytest.raises(ValueError, match="< 1"):
        tvf._kernel_head_dim(d)


@pytest.mark.parametrize("d, want", [(288, (1, 288)), (1536, (1, 1536)),
                                     (1537, (2, 800)), (2048, (2, 1024)),
                                     (3072, (2, 1536)), (3073, (3, 1056))])
def test_wide_column_ranges_split_the_accumulator_above_1536(d, want):
    # n = ceil(D / 1536) ranges of ceil(D / n) columns rounded up to 32
    # (csrc/flash_attention_varlen.cu wide_range_cols), at the padded D:
    # 1537 runs at 1568 = 800 + 768; the ranges cover D once
    assert tvf.WIDE_RANGE_COLS == 1536
    n, cols = tvf._wide_column_ranges(d)
    d_run = tvf._kernel_head_dim(d)[0]
    assert (n, cols) == want
    assert cols <= tvf.WIDE_RANGE_COLS and cols % 32 == 0
    assert (n - 1) * cols < d_run <= n * cols


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


@pytest.mark.parametrize("d", [1537, 2048])
def test_kernel_wrappers_send_head_dims_above_1536_to_the_wide_route(
        plain_launches, d):
    # the launches get D padded to 32 and no further, which the C entry
    # points route to the wide kernels in column ranges; the results equal
    # the plain version at the caller's D
    q, k, v, do = (torch.from_numpy(a) for a in _pack(2, 8, 8, 2, 2, d))
    cu = torch.from_numpy(_cu([3, 5]))
    st = dict(causal=True, scale=d ** -0.5, dropout_rate=0.0)
    out, lse = tvf._vflash_fwd_kernel(q, k, v, cu, cu, None, **st)
    want_out, want_lse = tvf._vflash_fwd_reference(q, k, v, cu, cu, **st)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=0,
                               atol=TOL)
    got = tvf._vflash_bwd_kernel(q, k, v, cu, cu, want_out, want_lse, do,
                                 None, **st)
    want = tvf._vflash_bwd_reference(q, k, v, cu, cu, want_out, want_lse,
                                     do, **st)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=GRAD_TOL)
    d_run = -(-d // 32) * 32
    assert [tvf._kernel_head_dim(x) for x in plain_launches] == \
        [(d_run, "wide")] * 2


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


def _column_split_fwd(q, k, v, cu_q, cu_k, *, causal, scale):
    """The wide forward kernel's column split in fp32 torch: per column
    range of ``_wide_column_ranges``, the keys in 32-wide tiles with an
    online softmax whose scores take the full D, accumulating only the
    range's columns of O; the lse from the first range."""
    n, cols = tvf._wide_column_ranges(q.shape[-1])
    valid = tvf._mask(cu_q, cu_k, q.shape[0], k.shape[0], causal)
    g = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(g, dim=1).transpose(0, 1)      # [H, Tk, D]
    vr = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    outs, lse = [], None
    for c in range(n):
        c0, c1 = c * cols, min(q.shape[-1], (c + 1) * cols)
        m = torch.full(qh.shape[:2], -np.inf)
        l = torch.zeros(qh.shape[:2])
        acc = torch.zeros(*qh.shape[:2], c1 - c0)
        for k0 in range(0, k.shape[0], 32):
            s = torch.einsum("hqd,hkd->hqk", qh, kr[:, k0:k0 + 32]) * scale
            s = torch.where(valid[None, :, k0:k0 + 32], s, -np.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_eff = torch.where(m_new == -np.inf, 0.0, m_new)
            alpha = torch.exp(m - m_eff)
            p = torch.exp(s - m_eff[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "hqk,hkd->hqd", p, vr[:, k0:k0 + 32, c0:c1])
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        outs.append(acc / l_safe[..., None])
        if c == 0:
            lse = torch.where(l == 0, -np.inf, m + torch.log(l_safe))
    return torch.cat(outs, -1).transpose(0, 1), lse


def _column_split_bwd(q, k, v, cu_q, cu_k, lse, do, *, causal, scale):
    """The wide backward kernels' column split: P and dS from products over
    the full D, each range's columns of dQ, dK and dV from them."""
    n, cols = tvf._wide_column_ranges(q.shape[-1])
    h, hkv = q.shape[1], k.shape[1]
    g = h // hkv
    valid = tvf._mask(cu_q, cu_k, q.shape[0], k.shape[0], causal)
    kr = k.repeat_interleave(g, dim=1).transpose(0, 1)
    vr = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qh, doh = q.transpose(0, 1), do.transpose(0, 1)
    out, _ = _column_split_fwd(q, k, v, cu_q, cu_k, causal=causal,
                               scale=scale)
    delta = (doh * out.transpose(0, 1)).sum(-1, keepdim=True)
    s = torch.einsum("hqd,hkd->hqk", qh, kr) * scale
    lse_safe = torch.where(lse == -np.inf, 0.0, lse)[..., None]
    p = torch.where(valid[None], torch.exp(s - lse_safe), 0.0)
    ds = p * (torch.einsum("hqd,hkd->hqk", doh, vr) - delta) * scale
    grads = [[], [], []]
    for c in range(n):
        c0, c1 = c * cols, min(q.shape[-1], (c + 1) * cols)
        grads[0].append(torch.einsum("hqk,hkd->qhd", ds, kr[..., c0:c1]))
        dk = torch.einsum("hqk,hqd->khd", ds, qh[..., c0:c1])
        dv = torch.einsum("hqk,hqd->khd", p, doh[..., c0:c1])
        grads[1].append(dk.reshape(k.shape[0], hkv, g, -1).sum(2))
        grads[2].append(dv.reshape(k.shape[0], hkv, g, -1).sum(2))
    return [torch.cat(x, -1) for x in grads]


@pytest.mark.parametrize("causal", [False, True])
def test_column_split_matches_pallas_kernels_at_d_2048(causal):
    # two column ranges of 1024; GQA 4/2, segment boundaries inside the
    # 32-row tiles, len_k != len_q
    lq, lk = [13, 1, 20], [9, 4, 24]
    cu_q, cu_k = _cu(lq), _cu(lk)
    q, k, v, do = _pack(11, sum(lq), sum(lk), 4, 2, 2048)
    assert tvf._wide_column_ranges(2048) == (2, 1024)
    t = torch.from_numpy
    scale = 2048 ** -0.5
    out, lse = _column_split_fwd(t(q), t(k), t(v), t(cu_q), t(cu_k),
                                 causal=causal, scale=scale)
    (want_out, want_lse), _ = _both(q, k, v, cu_q, cu_k, causal=causal)
    _close((out.numpy(), lse.numpy()), (want_out, want_lse))
    got = _column_split_bwd(t(q), t(k), t(v), t(cu_q), t(cu_k), lse, t(do),
                            causal=causal, scale=scale)
    want = jvf._vflash_bwd(
        _htd(q), _htd(k), _htd(v), jnp.asarray(cu_q), jnp.asarray(cu_k),
        _htd(out.numpy()), _htd(lse.numpy(), -np.inf), _htd(do), None,
        n_seqs=len(lq), causal=causal, scale=scale, dropout_rate=0.0)
    want = [np.swapaxes(np.asarray(x), 0, 1)[:n]
            for x, n in zip(want, (q.shape[0], k.shape[0], k.shape[0]))]
    _grads_close([x.numpy() for x in got], want)
