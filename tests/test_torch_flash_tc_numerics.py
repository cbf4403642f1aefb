"""A CPU model of the rounding in the tensor-core flash kernels
(``flash_fwd_tc_kernel``, ``flash_bwd_dq_tc_kernel`` and
``flash_bwd_dkv_tc_kernel`` in paddle_tpu_torch/csrc/flash_attention.cu),
held against the plain versions ``_flash_fwd_reference`` /
``_flash_bwd_reference`` that chip_smoke.py holds the kernels to on the
card; and of the varlen tensor-core forward (``vflash_fwd_tc_kernel``)
over packed segments with its tiling, held against
``_vflash_fwd_reference``.

What the model keeps of the kernels: bf16 (or fp16) q, k, v, dO; the
products S = Q K^T and dP = dO V^T of 16-bit inputs, exact and summed in
fp32; the forward's online softmax over 64-key tiles in fp32 (running max
with the rescale of the row sum and the output); the row sum l taken from
the fp32 p, undropped; and every product with an fp32 left operand (P V,
dS K, P^T dO, dS^T Q) taking that operand as hi + lo in the input type,
hi = T(x), lo = T(x - hi), both products summed in fp32.

Tolerance: chip_smoke.py's ``tolerance(dtype, 1e-4)``, the check the
kernels must pass on the card: 1e-4 absolute plus two output ulps
(2 * eps * |ref|), i.e. the plain version's fp32 result may round to the
neighbouring 16-bit value. lse within 1e-4. The model is not the kernels'
exact summation order; it shows that the design's roundings fit inside
that check, and (``test_single_rounding_misses_the_check``) that a P
rounded once to bf16 does not, which is why the kernels split it.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import flash_attention_varlen as tvf

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

NEG_INF = float("-inf")
BLOCK = 64          # the kernels' key tile


def _split(x, dtype, split=True):
    """The operand the tensor cores see for an fp32 ``x``: hi + lo (two
    products) or, with ``split=False``, a single rounding."""
    hi = x.to(dtype).float()
    if not split:
        return [hi]
    return [hi, (x - hi).to(dtype).float()]


def _mm(parts, b):
    """sum over the parts of part @ b, in fp32."""
    return sum(p @ b for p in parts)


def _tc_forward(q, k, v, seed=None, bias=None, *, causal, scale,
                rate=0.0, split=True):
    """The forward kernel's rounding: (out in q's dtype, lse fp32)."""
    dt = q.dtype
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(g, dim=1) for t in (k, v))
    keep = (tfa._keep_scale(q, sk, seed, rate) if rate > 0.0 else None)
    rows = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk, BLOCK):
        cols = torch.arange(k0, min(k0 + BLOCK, sk))[None, :]
        x = (qf @ kf[:, :, k0:k0 + BLOCK].transpose(-1, -2)) * scale
        if bias is not None:
            x = x + bias[:, None, None, k0:k0 + BLOCK]
        if causal:
            x = torch.where(rows + (sk - sq) >= cols, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        m_eff = torch.where(m_new == NEG_INF, 0.0, m_new)
        alpha = torch.exp(m - m_eff)
        p = torch.exp(x - m_eff)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = p * keep[..., k0:k0 + BLOCK]
        acc = acc * alpha + _mm(_split(p, dt, split), vf[:, :, k0:k0 + BLOCK])
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(dt)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return out, lse


def _tc_backward(q, k, v, out, lse, do, seed=None, bias=None, *, causal,
                 scale, rate=0.0, split=True):
    """The dq and dk/dv kernels' rounding: (dq, dk, dv) in q's dtype, the
    GQA group summed in fp32 and cast once."""
    dt = q.dtype
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    s, repeat = tfa._scores(q, k, bias, causal=causal, scale=scale)
    lse_safe = torch.where(lse == NEG_INF, 0.0, lse.float())[..., None]
    p = torch.exp(s - lse_safe)
    dof = do.float()
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = dof @ repeat(v).transpose(-1, -2)
    p_drop = p
    if rate > 0.0:
        keep = tfa._keep_scale(q, sk, seed, rate)
        p_drop, dp = p * keep, dp * keep
    ds = p * (dp - delta) * scale
    dq = _mm(_split(ds, dt, split), repeat(k))
    dk = _mm(_split(ds.transpose(-1, -2), dt, split), q.float())
    dv = _mm(_split(p_drop.transpose(-1, -2), dt, split), dof)
    if h != hkv:
        dk = dk.reshape(b, hkv, h // hkv, sk, d).sum(dim=2)
        dv = dv.reshape(b, hkv, h // hkv, sk, d).sum(dim=2)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _inputs(seed, b, h, hkv, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dtype)

    return rnd(b, h, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d), \
        rnd(b, h, sq, d)


def _share(got, ref, dtype):
    atol, rtol = chip_smoke.tolerance(dtype, 1e-4)
    return chip_smoke.close_err(got, ref, atol, rtol)[1]


CASES = {
    "causal": ((2, 4, 4, 200, 200, 128), dict(causal=True)),
    "noncausal ragged Sq100 Sk300 D64": ((2, 4, 4, 100, 300, 64), {}),
    "causal Sq80 Sk48 GQA8/2 masked rows": ((2, 8, 2, 80, 48, 128),
                                            dict(causal=True)),
    "bias[1,Sk] GQA4/1": ((2, 4, 1, 64, 300, 128), dict(bias="one")),
    "bias[B,Sk] masked batch": ((2, 4, 4, 64, 300, 64), dict(bias="batch")),
    "causal dropout 0.1 GQA4/2": ((2, 4, 2, 128, 128, 128),
                                  dict(causal=True, rate=0.1)),
}


def _case(name, dtype, seed=0):
    (b, h, hkv, sq, sk, d), kw = CASES[name]
    q, k, v, do = _inputs(seed, b, h, hkv, sq, sk, d, dtype)
    kw = dict(kw)
    bias = kw.pop("bias", None)
    if bias == "one":
        bias = torch.from_numpy(np.random.default_rng(seed + 1).normal(
            size=(1, sk)).astype(np.float32))
    elif bias == "batch":
        bias = torch.zeros(2, sk)
        bias[0] = NEG_INF            # batch 0: every key masked
        bias[1, ::3] = -1e9
    rate = kw.pop("rate", 0.0)
    seed_t = torch.tensor([1234], dtype=torch.int32) if rate else None
    st = dict(causal=kw.get("causal", False), scale=d ** -0.5)
    return (q, k, v, do), (seed_t, bias), st, rate


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_model_within_the_kernel_check(name, dtype):
    (q, k, v, _), (seed, bias), st, rate = _case(name, dtype)
    out, lse = _tc_forward(q, k, v, seed, bias, rate=rate, **st)
    rout, rlse = tfa._flash_fwd_reference(q, k, v, seed, bias,
                                          dropout_rate=rate, **st)
    assert _share(out, rout, dtype) <= 1.0
    assert chip_smoke.max_err(lse, rlse) <= 1e-4
    if name.startswith("causal Sq80"):
        assert torch.isinf(lse[:, :, :32]).all()
        assert (out[:, :, :32] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", list(CASES))
def test_backward_model_within_the_kernel_check(name, dtype):
    (q, k, v, do), (seed, bias), st, rate = _case(name, dtype)
    out, lse = tfa._flash_fwd_reference(q, k, v, seed, bias,
                                        dropout_rate=rate, **st)
    got = _tc_backward(q, k, v, out, lse, do, seed, bias, rate=rate, **st)
    ref = tfa._flash_bwd_reference(q, k, v, out, lse, do, seed, bias,
                                   dropout_rate=rate, **st)
    for name_, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _share(a, r, dtype) <= 1.0, name_
    if name.startswith("bias[B"):
        assert all((x[0] == 0).all() for x in got)


def test_single_rounding_misses_the_check():
    """Why the kernels split P: at [2,4,512,128] bf16 causal, P rounded
    once to bf16 before P V puts the worst output entry well past the
    check (12.1x here), while hi + lo stays within it (one output ulp at
    most, about half the tolerance)."""
    q, k, v, _ = _inputs(0, 2, 4, 4, 512, 512, 128, torch.bfloat16)
    st = dict(causal=True, scale=128 ** -0.5)
    rout, _ = tfa._flash_fwd_reference(q, k, v, **st)
    single, _ = _tc_forward(q, k, v, split=False, **st)
    split, _ = _tc_forward(q, k, v, split=True, **st)
    s_single = _share(single, rout, torch.bfloat16)
    s_split = _share(split, rout, torch.bfloat16)
    assert s_single > 5.0, s_single
    assert s_split <= 0.6, s_split


if __name__ == "__main__":
    # Each product's worst share of the check, P / dS rounded once vs
    # split hi + lo, bf16 causal (numpy seed 0):
    #   PYTHONPATH=. python tests/test_torch_flash_tc_numerics.py
    for shape in ((2, 4, 4, 512, 512, 128), (1, 2, 2, 2048, 2048, 128)):
        q, k, v, do = _inputs(0, *shape, torch.bfloat16)
        st = dict(causal=True, scale=shape[-1] ** -0.5)
        rout, rlse = tfa._flash_fwd_reference(q, k, v, **st)
        ref = tfa._flash_bwd_reference(q, k, v, rout, rlse, do, **st)
        for split in (False, True):
            out, _ = _tc_forward(q, k, v, split=split, **st)
            got = _tc_backward(q, k, v, rout, rlse, do, split=split, **st)
            shares = [_share(out, rout, torch.bfloat16)] + [
                _share(a, r, torch.bfloat16) for a, r in zip(got, ref)]
            print(f"{list(shape)} {'hi + lo' if split else 'single'}: " +
                  ", ".join(f"{n} {x:.3f}" for n, x in zip(
                      ("out (P V)", "dq (dS K)", "dk (dS^T Q)",
                       "dv (P^T dO)"), shares)))


# ---------------------------------------------------------------------------
# The varlen tensor-core forward (vflash_fwd_tc_kernel in
# paddle_tpu_torch/csrc/flash_attention_varlen.cu): the same rounding over
# packed segments, with the kernel's tiling. A 64-row q tile loops over
# 64-key tiles from k_begin, a segment start (so key tiles are not
# 64-aligned); the element mask is evaluated only on tiles that need it (a
# tile needs none when all 64 rows lie in one segment, the tile is whole,
# and under causal its last key is at most the rows' smallest bound).

def _tile_keys(rows, seg_q, bound, cu_k, n_seqs, tk, causal):
    """q_tile_keys<64>: (k_begin, k_end, the rows' one segment or -1, the
    rows' smallest bound), or None for a tile whose rows see no segment."""
    sr = seg_q[rows]
    inside = sr < n_seqs
    if not inside.any():
        return None
    lo, hi = int(sr[inside].min()), int(sr[inside].max())
    b = bound[rows][inside]
    begin = int(cu_k[lo])
    end = min(int(cu_k[hi + 1]), tk)
    if causal:
        end = min(end, int(b.max()) + 1)
    uniform = len(rows) == BLOCK and bool(inside.all()) and lo == hi
    return begin, max(begin, end), lo if uniform else -1, int(b.min())


def _tc_varlen_forward(q, k, v, cu_q, cu_k, seed=None, *, causal, scale,
                       rate=0.0, split=True, mask_rule=None, tiles=None):
    """The varlen tensor-core forward's rounding and tiling: (out in q's
    dtype, lse [H, Tq] fp32). ``mask_rule(k0, keys, causal)`` says whether
    a tile needs no mask (the kernel's rule by default); ``tiles`` counts
    the tiles taken without and with the mask."""
    dt = q.dtype
    tq, h, d = q.shape
    tk, hkv = k.shape[0], k.shape[1]
    g = h // hkv
    n_seqs = cu_q.shape[0] - 1
    seg_q, seg_k, bound = tvf._seg_vectors(cu_q, cu_k, tq, tk)
    cu_k = cu_k.to(torch.int64)
    keep = (tvf._varlen_keep(seed, h, tq, tk, rate, torch.device("cpu"))
            if rate > 0.0 else None)
    if mask_rule is None:
        def mask_rule(k0, keys, causal):
            _, end, seg, min_bound = keys
            return seg >= 0 and k0 + BLOCK <= end and (
                not causal or k0 + BLOCK - 1 <= min_bound)
    qf = q.float().transpose(0, 1)                              # [H, Tq, D]
    kf, vf = (t.float().repeat_interleave(g, dim=1).transpose(0, 1)
              for t in (k, v))                                  # [H, Tk, D]
    out = torch.zeros(tq, h, d, dtype=dt)
    lse = torch.full((h, tq), NEG_INF)
    for q0 in range(0, tq, BLOCK):
        rows = torch.arange(q0, min(q0 + BLOCK, tq))
        keys = _tile_keys(rows, seg_q, bound, cu_k, n_seqs, tk, causal)
        if keys is None:
            continue
        begin, end = keys[:2]
        m = torch.full((h, len(rows), 1), NEG_INF)
        l = torch.zeros(h, len(rows), 1)
        acc = torch.zeros(h, len(rows), d)
        for k0 in range(begin, end, BLOCK):
            cols = torch.arange(k0, k0 + BLOCK)
            live = cols < end                    # the rest are zero-filled
            safe = torch.where(live, cols, 0)
            kt = torch.where(live[None, :, None], kf[:, safe], 0.0)
            vt = torch.where(live[None, :, None], vf[:, safe], 0.0)
            x = (qf[:, rows] @ kt.transpose(-1, -2)) * scale
            free = mask_rule(k0, keys, causal)
            if tiles is not None:
                tiles["free" if free else "masked"] += 1
            if not free:
                vis = live[None, :] & (seg_k[safe][None, :]
                                       == seg_q[rows][:, None])
                if causal:
                    vis = vis & (cols[None, :] <= bound[rows][:, None])
                x = torch.where(vis[None], x, NEG_INF)
            m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
            m_eff = torch.where(m_new == NEG_INF, 0.0, m_new)
            alpha = torch.exp(m - m_eff)
            p = torch.exp(x - m_eff)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            if keep is not None:
                p = p * torch.where(live, keep[:, rows][:, :, safe], 0.0)
            acc = acc * alpha + _mm(_split(p, dt, split), vt)
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        out[rows] = (acc / l_safe).transpose(0, 1).to(dt)
        lse[:, rows] = torch.where(l == 0.0, NEG_INF,
                                   m + torch.log(l_safe))[..., 0]
    return out, lse


def _cu(lens):
    return torch.tensor([0, *np.cumsum(lens)], dtype=torch.int32)


VARLEN_CASES = {
    "[90, 7, 130, 0, 45] noncausal": (([90, 7, 130, 0, 45],) * 2, 4, 4, 128,
                                      dict(causal=False)),
    "[90, 7, 130, 0, 45] causal": (([90, 7, 130, 0, 45],) * 2, 4, 4, 128,
                                   dict(causal=True)),
    "[300, 7, 130, 0, 45] causal GQA 4/2": (([300, 7, 130, 0, 45],) * 2, 4,
                                            2, 128, dict(causal=True)),
    "len_k != len_q causal, rows past cu[-1]": (
        ([70, 37, 150, 0], [100, 20, 150, 9]), 4, 2, 128,
        dict(causal=True, extra_q=13)),
    "len_k != len_q noncausal D64": (([70, 37, 150], [100, 20, 150]), 4, 4,
                                     64, dict(causal=False)),
    "dropout 0.1 causal GQA 4/1": (([200, 9, 70],) * 2, 4, 1, 128,
                                   dict(causal=True, rate=0.1)),
}


def _varlen_case(name, dtype, seed=0):
    (lq, lk), h, hkv, d, kw = VARLEN_CASES[name]
    kw = dict(kw)
    tq, tk = sum(lq) + kw.pop("extra_q", 0), sum(lk)
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dtype)

    rate = kw.pop("rate", 0.0)
    seed_t = torch.tensor([99], dtype=torch.int32) if rate else None
    return ((rnd(tq, h, d), rnd(tk, hkv, d), rnd(tk, hkv, d), _cu(lq),
             _cu(lk), seed_t), dict(causal=kw["causal"], scale=d ** -0.5),
            rate)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", list(VARLEN_CASES))
def test_varlen_forward_model_within_the_kernel_check(name, dtype):
    args, st, rate = _varlen_case(name, dtype)
    tiles = {"free": 0, "masked": 0}
    out, lse = _tc_varlen_forward(*args, rate=rate, tiles=tiles, **st)
    rout, rlse = tvf._vflash_fwd_reference(*args, dropout_rate=rate, **st)
    assert _share(out, rout, dtype) <= 1.0
    assert chip_smoke.max_err(lse, rlse) <= 1e-4
    assert tiles["masked"] > 0
    if name.startswith("len_k != len_q causal"):
        # rows past cu[-1] and the first 17 rows of segment 1 (len_k 20 <
        # len_q 37 under bottom-right causal) see no key
        assert torch.isinf(lse[:, 257:]).all() and (out[257:] == 0).all()
        assert torch.isinf(lse[:, 70:87]).all() and (out[70:87] == 0).all()


def test_varlen_model_takes_both_tile_paths():
    """Long segments give whole tiles that need no mask, under causal and
    not; a q tile that straddles a segment boundary is always masked."""
    for name in ("[90, 7, 130, 0, 45] noncausal",
                 "[300, 7, 130, 0, 45] causal GQA 4/2"):
        args, st, _ = _varlen_case(name, torch.bfloat16)
        tiles = {"free": 0, "masked": 0}
        _tc_varlen_forward(*args, tiles=tiles, **st)
        assert tiles["free"] > 0 and tiles["masked"] > 0, (name, tiles)
    seg_q, _, bound = tvf._seg_vectors(_cu([90, 7, 130]), _cu([90, 7, 130]),
                                       227, 227)
    keys = _tile_keys(torch.arange(64, 128), seg_q, bound,
                      _cu([90, 7, 130]).long(), 3, 227, False)
    assert keys[2] == -1          # rows 64..127 span segments 0, 1 and 2


def test_varlen_mask_rule_is_needed():
    """The rule has teeth: a tile taken without its mask where the causal
    bound still cuts it (the rule without its last condition) puts the
    output far outside the check."""
    args, st, _ = _varlen_case("[300, 7, 130, 0, 45] causal GQA 4/2",
                               torch.bfloat16)

    def loose(k0, keys, causal):
        return keys[2] >= 0 and k0 + BLOCK <= keys[1]

    out, _ = _tc_varlen_forward(*args, mask_rule=loose, **st)
    rout, _ = tvf._vflash_fwd_reference(*args, **st)
    assert _share(out, rout, torch.bfloat16) > 10.0
