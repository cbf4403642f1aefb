"""A CPU model of the rounding and tiling of the varlen tensor-core
backward (``vflash_bwd_dq_tc_kernel`` and ``vflash_bwd_dkv_tc_kernel`` in
paddle_tpu_torch/csrc/flash_attention_varlen.cu), held against the plain
version ``_vflash_bwd_reference`` that chip_smoke.py holds the kernels to
on the card.

What the model keeps of the kernels: bf16 (or fp16) q, k, v, dO; the
products S = Q K^T and dP = dO V^T of 16-bit inputs, exact and summed in
fp32; P from the saved lse (0 where lse is -inf); dS = P * (dP - delta) *
scale in fp32; every product with an fp32 left operand (dS K, P^T dO,
dS^T Q) taking that operand as hi + lo in the input type, hi = T(x),
lo = T(x - hi), both products summed in fp32; and the kernels' tiling.
dq: 64-row q tiles, each over the 64-key tiles from its key range's start
(a segment start, so key tiles are not 64-aligned), the element mask only
where the forward's rule says. dk/dv: 64-key tiles, each over the q rows
that may see it in steps of 32 rows, the mask only where the step's rule
says, the GQA group summed in fp32 and cast once.

Tolerance: chip_smoke.py's ``tolerance(dtype, 1e-4)``, the check the
kernels must pass on the card: 1e-4 absolute plus two output ulps
(2 * eps * |ref|). The model is not the kernels' exact summation order; it
shows that the design's roundings fit inside that check, that dS rounded
once does not (``test_single_rounding_of_ds_misses_the_check``), and that
both tile rules matter.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention_varlen as tvf
from test_torch_flash_tc_numerics import (BLOCK, NEG_INF, _cu, _mm, _share,
                                          _split, _tile_keys)
from _torch_zoo import one_torch_thread  # noqa: F401

STEP = 32           # q rows of a dk/dv step


def _tile_rows(keys, seg_k, cu_q, cu_k, n_seqs, tq, causal):
    """k_tile_rows<64>: (q_begin, q_end, the keys' one segment or -1), or
    None for a tile whose keys lie in no segment."""
    sk = seg_k[keys]
    inside = sk < n_seqs
    if not inside.any():
        return None
    lo, hi = int(sk[inside].min()), int(sk[inside].max())
    first = int(keys[inside].min())
    begin = int(cu_q[lo])
    if causal:
        len_q = int(cu_q[lo + 1] - cu_q[lo])
        len_k = int(cu_k[lo + 1] - cu_k[lo])
        begin += min(len_q, max(0, first - int(cu_k[lo]) - len_k + len_q))
    end = min(int(cu_q[hi + 1]), tq)
    uniform = len(keys) == BLOCK and bool(inside.all()) and lo == hi
    return begin, max(begin, end), lo if uniform else -1


def dq_rule(k0, keys, causal):
    """The dq kernel's tile needs no mask (the forward's rule)."""
    _, end, seg, min_bound = keys
    return seg >= 0 and k0 + BLOCK <= end and (
        not causal or k0 + BLOCK - 1 <= min_bound)


def dkv_rule(k0, q0, q_end, kseg, seg_q, bound, causal):
    """The dk/dv kernel's step needs no mask: keys and the step's rows in
    one segment and, under causal, the first row sees the last key."""
    return (kseg >= 0 and q0 + STEP <= q_end and int(seg_q[q0]) == kseg
            and int(seg_q[q0 + STEP - 1]) == kseg
            and (not causal or k0 + BLOCK - 1 <= int(bound[q0])))


def _tc_varlen_backward(q, k, v, cu_q, cu_k, out, lse, do, seed=None, *,
                        causal, scale, rate=0.0, split_p=True, split_ds=True,
                        rules=(dq_rule, dkv_rule), tiles=None):
    """The two kernels' rounding and tiling: (dq, dk, dv) in q's dtype.
    ``rules`` are the dq tile's and the dk/dv step's no-mask rules;
    ``tiles`` counts the tiles and steps taken without and with the
    mask."""
    dt = q.dtype
    tq, h, d = q.shape
    tk, hkv = k.shape[0], k.shape[1]
    g = h // hkv
    n_seqs = cu_q.shape[0] - 1
    seg_q, seg_k, bound = tvf._seg_vectors(cu_q, cu_k, tq, tk)
    cu_q, cu_k = cu_q.to(torch.int64), cu_k.to(torch.int64)
    keep = (tvf._varlen_keep(seed, h, tq, tk, rate, torch.device("cpu"))
            if rate > 0.0 else None)
    tiles = {} if tiles is None else tiles
    qf = q.float().transpose(0, 1)                              # [H, Tq, D]
    dof = do.float().transpose(0, 1)
    kf, vf = (t.float().repeat_interleave(g, dim=1).transpose(0, 1)
              for t in (k, v))                                  # [H, Tk, D]
    delta = (dof * out.float().transpose(0, 1)).sum(dim=-1)     # [H, Tq]
    lse_safe = torch.where(lse == NEG_INF, 0.0, lse.float())    # [H, Tq]

    def count(key, free):
        name = f"{key} {'free' if free else 'masked'}"
        tiles[name] = tiles.get(name, 0) + 1

    # dq: 64-row q tiles over 64-key tiles from k_begin
    dq = torch.zeros(tq, h, d)
    for q0 in range(0, tq, BLOCK):
        rows = torch.arange(q0, min(q0 + BLOCK, tq))
        keys = _tile_keys(rows, seg_q, bound, cu_k, n_seqs, tk, causal)
        if keys is None:
            continue
        acc = torch.zeros(h, len(rows), d)
        for k0 in range(keys[0], keys[1], BLOCK):
            cols = torch.arange(k0, k0 + BLOCK)
            live = cols < keys[1]                # the rest are zero-filled
            safe = torch.where(live, cols, 0)
            kt = torch.where(live[None, :, None], kf[:, safe], 0.0)
            vt = torch.where(live[None, :, None], vf[:, safe], 0.0)
            s = (qf[:, rows] @ kt.transpose(-1, -2)) * scale
            dp = dof[:, rows] @ vt.transpose(-1, -2)
            free = rules[0](k0, keys, causal)
            count("dq", free)
            vis = torch.ones(len(rows), BLOCK, dtype=torch.bool)
            if not free:
                vis = live[None, :] & (seg_k[safe][None, :]
                                       == seg_q[rows][:, None])
                if causal:
                    vis = vis & (cols[None, :] <= bound[rows][:, None])
            p = torch.where(vis[None], torch.exp(s - lse_safe[:, rows, None]),
                            0.0)
            if keep is not None:
                dp = dp * torch.where(live, keep[:, rows][:, :, safe], 0.0)
            ds = p * (dp - delta[:, rows, None]) * scale
            acc = acc + _mm(_split(ds, dt, split_ds), kt)
        dq[rows] = acc.transpose(0, 1)

    # dk/dv: 64-key tiles over the rows that may see them, 32 at a time
    dk = torch.zeros(tk, hkv, d)
    dv = torch.zeros(tk, hkv, d)
    for k0 in range(0, tk, BLOCK):
        keys = torch.arange(k0, min(k0 + BLOCK, tk))
        rows_info = _tile_rows(keys, seg_k, cu_q, cu_k, n_seqs, tq, causal)
        if rows_info is None:
            continue
        q_begin, q_end, kseg = rows_info
        acc_k = torch.zeros(hkv, len(keys), d)
        acc_v = torch.zeros(hkv, len(keys), d)
        kt = k.float().transpose(0, 1)[:, keys]              # [Hkv, K, D]
        vt = v.float().transpose(0, 1)[:, keys]
        for hh in range(g):
            heads = torch.arange(hkv) * g + hh
            for q0 in range(q_begin, q_end, STEP):
                r = torch.arange(q0, q0 + STEP)
                live = r < q_end
                safe = torch.where(live, r, 0)
                qt = torch.where(live[None, :, None], qf[heads][:, safe], 0.0)
                dot = torch.where(live[None, :, None], dof[heads][:, safe],
                                  0.0)
                s = (kt @ qt.transpose(-1, -2)) * scale      # [Hkv, K, 32]
                dp = vt @ dot.transpose(-1, -2)
                free = rules[1](k0, q0, q_end, kseg, seg_q, bound, causal)
                count("dkv", free)
                vis = torch.ones(len(keys), STEP, dtype=torch.bool)
                if not free:
                    vis = live[None, :] & (seg_q[safe][None, :]
                                           == seg_k[keys][:, None])
                    if causal:
                        vis = vis & (keys[:, None] <= bound[safe][None, :])
                ls = lse_safe[heads][:, safe]                # [Hkv, 32]
                p = torch.where(vis[None], torch.exp(s - ls[:, None, :]), 0.0)
                pd = p
                if keep is not None:
                    kp = torch.where(live[None, None, :], keep[heads][
                        :, safe][:, :, keys].transpose(-1, -2), 0.0)
                    pd, dp = p * kp, dp * kp
                ds = p * (dp - delta[heads][:, safe][:, None, :]) * scale
                acc_v = acc_v + _mm(_split(pd, dt, split_p), dot)
                acc_k = acc_k + _mm(_split(ds, dt, split_ds), qt)
        dk[keys] = acc_k.transpose(0, 1)
        dv[keys] = acc_v.transpose(0, 1)
    return dq.to(dt), dk.to(dt), dv.to(dt)


CASES = {
    "[90, 7, 130, 0, 45] noncausal": (([90, 7, 130, 0, 45],) * 2, 4, 4, 128,
                                      dict(causal=False)),
    "[300, 7, 130, 0, 45] causal GQA 4/2": (([300, 7, 130, 0, 45],) * 2, 4,
                                            2, 128, dict(causal=True)),
    "segments of 9 and 5 rows inside tiles, GQA 4/1": (
        ([40, 9, 70, 5, 100],) * 2, 4, 1, 128, dict(causal=True)),
    "len_k != len_q causal, rows past cu[-1]": (
        ([70, 37, 150, 0], [100, 20, 150, 9]), 4, 2, 128,
        dict(causal=True, extra_q=13)),
    "len_k != len_q noncausal D64": (([70, 37, 150], [100, 20, 150]), 4, 4,
                                     64, dict(causal=False)),
    "dropout 0.1 causal GQA 4/2": (([200, 9, 70],) * 2, 4, 2, 128,
                                   dict(causal=True, rate=0.1)),
}


def _case(name, dtype, seed=0):
    """(q, k, v, cu_q, cu_k, seed), do, static args, rate; out and lse
    come from the plain forward, as the kernels take the forward's."""
    (lq, lk), h, hkv, d, kw = CASES[name]
    kw = dict(kw)
    tq, tk = sum(lq) + kw.pop("extra_q", 0), sum(lk)
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dtype)

    rate = kw.pop("rate", 0.0)
    seed_t = torch.tensor([99], dtype=torch.int32) if rate else None
    args = (rnd(tq, h, d), rnd(tk, hkv, d), rnd(tk, hkv, d), _cu(lq),
            _cu(lk), seed_t)
    return args, rnd(tq, h, d), dict(causal=kw["causal"], scale=d ** -0.5), \
        rate


def _model_and_reference(name, dtype, **model_kw):
    args, do, st, rate = _case(name, dtype)
    out, lse = tvf._vflash_fwd_reference(*args, dropout_rate=rate, **st)
    q, k, v, cu_q, cu_k, seed = args
    got = _tc_varlen_backward(q, k, v, cu_q, cu_k, out, lse, do, seed,
                              rate=rate, **st, **model_kw)
    ref = tvf._vflash_bwd_reference(q, k, v, cu_q, cu_k, out, lse, do, seed,
                                    dropout_rate=rate, **st)
    return got, ref


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", list(CASES))
def test_backward_model_within_the_kernel_check(name, dtype):
    tiles = {}
    got, ref = _model_and_reference(name, dtype, tiles=tiles)
    for grad, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _share(a, r, dtype) <= 1.0, grad
    assert tiles.get("dq masked", 0) > 0 and tiles.get("dkv masked", 0) > 0
    if name.startswith("len_k != len_q causal"):
        # rows past cu[-1] and the first 17 rows of segment 1 (len_k 20 <
        # len_q 37 under bottom-right causal) see no key; no row sees the
        # 9 keys of segment 3 (len_q 0)
        assert (got[0][257:] == 0).all() and (got[0][70:87] == 0).all()
        assert (got[1][270:] == 0).all() and (got[2][270:] == 0).all()


def test_backward_model_takes_both_tile_paths():
    """Long segments give dq tiles and dk/dv steps that need no mask, under
    causal and not; tiles that straddle a segment boundary take the mask."""
    for name in ("[90, 7, 130, 0, 45] noncausal",
                 "[300, 7, 130, 0, 45] causal GQA 4/2"):
        tiles = {}
        _model_and_reference(name, torch.bfloat16, tiles=tiles)
        assert all(tiles.get(f"{kind} {path}", 0) > 0
                   for kind in ("dq", "dkv") for path in ("free", "masked")
                   ), (name, tiles)
    _, seg_k, _ = tvf._seg_vectors(_cu([90, 7, 130]), _cu([90, 7, 130]),
                                   227, 227)
    rows = _tile_rows(torch.arange(64, 128), seg_k, _cu([90, 7, 130]).long(),
                      _cu([90, 7, 130]).long(), 3, 227, True)
    # keys 64..127 span segments 0, 1 and 2; under causal the first row
    # that sees key 64 is row 64
    assert rows == (64, 227, -1)


def test_single_rounding_of_ds_misses_the_check():
    """Why the kernels split dS: rounded once to bf16 before dS K and
    dS^T Q, dq and dk land well outside the check, while hi + lo stays
    within it."""
    name = "[300, 7, 130, 0, 45] causal GQA 4/2"
    single, ref = _model_and_reference(name, torch.bfloat16, split_ds=False)
    split, _ = _model_and_reference(name, torch.bfloat16)
    s_single = [_share(a, r, torch.bfloat16) for a, r in zip(single, ref)]
    s_split = [_share(a, r, torch.bfloat16) for a, r in zip(split, ref)]
    assert min(s_single[:2]) > 5.0, s_single
    assert max(s_split) <= 1.0, s_split


def test_dkv_mask_rule_is_needed():
    """The dk/dv step rule has teeth: a step taken without its mask where
    the causal bound still cuts it (the rule without its last condition)
    puts dk and dv far outside the check."""
    def loose(k0, q0, q_end, kseg, seg_q, bound, causal):
        return dkv_rule(k0, q0, q_end, kseg, seg_q, bound, False)

    got, ref = _model_and_reference("[300, 7, 130, 0, 45] causal GQA 4/2",
                                    torch.bfloat16, rules=(dq_rule, loose))
    assert _share(got[1], ref[1], torch.bfloat16) > 10.0
    assert _share(got[2], ref[2], torch.bfloat16) > 10.0


if __name__ == "__main__":
    # Each gradient's worst share of the check, dS rounded once vs split
    # hi + lo, bf16 (numpy seed 0):
    #   PYTHONPATH=. python tests/test_torch_flash_varlen_tc_backward.py
    for name in CASES:
        for split in (False, True):
            got, ref = _model_and_reference(name, torch.bfloat16,
                                            split_ds=split)
            print(f"{name}, dS {'hi + lo' if split else 'single'}: " +
                  ", ".join(f"{g} {_share(a, r, torch.bfloat16):.3f}"
                            for g, a, r in zip(("dq", "dk", "dv"), got, ref)))
