"""The split-context design of the port's paged decode kernel
(paddle_tpu_torch/csrc/paged_attention.cu, launch rule in
paddle_tpu_torch/ops/cuda/paged_attention.py), on the CPU.

The kernel itself runs only on the card (chip_smoke.py holds it against
the plain version there). Held here: the launch rule ``_split_plan``
pinned at the serving, GQA and suffix-prefill shapes (and where it takes
half a page, and its limits); and a torch model of the kernel's
arithmetic order, against the reference package's
``paged_attention_decode_reference``: each split of ``split_tokens``
rows is streamed in ring stages of ``stage_rows`` rows, its lane groups
take two rows a step into their own online softmax (m, l, acc), the
groups of a warp merge pairwise (xor order), the warps merge max-then-sum,
and a row's splits merge max-then-sum in split order; a state that saw
no row (m = -inf) weighs 0. fp32 rows and accumulators (m and l as Python
floats), tolerance 2e-6 absolute
(both are fp32 softmaxes over the same values; only the order of the sums
differs), with empty splits, lengths on a split edge, length 0 and
lengths that fill every page.
"""
import math

import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import jax.numpy as jnp
from paddle_tpu.ops.pallas import paged_attention as jpa

from paddle_tpu_torch.ops.cuda import paged_attention as tpa

TOL = 2e-6
H100_SMS = 132


@pytest.mark.parametrize("name, args, kw, want", [
    # the serving decode step (default_serving_setup): 8 slots, 16/16
    # heads of 128, 8 pages of 128 a row, bf16; a page a split
    ("serving", (8, 128, 8, 16, 128, 2, H100_SMS), {},
     dict(split_tokens=128, splits=8, heads=1, grid=(8, 8, 16),
          stage_rows=16, lanes=16, vectors=1)),
    # llama3-8b's GQA 32/8: the 4 q heads of a kv head share a block
    ("gqa", (8, 128, 8, 8, 128, 2, H100_SMS), dict(group=4),
     dict(split_tokens=128, splits=8, heads=4, grid=(8, 8, 8),
          stage_rows=16, lanes=16, vectors=1)),
    # the engine's suffix prefill: 128 rows over one table
    ("prefill", (8, 128, 128, 16, 128, 2, H100_SMS), {},
     dict(split_tokens=128, splits=8, heads=1, grid=(8, 128, 16),
          stage_rows=16, lanes=16, vectors=1)),
    # one row of 8 kv heads: a page would give 64 items for 132 SMs, under
    # 2 an SM, so half a page
    ("half page", (8, 128, 1, 8, 128, 2, H100_SMS), {},
     dict(split_tokens=64, splits=16, heads=1, grid=(16, 1, 8),
          stage_rows=16, lanes=16, vectors=1)),
    # fp32: a row of 128 is 32 vectors, one a lane; 8-row stages
    ("fp32", (8, 128, 8, 16, 128, 4, H100_SMS), {},
     dict(split_tokens=128, splits=8, heads=1, grid=(8, 8, 16),
          stage_rows=8, lanes=32, vectors=1)),
    # D 64 bf16: 8 lanes a row, four rows a warp at once
    ("d64", (8, 128, 8, 16, 64, 2, H100_SMS), {},
     dict(split_tokens=128, splits=8, heads=1, grid=(8, 8, 16),
          stage_rows=32, lanes=8, vectors=1)),
    # D 256 fp32, group 8: 2 vectors (8 values) a lane, 8 heads a block;
    # 8 x 8 x 4 = 256 items a page, under 2 an SM: half a page
    ("d256 fp32 group 8", (8, 128, 8, 4, 256, 4, H100_SMS), dict(group=8),
     dict(split_tokens=64, splits=16, heads=8, grid=(16, 8, 4),
          stage_rows=4, lanes=32, vectors=2)),
    # D 2048 bf16: 8 vectors (64 values) a lane, so one head a block
    ("d2048", (8, 128, 8, 16, 2048, 2, H100_SMS), dict(group=2),
     dict(split_tokens=128, splits=8, heads=1, grid=(8, 8, 32),
          stage_rows=1, lanes=32, vectors=8)),
    # D 80 bf16: 10 vectors, 16 lanes (6 idle)
    ("d80", (8, 128, 8, 16, 80, 2, H100_SMS), {},
     dict(split_tokens=128, splits=8, heads=1, grid=(8, 8, 16),
          stage_rows=25, lanes=16, vectors=1)),
    # the chip_smoke sweep's override
    ("override", (8, 128, 8, 16, 128, 2, H100_SMS), dict(split_tokens=256),
     dict(split_tokens=256, splits=4, heads=1, grid=(4, 8, 16),
          stage_rows=16, lanes=16, vectors=1)),
])
def test_split_plan_is_pinned(name, args, kw, want):
    plan = tpa._split_plan(*args, **kw)
    assert {k: getattr(plan, k) for k in want} == want, name
    # the ring (4 stages of K and V rows) or the warps' states, then the
    # page ids and the rows' first splits
    pps, page, b, _, dh, itemsize, _ = args
    region = max(4 * 2 * plan.stage_rows * dh * itemsize,
                 4 * 4 * plan.heads * (dh + 2))
    assert plan.smem == -(-region // 16) * 16 + 4 * (
        plan.split_tokens // page + 2 + b + 1)
    assert plan.smem <= 227 * 1024


def test_split_plan_limits():
    with pytest.raises(ValueError, match="at most 8"):
        tpa._split_plan(8, 128, 8, 16, 4096, 2, H100_SMS)
    with pytest.raises(ValueError, match="at most 8"):
        tpa._split_plan(8, 128, 8, 16, 2048, 4, H100_SMS)
    with pytest.raises(ValueError, match="split_tokens"):
        tpa._split_plan(8, 128, 8, 16, 128, 2, H100_SMS, split_tokens=0)


def _merge(a, b):
    """Two online-softmax states (m, l, acc) as one; m = -inf weighs 0."""
    m = max(a[0], b[0])
    fa = 0.0 if a[0] == -math.inf else math.exp(a[0] - m)
    fb = 0.0 if b[0] == -math.inf else math.exp(b[0] - m)
    return m, a[1] * fa + b[1] * fb, a[2] * fa + b[2] * fb


def _merge_in_order(states):
    """max-then-sum over ``states`` in their order, as the kernel merges
    its warps and a row's splits."""
    m = max(s[0] for s in states)
    l, acc = 0.0, torch.zeros_like(states[0][2])
    for s in states:
        f = 0.0 if s[0] == -math.inf else math.exp(s[0] - m)
        l, acc = l + s[1] * f, acc + s[2] * f
    return m, l, acc


def _split_model(q, kp, vp, lens, tbl, plan, scale):
    """The kernel's order of arithmetic for every (row, head), fp32."""
    b, nh, dh = q.shape
    kvh, _, page, _ = kp.shape
    pps = tbl.shape[1]
    group = nh // kvh
    rpw = 32 // plan.lanes
    warps = tpa.WARPS
    workers = warps * rpw
    split, rows_st = plan.split_tokens, plan.stage_rows
    out = torch.zeros_like(q)
    for bi in range(b):
        n_len = max(0, min(int(lens[bi]), pps * page))
        t = torch.arange(n_len)
        phys = tbl[bi][t // page]
        for h in range(nh):
            keys = kp[h // group, phys, t % page]
            vals = vp[h // group, phys, t % page]
            parts = []
            for s in range(-(-n_len // split)):
                row0, n = s * split, min(split, n_len - s * split)
                st = [(-math.inf, 0.0, torch.zeros(dh))] * workers
                for lo in range(0, n, rows_st):
                    hi = min(n, lo + rows_st)
                    for w in range(warps):
                        for base in range(lo + w * rpw, hi, 2 * workers):
                            for sub in range(rpw):
                                rows = [base + sub + u * workers
                                        for u in (0, 1)]
                                x = [float(q[bi, h] @ keys[row0 + r]) * scale
                                     if r < hi else -math.inf for r in rows]
                                m, l, acc = st[w * rpw + sub]
                                m_new = max(m, *x)
                                if m_new == -math.inf:
                                    continue
                                alpha = math.exp(m - m_new)
                                p = [math.exp(xi - m_new) for xi in x]
                                acc = acc * alpha
                                for pi, r in zip(p, rows):
                                    if r < hi:
                                        acc = acc + pi * vals[row0 + r]
                                st[w * rpw + sub] = (m_new,
                                                     l * alpha + sum(p), acc)
                # a warp's lane groups pairwise, xor 1, 2, ..., then the
                # warps in order
                warp_states = []
                for w in range(warps):
                    g = st[w * rpw:(w + 1) * rpw]
                    o = 1
                    while o < rpw:
                        g = [_merge(g[i], g[i ^ o]) for i in range(rpw)]
                        o <<= 1
                    warp_states.append(g[0])
                parts.append(_merge_in_order(warp_states))
            if parts:
                m, l, acc = _merge_in_order(parts)
                out[bi, h] = acc / l if l > 0 else 0.0
    return out


def _case(seed, b, nh, kvh, dh, page, pps, pages, lens):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nh, dh)).astype(np.float32)
    kp = rng.normal(size=(kvh, pages, page, dh)).astype(np.float32)
    vp = rng.normal(size=(kvh, pages, page, dh)).astype(np.float32)
    tbl = rng.permutation(pages)[:b * pps].reshape(b, pps).astype(np.int32)
    return q, kp, vp, np.asarray(lens, np.int32), tbl


@pytest.mark.parametrize("label, shape, lens, split", [
    # pages of 8, 4 a row: splits of 8 (a page), rows 0 | 1 | 8 (a split
    # edge) | 9 | 32 (every page) | 17; stages of 3 rows
    ("page splits", (6, 4, 4, 8, 8, 4, 24), [0, 1, 8, 9, 32, 17], 8),
    # half-page splits of 4 with GQA 4/2: every row but the first spans
    # several splits, and the 3-row stages end inside them
    ("half-page splits GQA", (5, 4, 2, 8, 8, 4, 20), [5, 0, 12, 32, 4], 4),
    # a split of 16 across two pages, D 16 (2 lanes a row), fp32
    ("two-page splits", (4, 2, 2, 16, 8, 4, 16), [16, 31, 3, 0], 16),
])
def test_split_model_matches_reference(label, shape, lens, split):
    b, nh, kvh, dh, page, pps, pages = shape
    args = _case(len(label), b, nh, kvh, dh, page, pps, pages, lens)
    plan = tpa._split_plan(pps, page, b, kvh, dh, 4, H100_SMS,
                           group=nh // kvh, split_tokens=split)
    plan = plan._replace(stage_rows=3)      # stages end inside the splits
    scale = dh ** -0.5
    got = _split_model(*(torch.from_numpy(a) for a in args), plan, scale)
    want = np.asarray(jpa.paged_attention_decode_reference(
        *(jnp.asarray(a) for a in args)))
    assert np.isfinite(got.numpy()).all()
    for i, n in enumerate(lens):
        if n == 0:
            assert (got[i] == 0).all(), label
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL,
                               err_msg=label)
    # and the port's plain version, which a CPU tensor runs
    plain = tpa.paged_attention_decode(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=TOL)
