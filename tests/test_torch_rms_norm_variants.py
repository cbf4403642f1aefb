"""The variants of the port's RMSNorm kernels (paddle_tpu_torch/ops/cuda/
rms_norm.py, csrc/rms_norm.cu), on the CPU.

The kernels run only on the card; here are held what surrounds them:

- the variant-and-grid rule ``_launch_config`` at the shapes the port's
  main paths give it (8, 2048 and 8192 rows x 2048: decode, serving
  prefill, training), at an odd hidden (the scalar variant) and at a wide
  one (the chunked variant);
- the backward's dw split, modelled in fp32 as the vector kernel sums it
  (each thread's rows in order, the block's row groups in order, then the
  block partials in 8 strided runs and the runs in order) at the training
  shape [8192, 2048], against an fp64 sum, within chip_smoke.py's
  ``tolerance(dtype, 1e-3)``, the dw tolerance the kernel is held to on
  the card;
- the plain version at an odd and a wide hidden (a few rows) against the
  reference's Pallas kernels ``_rms_fwd`` / ``_rms_bwd`` run under the
  interpreter, at test_torch_rms_norm.py's fp32 tolerances: y and dx 2e-6
  absolute, dw 1e-5 (sums of 8 rows in another order).
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import jax.numpy as jnp
from paddle_tpu.ops.pallas import rms_norm as jrn

from chip_smoke import tolerance
from paddle_tpu_torch.ops.cuda import rms_norm as trn

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("rows, hidden, dtype, backward, want", [
    # decode: few rows, spread over 8 warps each, one access a lane
    (8, 2048, BF16, False, ("vector", 8, 1, 8, (8, 1), 0)),
    (8, 2048, BF16, True, ("vector", 8, 1, 8, (8, 1), 8)),
    # serving prefill and training: 4 warps a row, 2 accesses a lane, 4
    # blocks per SM forward, 2 backward (its dw partial rows)
    (2048, 2048, BF16, False, ("vector", 8, 2, 4, (528, 1), 0)),
    (2048, 2048, BF16, True, ("vector", 8, 2, 4, (264, 1), 264)),
    (8192, 2048, BF16, False, ("vector", 8, 2, 4, (528, 1), 0)),
    (8192, 2048, BF16, True, ("vector", 8, 2, 4, (264, 1), 264)),
    (8192, 2048, F32, True, ("vector", 4, 2, 8, (264, 1), 264)),
    # an odd hidden: one element per access, a block per row forward,
    # 4 column chunks x 66 row runs backward
    (8192, 2047, BF16, False, ("scalar", 1, 1, 0, (528, 1), 0)),
    (8192, 2047, BF16, True, ("scalar", 1, 2, 0, (4, 66), 66)),
    # wider than 8 warps x 32 lanes x 4 accesses: chunked
    (64, 65536, BF16, False, ("chunked", 8, 1, 0, (64, 1), 0)),
    (64, 65536, BF16, True, ("chunked", 8, 2, 0, (16, 17), 17)),
    (8192, 8192, F32, False, ("chunked", 4, 1, 0, (528, 1), 0)),
])
def test_launch_config_pins_the_variant_and_grid(rows, hidden, dtype,
                                                 backward, want):
    assert tuple(trn._launch_config(rows, hidden, dtype,
                                    backward=backward)) == want


def test_launch_config_takes_the_scalar_variant_off_a_16_byte_boundary():
    cfg = trn._launch_config(8192, 2048, BF16, aligned=False)
    assert (cfg.variant, cfg.vec) == ("scalar", 1)
    x = torch.zeros(2 * 2048 + 1, dtype=BF16)
    assert trn._aligned(x[:2048]) and not trn._aligned(x[1:2049])


@pytest.mark.parametrize("rows, hidden, dtype", [
    (8192, 2048, BF16), (8192, 2047, BF16), (64, 65536, BF16),
    (8, 2048, F32), (8192, 8192, F32), (3, 128, BF16)])
def test_launch_config_covers_every_column_once(rows, hidden, dtype):
    # what the C entry points check before they launch: the vector
    # variant's lanes hold the whole row, the column chunks cover it
    for backward in (False, True):
        cfg = trn._launch_config(rows, hidden, dtype, backward=backward)
        nvec = hidden // cfg.vec
        assert hidden % cfg.vec == 0
        if cfg.variant == "vector":
            assert cfg.wpr in (1, 2, 4, 8) and cfg.nv in (1, 2, 4)
            assert 32 * cfg.wpr * cfg.nv >= nvec
            assert cfg.grid[0] <= -(-rows // (8 // cfg.wpr))
        elif backward:
            per_block = 256 * cfg.nv
            assert (cfg.grid[0] - 1) * per_block < nvec <= cfg.grid[0] * \
                per_block
            assert cfg.grid[1] == cfg.partials <= rows
        else:
            assert cfg.grid[0] <= rows


def _dw_vector_model(contrib, cfg):
    """dw as the vector backward kernel sums ``contrib`` ([rows, hidden]
    fp32, g * x * r per element) with the launch ``cfg``: thread (block b,
    row group k) adds its rows (b + i * grid) * groups + k in order, the
    block adds its groups in order, and the reduction adds the block
    partials b = j, j + 8, ... in order for each j, then the 8 sums."""
    rows, hidden = contrib.shape
    groups, grid = 8 // cfg.wpr, cfg.grid[0]
    iters = -(-rows // (groups * grid))
    padded = torch.zeros(iters * grid * groups, hidden, dtype=torch.float32)
    padded[:rows] = contrib
    per_thread = torch.zeros(grid, groups, hidden, dtype=torch.float32)
    for chunk in padded.view(iters, grid, groups, hidden):
        per_thread = per_thread + chunk
    block = per_thread[:, 0]
    for k in range(1, groups):
        block = block + per_thread[:, k]
    runs = []
    for j in range(8):
        s = torch.zeros(hidden, dtype=torch.float32)
        for b in range(j, grid, 8):
            s = s + block[b]
        runs.append(s)
    total = runs[0]
    for s in runs[1:]:
        total = total + s
    return total


@pytest.mark.parametrize("x_dtype, w_dtype", [
    (BF16, BF16), (torch.float16, torch.float16), (F32, F32), (BF16, F32)])
def test_dw_block_partials_match_an_fp64_sum(x_dtype, w_dtype):
    rows, hidden = 8192, 2048
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(rows, hidden)).astype(
        np.float32)).to(x_dtype)
    g = torch.from_numpy(rng.normal(size=(rows, hidden)).astype(
        np.float32)).to(x_dtype)
    xf, gf = x.float(), g.float()
    invr = 1.0 / torch.sqrt((xf * xf).sum(-1, keepdim=True) / hidden + 1e-6)
    cfg = trn._launch_config(rows, hidden, x_dtype, backward=True)
    assert cfg.variant == "vector" and cfg.partials == cfg.grid[0]
    got = _dw_vector_model(gf * xf * invr, cfg).to(w_dtype)
    want = (gf.double() * xf.double() * invr.double()).sum(0)
    atol, rtol = tolerance(w_dtype, 1e-3)
    err = (got.double() - want).abs()
    assert float((err / (atol + rtol * want.abs())).max()) <= 1.0
    assert float(want.abs().max()) > 100     # sums that can lose bits


@pytest.mark.parametrize("rows, hidden", [(8, 2047), (8, 65536)])
def test_plain_version_matches_pallas_kernels_off_the_vector_variant(
        rows, hidden):
    rng = np.random.default_rng(hidden)
    x = rng.normal(size=(rows, hidden)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=hidden)).astype(np.float32)
    g = rng.normal(size=(rows, hidden)).astype(np.float32)
    assert trn._launch_config(rows, hidden, F32).variant != "vector"
    want = np.asarray(jrn._rms_fwd(jnp.asarray(x), jnp.asarray(w), eps=1e-6))
    got = trn.rms_norm_fwd(torch.from_numpy(x), torch.from_numpy(w),
                           eps=1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    jdx, jdw = jrn._rms_bwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                            eps=1e-6)
    dx, dw = trn.rms_norm_bwd(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(g), eps=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0, atol=2e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=0, atol=1e-5)
