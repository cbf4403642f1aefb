"""The port's conv-calibration tool (paddle_tpu_torch/tools/
conv_calibration.py) and its matmul probe (paddle_tpu_torch/ops/cuda/
tiled_mm.py) against the reference tool (tools/conv_calibration.py), on
the CPU.

- the ResNet-50 conv table, the FLOPs and the implicit-GEMM shape with
  its padding to 128 equal the reference's (its ``measure_shape`` run at
  a small shape gives its FLOPs);
- the probe's plain version equals the body of the reference's Pallas
  probe, ``jnp.dot(a, b, preferred_element_type=float32).astype(bf16)``,
  on the same bf16 inputs: bit for bit where the fp32 sums are exact
  (small integers), and within one bf16 unit in the last place (the fp32
  sums taken in another order may round to the neighbouring bf16 value)
  on normal inputs;
- measuring needs a card: ``measure_shape`` raises without one.

The CUDA kernel is held against the same plain version on the card by
chip_smoke.py.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from paddle_tpu_torch.ops.cuda import tiled_mm as ttm
from paddle_tpu_torch.tools import conv_calibration as tcc

ROOT = Path(__file__).resolve().parents[1]


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "_reference_conv_calibration", ROOT / "tools" / "conv_calibration.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tool()
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
CHIP_SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CHIP_SMOKE)


def test_resnet50_table_is_the_reference_table():
    assert tcc.RESNET50_CONVS == REF.RESNET50_CONVS


@pytest.mark.parametrize("i", range(len(REF.RESNET50_CONVS)))
def test_flops_and_gemm_shape_match_the_reference(i):
    # the arithmetic of the reference's measure_shape (conv_calibration.py
    # :109-135) at its default batch
    cin, h, w, cout, kk, stride, _ = REF.RESNET50_CONVS[i]
    batch = 64
    ho, wo = h // stride, w // stride
    d = tcc.conv_dims(cin, h, w, cout, kk, stride, batch)
    assert d["flops"] == 2.0 * batch * ho * wo * cout * cin * kk * kk
    assert (d["m"], d["k"], d["n"]) == (batch * ho * wo, cin * kk * kk, cout)
    assert d["kp"] == ((cin * kk * kk + 127) // 128) * 128
    assert d["np"] == ((cout + 127) // 128) * 128
    assert d["kp"] % 128 == 0 and d["kp"] - d["k"] < 128


def test_flops_equal_the_reference_measurement():
    # the reference's own measure_shape at a small shape (its Pallas probe
    # is skipped there: m = 2 * 6 * 6 is not a multiple of 512)
    flops, t_conv, t_gemm, t_pal = REF.measure_shape(8, 12, 12, 16, 3, 2, 2,
                                                     1)
    assert t_pal is None and t_conv > 0 and t_gemm > 0
    assert tcc.conv_dims(8, 12, 12, 16, 3, 2, 2)["flops"] == flops


def _mk(a, b):
    """The body of the reference's Pallas probe (``mk``)."""
    return np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                              preferred_element_type=jnp.float32)
                      .astype(jnp.bfloat16)).astype(np.float32)


def _bf16(x):
    t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return t, np.asarray(jnp.asarray(x.astype(np.float32), jnp.bfloat16))


@pytest.mark.parametrize("m, k, n", [(100, 640, 128), (37, 147, 64),
                                     (512, 128, 256)])
def test_plain_probe_equals_the_pallas_body_exactly(m, k, n):
    rng = np.random.default_rng(m)
    (ta, ja), (tb, jb) = (_bf16(rng.integers(-4, 5, size=s))
                          for s in ((m, k), (k, n)))
    got = ttm.tiled_mm(ta, tb)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), _mk(ja, jb))


def test_plain_probe_matches_the_pallas_body_on_normal_inputs():
    rng = np.random.default_rng(1)
    (ta, ja), (tb, jb) = _bf16(rng.normal(size=(96, 576))), \
        _bf16(rng.normal(size=(576, 128)) * 0.05)
    got = ttm.tiled_mm(ta, tb).float().numpy()
    want = _mk(ja, jb)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() > 0.95


def test_probe_checks_its_operands():
    a = torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wants a"):
        ttm.tiled_mm(a, torch.zeros(4, 8, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        ttm.tiled_mm(a.float(), torch.zeros(8, 2))


def test_measure_shape_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcc.measure_shape(64, 56, 56, 64, 3, 1, 64, 1)
    with pytest.raises(ValueError, match="CUDA card"):
        tcc.measure_shape(64, 56, 56, 64, 3, 1, 64, 1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcc.main(["--shape", "2", "--iters", "1"])


# The tiled matmul's K split is a rule of the shape (_tile_config): one K
# range where the 128 x 128 tiles of C alone give each of the H100's 132 SMs
# a block; else the fewest ranges that do, each at least MIN_SPLIT_STEPS
# K steps. The kernel adds the ranges' fp32 partials in a fixed order.

def _probe_shape(i, batch=64):
    cin, h, w, cout, kk, stride, _ = tcc.RESNET50_CONVS[i]
    d = tcc.conv_dims(cin, h, w, cout, kk, stride, batch)
    return d["m"], d["kp"], d["np"]


def test_split_rule_at_the_calibrate_shapes():
    assert _probe_shape(2) == (200704, 640, 128)
    assert _probe_shape(17) == (3136, 4608, 512)
    assert ttm._tile_config(*_probe_shape(2)) == 1
    assert ttm._blocks(3136, 512) == 100         # 32 of 132 SMs idle
    assert ttm._tile_config(*_probe_shape(17)) == 2
    assert ttm._blocks(3136, 512) * 2 >= ttm.H100_SMS


@pytest.mark.parametrize("i", range(len(REF.RESNET50_CONVS)))
def test_split_rule_fills_a_wave_where_it_can(i):
    m, k, n = _probe_shape(i)
    splits = ttm._tile_config(m, k, n)
    tiles = ttm._blocks(m, n)
    steps = -(-k // ttm.K_STEP)
    if tiles >= ttm.H100_SMS:
        assert splits == 1
    else:
        # a wave of blocks, or as many ranges as K allows
        assert (tiles * splits >= ttm.H100_SMS
                or splits == steps // ttm.MIN_SPLIT_STEPS)
        assert tiles * (splits - 1) < ttm.H100_SMS  # the fewest that do
    assert splits == 1 or steps // splits >= ttm.MIN_SPLIT_STEPS


def test_split_rule_takes_the_card_sm_count_and_short_k():
    assert ttm._tile_config(3136, 4608, 512, sms=100) == 1
    assert ttm._tile_config(1000, 300, 200) == 1     # 5 K steps: no split
    assert ttm._tile_config(1000, 2000, 200) == 8    # 16 tiles, 32 steps


def _split_model(a, b, splits):
    """The kernel's split-K arithmetic: K ranges of whole 64-steps, each
    summed in fp32, the partials added in order and rounded once."""
    k = a.shape[1]
    steps = -(-k // ttm.K_STEP)
    k_split = -(-steps // splits) * ttm.K_STEP
    part = [a[:, k0:k0 + k_split].float() @ b[k0:k0 + k_split].float()
            for k0 in range(0, k, k_split)]
    acc = part[0]
    for p in part[1:]:
        acc = acc + p
    return acc.to(torch.bfloat16), len(part)


@pytest.mark.parametrize("m, k, n", [(1000, 2000, 200), (1000, 2004, 196),
                                     (49, 4608, 512)])
def test_split_k_within_the_kernel_check(m, k, n):
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                         ).to(torch.bfloat16)
    b = torch.from_numpy((rng.normal(size=(k, n)) * 0.05).astype(np.float32)
                         ).to(torch.bfloat16)
    splits = ttm._tile_config(m, k, n)
    got, ranges = _split_model(a, b, splits)
    assert splits > 1 and 1 < ranges <= splits
    atol, rtol = CHIP_SMOKE.tolerance(torch.bfloat16, 1e-4)
    _, share = CHIP_SMOKE.close_err(got, ttm.tiled_mm_reference(a, b), atol,
                                    rtol)
    assert share <= 1.0
