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
