"""``paddle.save`` / ``paddle.load`` of the port
(paddle_tpu_torch/framework/io_.py) against the reference's
(paddle_tpu/framework/io_.py): each package reads the other's files.

The reference pickles each tensor as its
``paddle_tpu.framework.io_._TensorPayload`` (dtype name, shape, raw
bytes). The port reads that name without importing the reference and
writes its own payload under it, so the reference's ``load`` reads the
port's files. Values are compared bit for bit, dtypes by name; bf16
comes back as bf16 both ways.
"""
import os
import pickletools
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as ptt
from _torch_zoo import one_torch_thread  # noqa: F401
from paddle_tpu_torch.framework import io_ as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays():
    rng = np.random.default_rng(0)
    return dict(
        w=rng.standard_normal((3, 4)).astype(np.float32),
        h=rng.standard_normal((5,)).astype(np.float16),
        bf=rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
        ids=rng.integers(0, 100, (4,)).astype(np.int64),
        mask=np.array([True, False, True]),
        d64=rng.standard_normal((2,)).astype(np.float64),
        scalar=np.array(1.5, np.float32))


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bytes(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("protocol", [2, 4])
def test_reference_reads_the_ports_file(tmp_path, protocol):
    arrays = _arrays()
    obj = {"state": {k: _torch(a) for k, a in arrays.items()},
           "list": [_torch(arrays["w"]), 3, "x"],
           "tuple": (_torch(arrays["ids"]),), "step": 7}
    path = str(tmp_path / "sub" / "port.pdparams")
    ptt.save(obj, path, protocol=protocol)
    got = paddle.load(path)
    for k, a in arrays.items():
        v = np.asarray(got["state"][k]._value)
        assert v.dtype == a.dtype and v.shape == a.shape, k
        np.testing.assert_array_equal(_bytes(v), _bytes(a))
    np.testing.assert_array_equal(np.asarray(got["list"][0]._value),
                                  arrays["w"])
    assert got["list"][1:] == [3, "x"] and got["step"] == 7
    assert isinstance(got["tuple"], tuple)
    np.testing.assert_array_equal(
        paddle.load(path, return_numpy=True)["state"]["ids"], arrays["ids"])


def test_port_reads_the_references_file(tmp_path):
    arrays = _arrays()
    path = str(tmp_path / "ref.pdparams")
    paddle.save({"state": {k: paddle.to_tensor(a) for k, a in
                           arrays.items()},
                 "nested": [paddle.to_tensor(arrays["bf"]), {"n": 2}]},
                path)
    got = ptt.load(path, device="cpu")
    for k, a in arrays.items():
        t = got["state"][k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert str(t.dtype) == f"torch.{a.dtype.name}", k
        np.testing.assert_array_equal(_bytes(_numpy(t)), _bytes(a))
    assert got["nested"][0].dtype == torch.bfloat16
    assert got["nested"][1] == {"n": 2}
    plain = str(tmp_path / "plain.pdparams")
    paddle.save({"w": paddle.to_tensor(arrays["w"])}, plain)
    np.testing.assert_array_equal(
        ptt.load(plain, return_numpy=True)["w"], arrays["w"])
    with pytest.raises(TypeError, match="bfloat16"):
        ptt.load(path, return_numpy=True)


def test_round_trip_of_a_model_and_its_optimizer(tmp_path):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").to(
        torch.bfloat16)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                multi_precision=True)
    opt._ensure_accumulators()
    ptt.save(model.state_dict(), str(tmp_path / "m.pdparams"))
    ptt.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    state = ptt.load(str(tmp_path / "m.pdparams"), device="cpu")
    for k, v in model.state_dict().items():
        assert state[k].dtype == v.dtype == torch.bfloat16
        assert torch.equal(state[k], v), k
    fresh = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3).to(
        torch.bfloat16)
    fresh.load_state_dict(state)
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                                 model.parameters()))
    ostate = ptt.load(str(tmp_path / "m.pdopt"), device="cpu")
    assert ostate["__step__"] == 0
    assert all(v.dtype == torch.float32 for v in ostate.values()
               if isinstance(v, torch.Tensor))


def test_the_pickle_names_the_reference_class_without_importing_it(tmp_path):
    """The port's file names ``paddle_tpu.framework.io_._TensorPayload``;
    writing and reading it in a fresh interpreter imports no module of
    the reference."""
    path = tmp_path / "x.pdparams"
    ptt.save({"a": torch.ones(2)}, str(path))
    names = {a for op, a, _ in pickletools.genops(
        path.read_bytes()) if isinstance(a, str)}
    assert {"paddle_tpu.framework.io_", "_TensorPayload"} <= names
    code = ("import sys, paddle_tpu_torch as p; "
            f"p.save({{'a': __import__('torch').ones(2)}}, {str(path)!r}); "
            f"x = p.load({str(path)!r}, device='cpu'); "
            "assert float(x['a'].sum()) == 2; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'paddle_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=str(tmp_path), env={**os.environ,
                                                 "PYTHONPATH": REPO})
    assert out.stdout.strip() == "[]"
    with open(path, "rb") as f:
        assert tio._Unpickler(f).find_class(
            "paddle_tpu.framework.io_", "_TensorPayload") is \
            tio._TensorPayload
