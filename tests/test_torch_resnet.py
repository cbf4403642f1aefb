"""The port's ResNet family (paddle_tpu_torch/vision/models/resnet.py)
against the reference's (paddle_tpu/vision/models/resnet.py) on the CPU,
from bridged weights and buffers (``convert.load_paddle_tpu_state``),
fp32, batch 2 at 48 x 48: the logits of a training-mode forward and the
batch-norm running statistics it leaves, the gradients of a
cross-entropy loss, the parameters after one ``Momentum(0.1, 0.9)``
step, and the logits in eval mode after it. Then the names and shapes
of the other constructors, ``pretrained=True`` and the bridge's
refusals.

How well fp32 can agree is set by the step's conditioning, measured as
the port's own fp32 run against its fp64 run from the same weights:
- ``resnet18`` in training mode at 48 x 48: logits 2.4e-6 of their max
  apart, gradients 1.2e-5. Held to: logits and running statistics 1e-5
  of their own max |value|, each gradient 1e-4 of its own max |g|, each
  parameter after the step within lr x that gradient bound plus 1e-6 of
  its own max |value|.
- ``resnet50`` in training mode at 48 x 48: logits 7.0e-5 apart, and
  gradients up to 35% apart (a random-init ResNet-50's training-mode
  gradients cancel through 16 batch norms over few values a channel).
  So its training-mode forward is held to 5e-4 (logits and running
  statistics), and its gradients and step are taken in eval mode (batch
  norm on the running statistics: 4.4e-7 and 1.1e-6 apart), to the
  tolerances above.
- At 32 x 32 the last stage is 1 x 1 and its batch norm normalises two
  values a channel: ``resnet18``'s own fp32 and fp64 logits are already
  2.1e-4 apart, its gradients 28%. Hence 48 x 48 (eight values a
  channel there).

The reference's models draw their weights with numpy and run their
forward and step under the reference's ``jit.to_static``
(``_torch_zoo.numpy_init`` and ``reference_programs``: one XLA program
each instead of one for every op at every shape).
"""
import numpy as np
import pytest
import torch
from _torch_zoo import (  # noqa: F401
    numpy_init, one_torch_thread, reference_programs)

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import vision as jvision

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch import vision as tvision
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Momentum

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
LR = 0.1
#: resnet50's training-mode forward (see the module docstring)
DEEP_OUT_TOL = 5e-4


@pytest.fixture(autouse=True)
def _fast_reference(monkeypatch):
    numpy_init(monkeypatch)


def _share(got, want):
    got = got.detach().float().numpy()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _torch_layout(state):
    """The reference's arrays in the port's layout: ``fc.weight``
    transposed to ``[out, in]``."""
    return dict(state, **{"fc.weight": state["fc.weight"].T})


def _pair(name, **kw):
    paddle.seed(7)
    jm = getattr(jvision.models, name)(**kw)
    tm = getattr(tvision.models, name)(device="cpu", **kw)
    load_paddle_tpu_state(tm, _state(jm))
    return jm, tm


@pytest.mark.parametrize("name, out_tol, grads_in", [
    ("resnet18", OUT_TOL, "train"), ("resnet50", DEEP_OUT_TOL, "eval")])
def test_resnet_step_matches_reference(name, out_tol, grads_in):
    jm, tm = _pair(name)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 48, 48)).astype(np.float32)
    y = rng.integers(0, 1000, (2,)).astype(np.int64)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    jo = jopt.Momentum(learning_rate=LR, momentum=0.9,
                       parameters=jm.parameters())
    to = Momentum(learning_rate=LR, momentum=0.9,
                  parameters=tm.parameters())
    jforward, jstep = reference_programs(jm, jo)
    jy = paddle.to_tensor(y)

    tlog = tm(tx)
    if grads_in == "eval":
        jlog = jforward(jx)
    else:       # the training-mode forward is the step's
        jlog, jgrads = jstep(jx, jy)
    assert _share(tlog, np.asarray(jlog._value)) <= out_tol
    jstate = _state(jm)
    for n, b in tm.named_buffers():
        assert _share(b, jstate[n]) <= out_tol, n

    if grads_in == "eval":
        jm.eval()
        tm.eval()
        tlog = tm(tx)
        jlog, jgrads = jstep(jx, jy)
        assert _share(tlog, np.asarray(jlog._value)) <= OUT_TOL
    TF.cross_entropy(tlog, torch.from_numpy(y)).backward()
    jgrads = _torch_layout(jgrads)
    worst = max((_share(p.grad, jgrads[n]), n)
                for n, p in tm.named_parameters())
    assert worst[0] <= GRAD_TOL, worst
    to.step()
    jstate = _torch_layout(_state(jm))
    for n, p in tm.named_parameters():
        err = float(np.abs(p.detach().numpy() - jstate[n]).max())
        bound = (LR * GRAD_TOL * float(np.abs(jgrads[n]).max())
                 + PARAM_TOL * float(np.abs(jstate[n]).max()))
        assert err <= bound, (n, err, bound)

    # after the step (for resnet50 the eval-mode gradients move the
    # weights far enough that both packages' logits are NaN)
    jm.eval()
    tm.eval()
    with torch.no_grad():
        tlog = tm(tx).numpy()
    jlog = np.asarray(jforward(jx)._value)
    np.testing.assert_array_equal(np.isnan(tlog), np.isnan(jlog))
    ok = ~np.isnan(jlog)
    if ok.any():
        assert _share(torch.from_numpy(tlog[ok]), jlog[ok]) <= OUT_TOL


@pytest.mark.parametrize("name", ["resnet34", "resnext50_32x4d",
                                  "wide_resnet50_2"])
def test_constructors_match_reference_names_and_shapes(name):
    paddle.seed(0)
    jm = getattr(jvision.models, name)(num_classes=10)
    tm = getattr(tvision.models, name)(num_classes=10, device="cpu")
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    want["fc.weight"] = want["fc.weight"][::-1]       # [in, out] in paddle
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want


def test_pool_and_head_options():
    """``with_pool=False`` and ``num_classes=0`` leave the feature map, as
    in the reference."""
    _, tm = _pair("resnet18", num_classes=0, with_pool=False)
    assert tm(torch.zeros(1, 3, 64, 64)).shape == (1, 512, 2, 2)


def test_pretrained_and_bridge_refusals():
    with pytest.raises(NotImplementedError, match="download"):
        tvision.models.resnet50(pretrained=True, device="cpu")
    paddle.seed(0)
    state = _state(jvision.models.resnet18(num_classes=10))
    tm = tvision.models.resnet18(num_classes=10, device="cpu")
    missing = dict(state)
    del missing["layer2.1.bn2._variance"]
    with pytest.raises(KeyError, match="missing.*layer2.1.bn2._variance"):
        load_paddle_tpu_state(tm, missing)
    extra = dict(state, **{"layer2.1.bn2.num_batches_tracked": np.zeros(1)})
    with pytest.raises(KeyError, match="extra"):
        load_paddle_tpu_state(tm, extra)
    wrong = dict(state, **{"bn1._mean": np.zeros(65, np.float32)})
    with pytest.raises(ValueError, match="bn1._mean"):
        load_paddle_tpu_state(tm, wrong)
    # the fc weight arrives [in, out] and is transposed
    load_paddle_tpu_state(tm, state)
    np.testing.assert_array_equal(tm.fc.weight.detach().numpy(),
                                  state["fc.weight"].T)
