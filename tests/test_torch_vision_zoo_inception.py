"""The port's GoogLeNet and InceptionV3 against the reference's on the
CPU: one training step of each, as ``test_torch_vision_zoo.py``
(tolerances in ``_torch_zoo.py``; GoogLeNet's training-mode forward
returns ``(out, aux1, aux2)``, its eval forward ``out``)."""
import pytest
import torch

from _torch_zoo import (  # noqa: F401
    family_step, numpy_init, one_torch_thread, pair)


@pytest.fixture(autouse=True)
def _fast_reference_init(monkeypatch):
    numpy_init(monkeypatch)


@pytest.mark.parametrize("name", ["googlenet", "inception_v3"])
def test_step_matches_reference(name):
    family_step(name)


def test_googlenet_eval_returns_the_logits_only():
    _, g = pair("googlenet", num_classes=10)
    with torch.no_grad():
        out = g.eval()(torch.zeros(1, 3, 64, 64))
    assert isinstance(out, torch.Tensor) and out.shape == (1, 10)
