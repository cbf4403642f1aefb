"""The port's DenseNet against the reference's on the CPU: one training
step of ``densenet121`` at 64 x 64, as ``test_torch_vision_zoo.py``
(tolerances in ``_torch_zoo.py``), and its dropout layers."""
import pytest
import torch

from _torch_zoo import (  # noqa: F401
    family_step, numpy_init, one_torch_thread, pair)


@pytest.fixture(autouse=True)
def _fast_reference_init(monkeypatch):
    numpy_init(monkeypatch)


def test_step_matches_reference():
    family_step("densenet121")


def test_densenet_dropout_layers():
    _, tm = pair("densenet121", num_classes=10, dropout=0.2)
    assert tm.blocks[0].dropout.p == 0.2
    x = torch.zeros(1, 3, 32, 32)
    with torch.no_grad():
        assert tm.eval()(x).shape == (1, 10)
