"""The port's LeNet, AlexNet, VGG, SqueezeNet and MobileNetV1
(paddle_tpu_torch/vision/models/) against the reference's
(paddle_tpu/vision/models/) on the CPU: one training step of each
family's smallest configuration from bridged weights and buffers
(``convert.load_paddle_tpu_state``), fp32 — the logits, batch-norm
statistics, gradients and parameters after one ``Momentum(0.1, 0.9)``
step (``_torch_zoo.step_matches_reference``; its docstring gives the
measured conditioning and the tolerances). The other families are in
``test_torch_vision_zoo_mobile.py`` (MobileNet v2 / v3, ShuffleNetV2),
``test_torch_vision_zoo_deep.py`` (DenseNet) and
``test_torch_vision_zoo_inception.py`` (GoogLeNet, InceptionV3); every
constructor's state names in ``test_torch_vision_zoo_names.py``.
"""
import pytest

from _torch_zoo import family_step, numpy_init, one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fast_reference_init(monkeypatch):
    numpy_init(monkeypatch)


@pytest.mark.parametrize("name", ["LeNet", "alexnet", "vgg11",
                                  "squeezenet1_1", "mobilenet_v1"])
def test_step_matches_reference(name):
    family_step(name)
