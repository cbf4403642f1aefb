"""The port's MobileNetV2, MobileNetV3 and ShuffleNetV2 against the
reference's on the CPU: one training step of each family's smallest
configuration, as ``test_torch_vision_zoo.py`` (tolerances in
``_torch_zoo.py``)."""
import pytest

from _torch_zoo import family_step, numpy_init, one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fast_reference_init(monkeypatch):
    numpy_init(monkeypatch)


@pytest.mark.parametrize("name", ["mobilenet_v2", "mobilenet_v3_small",
                                  "shufflenet_v2_x0_25"])
def test_step_matches_reference(name):
    family_step(name)
