"""The device surface of the port (paddle_tpu_torch/device,
core/place.py) against the reference's (paddle_tpu/device).

- ``set_device`` / ``get_device`` / ``device_count`` /
  ``is_compiled_with_cuda``: ``set_device("cpu")`` is an explicit
  request for the CPU, after which ``resolve_device(None)`` returns it;
  without a card and without that request ``resolve_device(None)`` still
  raises (ROADMAP rule "Devices"); a card that is not there raises at
  ``set_device``;
- ``device.__all__`` is the reference's, ``device.cuda.__all__`` and
  ``device.xpu.__all__`` too, every name defined;
- on a host without a card: the device queries name the CPU, the memory
  calls read 0 (``memory_stats`` ``{}``, as the reference's CPU), and a
  stream or an event raises rather than falling back to the host; the
  reference's XPU stubs raise in both;
- with a stand-in card: the names and indices ``set_device`` /
  ``get_device`` / ``get_available_device`` report.
"""
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu.device as jdev

import paddle_tpu_torch.device as tdev
from paddle_tpu_torch.core import place
from paddle_tpu_torch.core.place import resolve_device


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(place, "_expected", None)


@pytest.fixture
def fake_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(place, "_expected", None)


@pytest.mark.parametrize("module", ["", ".cuda", ".xpu"])
def test_all_matches_the_reference(module):
    import importlib

    ref = importlib.import_module(f"paddle_tpu.device{module}")
    port = importlib.import_module(f"paddle_tpu_torch.device{module}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


def test_cpu_request_lets_resolve_device_return_the_cpu(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert tdev.get_device() == "cpu"
    assert tdev.set_device("cpu") == torch.device("cpu")
    assert resolve_device() == torch.device("cpu")
    assert tdev.get_device() == "cpu"
    # an explicit device still wins, and a card that is not there raises
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdev.set_device("gpu:0")
    with pytest.raises(ValueError, match="unsupported"):
        tdev.set_device("tpu")


def test_models_follow_set_device(no_card):
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1))
    tdev.set_device("cpu")
    m = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1))
    assert next(m.parameters()).device == torch.device("cpu")


def test_queries_without_a_card_as_the_reference(no_card):
    assert tdev.device_count() == 0
    assert tdev.get_all_device_type() == ["cpu"]
    assert tdev.get_available_device() == ["cpu"]
    assert tdev.get_all_custom_device_type() == []
    assert tdev.get_available_custom_device() == []
    assert tdev.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    for name in ("is_compiled_with_xpu", "is_compiled_with_ipu"):
        assert getattr(tdev, name)() is getattr(jdev, name)() is False
    assert tdev.is_compiled_with_custom_device("npu") is False
    tdev.synchronize()                       # nothing queued: a no-op
    tdev.cuda.synchronize()


def test_memory_calls_without_a_card(no_card):
    assert tdev.memory_stats() == {} == jdev.memory_stats()
    for name in ("memory_allocated", "memory_reserved",
                 "max_memory_allocated", "max_memory_reserved"):
        assert getattr(tdev, name)() == 0
        assert getattr(tdev.cuda, name)() == 0
    tdev.empty_cache()
    tdev.cuda.empty_cache()
    assert tdev.memory.get_device_properties() == {
        "name": "cpu", "platform": "cpu", "id": 0, "total_memory": 0}
    assert tdev.cuda.device_count() == 0


def test_streams_and_events_need_a_card(no_card):
    for make in (tdev.Stream, tdev.Event, tdev.current_stream,
                 tdev.cuda.get_device_name, tdev.cuda.get_device_properties,
                 tdev.cuda.get_device_capability):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()
    with pytest.raises(NotImplementedError):
        tdev.xpu.synchronize()
    with pytest.raises(NotImplementedError):
        jdev.xpu.synchronize()


def test_names_with_cards(fake_cards):
    assert tdev.device_count() == 2
    assert tdev.get_all_device_type() == ["cpu", "gpu"]
    assert tdev.get_available_device() == ["gpu:0", "gpu:1"]
    assert tdev.get_device() == "gpu:0"
    assert tdev.set_device("gpu:1") == torch.device("cuda", 1)
    assert tdev.get_device() == "gpu:1"
    assert resolve_device() == torch.device("cuda", 1)
    assert tdev.set_device("cuda") == torch.device("cuda", 0)
    assert tdev.cuda._index("gpu:1") == 1
    assert tdev.cuda._index(torch.device("cuda", 1)) == 1
    assert tdev.cuda._index(None) == 0
    assert tdev.cuda._priority(1) == -1 and tdev.cuda._priority(2) == 0
