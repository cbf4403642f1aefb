"""Step telemetry, device memory and FLOP counting of the port
(paddle_tpu_torch/observability/runtime.py, device/memory.py,
utils/flops.py) against the reference's.

- ``step_region`` / ``StepTimer`` under a ``FakeClock``, the split
  ``begin`` / ``end`` / ``abandon`` form and a step that fails, driven
  the same way through both packages: the ``train.*`` registry series
  (names, labels, values within 1e-12 relative) and the ``train.step`` /
  ``train.step_failed`` events must be equal, and both failed steps
  write a ``step_exception`` flight dump that holds ``device_memory``.
- The port's own timing on the card (CUDA events, resolved one step
  late) with the events replaced by a fake whose device times are set:
  the gauge reads the events' times, not the host's, and a step is
  recorded at the next step's exit or at ``flush_steps``.
- ``default_peak_flops``: the reference's 1e12 on the CPU and its
  override; 989e12 for the H100 SXM's name, and a ``ValueError`` naming
  the override for a card the port does not know.
- ``flops`` / ``register_flops`` / ``dynamic_flops`` equal to the
  reference's on the same shapes and layers; ``measure_step_flops`` of a
  2-layer Llama's forward and backward equal to the analytic count of
  ``_llama_step_flops``; the flash wrapper counts the work the
  reference's Pallas call declares.
- the memory calls on the CPU (``{}``, the live-tensor scan, monotone
  watermark gauges), ``vjp_residual_bytes`` and ``compiled_memory_stats``.
"""
import importlib
import json

import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu.observability as jobs
from paddle_tpu.observability import health as jhealth

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.device import memory as dev_mem
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import health, runtime
from paddle_tpu_torch.ops.cuda import flash_attention as fa

# ``utils.flops`` is also the name of a function in both ``utils``
jflops = importlib.import_module("paddle_tpu.utils.flops")
tflops = importlib.import_module("paddle_tpu_torch.utils.flops")

TRAIN_METRICS = ("train.step_seconds", "train.steps",
                 "train.items_per_second", "train.mfu")
STEP_EVENTS = ("train.step", "train.step_failed")


@pytest.fixture
def both_on():
    for pkg, hl in ((jobs, jhealth), (obs, health)):
        hl.install(None)
        pkg.reset()
        pkg.enable()
    yield
    for pkg, hl in ((jobs, jhealth), (obs, health)):
        hl.install(None)
        pkg.disable()
        pkg.reset()


def _drive_steps(pkg):
    """One sequence of bracketed steps on a ticking FakeClock."""
    clk = pkg.FakeClock(start=100.0, tick=0.125)
    with pkg.step_region("train", step=0, items=4096, unit="tokens",
                         flops=3e12, peak_flops=1e13, clock=clk, lr=0.1):
        clk.advance(0.5)
    with pkg.step_region("eval", items=64, clock=clk, shard="dp0"):
        clk.advance(0.03)
    with pytest.raises(ValueError):
        with pkg.step_region("train", step=1, clock=clk):
            raise ValueError("boom")
    timer = pkg.StepTimer("fit", flops_per_step=2e12, items_per_step=32,
                          unit="samples", peak_flops=5e12,
                          sample_memory_every=0, clock=clk)
    for i in range(3):
        with timer.region(epoch=i):
            clk.advance(0.1 * (i + 1))
    timer.begin()
    timer.abandon()
    timer.begin()
    clk.advance(0.2)
    timer.end(items=16)
    timer.begin()
    timer.begin()               # supersedes (abandons) the open region
    timer.end(failed=True)
    timer.end()                 # end without begin: a no-op
    return timer.count


def _series(pkg):
    reg = pkg.registry.to_dict()
    return {n: reg[n]["series"] for n in TRAIN_METRICS if n in reg}


def _events(pkg):
    out = []
    for e in pkg.events():
        if e.kind in STEP_EVENTS:
            out.append((e.kind, dict(e.fields)))
    return out


def _close(a, b, path="value"):
    """Equal structure; floats within 1e-12 relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, rel=1e-12, abs=0), path
    else:
        assert a == b, path


class TestStepRegionAgainstReference:
    def test_registry_and_events_equal(self, both_on, tmp_path, monkeypatch):
        dumps = {}
        for tag, pkg in (("ref", jobs), ("port", obs)):
            # each package numbers its dumps from 1: one directory each
            d = tmp_path / tag
            monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(d))
            count = _drive_steps(pkg)
            assert count == 7
            dumps[tag] = [json.loads(p.read_text())
                          for p in sorted(d.glob("flight-*.json"))]
        _close(_series(jobs), _series(obs))
        assert set(_series(obs)) == set(TRAIN_METRICS)
        _close(_events(jobs), _events(obs))
        kinds = [k for k, _ in _events(obs)]
        assert kinds.count("train.step") == 6
        assert kinds.count("train.step_failed") == 2
        # the failed region of step_region dumps; StepTimer.end(failed)
        # dumps too, with the synthesized RuntimeError
        assert len(dumps["ref"]) == len(dumps["port"]) == 2
        for jd, td in zip(dumps["ref"], dumps["port"]):
            assert td["reason"] == jd["reason"] == "step_exception"
            assert td["exception"]["type"] == jd["exception"]["type"]
            assert td["exception"]["message"] == jd["exception"]["message"]
            assert sorted(td["device_memory"]) == sorted(jd["device_memory"])

    def test_disabled_is_a_shared_no_op(self):
        obs.reset()
        obs.disable()
        r = obs.step_region("probe", items=10, flops=1e9)
        assert r is obs.step_region("other")
        with r:
            pass
        assert obs.registry.get("train.step_seconds").to_dict()["series"] \
            == []
        assert obs.events() == []


class _FakeEvent:
    """A CUDA event stand-in: ``record`` stamps the next preset device
    time; ``synchronize`` counts the waits."""

    stamps = []
    waits = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = _FakeEvent.stamps.pop(0)

    def synchronize(self):
        _FakeEvent.waits += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class TestDeviceTimedSteps:
    def test_events_resolved_one_step_late_and_at_flush(self, both_on,
                                                        monkeypatch):
        monkeypatch.setattr(runtime, "_card_in_use", lambda: True)
        monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
        # device start / end of three steps (s); the host clock is real
        _FakeEvent.stamps = [1.0, 1.5, 1.5, 1.75, 1.75, 2.5]
        _FakeEvent.waits = 0
        t = obs.StepTimer("dev", items_per_step=100, unit="tokens",
                          flops_per_step=1e12, peak_flops=1e13,
                          sample_memory_every=0)
        hist = obs.registry.get("train.step_seconds")
        counts = []
        for _ in range(3):
            with t.region():
                pass
            counts.append(hist.stats(name="dev")["count"])
        assert counts == [0, 1, 2]           # each step one step late
        t.flush()
        st = hist.stats(name="dev")
        assert st["count"] == 3
        assert st["sum"] == pytest.approx(0.5 + 0.25 + 0.75)
        assert _FakeEvent.waits == 3
        evs = [e.fields for e in obs.events("train.step")]
        assert [e["step"] for e in evs] == [0, 1, 2]
        assert [e["seconds"] for e in evs] == pytest.approx(
            [0.5, 0.25, 0.75])
        assert evs[1]["tokens_per_second"] == pytest.approx(400.0)
        assert evs[2]["mfu"] == pytest.approx(1e12 / 0.75 / 1e13, abs=1e-5)
        t.flush()                             # nothing left: no-op
        assert hist.stats(name="dev")["count"] == 3

    def test_dump_records_the_pending_step(self, both_on, monkeypatch):
        monkeypatch.setattr(runtime, "_card_in_use", lambda: True)
        monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
        _FakeEvent.stamps = [0.0, 0.125]
        with obs.step_region("dump"):
            pass
        d = obs.dump_dict()
        (series,) = d["metrics"]["train.step_seconds"]["series"]
        assert series["count"] == 1 and series["sum"] == 0.125


class TestPeakFlops:
    def test_cpu_and_override_as_the_reference(self, monkeypatch):
        monkeypatch.delenv(runtime.PEAK_FLOPS_ENV, raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert obs.default_peak_flops() == jobs.default_peak_flops() == 1e12
        monkeypatch.setenv(runtime.PEAK_FLOPS_ENV, "4.5e14")
        assert obs.default_peak_flops() == jobs.default_peak_flops() == 4.5e14

    @pytest.mark.parametrize("name, peak", [
        ("NVIDIA H100 80GB HBM3", 989e12),
        ("NVIDIA A100-SXM4-80GB", None),
        ("NVIDIA H100 PCIe", None)])
    def test_card_peak_from_its_name(self, monkeypatch, name, peak):
        monkeypatch.delenv(runtime.PEAK_FLOPS_ENV, raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: name)
        if peak is None:
            with pytest.raises(ValueError, match=runtime.PEAK_FLOPS_ENV):
                obs.default_peak_flops()
        else:
            assert obs.default_peak_flops() == peak
        monkeypatch.setenv(runtime.PEAK_FLOPS_ENV, "1e15")
        assert obs.default_peak_flops() == 1e15


FLOP_CASES = [
    ("matmul", {"X": [(4, 8, 16)], "Y": [(16, 32)]}, {}),
    ("matmul_v2", {"x": [(8, 16)], "y": [(32, 16)]}, {"trans_y": True}),
    ("conv2d", {"Input": [(2, 3, 32, 32)], "Filter": [(8, 3, 3, 3)]},
     {"strides": [2, 2], "paddings": [1, 1]}),
    ("relu", {"X": [(4, 5)]}, {}),
    ("softmax", {"X": [(2, 3, 7)]}, {}),
    ("layer_norm", {"X": [(6, 10)]}, {}),
    ("embedding", {"W": [(100, 16)]}, {}),
    ("unknown_op", {"X": [(3,)]}, {}),
]


class TestFlops:
    @pytest.mark.parametrize("op, shapes, attrs", FLOP_CASES,
                             ids=[c[0] for c in FLOP_CASES])
    def test_flops_table_as_the_reference(self, op, shapes, attrs):
        assert tflops.flops(op, shapes, attrs) == \
            jflops.flops(op, shapes, attrs)

    def test_register_flops(self):
        @tflops.register_flops("test_probe_op")
        def _probe(shapes, attrs):
            return 7 * shapes["X"][0][0]

        assert tflops.flops("test_probe_op", {"X": [(3,)]}, {}) == 21

    def test_dynamic_flops_as_the_reference_on_lenet(self, capsys,
                                                     monkeypatch):
        from _torch_zoo import numpy_init
        from paddle_tpu.vision.models import LeNet as JLeNet

        from paddle_tpu_torch.vision.models import LeNet

        numpy_init(monkeypatch, zeros=True)   # no jax.random compiles
        ref = jflops.dynamic_flops(JLeNet(), [2, 1, 28, 28])
        port = tflops.dynamic_flops(LeNet(device="cpu"), [2, 1, 28, 28])
        assert port == ref > 0
        out = capsys.readouterr().out.splitlines()
        assert out[0] == out[1]        # "Total Flops: ... Total Params: ..."

    def test_flash_forward_counts_the_declared_work(self):
        b, h, s, d = 2, 2, 16, 64
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(b, h, s, d, generator=g) for _ in range(3))
        n = tflops.count_flops(fa._flash_fwd_bhsd, q, k, v, causal=True,
                               scale=0.125)
        assert n == 4 * b * h * s * s * d
        # the plain composition alone counts its own products
        assert tflops.count_flops(fa._flash_fwd_reference, q, k, v,
                                  causal=True, scale=0.125) > 0

    def test_nested_kernel_work_counts_the_outer_figure(self):
        a = torch.ones(4, 8)

        def fn():
            with tflops.kernel_work(100):
                a @ a.t()
                with tflops.kernel_work(7):
                    a @ a.t()
            a @ a.t()                  # outside: counted, 2*4*8*4

        assert tflops.count_flops(fn) == 100 + 2 * 4 * 8 * 4


def _llama_step_flops(cfg, batch, seq, chunk=2048):
    """The analytic count of one forward + backward of the port's Llama
    under utils/flops.py's convention: every linear layer of the
    decoder 6 * T * in * out (forward, and dX and dW); the lm head
    through the fused loss 8 * Tp * H * V, where Tp is T padded up to
    the loss's 2048-row chunks (each chunk's product is recomputed in the
    backward: forward, recompute, dX, dW); the flash forward 4 * B * H *
    S * S * D a layer (the reference's declared cost) and nothing for its
    backward, RMSNorm, RoPE, SwiGLU or the embedding."""
    h, i, nl = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    heads, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    d = h // heads
    t = batch * seq
    linear = h * heads * d + 2 * h * kvh * d + heads * d * h + 3 * h * i
    tp = -(-t // chunk) * chunk
    return (6 * t * nl * linear + 8 * tp * h * cfg.vocab_size
            + 4 * batch * heads * seq * seq * d * nl)


class TestMeasureStepFlops:
    def test_llama_forward_backward_equals_the_analytic_count(self):
        cfg = LlamaConfig.tiny(hidden_size=128, num_attention_heads=2,
                               num_key_value_heads=2, num_hidden_layers=2)
        model = LlamaForCausalLM(cfg, device="cpu")
        ids = torch.randint(0, cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(0))
        calls = []
        real = fa._flash_fwd_bhsd

        def counting(*a, **k):
            calls.append(1)
            return real(*a, **k)

        def step():
            loss, _ = model(ids, labels=ids)
            loss.backward()

        fa._flash_fwd_bhsd, saved = counting, fa._flash_fwd_bhsd
        try:
            n = obs.measure_step_flops(step)
        finally:
            fa._flash_fwd_bhsd = saved
        assert len(calls) == 2               # the flash gate passed: D 64
        assert n == _llama_step_flops(cfg, 2, 16) == 581435392
        timer = obs.StepTimer("llama")
        assert timer.measure_flops(step) == n == timer.flops_per_step

    def test_never_raises(self):
        def bad():
            raise RuntimeError("no")

        assert obs.measure_step_flops(bad) == 0
        assert obs.measure_step_flops(lambda: None) == 0


class TestDeviceMemory:
    def test_memory_calls_on_the_cpu(self):
        assert dev_mem.memory_stats() == {}
        assert dev_mem.memory_stats(device_id=9999) == {}
        assert dev_mem.memory_allocated() == 0
        assert dev_mem.max_memory_reserved() == 0
        assert dev_mem.get_device_properties()["platform"] in ("cpu", "gpu")
        dev_mem.empty_cache()

    def test_live_tensor_scan_tracks_allocations(self):
        base = dev_mem.live_array_bytes()
        keep = torch.ones(512, 512)          # 1 MiB
        assert dev_mem.live_array_bytes() >= base + keep.numel() * 4
        view = keep[:10]                     # a view: its storage once
        assert dev_mem.live_array_bytes() < base + 2 * keep.numel() * 4
        del keep, view

    def test_sample_sets_gauges_and_watermark_is_monotone(self, both_on):
        keep = torch.ones(256, 256)
        s1 = obs.sample_device_memory()
        assert s1["bytes_in_use"] > 0 and s1["bytes_limit"] == 0
        del keep
        s2 = obs.sample_device_memory()
        assert s2["watermark_bytes"] >= s1["watermark_bytes"]
        assert s2["watermark_bytes"] >= s2["bytes_in_use"]
        g = obs.registry.get
        assert g("device.hbm_bytes_in_use").value(device="0") == \
            s2["bytes_in_use"]
        assert g("device.hbm_watermark_bytes").value(device="0") == \
            s2["watermark_bytes"]

    def test_vjp_residual_bytes_and_recompute(self):
        w = torch.randn(64, 64)
        x = torch.randn(32, 64)

        def f(x, w):
            return torch.tanh(torch.tanh(x @ w) @ w).sum()

        def f_ckpt(x, w):
            from torch.utils.checkpoint import checkpoint

            return checkpoint(f, x, w, use_reentrant=False)

        full = dev_mem.vjp_residual_bytes(f, x, w)
        # x, w and the two tanh outputs at least
        assert full >= (2 * 32 * 64 + 64 * 64) * 4
        assert dev_mem.vjp_residual_bytes(f_ckpt, x, w) < full

    def test_compiled_memory_stats_without_a_graph(self):
        from paddle_tpu_torch import jit

        assert dev_mem.compiled_memory_stats(object()) == {}
        fn = jit.to_static(lambda a: a * 2)
        fn(torch.ones(4))                    # the CPU captures nothing
        assert dev_mem.compiled_memory_stats(fn, torch.ones(4)) == {}
