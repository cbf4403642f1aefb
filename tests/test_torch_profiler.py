"""The profiler of the port (paddle_tpu_torch/profiler) against the
reference's (paddle_tpu/profiler).

- ``make_scheduler``'s windows and the ``Profiler``'s step state machine
  (states, ``on_trace_ready`` calls, window indices, the host spans each
  window kept) equal to the reference's for the same schedules, the
  port's windows running ``torch.profiler`` with CPU activity here;
- ``RecordEvent`` nesting (and its decorator form) gives the reference's
  span tree, and ``summary_table`` / ``collect_statistic`` over the same
  host events give identical text and items;
- the timer (``TimeAverager``, ``Benchmark``) as the reference's;
- the device side, which needs the card to record, on recorded data:
  ``kineto.device_trace_events`` over stand-in profiler events (kernels,
  copies, user annotations and host ranges), ``op_class`` /
  ``_base_name`` on
  the port's, cuBLAS's, cuDNN's, NCCL's and torch's kernel names, the
  device tables, ``statistic_from_trace`` and the chrome export.
"""
import json
import os

import pytest
import torch

import paddle_tpu.profiler as jprof
from paddle_tpu.profiler import host_tracer as jht
from paddle_tpu.profiler import statistic as jstat
from paddle_tpu.profiler import timer as jtimer

import paddle_tpu_torch.profiler as tprof
from paddle_tpu_torch.profiler import host_tracer as tht
from paddle_tpu_torch.profiler import kineto
from paddle_tpu_torch.profiler import statistic as tstat
from paddle_tpu_torch.profiler import timer as ttimer

PKGS = {"ref": jprof, "port": tprof}

SCHEDULES = [dict(closed=1, ready=1, record=2, repeat=1, skip_first=1),
             dict(closed=0, ready=0, record=2, repeat=3),
             dict(closed=2, ready=1, record=3),
             dict(closed=1, ready=0, record=1, repeat=2, skip_first=3)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_make_scheduler_windows(kw):
    got = {tag: [p.make_scheduler(**kw)(i).name for i in range(20)]
           for tag, p in PKGS.items()}
    assert got["port"] == got["ref"]


def _tree(roots):
    return [(e.name, e.type, _tree(e.children)) for e in roots]


def _drive_profiler(p, kw, steps=7):
    """A scheduled loop: each step a nested span; returns the states seen,
    the windows handed to on_trace_ready and each window's span tree."""
    fired = []
    prof = p.Profiler(targets=[p.ProfilerTarget.CPU],
                      scheduler=p.make_scheduler(**kw) if kw else None,
                      on_trace_ready=lambda pr: fired.append(
                          (pr.step_num, pr._span_idx, _tree(pr._events))))
    states = []
    prof.start()
    for i in range(steps):
        states.append(prof.current_state.name)
        with p.RecordEvent("work"):
            with p.RecordEvent(f"inner{i % 2}"):
                torch.ones(4) * 2
        prof.step()
    prof.stop()
    return states, fired, prof._span_idx


@pytest.mark.parametrize("kw", SCHEDULES[:3] + [None])
def test_profiler_windows_as_the_reference(kw):
    got = {tag: _drive_profiler(p, kw) for tag, p in PKGS.items()}
    assert got["port"] == got["ref"]
    assert got["port"][1]                 # at least one window fired


def test_record_event_tree_and_decorator():
    def run(p, ht):
        @p.RecordEvent("decorated")
        def f(x):
            with p.RecordEvent("in_fn", ht.TracerEventType.Forward):
                return x + 1

        tr = ht.get_host_tracer()
        tr.start()
        with p.RecordEvent("outer"):
            with p.RecordEvent("inner"):
                f(1)
            ev = p.RecordEvent("split")
            ev.begin()
            ev.end()
        assert f(2) == 3
        return _tree(tr.stop())

    assert run(tprof, tht) == run(jprof, jht)


def _host_events(ht):
    """The same span tree with fixed times, as each package's HostEvent."""
    E = ht.HostEvent

    def ev(name, start, end, *children):
        return E(name=name, type="UserDefined", start_ns=start, end_ns=end,
                 children=list(children))

    return [ev("step", 0, 9_000_000,
               ev("forward", 100_000, 4_100_000,
                  ev("matmul", 200_000, 1_200_000),
                  ev("matmul", 1_300_000, 3_300_000)),
               ev("backward", 4_200_000, 8_700_000)),
            ev("step", 10_000_000, 17_500_000,
               ev("forward", 10_100_000, 13_000_000)),
            ev("eval", 20_000_000, 20_250_000)]


@pytest.mark.parametrize("sorted_by", ["total", "avg"])
def test_summary_table_as_the_reference(sorted_by):
    assert tstat.summary_table(_host_events(tht), sorted_by=sorted_by) == \
        jstat.summary_table(_host_events(jht), sorted_by=sorted_by)
    t = {n: (i.calls, i.total_ns, i.max_ns, i.min_ns)
         for n, i in tstat.collect_statistic(_host_events(tht)).items()}
    j = {n: (i.calls, i.total_ns, i.max_ns, i.min_ns)
         for n, i in jstat.collect_statistic(_host_events(jht)).items()}
    assert t == j and t["matmul"] == (2, 3_000_000, 2_000_000, 1_000_000)
    assert [e.name for e in tht.flatten_events(_host_events(tht))] == \
        [e.name for e in jht.flatten_events(_host_events(jht))]


def test_timer_as_the_reference():
    out = []
    for mod in (ttimer, jtimer):
        avg = mod.TimeAverager()
        for sec, n in ((0.5, 32), (0.25, 32), (0.75, 64)):
            avg.record(sec, n)
        out.append((avg.get_average(), avg.get_ips_average()))
        avg.reset()
        out.append((avg.get_average(), avg.get_ips_average()))
    assert out[:2] == out[2:]
    assert out[0] == (0.5, 128 / 1.5)
    p = tprof.Profiler(timer_only=True)
    p.start()
    for _ in range(3):
        p.step(num_samples=4)
    assert "avg_batch_cost" in p.step_info() and p.step_num == 3
    p.stop()


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Ev:
    """A stand-in for torch.profiler's FunctionEvent."""

    def __init__(self, name, start, end, cuda=True, annotation=False):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.device_index = 0
        self.is_user_annotation = annotation
        self.time_range = _Range(start, end)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


FLASH = "void flash_fwd_tc_kernel<__nv_bfloat16, 128>(Params)"
DQ = "void flash_bwd_dq_tc_kernel<__nv_bfloat16, 128>(Params)"
RMS = "void rms_norm_fwd_vec_kernel<__nv_bfloat16, float, 4>(...)"
GEMM = "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT"
EW = ("void at::native::vectorized_elementwise_kernel<4, "
      "at::native::CUDAFunctor_add<c10::BFloat16>, ...>(int, ...)")


def _recorded():
    return _Prof([
        _Ev("ProfileStep#2", 0, 900, annotation=True),
        _Ev("train.step", 0, 880),                # a host range, laid on
        _Ev("aten::mm", 1, 5, cuda=False),       # the device by kineto
        _Ev(FLASH, 10, 110), _Ev(FLASH, 200, 300),
        _Ev(DQ, 400, 650),
        _Ev(RMS, 700, 705), _Ev(RMS, 710, 716), _Ev(RMS, 720, 723),
        _Ev(GEMM, 730, 800), _Ev(EW, 800, 810),
        _Ev("Memcpy HtoD (Pageable -> Device)", 820, 821),
        _Ev("Memset (Device)", 830, 830),
    ])


class TestDeviceTables:
    def test_device_trace_events_keep_kernels_and_copies(self):
        evs = kineto.device_trace_events(_recorded(), t0_us=1000.0,
                                         skip_names={"train.step"})
        assert [e["name"] for e in evs][:2] == [FLASH, FLASH]
        assert len(evs) == 10
        assert {e["tid"] for e in evs} == {"Kernels", "Memcpy", "Memset"}
        assert evs[0]["ts"] == 1010.0 and evs[0]["dur"] == 100
        assert evs[-1]["dur"] == 0.001          # a zero-length fill
        assert all(e["cat"] == "device" and e["pid"] == "/device:GPU:0"
                   for e in evs)

    def test_tables_by_kernel_and_by_class(self):
        evs = kineto.device_trace_events(_recorded(),
                                         skip_names={"train.step"})
        by_op = tstat.collect_device_statistic(evs, by="op")
        assert by_op["flash_fwd_tc_kernel"].calls == 2
        assert by_op["flash_fwd_tc_kernel"].total_ns == 200_000
        assert by_op["rms_norm_fwd_vec_kernel"].calls == 3
        by_class = tstat.collect_device_statistic(evs, by="class")
        assert by_class[tstat.PORT_CLASS].calls == 6
        assert by_class["matmul"].calls == 1
        assert by_class["data-movement"].calls == 2
        assert by_class["other"].calls == 1
        total = sum(i.total_ns for i in by_op.values())
        assert total == sum(i.total_ns for i in by_class.values())
        table = tstat.device_summary_table(evs, by="op")
        assert "flash_fwd_tc_kernel" in table and "Kernel" in table
        assert tstat.PORT_CLASS in tstat.device_summary_table(evs,
                                                              by="class")

    @pytest.mark.parametrize("name, cls", [
        (FLASH, tstat.PORT_CLASS), (DQ, tstat.PORT_CLASS),
        ("void vflash_bwd_dkv_tc_kernel<half, 64>(...)", tstat.PORT_CLASS),
        ("paged_decode_split_kernel", tstat.PORT_CLASS),
        ("tiled_mm_reduce_kernel", tstat.PORT_CLASS),
        ("rms_norm_dw_reduce_kernel", tstat.PORT_CLASS),
        (GEMM, "matmul"),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
         "matmul"),
        ("cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>",
         "matmul"),
        ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc",
         "convolution"),
        ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>(...)",
         "convolution"),
        ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(...)", "collective"),
        ("Memcpy DtoD (Device -> Device)", "data-movement"),
        ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<>",
         "data-movement"),
        ("triton_poi_fused_add_0", "fusion"),
        (EW, "other"),
        ("void at::native::reduce_kernel<512, 1>(...)", "other")])
    def test_op_class(self, name, cls):
        assert tstat.op_class(tstat._base_name(name)) == cls

    def test_base_name(self):
        assert tstat._base_name(FLASH) == "flash_fwd_tc_kernel"
        assert tstat._base_name(GEMM) == GEMM
        assert tstat._base_name("fusion.42") == "fusion"
        assert tstat._base_name("void at::native::(anonymous namespace)::"
                                "CatArrayBatchedCopy<float>(...)") == \
            "at::native::CatArrayBatchedCopy"
        assert tstat._base_name(EW) == \
            "at::native::vectorized_elementwise_kernel"

    def test_statistic_from_an_exported_trace(self, tmp_path):
        evs = kineto.device_trace_events(_recorded(),
                                         skip_names={"train.step"})
        host = [{"name": "ProfileStep#2", "ph": "X", "cat": "ProfileStep",
                 "ts": 0, "dur": 900, "pid": 1, "tid": 1}]
        path = tmp_path / "trace.json"
        path.write_text(json.dumps({"traceEvents": host + evs}))
        st = tprof.statistic_from_trace(str(path))
        assert st["flash_fwd_tc_kernel"].calls == 2
        assert "ProfileStep#2" not in st
        by_class = tprof.statistic_from_trace(str(path), by="class")
        assert by_class[tstat.PORT_CLASS].calls == 6


class TestExport:
    def test_chrome_export_and_window_files(self, tmp_path):
        p = tprof.Profiler(targets=[tprof.ProfilerTarget.CPU],
                           on_trace_ready=tprof.export_chrome_tracing(
                               str(tmp_path), worker_name="w"))
        for _ in range(2):
            p.start()
            with tprof.RecordEvent("span"):
                torch.ones(3) + 1
            p.stop()
        assert sorted(os.listdir(tmp_path)) == ["w_time_0.json",
                                                "w_time_1.json"]
        data = tprof.load_profiler_result(str(tmp_path / "w_time_1.json"))
        names = [ev["name"] for ev in data["traceEvents"]]
        assert "span" in names and "ProfileStep#0" in names
        assert p.device_events == []        # CPU target: no device lane
        table = p.summary()
        assert "span" in table and "Device" not in table
        assert p.get_summary() == tprof.summary_table(p._events)

    def test_targets_default_to_the_card_when_visible(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert tprof.Profiler().targets == [tprof.ProfilerTarget.CPU]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert tprof.Profiler().targets == [tprof.ProfilerTarget.CPU,
                                            tprof.ProfilerTarget.GPU]

    def test_sorted_keys_and_views_as_the_reference(self):
        assert vars(tprof.SortedKeys).items() >= {
            k: v for k, v in vars(jprof.SortedKeys).items()
            if not k.startswith("_")}.items()
        for enum in ("SummaryView", "ProfilerState", "ProfilerTarget"):
            assert [m.name for m in getattr(tprof, enum)] == \
                [m.name for m in getattr(jprof, enum)]
