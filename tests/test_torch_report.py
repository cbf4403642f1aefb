"""The metrics dump and its renderers in the port
(paddle_tpu_torch/observability/report.py and
paddle_tpu_torch/tools/metrics_report.py) against the reference's.

``render_report``, ``render_flight``, ``render_health``, ``sparkline``
and ``render_trend_table`` over the same dump dicts must give identical
text in both packages: a metrics dump with every metric kind, unit-aware
names, labels, the ``opt`` and ``cost`` tables, events and ``top``
trimming; flight dumps of every reason the renderer explains (with an
SLO breach's exemplars, a health alert's window, device memory and a
traceback); health views of a monitored dump, an alert dump, per-rank
lanes and an empty dump. The port's CLI prints what the reference's
``tools/metrics_report.py`` prints for the same files, and a live dump
of the port round-trips through both renderers.
"""
import contextlib
import importlib.util
import io
import json
import os

import pytest

from paddle_tpu.observability import report as jrep

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.observability import report as trep
from paddle_tpu_torch.tools import metrics_report as tcli

REPO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         os.pardir)
TS = 1_700_000_000.0


def _ref_cli():
    spec = importlib.util.spec_from_file_location(
        "_ref_metrics_report",
        os.path.join(REPO_ROOT, "tools", "metrics_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


METRICS = {
    "train.steps": {"kind": "counter", "series": [
        {"labels": {"name": "train"}, "value": 12},
        {"labels": {"name": "eval"}, "value": 3}]},
    "train.step_seconds": {"kind": "histogram", "series": [
        {"labels": {"name": "train"}, "count": 12, "sum": 1.3,
         "max": 0.2},
        {"labels": {}, "count": 0, "sum": 0.0, "max": 0.0},
        {"labels": {"name": "eval"}, "count": 3, "sum": 3.6, "max": 1.5}]},
    "train.mfu": {"kind": "gauge", "series": [
        {"labels": {"name": "train"}, "value": 0.31234}]},
    "device.hbm_bytes_in_use": {"kind": "gauge", "series": [
        {"labels": {"device": "0"}, "value": 17179869184},
        {"labels": {"device": "1"}, "value": 3 * 2**20},
        {"labels": {"device": "2"}, "value": 512},
        {"labels": {"device": "3"}, "value": None}]},
    "serve.queue_depth": {"kind": "gauge", "series": [
        {"labels": {"engine": f"e{i}"}, "value": i} for i in range(6)]},
    "serve.tokens_generated": {"kind": "counter", "series": [
        {"labels": {"engine": f"e{i}"}, "value": 10 * i} for i in range(5)]},
    "opt.findings_fixed": {"kind": "counter", "series": [
        {"labels": {"code": "PTL101"}, "value": 4},
        {"labels": {"code": "PTL103"}, "value": 1}]},
    "opt.findings_remaining": {"kind": "gauge", "series": [
        {"labels": {"code": "PTL101"}, "value": 0},
        {"labels": {"code": "PTL104"}, "value": 2}]},
    "cost.predicted_flops": {"kind": "gauge", "series": [
        {"labels": {"name": "main"}, "value": 1.5e12}]},
    "cost.measured_flops": {"kind": "gauge", "series": [
        {"labels": {"name": "main"}, "value": 1.4e12}]},
    "cost.model_flops_error_pct": {"kind": "gauge", "series": [
        {"labels": {"name": "main"}, "value": 7.1}]},
    "cost.predicted_peak_hbm_bytes": {"kind": "gauge", "series": [
        {"labels": {"name": "main"}, "value": 3 * 2**30}]},
    "cost.predicted_step_seconds": {"kind": "gauge", "series": [
        {"labels": {"name": "main"}, "value": 0.12}]},
    "cost.measured_step_seconds": {"kind": "gauge", "series": [
        {"labels": {"name": "main"}, "value": 0.13}]},
    "cost.comm_predicted_bytes": {"kind": "gauge", "series": [
        {"labels": {"name": "main", "kind": "all_reduce"}, "value": 2**28},
        {"labels": {"name": "main", "kind": "all"}, "value": 2**29}]},
    "cost.comm_predicted_seconds": {"kind": "gauge", "series": [
        {"labels": {"name": "main", "kind": "all_reduce"}, "value": 0.004}]},
    "health.alerts": {"kind": "counter", "series": [
        {"labels": {"rule": "step_time_drift",
                    "series": "train.step_seconds"}, "value": 1}]},
}

EVENTS = [{"ts": TS + i, "kind": "train.step", "name": "train", "step": i,
           "seconds": 0.1 + i / 100} for i in range(25)]

WINDOW = [[float(i), 100.0 + 20 * i] for i in range(8)]
SERIES = {
    "train.step_seconds": [[float(i), 0.1 + 0.01 * (i % 5)]
                           for i in range(40)],
    "train.step_seconds.p90": [[0.0, 0.2], [1.0, 0.25]],
    "device.hbm_watermark_bytes": [[float(i), 2.0**30 * (1 + i)]
                                   for i in range(5)],
    "serve.tokens_per_sec": [[0.0, 0.0], [1.0, 50.0]],
    "serve.queue_depth": [[0.0, 3.0]] * 3,
    "empty.series": [],
}
ALERTS = [{"rule": "leak", "rule_kind": "leak", "series": "test.wm",
           "code": "PTL602", "at": 7.0, "value": 240.0,
           "growth_pct": 140.0, "detail": "monotonic 100 -> 240"}]


def _metrics_dump():
    return {"version": 1, "generated_unix": TS, "enabled": True,
            "metrics": METRICS, "events": EVENTS,
            "timeseries": {"capacity": 512, "samples": 40,
                           "series": SERIES},
            "health_alerts": ALERTS}


def _flight(reason, context=None, exc=True, memory=True):
    d = {"kind": "flight_dump", "version": 1, "reason": reason,
         "generated_unix": TS, "pid": 4242, "argv": ["train.py"],
         "events": EVENTS[:7], "metrics": METRICS}
    if context is not None:
        d["context"] = context
    if exc:
        d["exception"] = {"type": "ValueError", "message": "boom",
                          "traceback": ["Traceback (most recent call):\n",
                                        "  File \"x.py\", line 1\n",
                                        "ValueError: boom\n"]}
    if memory:
        d["device_memory"] = {"bytes_in_use": 5 * 2**30,
                              "watermark_bytes": 7 * 2**30,
                              "bytes_limit": 80 * 2**30}
    return d


EXEMPLARS = {"n": 2, "worst_ttft": [
    {"id": 3, "ttft_seconds": 0.25, "preemptions": 1,
     "ttft_breakdown": {"queue": 0.2, "prefill": 0.05}}],
    "worst_latency": []}

FLIGHTS = {
    "step_exception": _flight("step_exception", {"step": 3}),
    "slo_breach": _flight("slo_breach", {"rule": "ttft_p99", "value": 0.25,
                                         "engine": "e0",
                                         "exemplars": EXEMPLARS}, exc=False),
    "health_alert": _flight("health_alert", {
        "rule": "leak", "code": "PTL602", "series": "test.wm",
        "value": 240.0, "window": WINDOW}, exc=False),
    "peer_death": _flight("peer_death", {"rank": 1}, memory=False),
    "rejoin": _flight("rejoin", None, exc=False),
    "straggler": _flight("straggler", {"rank": 2}),
    "unhandled_exception": _flight("unhandled_exception"),
}


class TestRenderersAgainstReference:
    @pytest.mark.parametrize("max_events, top", [(20, None), (5, 2),
                                                 (0, 1), (100, 0)])
    def test_render_report(self, max_events, top):
        d = _metrics_dump()
        assert trep.render_report(d, max_events=max_events, top=top) == \
            jrep.render_report(d, max_events=max_events, top=top)

    def test_render_report_empty_and_bad(self):
        for empty in ({"metrics": {}}, {}):
            assert trep.render_report(empty) == jrep.render_report(empty) \
                == "(no metrics recorded)"
        for bad in ({"metrics": []}, [], "x"):
            with pytest.raises(ValueError):
                trep.render_report(bad)

    @pytest.mark.parametrize("reason", sorted(FLIGHTS))
    def test_render_flight(self, reason):
        d = FLIGHTS[reason]
        for kw in ({}, {"max_events": 3, "top": 1}):
            assert trep.render_flight(d, **kw) == jrep.render_flight(d, **kw)
        with pytest.raises(ValueError):
            trep.render_flight(_metrics_dump())

    @pytest.mark.parametrize("which", ["metrics", "alert", "lanes", "empty"])
    def test_render_health(self, which):
        d = {"metrics": _metrics_dump(), "alert": FLIGHTS["health_alert"],
             "lanes": {"timeseries": {"train.step_seconds": {"lanes": {
                 "0": [[0.0, 0.1], [1.0, 0.12]],
                 "1": [[0.0, 0.3], [1.0, 0.31]]}}}},
             "empty": {}}[which]
        assert trep.render_health(d) == jrep.render_health(d)

    @pytest.mark.parametrize("values", [
        [], [1.0], [2.0, 2.0, 2.0], [0, 1, 2, 3, 4, 5, 6, 7],
        [float(i % 7) for i in range(100)], [3, "x", None, 1e9]])
    def test_sparkline(self, values):
        for width in (32, 5):
            assert trep.sparkline(values, width) == \
                jrep.sparkline(values, width)

    def test_render_trend_table(self):
        for title in ("Time-series", "Offending window"):
            assert trep.render_trend_table(SERIES, title) == \
                jrep.render_trend_table(SERIES, title)
        assert trep.render_trend_table({}) == [] == \
            jrep.render_trend_table({})


@pytest.fixture
def port_on():
    obs.reset()
    obs.enable()
    yield
    obs.disable()
    obs.reset()


class TestDumpRoundTrip:
    def test_live_dump_renders_the_same_in_both(self, port_on, tmp_path):
        clk = obs.FakeClock(start=1.0)
        for i in range(3):
            with obs.step_region("train", step=i, items=64, unit="tokens",
                                 flops=1e9, peak_flops=1e12, clock=clk):
                clk.advance(0.01 * (i + 1))
        obs.sample_device_memory()
        path = tmp_path / "metrics.json"
        d = obs.dump(str(path))
        loaded = json.loads(path.read_text())
        assert loaded["metrics"]["train.steps"] == d["metrics"]["train.steps"]
        assert trep.render_report(loaded) == jrep.render_report(loaded)
        assert "=== train ===" in obs.summary()
        assert "timeseries" not in d           # no monitor installed

    def test_dump_env_path(self, port_on, tmp_path, monkeypatch):
        path = tmp_path / "env.json"
        monkeypatch.setenv(trep.DUMP_ENV, str(path))
        obs.dump()
        assert json.loads(path.read_text())["version"] == trep.DUMP_VERSION


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


class TestCli:
    def test_cli_prints_what_the_reference_prints(self, tmp_path):
        ref = _ref_cli()
        (tmp_path / "m.json").write_text(json.dumps(_metrics_dump()))
        flights = tmp_path / "incident"
        flights.mkdir()
        for i, reason in enumerate(("step_exception", "health_alert",
                                    "peer_death")):
            (flights / f"flight-4242-{i + 1}.json").write_text(
                json.dumps(dict(FLIGHTS[reason], generated_unix=TS + i)))
        (tmp_path / "bad.json").write_text("[1, 2]")
        for argv in ([str(tmp_path / "m.json")],
                     [str(tmp_path / "m.json"), "--events", "3", "--top",
                      "2"],
                     [str(flights / "flight-4242-1.json")],
                     [str(flights)],
                     ["--health", str(tmp_path / "m.json")],
                     ["--health", str(flights)],
                     [str(tmp_path / "bad.json")],
                     [str(tmp_path / "missing.json")]):
            assert _run(tcli.main, argv) == _run(ref.main, argv), argv

    def test_cli_serve_trace_missing_file(self, tmp_path):
        rc, _ = _run(tcli.main, ["--serve-trace",
                                 str(tmp_path / "nothing.json")])
        assert rc == 1
