"""Metric time-series and health monitoring of the port
(paddle_tpu_torch/observability/{timeseries,health}.py) against the
reference's.

Every case feeds the same series, on the same ``FakeClock``, through
the reference's and the port's ``SeriesRecorder`` / ``HealthMonitor``
(the cases of tests/test_health_monitoring.py:54-279): the recorded
points, and the findings (code, rule, series, value, one latch per
excursion), the ``health.alerts`` counts, the PTL60x diagnostics and the
``health_alert`` flight dumps must be equal. Then the hooks:
``step_region`` feeds the installed monitor once a step in both
packages, and a small CPU ``ServeEngine``'s ``step`` calls
``maybe_on_step`` once a step. No wall-clock sleeps.
"""
import json

import numpy as np
import pytest

import paddle_tpu.observability as jobs
from paddle_tpu.observability import health as jhealth
from paddle_tpu.observability import timeseries as jts

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.observability import health, timeseries

PKGS = {"ref": (jobs, jhealth, jts), "port": (obs, health, timeseries)}


@pytest.fixture
def both_on():
    for o, h, _ in PKGS.values():
        h.install(None)
        o.reset()
        o.enable()
    yield
    for o, h, _ in PKGS.values():
        h.install(None)
        o.disable()
        o.reset()


def _both(scenario, tmp_path=None, monkeypatch=None):
    """``scenario(o, h, ts)`` through each package; returns {tag: out}.
    With ``tmp_path``, each package gets its own flight directory (each
    numbers its dumps from 1) and the dumps are returned too."""
    out = {}
    for tag, (o, h, ts) in PKGS.items():
        if tmp_path is not None:
            d = tmp_path / tag
            monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(d))
        res = scenario(o, h, ts)
        if tmp_path is not None:
            res = (res, [json.loads(p.read_text())
                         for p in sorted(d.glob("flight-*.json"))])
        out[tag] = res
    return out


def _same(scenario, **kw):
    out = _both(scenario, **kw)
    assert out["port"] == out["ref"]
    return out["port"]


class TestSeriesRecorder:
    def test_counter_sampled_as_deltas_after_baseline(self, both_on):
        def run(o, h, ts):
            c = o.registry.counter("test.ts_port_requests", "probe")
            rec = ts.SeriesRecorder(capacity=8, clock=o.FakeClock(),
                                    tracked=("test.ts_port_requests",))
            c.inc(3)
            rec.sample(now=0.0)
            first = rec.values("test.ts_port_requests")
            c.inc(2)
            rec.sample(now=1.0)
            c.inc(5)
            rec.sample(now=2.0)
            return first, rec.window("test.ts_port_requests")

        assert _same(run) == ([], [(1.0, 2), (2.0, 5)])

    def test_gauge_sampled_as_level_max_across_labelsets(self, both_on):
        def run(o, h, ts):
            g = o.registry.gauge("test.ts_port_occupancy", "probe")
            g.set(10.0, pool="a")
            g.set(30.0, pool="b")
            rec = ts.SeriesRecorder(capacity=8, clock=o.FakeClock(),
                                    tracked=("test.ts_port_occupancy",))
            rec.sample(now=0.0)
            g.set(5.0, pool="b")
            rec.sample(now=1.0)
            return rec.values("test.ts_port_occupancy")

        assert _same(run) == [30.0, 10.0]

    def test_histogram_sampled_as_window_mean_and_p90(self, both_on):
        def run(o, h, ts):
            hist = o.registry.histogram("test.ts_port_latency", "probe",
                                        buckets=(0.1, 0.2, 0.3))
            rec = ts.SeriesRecorder(capacity=8, clock=o.FakeClock(),
                                    tracked=("test.ts_port_latency",))
            rec.sample(now=0.0)
            hist.observe(0.1)
            hist.observe(0.2)
            rec.sample(now=1.0)
            rec.sample(now=2.0)          # empty window: nothing recorded
            hist.observe(0.25)
            hist.observe(0.9)            # overflow bucket
            rec.sample(now=3.0)
            return (rec.window("test.ts_port_latency"),
                    rec.window("test.ts_port_latency.p90"))

        (mean, p90) = _same(run)
        assert [v for _, v in mean] == pytest.approx([0.15, 0.575])
        assert [v for _, v in p90] == pytest.approx([0.18, 0.3])

    def test_ring_evicts_at_capacity_and_serializes(self, both_on):
        def run(o, h, ts):
            rec = ts.SeriesRecorder(capacity=4, clock=o.FakeClock())
            for i in range(10):
                rec.record("test.ring", float(i), t=float(i))
            return (rec.values("test.ring"), rec.points_total(),
                    rec.to_dict(),
                    o.registry.get("ts.points_recorded").value(
                        series="test.ring"))

        vals, total, doc, points = _same(run)
        assert vals == [6.0, 7.0, 8.0, 9.0] and total == 4
        assert points == 10
        assert doc["series"]["test.ring"][0] == [6.0, 6.0]

    def test_sample_probes_host_ring_lengths(self, both_on):
        def run(o, h, ts):
            rec = ts.SeriesRecorder(capacity=8, clock=o.FakeClock(),
                                    tracked=())
            o.emit("probe.event")
            rec.sample(now=0.0)
            return rec.values("host.events_ring_len"), rec.names()

        vals, names = _same(run)
        assert vals == [1]
        assert names == ["host.events_ring_len", "host.flight_ring_len"]

    def test_merge_timeseries_keeps_rank_lanes(self):
        snaps = [{"rank": 0, "timeseries": {"series": {
                     "train.step_seconds": [[1.0, 0.1]]}}},
                 {"rank": 1, "timeseries": {"series": {
                     "train.step_seconds": [[1.5, 0.3]]}}},
                 {"rank": 2, "timeseries": None}]
        own = {"rank": "own", "timeseries": {"series": {"x.y": [[0, 1]]}}}
        assert timeseries.merge_timeseries(snaps, own) == \
            jts.merge_timeseries(snaps, own)


def _monitor(h, ts, o, rules):
    """A monitor over a manually-driven recorder (tracked=() so
    ``sample()`` adds only the host probes)."""
    return h.HealthMonitor(
        rules, recorder=ts.SeriesRecorder(capacity=32, clock=o.FakeClock(),
                                          tracked=()))


def _feed(mon, series, values):
    fired = []
    for i, v in enumerate(values):
        mon.recorder.record(series, float(v), t=float(i))
        fired += mon.on_step(now=float(i))
    return fired


def _findings(o, mon, fired):
    """What a detector run left: fired alerts, every alert, the report's
    (code, severity, message) and the health.alerts counts."""
    m = o.registry.get("health.alerts")
    counts = {} if m is None else {
        tuple(sorted(k)): v for k, v in m._series.items()}
    return (fired, list(mon.alerts),
            [(d.code, int(d.severity), d.message) for d in mon.report],
            counts)


DETECTOR_CASES = {
    # name: (rule kwargs, series values)
    "stationary_quiet": (dict(name="d", kind="drift", series="test.step"),
                         [0.1] * 20),
    "drift_up_ptl601": (dict(name="d", kind="drift", series="test.step"),
                        [0.1] * 12 + [0.2] * 8),
    "drift_down_ptl603": (dict(name="tps", kind="drift", series="test.tps",
                               direction="down"),
                          [1000.0] * 12 + [500.0] * 8),
    "leak_ptl602": (dict(name="leak", kind="leak", series="test.wm"),
                    [100.0 + 20 * i for i in range(10)]),
    "sawtooth_quiet": (dict(name="leak", kind="leak", series="test.wm"),
                       [100, 150, 200, 120, 180, 240, 130, 190, 250, 140]),
    "rate_ptl603": (dict(name="lost", kind="rate", series="test.lost",
                         threshold=5.0, window_points=8), [1.0] * 6),
    "latch_rearm": (dict(name="leak", kind="leak", series="test.ring",
                         min_points=4, min_growth_pct=10.0),
                    [1, 2, 3, 4, 5, 6, 3, 4, 5, 6]),
}


class TestDetectors:
    @pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
    def test_findings_equal(self, both_on, case):
        kw, values = DETECTOR_CASES[case]
        capacity = 4 if case == "latch_rearm" else 32

        def run(o, h, ts):
            mon = h.HealthMonitor(
                [h.HealthRule(**kw)],
                recorder=ts.SeriesRecorder(capacity=capacity,
                                           clock=o.FakeClock(), tracked=()))
            return _findings(o, mon, _feed(mon, kw["series"], values))

        fired, alerts, report, counts = _same(run)
        want = {"stationary_quiet": [], "sawtooth_quiet": [],
                "drift_up_ptl601": ["PTL601"],
                "drift_down_ptl603": ["PTL603"],
                "leak_ptl602": ["PTL602"], "rate_ptl603": ["PTL603"],
                "latch_rearm": ["PTL602", "PTL602"]}[case]
        assert [f["code"] for f in fired] == want
        assert [c for c, _, _ in report] == want
        assert sum(counts.values()) == len(want)
        if case == "leak_ptl602":
            assert fired[0]["growth_pct"] == pytest.approx(140.0)
        if case == "rate_ptl603":
            assert fired[0]["value"] == 5.0

    def test_malformed_series_files_ptl604_once(self, both_on):
        def run(o, h, ts):
            mon = _monitor(h, ts, o, [h.HealthRule("d", "drift",
                                                   "test.nan")])
            for i in range(10):
                mon.recorder.record("test.nan", 0.1, t=float(i))
            mon.recorder.record("test.nan", float("nan"), t=10.0)
            fired = mon.on_step(now=10.0) + mon.on_step(now=11.0)
            return _findings(o, mon, fired)

        fired, alerts, report, _ = _same(run)
        assert fired == [] and alerts == []
        assert [c for c, _, _ in report] == ["PTL604"]

    def test_alert_dumps_flight_with_window(self, both_on, tmp_path,
                                            monkeypatch):
        def run(o, h, ts):
            mon = _monitor(h, ts, o, [h.HealthRule("leak", "leak",
                                                   "test.wm")])
            return _feed(mon, "test.wm", [100.0 + 20 * i for i in range(10)])

        out = _both(run, tmp_path=tmp_path, monkeypatch=monkeypatch)
        (fired, jdumps), (tfired, tdumps) = out["ref"], out["port"]
        assert tfired == fired
        assert len(tdumps) == len(jdumps) == 1
        jd, td = jdumps[0], tdumps[0]
        assert td["reason"] == jd["reason"] == "health_alert"
        assert td["context"] == jd["context"]
        assert td["context"]["window"][0] == [0.0, 100.0]
        assert td["context"]["window"][-1] == [7.0, 240.0]
        assert "device_memory" in td

    def test_rules_parse_as_the_reference(self, tmp_path, monkeypatch):
        spec = [{"name": "a", "kind": "drift", "series": "x.y",
                 "direction": "down"},
                {"name": "b", "kind": "rate", "series": "x.z",
                 "threshold": 3.0}]
        path = tmp_path / "rules.json"
        path.write_text(json.dumps(spec))
        for s in (spec, json.dumps(spec), str(path), "1", "0", "", None,
                  spec[0]):
            got = [r.to_dict() for r in health.parse_rules(s)]
            assert got == [r.to_dict() for r in jhealth.parse_rules(s)]
        assert [r.to_dict() for r in health.default_rules()] == \
            [r.to_dict() for r in jhealth.default_rules()]
        monkeypatch.setenv(health.HEALTH_ENV, json.dumps(spec))
        assert [r.to_dict() for r in health.rules_from_env()] == \
            [r.to_dict() for r in jhealth.rules_from_env()]
        for bad in (dict(name="x", kind="spike", series="s"),
                    dict(name="x", kind="drift", series="s",
                         direction="sideways")):
            with pytest.raises(ValueError):
                health.HealthRule(**bad)
        assert health.HEALTH_CODES == jhealth.HEALTH_CODES
        assert health.RULE_KINDS == jhealth.RULE_KINDS

    def test_monitor_from_env_installs_and_reset_clears(self, both_on,
                                                        monkeypatch):
        monkeypatch.delenv(health.HEALTH_ENV, raising=False)
        assert health.monitor_from_env() is None
        monkeypatch.setenv(health.HEALTH_ENV, "1")
        mon = health.monitor_from_env()
        assert health.active_monitor() is mon
        assert [r.name for r in mon.rules] == \
            [r.name for r in jhealth.default_rules()]
        mon.recorder.record("test.x", 1.0, t=0.0)
        mon.alerts.append({"probe": 1})
        obs.reset()
        assert mon.recorder.names() == [] and mon.alerts == []


class TestHooks:
    def test_step_region_feeds_the_monitor_once_a_step(self, both_on):
        def run(o, h, ts):
            clk = o.FakeClock(start=5.0)
            mon = h.install(h.HealthMonitor(
                [h.HealthRule("step_time_drift", "drift",
                              "train.step_seconds")],
                recorder=ts.SeriesRecorder(
                    capacity=64, clock=clk,
                    tracked=("train.step_seconds", "train.steps"))))
            fired = []
            for i in range(20):
                with o.step_region("train", step=i, clock=clk):
                    clk.advance(0.1 if i < 12 else 0.3)
                fired.append(len(mon.alerts))
            h.install(None)
            return (mon.recorder.samples, mon.recorder.to_dict(),
                    [(a["code"], a["rule"], a["series"]) for a in mon.alerts],
                    fired)

        samples, doc, alerts, fired = _same(run)
        assert samples == 20
        assert alerts == [("PTL601", "step_time_drift",
                           "train.step_seconds")]
        # each step's sample holds that step's seconds (host clock)
        assert doc["series"]["train.step_seconds"][0][1] == \
            pytest.approx(0.1)

    def test_no_monitor_is_one_load(self):
        health.install(None)
        assert health.maybe_on_step(1.0) is None
        assert health.active_monitor() is None

    def test_serve_engine_step_feeds_the_monitor_once_a_step(
            self, both_on, monkeypatch):
        from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM, ServeEngine

        model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                                 device="cpu").eval()
        clk = obs.FakeClock(tick=0.001)
        eng = ServeEngine(model, max_slots=2, block_size=8, num_blocks=8,
                          max_seq_len=32, name="t_health", device="cpu",
                          clock=clk)
        mon = health.install(health.HealthMonitor(
            clock=clk,
            recorder=timeseries.SeriesRecorder(capacity=64, clock=clk)))
        hooks = []
        real = health.maybe_on_step

        def counting(now=None):
            hooks.append(now)
            return real(now)

        monkeypatch.setattr(health, "maybe_on_step", counting)
        rng = np.random.default_rng(0)
        for n in (5, 9, 3):
            eng.submit(rng.integers(1, 200, n), max_new_tokens=4)
        steps = 0
        while eng.has_work:
            eng.step()
            steps += 1
        assert steps > 1 and len(hooks) == steps
        assert mon.recorder.samples == steps
        assert hooks == sorted(hooks)          # the engine's clock
        # the serving gauges the default detectors read were sampled
        assert len(mon.recorder.values("serve.pool_occupancy")) == steps
        health.install(None)
