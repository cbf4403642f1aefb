"""Request tracing, SLO monitors and the serve-trace lint of the port
(paddle_tpu_torch/observability/{tracing,slo,flight,events,chrome}.py,
paddle_tpu_torch/static/analysis/{diagnostics,serve_trace_lint}.py).

The first classes mirror tests/test_tracing.py's cases on the port's
modules: span trees tile submit -> finish, validate_trace codes damage
(PTL403), the overhead guard (PTL402), the preempted chain, decode-gap
accounting, the Chrome lanes, exemplars, SLO rules, the latch,
min_samples, the breach dump (PTL401), PTL404/405 and the renderers.
``TestAgainstReference`` drives one hook sequence on a fake clock through
the reference's and the port's tracer and monitor and holds their dumps,
Chrome events, breaches and diagnostic reports equal. Everything runs on
a FakeClock: no wall-clock dependence.
"""
import json

import numpy as np
import pytest

import paddle_tpu.observability as jobs
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import tracing as jtr
from paddle_tpu.observability.fleet import merge_chrome_trace_files
from paddle_tpu.serve.engine import Request as JRequest
from paddle_tpu.static.analysis import lint_serve_trace as jlint

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.observability import slo as slo_mod
from paddle_tpu_torch.observability import tracing as tr_mod
from paddle_tpu_torch.observability.tracing import (
    RequestTrace, ServeTracer, TailExemplars, check_tracing_overhead,
    render_phase_table, render_serve_trace, validate_trace)
from paddle_tpu_torch.serve.engine import Request
from paddle_tpu_torch.static.analysis import (CODES, SERVE_TRACE_LINT_CODES,
                                              lint_serve_trace)

FakeClock = jobs.FakeClock


def _codes(report):
    return sorted({d.code for d in report})


class TestRequestTrace:
    def test_phases_tile_the_root_exactly(self):
        t = RequestTrace(7, 10.0)
        t.begin_phase("queue", 10.0)
        t.begin_phase("prefill", 10.4, slot=1)
        t.begin_phase("decode", 10.5, slot=1)
        t.finish(11.0, "eos")
        assert t.finished
        ph = t.phase_seconds()
        assert ph == pytest.approx(
            {"queue": 0.4, "prefill": 0.1, "decode": 0.5})
        assert sum(ph.values()) == pytest.approx(t.root.seconds)
        assert t.root.attrs["finish_reason"] == "eos"

    def test_attributed_seconds_clips_to_first_token(self):
        t = RequestTrace(0, 0.0)
        t.begin_phase("queue", 0.0)
        t.begin_phase("prefill", 1.0)
        t.begin_phase("decode", 1.5)
        t.first_token_time = 1.5
        t.finish(3.0)
        ttft = t.attributed_seconds(upto=1.5)
        assert ttft == pytest.approx({"queue": 1.0, "prefill": 0.5})
        assert sum(ttft.values()) == pytest.approx(1.5)

    def test_mutators_are_noops_after_finish(self):
        t = RequestTrace(0, 0.0)
        t.begin_phase("queue", 0.0)
        t.finish(1.0)
        assert t.begin_phase("decode", 2.0) is None
        t.annotate(bucket=8)
        assert len(t.root.children) == 1
        assert "bucket" not in t.root.children[0].attrs
        t.finish(9.0)
        assert t.root.end == 1.0

    def test_repeated_phases_accumulate(self):
        t = RequestTrace(0, 0.0)
        for i in range(3):
            t.begin_phase("decode", float(i), slot=0)
            t.begin_phase("preempt", i + 0.6)
        t.finish(3.0)
        ph = t.phase_seconds()
        assert ph["decode"] == pytest.approx(0.6 * 3)
        assert ph["preempt"] == pytest.approx(0.4 * 3)


def _doc(children, end=5.0):
    return {"id": 1, "spans": {"name": "request", "start": 0.0, "end": end,
                               "children": children}}


DAMAGE = [
    ([], 5.0, "no_phases"),
    ([{"name": "queue", "start": 0.0, "end": 1.0}], None, "root_open"),
    ([{"name": "teleport", "start": 0.0, "end": 1.0}], 5.0, "unknown_phase"),
    ([{"name": "decode", "start": 1.0, "end": None}], 5.0, "phase_open"),
    ([{"name": "decode", "start": 2.0, "end": 1.0}], 5.0, "negative_span"),
    ([{"name": "queue", "start": -1.0, "end": 1.0}], 5.0, "outside_root"),
    ([{"name": "queue", "start": 0.0, "end": 6.0}], 5.0, "outside_root"),
    ([{"name": "queue", "start": 0.0, "end": 2.0},
      {"name": "prefill", "start": 1.0, "end": 3.0}], 5.0, "overlap"),
]


class TestValidateTrace:
    def test_well_formed_tree_is_clean(self):
        doc = _doc([{"name": "queue", "start": 0.0, "end": 1.0},
                    {"name": "prefill", "start": 1.0, "end": 2.0},
                    {"name": "decode", "start": 2.0, "end": 5.0}])
        assert not validate_trace(doc).diagnostics

    @pytest.mark.parametrize("children,end,reason", DAMAGE)
    def test_damage_is_coded_with_reason(self, children, end, reason):
        report = validate_trace(_doc(children, end))
        assert _codes(report) == ["PTL403"]
        assert reason in [(d.suggestion or {}).get("reason")
                          for d in report]


class TestTracingOverheadGuard:
    def test_within_budget_is_clean(self):
        assert not check_tracing_overhead(
            98.0, 100.0, tolerance_pct=3.0, engine="tg1").diagnostics
        assert obs.registry.get("trace.overhead_pct").value(
            engine="tg1") == pytest.approx(2.0)

    def test_over_budget_emits_ptl402(self):
        report = check_tracing_overhead(90.0, 100.0, tolerance_pct=3.0,
                                        engine="tg2")
        assert _codes(report) == ["PTL402"]
        (d,) = list(report)
        assert d.suggestion["overhead_pct"] == pytest.approx(10.0)

    def test_zero_baseline_is_not_judged(self):
        assert not check_tracing_overhead(5.0, 0.0).diagnostics


def _req(cls, clk, rid=0):
    r = cls(id=rid, prompt=np.arange(1, 5, dtype=np.int32),
            max_new_tokens=4, submit_time=clk.time())
    r.ids = [int(x) for x in r.prompt]
    return r


class TestServeTracerHooks:
    def test_preempted_lifecycle_builds_the_canonical_chain(self):
        clk = FakeClock(tick=0.001)
        tr = ServeTracer("tt1", clk, max_slots=2)
        req = _req(Request, clk)
        tr.on_submit(req)
        tr.on_admit(req, 0, resumed=False)
        tr.on_prefill(req, bucket=8, tokens=4)
        tr.on_first_token(req, clk.time())
        req.first_token_time = req.trace.first_token_time
        tr.on_decode_begin(req)
        req.ids.append(5)
        tr.on_preempt(req)
        req.preemptions += 1
        tr.on_admit(req, 1, resumed=True)
        tr.on_prefill(req, bucket=8, tokens=4)   # resume -> recompute
        tr.on_decode_begin(req)
        req.finish_time = clk.time()
        req.finish_reason = "max_new_tokens"
        tr.on_finish(req)
        (doc,) = list(tr.requests)
        names = [c["name"] for c in doc["spans"]["children"]]
        assert names == ["queue", "prefill", "decode", "preempt",
                         "resume", "recompute", "decode"]
        assert not doc.get("malformed")
        assert doc["ttft_attributed_pct"] == pytest.approx(100.0)
        assert doc["latency_attributed_pct"] == pytest.approx(100.0)
        rec = [c for c in doc["spans"]["children"]
               if c["name"] == "recompute"]
        assert rec[0]["attrs"]["bucket"] == 8
        assert tr.n_traced == 1

    def test_decode_gap_counts_only_runnable_slots(self):
        clk = FakeClock()
        tr = ServeTracer("tt2", clk, max_slots=1)
        tr.on_decode_step(0.0, 0.01, active_after=1, queued=0)
        tr.on_decode_step(0.05, 0.06, active_after=0, queued=0)  # 40ms gap
        tr.on_decode_step(0.50, 0.51, active_after=1, queued=2)  # idle
        assert tr.total_decode_gap == pytest.approx(0.04)
        assert obs.registry.get("trace.decode_gap_seconds").value(
            engine="tt2") == pytest.approx(0.04)

    def test_chrome_export_lanes_and_merge(self, tmp_path):
        clk = FakeClock(tick=0.001)
        tr = ServeTracer("tt3", clk, max_slots=2)
        req = _req(Request, clk)
        tr.on_submit(req)
        tr.on_admit(req, 1, resumed=False)
        req.slot = 1
        tr.on_prefill(req, bucket=8, tokens=4)
        tr.on_decode_begin(req)
        req.finish_time = clk.time()
        tr.on_finish(req)
        tr.on_decode_step(clk.time(), clk.time(), active_after=0, queued=0)
        d = tr.chrome_trace_dict()
        assert set(d) == {"traceEvents", "displayTimeUnit"}
        xs = [e for e in d["traceEvents"] if e["ph"] == "X"]
        by_name = {e["name"]: e["tid"] for e in xs}
        assert by_name["queue"] == 0
        assert by_name["prefill"] == 2 and by_name["decode"] == 2
        assert by_name["decode_step"] == 3
        names = {(e.get("tid"), e["args"]["name"])
                 for e in d["traceEvents"] if e["ph"] == "M"
                 and e["name"] == "thread_name"}
        assert (0, "queue/preempt wait") in names
        assert (2, "slot 1") in names
        # the file reads back, and the reference's fleet merger takes it
        # as one of its own rank traces
        p = tmp_path / "serve_chrome.json"
        tr.write_chrome_trace(str(p))
        assert json.loads(p.read_text()) == d
        merged = merge_chrome_trace_files({0: str(p)},
                                          path=str(tmp_path / "m.json"))
        assert len(merged["traceEvents"]) >= len(xs)
        assert all(e["pid"] == 0 for e in merged["traceEvents"])

    def test_malformed_hooks_are_counted_not_raised(self):
        clk = FakeClock(tick=0.001)
        tr = ServeTracer("tt4", clk)
        req = _req(Request, clk)
        tr.on_submit(req)
        req.finish_time = None
        tr.on_finish(req)
        (doc,) = list(tr.requests)
        assert doc["malformed"]
        assert obs.registry.get("trace.spans_malformed").value(
            engine="tt4", reason="root_open") >= 1


def _ex_doc(rid, ttft, latency):
    return {"id": rid, "ttft_seconds": ttft, "latency_seconds": latency,
            "preemptions": 0, "ttft_breakdown": {"queue": ttft},
            "breakdown": {"decode": latency}}


class TestTailExemplars:
    def test_keeps_n_worst_sorted(self):
        ex = TailExemplars(2, engine="tex1")
        for rid, t in enumerate([0.1, 0.5, 0.3, 0.9]):
            ex.offer(_ex_doc(rid, t, t * 2))
        assert [d["id"] for d in ex.worst_ttft] == [3, 1]
        assert [d["id"] for d in ex.worst_latency] == [3, 1]
        assert obs.registry.get("trace.exemplars_kept").value(
            engine="tex1", kind="ttft") == 2
        text = ex.render()
        assert "worst TTFT" in text and "req 3" in text

    def test_unmeasured_requests_are_skipped(self):
        ex = TailExemplars(2, engine="tex2")
        ex.offer({"id": 9, "ttft_seconds": None, "latency_seconds": None})
        assert not ex.worst_ttft and not ex.worst_latency


def _rules(**over):
    base = dict(name="ttft", kind="ttft_p99", threshold=0.1,
                window_seconds=100.0, min_samples=3)
    base.update(over)
    return [base]


class TestSloMonitor:
    def test_parse_rules_json_file_and_env(self, tmp_path, monkeypatch):
        inline = '[{"name": "a", "kind": "ttft_p99", "threshold": 0.2}]'
        (r,) = slo_mod.parse_rules(inline)
        assert r.name == "a" and r.bound == "max"
        p = tmp_path / "rules.json"
        p.write_text(inline)
        assert slo_mod.parse_rules(str(p))[0].name == "a"
        monkeypatch.setenv(slo_mod.SLO_ENV, inline)
        assert slo_mod.rules_from_env()[0].name == "a"
        monkeypatch.delenv(slo_mod.SLO_ENV)
        assert slo_mod.rules_from_env() == []
        with pytest.raises(ValueError, match="unknown kind"):
            slo_mod.parse_rules([dict(name="x", kind="p95_vibes",
                                      threshold=1.0)])
        (tps,) = slo_mod.parse_rules([dict(
            name="tps", kind="tokens_per_sec", threshold=10.0)])
        assert tps.bound == "min"

    def test_breach_latches_once_per_excursion(self):
        clk = FakeClock()
        m = slo_mod.SloMonitor(_rules(), engine="tslo1", clock=clk)
        for _ in range(3):
            m.observe_ttft(0.5, now=clk.time())
        fired = m.on_step(tokens=5, now=clk.time())
        assert [b["rule"] for b in fired] == ["ttft"]
        assert m.on_step(tokens=5, now=clk.time()) == []
        assert obs.registry.get("trace.slo_breaches").value(
            engine="tslo1", rule="ttft") == 1
        assert _codes(m.report) == ["PTL401"]
        m._ttfts.clear()
        for _ in range(3):
            m.observe_ttft(0.01, now=clk.time())
        assert m.on_step(now=clk.time()) == []
        for _ in range(3):
            m.observe_ttft(0.7, now=clk.time())
        assert [b["rule"] for b in m.on_step(now=clk.time())] == ["ttft"]
        assert obs.registry.get("trace.slo_breaches").value(
            engine="tslo1", rule="ttft") == 2

    def test_min_samples_withholds_judgement(self):
        clk = FakeClock()
        m = slo_mod.SloMonitor(_rules(), engine="tslo2", clock=clk)
        m.observe_ttft(9.0, now=clk.time())
        m.observe_ttft(9.0, now=clk.time())
        assert m.on_step(now=clk.time()) == []

    def test_tokens_per_sec_floor_and_pool_rate(self):
        clk = FakeClock(tick=0.01)
        rules = [dict(name="tps", kind="tokens_per_sec", threshold=1e6,
                      window_seconds=100.0),
                 dict(name="pool", kind="pool_exhaustion_rate",
                      threshold=0.5, window_seconds=100.0)]
        m = slo_mod.SloMonitor(rules, engine="tslo3", clock=clk)
        fired = []
        for _ in range(4):
            fired += m.on_step(tokens=3, preemptions=1, now=clk.time())
        assert {b["rule"] for b in fired} == {"tps", "pool"}
        tps = next(b for b in fired if b["rule"] == "tps")
        assert tps["bound"] == "min" and tps["value"] < 1e6
        assert tps["rule_kind"] == "tokens_per_sec"

    def test_breach_dump_carries_exemplars(self, tmp_path, monkeypatch):
        monkeypatch.setenv(obs.flight.FLIGHT_DIR_ENV, str(tmp_path))
        monkeypatch.setattr(obs.state, "on", True)
        clk = FakeClock()
        ex = TailExemplars(2, engine="tslo4")
        ex.offer({"id": 1, "ttft_seconds": 0.4, "latency_seconds": 0.8,
                  "preemptions": 2, "ttft_breakdown": {"queue": 0.4},
                  "breakdown": {"decode": 0.8}})
        m = slo_mod.SloMonitor(_rules(), engine="tslo4", clock=clk,
                               exemplars=ex)
        for _ in range(3):
            m.observe_ttft(0.4, now=clk.time())
        assert m.on_step(now=clk.time())
        (p,) = sorted(tmp_path.glob("flight-*.json"))
        doc = json.loads(p.read_text())
        assert doc["reason"] == slo_mod.flight.REASON_SLO_BREACH
        assert doc["context"]["rule"] == "ttft"
        assert doc["context"]["exemplars"]["worst_ttft"][0]["id"] == 1
        # the breach event is on the export ring and in the dump's trail
        (e,) = [e for e in obs.events("trace.slo_breach")
                if e.fields["engine"] == "tslo4"]
        assert e.fields["rule"] == "ttft"
        assert any(r["kind"] == "trace.slo_breach" for r in doc["events"])


def _lint_dump(steps=(), requests=()):
    return {"kind": "serve_trace", "version": 1, "engine": "lint",
            "requests_traced": len(requests), "decode_gap_seconds": 0.0,
            "requests": list(requests), "decode_steps": list(steps),
            "exemplars": {}}


def _steps(n, dur=0.002, gap=0.0005, active=1):
    out, t = [], 0.0
    for _ in range(n):
        out.append({"start": t, "end": t + dur, "active": active,
                    "queued": 0})
        t += dur + gap
    return out


class TestServeTraceLint:
    def test_healthy_trace_is_clean(self):
        assert not lint_serve_trace(_lint_dump(steps=_steps(20))).diagnostics

    def test_gap_with_runnable_slots_is_ptl404(self):
        steps = _steps(5)
        stalled = dict(steps[-1])
        stalled["start"] = steps[-1]["end"] + 0.05
        stalled["end"] = stalled["start"] + 0.002
        report = lint_serve_trace(_lint_dump(steps=steps + [stalled]))
        assert _codes(report) == ["PTL404"]
        (d,) = list(report)
        assert d.suggestion["gap_seconds"] == pytest.approx(0.05, rel=0.1)

    def test_gap_while_drained_is_not_flagged(self):
        steps = _steps(5)
        steps[-1]["active"] = 0
        stalled = {"start": steps[-1]["end"] + 5.0,
                   "end": steps[-1]["end"] + 5.002, "active": 1,
                   "queued": 0}
        assert not lint_serve_trace(
            _lint_dump(steps=steps + [stalled])).diagnostics

    def test_systemic_stall_is_truncated_with_note(self):
        report = lint_serve_trace(_lint_dump(steps=_steps(20, gap=0.06)))
        warns = [d for d in report if d.severity.name == "WARNING"]
        notes = [d for d in report if d.severity.name == "NOTE"]
        assert len(warns) == 8 and len(notes) == 1
        assert notes[0].suggestion["suppressed"] == 19 - 8

    def test_preemption_thrash_is_ptl405(self):
        reqs = [{"id": 5, "preemptions": 4,
                 "breakdown": {"recompute": 0.12}},
                {"id": 6, "preemptions": 1, "breakdown": {}}]
        report = lint_serve_trace(_lint_dump(requests=reqs), thrash_k=3)
        assert _codes(report) == ["PTL405"]
        (d,) = list(report)
        assert d.suggestion == {"request": 5, "preemptions": 4}
        assert "recompute" in d.message

    def test_wrong_kind_raises(self):
        with pytest.raises(ValueError, match="serve_trace"):
            lint_serve_trace({"kind": "fleet_trace"})
        assert SERVE_TRACE_LINT_CODES == ("PTL404", "PTL405")


class TestRendering:
    def test_phase_table_and_serve_trace_render(self):
        docs = [{"id": i, "latency_seconds": 0.4,
                 "breakdown": {"queue": 0.1, "decode": 0.3}}
                for i in range(4)]
        table = render_phase_table(docs)
        assert "queue" in table and "p99 ms" in table and "share" in table
        dump = {"kind": "serve_trace", "engine": "r1",
                "requests_traced": 4, "decode_gap_seconds": 0.01,
                "requests": docs, "decode_steps": [],
                "exemplars": {"n": 2, "worst_ttft": [],
                              "worst_latency": []}}
        out = render_serve_trace(dump)
        assert "engine=r1" in out and "tail exemplars" in out
        with pytest.raises(ValueError, match="serve_trace"):
            render_serve_trace({"kind": "metrics"})

    def test_trace_env_gate(self, monkeypatch):
        for off in ("", "0", "false", "no", "off"):
            monkeypatch.setenv(tr_mod.TRACE_ENV, off)
            assert not tr_mod.trace_enabled_from_env()
        monkeypatch.setenv(tr_mod.TRACE_ENV, "1")
        assert tr_mod.trace_enabled_from_env()


# ---------------------------------------------------------------------------
# one hook sequence through both packages
# ---------------------------------------------------------------------------
def _report_rows(report):
    return [(d.code, int(d.severity), d.message, d.suggestion)
            for d in report]


def _drive_tracer(tracer_cls, request_cls, engine):
    """Three requests on one fake clock: one plain, one preempted and
    recomputed, one that finishes at its first token; decode steps with
    and without runnable slots left behind."""
    clk = FakeClock(tick=0.0005)
    tr = tracer_cls(engine, clk, max_slots=2, exemplars=2)
    reqs = [_req(request_cls, clk, rid) for rid in range(3)]
    for r in reqs:
        tr.on_submit(r)
    a, b, c = reqs
    for r, slot in ((a, 0), (b, 1)):
        r.slot = slot
        tr.on_admit(r, slot, resumed=False)
        tr.on_prefill(r, bucket=8, tokens=4)
        r.first_token_time = clk.time()
        tr.on_first_token(r, r.first_token_time)
        r.ids.append(7)
        tr.on_decode_begin(r)
    tr.on_decode_step(clk.time(), clk.time(), active_after=2, queued=1)
    tr.on_preempt(b)
    b.preemptions += 1
    b.slot = None
    tr.on_decode_step(clk.time() + 0.02, clk.time(), active_after=1,
                      queued=2)
    a.finish_time, a.finish_reason = clk.time(), "max_new_tokens"
    a.ids += [8, 9, 10]
    tr.on_finish(a)
    tr.on_decode_step(clk.time(), clk.time(), active_after=0, queued=2)
    b.slot = 0
    tr.on_admit(b, 0, resumed=True)
    tr.on_prefill(b, bucket=8, tokens=5)
    tr.on_decode_begin(b)
    c.slot = 1
    tr.on_admit(c, 1, resumed=False)
    tr.on_prefill(c, bucket=8, tokens=4)
    c.first_token_time = clk.time()
    tr.on_first_token(c, c.first_token_time)
    c.ids.append(2)
    c.finish_time, c.finish_reason = c.first_token_time, "eos"
    tr.on_finish(c)
    tr.on_decode_step(clk.time() + 0.05, clk.time(), active_after=1,
                      queued=0, tokens=4)
    b.ids += [3, 4, 5]
    b.finish_time, b.finish_reason = clk.time(), "max_new_tokens"
    tr.on_finish(b)
    return tr


def _drive_monitor(monitor_cls, engine, exemplars):
    clk = FakeClock(tick=0.01)
    rules = [dict(name="ttft", kind="ttft_p99", threshold=0.1,
                  window_seconds=100.0, min_samples=3),
             dict(name="tps", kind="tokens_per_sec", threshold=500.0,
                  window_seconds=100.0),
             dict(name="pool", kind="pool_exhaustion_rate", threshold=0.3,
                  window_seconds=100.0)]
    m = monitor_cls(rules, engine=engine, clock=clk, exemplars=exemplars)
    fired = []
    for i, (ttft, toks, pre) in enumerate(
            [(0.05, 8, 0), (0.3, 8, 1), (0.4, 0, 1), (0.02, 16, 0),
             (None, 16, 0), (0.6, 2, 1), (0.7, 0, 0)]):
        if ttft is not None:
            m.observe_ttft(ttft, now=clk.time())
        fired.append(m.on_step(tokens=toks, preemptions=pre,
                               now=clk.time()))
    return m, fired


class TestAgainstReference:
    def test_tracer_docs_and_chrome_events_equal(self):
        j = _drive_tracer(jtr.ServeTracer, JRequest, "xref_tr")
        t = _drive_tracer(ServeTracer, Request, "xref_tr")
        assert t.dump_dict() == j.dump_dict()
        assert t.chrome_trace_dict() == j.chrome_trace_dict()
        assert t.exemplars.render() == j.exemplars.render()
        assert render_serve_trace(t.dump_dict()) == \
            jtr.render_serve_trace(j.dump_dict())
        names = [c["name"] for c in
                 t.dump_dict()["requests"][-1]["spans"]["children"]]
        assert names == ["queue", "prefill", "decode", "preempt",
                         "resume", "recompute", "decode"]
        assert _report_rows(lint_serve_trace(t.dump_dict(), thrash_k=1)) \
            == _report_rows(jlint(j.dump_dict(), thrash_k=1))
        assert {d.code for d in lint_serve_trace(
            t.dump_dict(), min_gap_seconds=0.001, thrash_k=1)} == \
            {"PTL404", "PTL405"}

    @pytest.mark.parametrize("children,end,reason", DAMAGE)
    def test_validation_reports_equal(self, children, end, reason):
        assert _report_rows(validate_trace(_doc(children, end))) == \
            _report_rows(jtr.validate_trace(_doc(children, end)))

    def test_overhead_reports_equal(self):
        for on, off in ((98.0, 100.0), (90.0, 100.0), (5.0, 0.0)):
            assert _report_rows(check_tracing_overhead(on, off)) == \
                _report_rows(jtr.check_tracing_overhead(on, off))

    def test_monitor_breaches_and_reports_equal(self, tmp_path,
                                                monkeypatch):
        jex = _drive_tracer(jtr.ServeTracer, JRequest, "xref_slo").exemplars
        tex = _drive_tracer(ServeTracer, Request, "xref_slo").exemplars
        # each package's recorder numbers its dumps from 1 in this
        # process: one directory each
        monkeypatch.setenv(obs.flight.FLIGHT_DIR_ENV, str(tmp_path / "j"))
        jm, jfired = _drive_monitor(jslo.SloMonitor, "xref_slo", jex)
        monkeypatch.setenv(obs.flight.FLIGHT_DIR_ENV, str(tmp_path / "t"))
        tm, tfired = _drive_monitor(slo_mod.SloMonitor, "xref_slo", tex)
        assert tfired == jfired
        assert tm.breaches == jm.breaches
        assert {b["rule"] for b in tm.breaches} == {"ttft", "tps", "pool"}
        assert _report_rows(tm.report) == _report_rows(jm.report)
        assert obs.registry.get("trace.slo_breaches").value(
            engine="xref_slo", rule="ttft") == jobs.registry.get(
                "trace.slo_breaches").value(engine="xref_slo", rule="ttft")
        ctx = {}
        for side in "jt":
            dumps = [json.loads(p.read_text())
                     for p in (tmp_path / side).glob("flight-*.json")]
            assert {d["reason"] for d in dumps} == {"slo_breach"}
            ctx[side] = sorted(json.dumps(d["context"], sort_keys=True)
                               for d in dumps)
        assert len(ctx["t"]) == len(tm.breaches)
        assert ctx["t"] == ctx["j"]

    def test_codes_table_is_the_references(self):
        from paddle_tpu.static.analysis.diagnostics import CODES as JCODES

        assert CODES == JCODES
        assert set(tr_mod.TRACE_CODES + slo_mod.SLO_CODES
                   + SERVE_TRACE_LINT_CODES) <= set(CODES)
