"""Request tracing and SLO monitors in the port's serving engine
(``ServeEngine(trace=, slo=)``, paddle_tpu_torch/serve/engine.py) against
the reference's engine on the CPU, on test_torch_serve_prefill.py's tiny
Llama and a fake clock:

- ``trace=True``: the phase sequence of every request (names and the
  ``slot`` / ``bucket`` / ``tokens`` / ``preemptions`` attributes) equals
  the reference's, every doc validates in both packages, the leaf phases
  tile each request's latency, every prefill span's bucket is
  ``prefill_bucket`` of its tokens, and ``decode_traces`` stays 1;
- ``slo=`` as a list, as inline JSON and through ``PADDLE_TPU_SLO``:
  the same breaches, reports and ``trace.slo_breaches`` counts as the
  reference's.
"""
import json

import numpy as np
import pytest
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu.observability as jobs
from paddle_tpu.observability.tracing import validate_trace as jvalidate
from paddle_tpu.serve import ServeEngine as JEngine

from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability.tracing import validate_trace
from paddle_tpu_torch.serve import ServeEngine
from paddle_tpu_torch.serve.engine import prefill_bucket

from test_torch_serve_prefill import S_MAX, VOCAB, llama  # noqa: F401


def _fake_clock_run(eng, clk, rng):
    """``_sequence``'s submissions, each scheduler step 10 ms of the fake
    clock apart (the clock does not move within a step)."""
    reqs, phases = [], [
        [(rng.randint(1, VOCAB, n), 4) for n in (5, 8, 13, 20)],
        None,
        [(rng.randint(1, VOCAB, 20), k) for k in (18, 17)]]
    for plans in phases:
        if plans is None:
            shared = reqs[3].prompt[:16]
            plans = [(np.concatenate([shared, rng.randint(1, VOCAB, n)]), 5)
                     for n in (2, 9)] + [(shared, 5)]
        reqs += [eng.submit(p, max_new_tokens=k) for p, k in plans]
        while eng.has_work:
            eng.step()
            clk.sleep(0.01)
    return reqs


def _phases(req):
    return [(c["name"], c.get("attrs", {}))
            for c in req.trace.root.to_dict()["children"]]


def test_trace_phase_sequences_equal_the_reference(llama):
    kw = dict(max_slots=2, block_size=4, num_blocks=16, max_seq_len=S_MAX,
              prefix_cache=True, trace=True)
    out = {}
    for side in ("j", "t"):
        clk = jobs.FakeClock(tick=0.001)
        jm, tm = llama
        eng = (JEngine(jm, name="j_traced", clock=clk, **kw) if side == "j"
               else ServeEngine(tm, name="t_traced", clock=clk,
                                device="cpu", **kw))
        out[side] = eng, _fake_clock_run(eng, clk, np.random.RandomState(9))
    (je, jreqs), (te, treqs) = out["j"], out["t"]
    assert [_phases(r) for r in treqs] == [_phases(r) for r in jreqs]
    assert te.tracer.n_traced == len(treqs) == je.tracer.n_traced
    assert te._n_preempts > 0 and te.decode_traces == 1
    names = {n for r in treqs for n, _ in _phases(r)}
    assert names == {"queue", "prefill", "decode", "preempt", "resume",
                     "recompute"}
    for doc in te.tracer.dump_dict()["requests"]:
        assert not validate_trace(doc).diagnostics
        assert not jvalidate(doc).diagnostics
        leaves = sum(c["seconds"] for c in doc["spans"]["children"])
        assert leaves == pytest.approx(doc["latency_seconds"], abs=1e-6)
        for c in doc["spans"]["children"]:
            a = c.get("attrs", {})
            if "bucket" in a:
                assert a["bucket"] == prefill_bucket(a["tokens"], S_MAX)
    assert len(te.tracer.decode_steps) == len(je.tracer.decode_steps)


RULES = [dict(name="ttft", kind="ttft_p99", threshold=0.015,
              window_seconds=1.0, min_samples=3),
         dict(name="tps", kind="tokens_per_sec", threshold=1e4,
              window_seconds=0.05),
         dict(name="pool", kind="pool_exhaustion_rate", threshold=0.01,
              window_seconds=0.5)]


@pytest.mark.parametrize("how", ["list", "json", "env"])
def test_slo_rules_breach_as_the_reference(llama, how, monkeypatch):
    slo = {"list": RULES, "json": json.dumps(RULES), "env": None}[how]
    if how == "env":
        monkeypatch.setenv("PADDLE_TPU_SLO", json.dumps(RULES))
    kw = dict(max_slots=2, block_size=4, num_blocks=16, max_seq_len=S_MAX,
              prefix_cache=True, slo=slo)
    out = {}
    for side in ("j", "t"):
        clk = jobs.FakeClock()
        jm, tm = llama
        eng = (JEngine(jm, name=f"j_slo_{how}", clock=clk, **kw)
               if side == "j" else
               ServeEngine(tm, name=f"t_slo_{how}", clock=clk, device="cpu",
                           **kw))
        _fake_clock_run(eng, clk, np.random.RandomState(9))
        out[side] = eng
    je, te = out["j"], out["t"]
    assert te.slo.breaches == [
        {**b, "engine": f"t_slo_{how}"} for b in je.slo.breaches]
    assert {b["rule"] for b in te.slo.breaches} == {"ttft", "tps", "pool"}
    assert [d.message.replace("t_slo", "j_slo") for d in te.slo.report] == \
        [d.message for d in je.slo.report]
    for rule in ("ttft", "tps", "pool"):
        assert tobs.registry.get("trace.slo_breaches").value(
            engine=f"t_slo_{how}", rule=rule) == jobs.registry.get(
                "trace.slo_breaches").value(engine=f"j_slo_{how}", rule=rule)
