"""The captured decode paths of the port on the CPU: the serving engine's
fixed-shape tick and bursts (one graph per engine, or one per
power-of-two burst length), its sink block, ``warm_burst`` /
``warm_engine``, and ``generate``'s device-side tick state, against the
reference where it has a counterpart.

On the CPU a ``Graphed`` call runs its function eagerly on its static
buffers (``jit/_capture.py``), so these tests run every piece of the
captured paths but the CUDA graph itself: the packed slot state, the
fixed-shape tick in which every slot writes, the device counters of
``generate``'s ticks, the trace counts. The graphs run on the card
(chip_smoke.py's ``[serve]`` and ``[generate]`` phases).

Greedy streams under slot churn are held against an oracle that does not
vary from run to run: the reference model's full-prefix forward over the
port's own stream (fp32, the same bridged weights), token for token
wherever the reference's top two logits are apart (``_hold_to_oracle``).
The reference engine's own greedy stream is not the oracle: in whole
runs of the suite it has left the full-prefix argmax (by 0.35 of a logit,
not a rounding tie) where the port's stream kept it. ``generate``'s
greedy streams are compared with the reference's token for token;
sampled streams are held within the port.
"""
import gc
import weakref

import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serve import ServeEngine as JEngine

from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.jit import _capture
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.serve import ServeEngine, warm_engine

_TINY = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JLlama(JConfig.tiny(**_TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(**_TINY), device="cpu").eval()
    load_paddle_tpu_state(
        tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


def _plans():
    """The churn's requests: (prompt, max_new_tokens), in arrival order."""
    rng = np.random.RandomState(21)
    return [(rng.randint(1, 97, n), k) for n, k in
            [(7, 9), (3, 12), (11, 6), (5, 10), (9, 7), (2, 11)]]


def _drive(eng, eos):
    """Slot churn on ``eng``: three requests at once, the rest arriving
    mid-flight every third step; the engine's streams."""
    plans = _plans()
    reqs = [eng.submit(p, max_new_tokens=k, eos_token_id=eos)
            for p, k in plans[:3]]
    pending, steps = list(plans[3:]), 0
    while eng.has_work or pending:
        if pending and steps % 3 == 2:
            p, k = pending.pop(0)
            reqs.append(eng.submit(p, max_new_tokens=k, eos_token_id=eos))
        eng.step()
        steps += 1
    return [r.output_ids for r in reqs]


def _churn(model, jax_side, burst=1, eos=None, name="t_churn"):
    """Slot churn: arrivals mid-flight, finishes, and a pool small enough
    to preempt."""
    kw = dict(max_slots=3, block_size=4, num_blocks=8, max_seq_len=32,
              name=f"{name}{burst}", decode_burst=burst)
    eng = (JEngine(model, **kw) if jax_side
           else ServeEngine(model, device="cpu", **kw))
    return _drive(eng, eos), eng


#: a step where the reference's top two logits are at most this far apart
#: (fp32 logits of order 1; the two packages' sums differ near 1e-6) may
#: emit either of the two tokens
NEAR_TIE_MARGIN = 1e-4
#: the most such steps one churn run may have
NEAR_TIE_CAP = 2


def _hold_to_oracle(jm, streams, eos=None):
    """Each request's greedy stream against the reference model's
    full-prefix forward over the prompt and the stream itself (one causal
    forward a request: the logits at each position pick the next token).
    Every token must be the reference's argmax, or the runner-up within
    ``NEAR_TIE_MARGIN`` of it; such steps are printed and at most
    ``NEAR_TIE_CAP`` are allowed. A stream ends at ``max_new_tokens``, or
    at its first ``eos``. Returns the near-tie steps."""
    near = []
    for i, ((prompt, k), toks) in enumerate(zip(_plans(), streams)):
        assert 0 < len(toks) <= k
        assert eos not in toks[:-1]
        assert len(toks) == k or toks[-1] == eos
        ids = np.concatenate([prompt, np.asarray(toks, "int64")])[None]
        logits = np.asarray(jm(paddle.to_tensor(ids)).numpy())[0]
        for t, tok in enumerate(toks):
            row = logits[len(prompt) - 1 + t]
            top = int(row.argmax())
            if tok == top:
                continue
            gap = float(row[top] - row[tok])
            runner_up = float(np.sort(row)[-2])
            assert row[tok] == runner_up and gap <= NEAR_TIE_MARGIN, (
                f"request {i}, new token {t}: {tok} is {gap:.4g} below the "
                f"reference's argmax {top}")
            near.append((i, t, tok, top, gap))
    if near:
        print(f"near-tie steps (request, step, token, argmax, gap): {near}")
    assert len(near) <= NEAR_TIE_CAP, near
    return near


def test_one_trace_under_slot_churn(models):
    jm, tm = models
    _, jeng = _churn(jm, True)
    got, eng = _churn(tm, False)
    _hold_to_oracle(jm, got)
    assert eng._n_preempts > 0 and jeng.decode_traces == 1
    assert eng.decode_traces == 1
    assert eng.prefill_traces == jeng.prefill_traces
    assert tobs.registry.get("serve.decode_traces").value(
        engine="t_churn1") == 1
    assert set(eng._graphs) == {1} and eng._graphs[1].calls > 10


@pytest.mark.parametrize("eos", [None, 5])
def test_one_trace_per_burst_length(models, eos):
    jm, tm = models
    got, eng = _churn(tm, False, burst=8, eos=eos, name="t_cburst")
    _hold_to_oracle(jm, got, eos)
    assert len(eng.burst_lens_used) > 1
    assert eng.burst_lens_used <= {1, 2, 4, 8}
    assert eng.decode_traces == len(eng.burst_lens_used) == len(eng._graphs)
    assert set(eng._graphs) == eng.burst_lens_used


def test_sink_block_never_handed_out_or_read(models):
    """Every slot writes each tick; idle and eos-latched rows write into
    the sink block, one past the pool's blocks. It is never allocated,
    never in a block table, and never read: NaN in it changes no token
    (the streams equal the same engine's without the NaN)."""
    _, tm = models
    want, _ = _churn(tm, False, burst=4, eos=5, name="t_sink_clean")
    eng = ServeEngine(tm, max_slots=3, block_size=4, num_blocks=8,
                      max_seq_len=32, name="t_sink_port", decode_burst=4,
                      device="cpu")
    sink = eng._sink
    assert sink == eng.pool.num_blocks == 8
    assert all(kc.shape[1] == 9 for kc, _ in eng._caches)
    for kc, vc in eng._caches:
        kc[:, sink] = float("nan")
        vc[:, sink] = float("nan")
    seen = []
    orig = eng._decode_core

    def spy(tokens, lens, live, tables, temps):
        seen.append(bool((tables == sink).any()))
        return orig(tokens, lens, live, tables, temps)

    eng._decode_core = spy
    assert _drive(eng, 5) == want
    assert seen and not any(seen)
    assert eng.pool.free_blocks == 8 and eng._n_preempts > 0
    # the pool hands out exactly its 8 blocks, never the sink
    assert sorted(eng.pool.alloc(8)) == list(range(8))
    # idle rows did write into the sink (its first row is no longer NaN)
    assert not torch.isnan(eng._caches[0][0][:, sink, 0]).any()


def test_packed_state_round_trip(models):
    _, tm = models
    eng = ServeEngine(tm, max_slots=3, block_size=4, num_blocks=12,
                      max_seq_len=32, name="t_pack", device="cpu")
    eng._tokens[:] = [5, 6, 7]
    eng._lens[:] = [3, 0, 9]
    eng._temps[:] = [0.0, 0.5, 1.25]
    eng._eos[:] = [-1, 2, 3]
    eng._tables[:] = np.arange(24).reshape(3, 8) % 12
    packed = eng._packed_state(np.array([True, False, True]))
    assert packed.dtype == torch.int32 and packed.shape == (5 * 3 + 24,)
    tokens, lens, temps, eos, live = packed[:15].view(5, 3)
    assert tokens.tolist() == [5, 6, 7] and lens.tolist() == [3, 0, 9]
    assert temps.view(torch.float32).tolist() == [0.0, 0.5, 1.25]
    assert eos.tolist() == [-1, 2, 3] and live.tolist() == [1, 0, 1]
    assert packed[15:].view(3, 8).tolist() == eng._tables.tolist()


def _sampled(model, warm, burst):
    eng = ServeEngine(model, max_slots=3, block_size=4, num_blocks=24,
                      max_seq_len=32, name=f"t_warm{burst}{warm}",
                      decode_burst=burst, seed=4, device="cpu")
    if warm:
        warm_engine(eng, max_prompt_len=8)
    rng = np.random.RandomState(8)
    reqs = [eng.submit(rng.randint(1, 97, n), max_new_tokens=k,
                       temperature=0.9)
            for n, k in [(5, 9), (8, 7), (3, 10)]]
    eng.run()
    return [r.output_ids for r in reqs], eng


@pytest.mark.parametrize("burst", [1, 4])
def test_warm_up_captures_and_leaves_sampled_streams(models, burst):
    _, tm = models
    cold, ceng = _sampled(tm, False, burst)
    warm, weng = _sampled(tm, True, burst)
    assert warm == cold
    assert set(weng._graphs) == {n for n in (1, 2, 4) if n <= burst}
    assert weng.decode_traces == len(weng._graphs)
    assert ceng.decode_traces == len(ceng.burst_lens_used or {1})


def test_engine_and_its_graphs_free_without_the_collector(models):
    """The engine holds its graphs and a graph's function reaches the
    engine only weakly: dropping the engine frees its pool and graphs at
    once, not when the garbage collector next runs."""
    _, tm = models
    eng = ServeEngine(tm, max_slots=2, block_size=4, num_blocks=8,
                      max_seq_len=32, name="t_free", decode_burst=2,
                      device="cpu")
    eng.submit(np.arange(1, 6), max_new_tokens=5)
    eng.run()
    refs = [weakref.ref(eng), weakref.ref(eng._caches[0][0])] + [
        weakref.ref(g) for g in eng._graphs.values()]
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_graphed_on_the_cpu():
    """The captured-callable plumbing without a card: static inputs
    reused, the first call flagged as the capture, shapes pinned, fresh
    outputs."""
    flags = []

    def fn(x, y):
        flags.append(tjit.is_capturing())
        return x * 2 + y

    g = _capture.Graphed(fn, "cpu", name="t_graphed")
    x, y = torch.arange(4.0), torch.ones(4)
    a = g(x, y)
    b = g(x + 1, y)
    assert a.tolist() == [1.0, 3.0, 5.0, 7.0] and b.tolist() == [3.0, 5.0,
                                                                7.0, 9.0]
    assert flags == [True, False] and not g.captured and g.calls == 2
    assert a.data_ptr() != g._inputs[0].data_ptr()
    with pytest.raises(ValueError, match="captured with"):
        g(torch.arange(5.0), torch.ones(5))
    with pytest.raises(_capture.CaptureError, match="host"):
        _capture.Graphed(lambda t: _capture.no_host_read("a read"),
                         "cpu")(x)


# ---------------------------------------------------------------------------
# generate: the tick's state lives on the device
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gen_models():
    paddle.seed(3)
    cfg = dict(_TINY, num_key_value_heads=2)
    jm = JLlama(JConfig.tiny(**cfg))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu").eval()
    load_paddle_tpu_state(
        tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


def _padded():
    rng = np.random.RandomState(30)
    rows = [np.concatenate([np.zeros(7 - n, "int64"),
                            rng.randint(1, 97, n)]) for n in (7, 4, 2)]
    return np.stack(rows)


@pytest.mark.parametrize("kw", [
    dict(min_length=6, eos_token_id=3),
    dict(min_length=4, eos_token_id=3, repetition_penalty=1.4,
         pad_token_id=0),
    dict(eos_token_id=3, pad_token_id=0),
    dict(pad_token_id=0, paged=True, block_size=4),
    dict(eos_token_id=3, paged=True, block_size=8),
], ids=["min_length", "min_length-rep-ragged", "eos-ragged", "paged-ragged",
        "paged-eos"])
def test_generate_device_ticks_match_reference(gen_models, kw, monkeypatch):
    jm, tm = gen_models
    ids = _padded() if kw.get("pad_token_id") is not None else \
        np.random.RandomState(31).randint(1, 97, (2, 6)).astype("int64")
    made = []
    real = tgen.Graphed

    def counting(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(tgen, "Graphed", counting)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=10,
                                  **kw).numpy())
    got = tm.generate(ids, max_new_tokens=10, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    # one graph for the call, 9 ticks through it
    assert len(made) == 1 and made[0].calls == 9
    assert made[0].name == ("generate.paged" if kw.get("paged")
                            else "generate.dense")


def test_generate_sampled_stream_through_the_tick(gen_models):
    _, tm = gen_models
    ids = _padded()
    kw = dict(max_new_tokens=9, pad_token_id=0, do_sample=True, top_k=20,
              top_p=0.9, seed=11)
    a = tm.generate(ids, **kw)
    b = tm.generate(ids, paged=True, block_size=4, **kw)
    c = tm.generate(ids, **dict(kw, seed=12))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a 2-token call has one tick and makes no graph
    assert tm.generate(ids, max_new_tokens=2, pad_token_id=0).shape == (3, 9)
