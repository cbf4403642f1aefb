"""The port's bucketed prefill in the serving engine (paddle_tpu_torch/serve/engine.py, load.py) against the
reference's engine on the CPU.

- ``prefill_bucket`` equals the buckets the reference's ``_prefill`` pads
  to, for every length up to a ``max_seq_len`` that is not a power of
  two;
- one sequence of submissions (cold prompts, prompts that mount a cached
  prefix, then a pool small enough to preempt and recompute) through
  tiny Llama and GPT engines of both packages: ``prefill_traces``, the
  ``serve.prefill_traces`` bucket labels and the greedy streams equal;
- a suffix prefill whose pad rows sit past ``max_seq_len`` (past the
  rope and position tables) runs, writes only the blocks its real rows
  own and the sink, and gives the reference's token;
- ``warm_engine`` captures every cold bucket and the reference's suffix
  buckets.

The engine's tracing and SLO monitors are held against the reference's
in test_torch_serve_trace.py, on this file's models and sequence.

On the CPU a ``Graphed`` call runs its function eagerly on its static
buffers, so everything but the CUDA graph runs here; chip_smoke.py's
serving phase runs the graphs. fp32 throughout.
"""
import numpy as np
import pytest
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serve import ServeEngine as JEngine
from paddle_tpu.serve.engine import Request as JRequest
from paddle_tpu.serve.load import warm_engine as jwarm_engine

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serve import ServeEngine, warm_engine
from paddle_tpu_torch.serve.engine import prefill_bucket

VOCAB = 83
#: the tables end here: max_seq_len, Llama's rope rows and GPT's
#: position rows (not a power of two, so the top bucket is capped)
S_MAX = 38


def _bridge(jm, tm, seed):
    """Weights drawn with numpy (normal(0, 0.3); norms around 1) into both
    models: the reference's own init makes tiny models repeat a token."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in jm.state_dict().items():
        base = 1.0 if "norm" in k and k.endswith("weight") else 0.0
        state[k] = (base + 0.3 * rng.standard_normal(
            tuple(v._value.shape))).astype(np.float32)
    jm.set_state_dict(state)
    load_paddle_tpu_state(tm, state)
    return jm.eval(), tm.eval()


@pytest.fixture(scope="module")
def llama():
    cfg = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64)
    paddle.seed(3)
    return _bridge(JLlama(JLlamaConfig.tiny(**cfg)),
                   LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu"),
                   7)


@pytest.fixture(scope="module")
def gpt():
    cfg = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=S_MAX)
    return _bridge(JGPT(JGPTConfig.tiny(**cfg)),
                   GPTForCausalLM(GPTConfig.tiny(**cfg), device="cpu"), 8)


def _engines(pair, name, **kw):
    jm, tm = pair
    return (JEngine(jm, name=f"j_{name}", **kw),
            ServeEngine(tm, name=f"t_{name}", device="cpu", **kw))


def _labels(registry, engine):
    m = registry.get("serve.prefill_traces")
    return sorted((int(ls["bucket"]), m.value(**ls)) for ls in m.labelsets()
                  if ls["engine"] == engine)


def test_bucket_function_is_the_references(llama):
    """The reference's ``_prefill`` with its compiled function replaced by
    one that records the padded length, for every n up to S_MAX."""
    jm, _ = llama
    eng = JEngine(jm, max_slots=1, block_size=4, num_blocks=16,
                  max_seq_len=S_MAX, name="j_buckets")
    seen = []

    def record(arrays, caches, ids, n, table):
        seen.append(int(ids.shape[1]))
        return caches, np.zeros(VOCAB, np.float32)

    eng._prefill_fn = record
    for n in range(1, S_MAX + 1):
        # a resumed request: the prefill appends and samples nothing
        req = JRequest(id=n, prompt=np.ones(1, np.int32), max_new_tokens=4,
                       ids=[1, 2], slot=0)
        eng._prefill(req, list(range(1, n + 1)), start=0)
    assert seen == [prefill_bucket(n, S_MAX) for n in range(1, S_MAX + 1)]
    assert seen[0] == 8 and seen[-1] == S_MAX and 32 in seen


def _sequence(eng, rng):
    """Cold prompts across three buckets; prompts that mount the cached
    blocks of an earlier one (suffix prefills, and a full match that
    copies on write); then two long streams a pool of 16 blocks cannot
    hold at once (the younger is preempted and recomputed). Returns every
    request's stream."""
    cold = [rng.randint(1, VOCAB, n) for n in (5, 8, 13, 20)]
    reqs = [eng.submit(p, max_new_tokens=4) for p in cold]
    eng.run()
    shared = cold[3][:16]
    prefixed = [np.concatenate([shared, rng.randint(1, VOCAB, n)])
                for n in (2, 9)] + [cold[3][:16]]
    reqs += [eng.submit(p, max_new_tokens=5) for p in prefixed]
    eng.run()
    reqs += [eng.submit(rng.randint(1, VOCAB, 20), max_new_tokens=k)
             for k in (18, 17)]
    eng.run()
    return [r.output_ids for r in reqs]


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_prefill_counts_and_streams_equal_the_reference(family, request):
    pair = request.getfixturevalue(family)
    kw = dict(max_slots=2, block_size=4, num_blocks=16, max_seq_len=S_MAX,
              prefix_cache=True)
    je, te = _engines(pair, f"pf_{family}", **kw)
    want = _sequence(je, np.random.RandomState(31))
    got = _sequence(te, np.random.RandomState(31))
    assert got == want
    assert te._n_preempts == je._n_preempts > 0
    assert tobs.registry.get("serve.prefix_hits").value(
        engine=f"t_pf_{family}") > 0
    assert te.prefill_traces == je.prefill_traces
    labels = _labels(tobs.registry, f"t_pf_{family}")
    assert labels == _labels(jobs.registry, f"j_pf_{family}")
    assert {b for b, _ in labels} >= {8, 16, 32}
    # one graph per (kind, bucket), each made once
    kinds = {k for k, _ in te._prefill_graphs}
    assert kinds == {"cold", "suffix"}
    assert len(te._prefill_graphs) == te.prefill_traces
    assert sum(v for _, v in labels) == te.prefill_traces
    assert te.decode_traces == 1


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_suffix_pad_rows_past_the_tables(family, request):
    """A 37-token prompt whose first 32 tokens are cached: its 5-token
    suffix pads to bucket 8, at positions 32..39, past S_MAX (38) and the
    tables' last row. The prefill runs, leaves every block but those its
    real rows write and the sink as it was, and samples the reference's
    token."""
    pair = request.getfixturevalue(family)
    kw = dict(max_slots=1, block_size=4, num_blocks=24, max_seq_len=S_MAX,
              prefix_cache=True)
    je, te = _engines(pair, f"pad_{family}", **kw)
    rng = np.random.RandomState(5)
    first = rng.randint(1, VOCAB, 33)
    second = np.concatenate([first[:32], rng.randint(1, VOCAB, 5)])
    calls = []
    run = te._run_prefill

    def watched(suffix, start, table_row):
        before = [(k.clone(), v.clone()) for k, v in te._caches]
        out = run(suffix, start, table_row)
        written = {int(table_row[p // 4])
                   for p in range(start, start + len(suffix))}
        keep = [b for b in range(te.pool.num_blocks + 1)
                if b not in written and b != te._sink]
        for (k0, v0), (k1, v1) in zip(before, te._caches):
            assert (k1[:, keep] == k0[:, keep]).all()
            assert (v1[:, keep] == v0[:, keep]).all()
        calls.append((start, len(suffix), sorted(written)))
        return out

    te._run_prefill = watched
    outs = []
    for eng in (je, te):
        reqs = [eng.submit(first, max_new_tokens=1)]
        eng.run()
        reqs.append(eng.submit(second, max_new_tokens=1))
        eng.run()
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == outs[1]
    assert calls[1][:2] == (32, 5)
    assert prefill_bucket(5, S_MAX) + 32 > S_MAX
    assert set(te._prefill_graphs) == {("cold", S_MAX), ("suffix", 8)}


def test_warm_engine_captures_every_cold_and_suffix_bucket(llama):
    """The port's warm-up captures every cold bucket up to the cap, with
    the prefix cache on as well (the reference's cold warm-up prompts
    share blocks, so above one block it warms suffix buckets instead),
    and the reference's suffix buckets."""
    kw = dict(max_slots=2, block_size=4, num_blocks=24, max_seq_len=S_MAX)
    buckets = sorted({prefill_bucket(n, S_MAX) for n in range(1, S_MAX)})
    for pc in (False, True):
        je, te = _engines(llama, f"warm{pc}", prefix_cache=pc, **kw)
        jwarm_engine(je)
        warm_engine(te)
        cold = sorted(b for k, b in te._prefill_graphs if k == "cold")
        suffix = sorted(b for k, b in te._prefill_graphs if k == "suffix")
        assert cold == buckets
        if not pc:
            assert suffix == [] and te.prefill_traces == je.prefill_traces
            continue
        # the reference's suffix loop, replayed on the port's engine
        # alone: the same suffix buckets
        assert suffix == buckets
        assert te.prefill_traces == 2 * len(buckets) > je.prefill_traces
        assert te._prefix.evictable_blocks == 0 and te.pool.used_blocks == 0
