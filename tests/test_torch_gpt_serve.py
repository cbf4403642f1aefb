"""The port's ``ServeEngine`` over the GPT family (paddle_tpu_torch/serve/
engine.py: the learned position rows looked up by each slot's device
position in the tick, by absolute position in the cold and the suffix
prefill, and the tied head) against the reference's engine on the CPU.

The reference's ``tests/test_serve.py::TestGptServe`` cases through both
packages (streams equal to solo ``generate``, one decode trace; a
``max_seq_len`` past the position table refused), the family gate's
message, and then: the prefix cache (suffixes prefilled through the
block table at absolute positions), decode bursts on the captured tick
(one graph per burst length used), preemption under a small pool, tied
and untied heads, all token for token against the reference engine's
greedy streams and the port's own solo decodes; sampled streams within
the port (burst 4 equal to burst 1, one seed twice equal). fp32, weights
drawn with numpy (normal(0, 0.3)) and bridged.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.serve import ServeEngine as JEngine

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serve import ServeEngine
from _torch_zoo import one_torch_thread  # noqa: F401

_CFG = dict(vocab_size=83, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64)


def _pair(tie, seed):
    cfg = dict(_CFG, tie_word_embeddings=tie)
    jm = JGPT(JGPTConfig.tiny(**cfg))
    tm = GPTForCausalLM(GPTConfig.tiny(**cfg), device="cpu")
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in jm.state_dict().items():
        base = 1.0 if ".norm" in k and k.endswith("weight") else 0.0
        state[k] = (base + 0.3 * rng.standard_normal(
            tuple(v._value.shape))).astype(np.float32)
    jm.set_state_dict(state)
    load_paddle_tpu_state(tm, state)
    return jm.eval(), tm.eval()


@pytest.fixture(scope="module")
def untied():
    return _pair(False, 5)


@pytest.fixture(scope="module")
def tied():
    return _pair(True, 6)


def _engines(jm, tm, name, **kw):
    return (JEngine(jm, name=f"j_{name}", **kw),
            ServeEngine(tm, name=f"t_{name}", device="cpu", **kw))


def _serve(eng, plans, **kw):
    reqs = [eng.submit(p, max_new_tokens=k, **kw) for p, k in plans]
    eng.run()
    return [r.output_ids for r in reqs]


def _solo(tm, prompt, n):
    out = tm.generate(np.asarray(prompt)[None], max_new_tokens=n)
    return out[0, len(prompt):].tolist()


@pytest.mark.parametrize("head", ["untied", "tied"])
def test_gpt_streams_match_solo_generate(head, request):
    """``tests/test_serve.py``'s GPT case: staggered streams in two slots
    equal their solo decodes and the reference engine's streams, with one
    decode trace."""
    jm, tm = request.getfixturevalue(head)
    rng = np.random.RandomState(4)
    plans = [(rng.randint(1, 83, n), 7) for n in (6, 9, 4)]
    je, te = _engines(jm, tm, f"gpt_{head}", max_slots=2, block_size=4,
                      num_blocks=24, max_seq_len=32)
    got = _serve(te, plans)
    assert got == _serve(je, plans)
    for out, (p, k) in zip(got, plans):
        assert out == _solo(tm, p, k)
    assert len({t for out in got for t in out}) > 3
    assert te.decode_traces == 1 and te._graphs[1].calls > 1


def test_max_seq_len_beyond_position_table_rejected(untied):
    jm, tm = untied
    with pytest.raises(ValueError, match="position"):
        JEngine(jm, max_seq_len=65, name="j_gptlong")
    with pytest.raises(ValueError, match="position"):
        ServeEngine(tm, max_seq_len=65, name="t_gptlong", device="cpu")
    ServeEngine(tm, max_seq_len=64, name="t_gptfits", device="cpu")


def test_family_gate_names_both_families():
    with pytest.raises(NotImplementedError, match="Llama and GPT"):
        ServeEngine(torch.nn.Linear(2, 2), device="cpu")


def _shared_plans(seed, n=6, shared=8, new=6):
    rng = np.random.RandomState(seed)
    prefix = list(rng.randint(1, 83, shared))
    return [(prefix + list(rng.randint(1, 83, rng.randint(2, 7)))
             if i % 3 else list(rng.randint(1, 83, 5)), new)
            for i in range(n)]


@pytest.mark.parametrize("head", ["untied", "tied"])
def test_prefix_cache_suffix_prefill(head, request):
    """Prompts sharing two full blocks: later ones mount them and prefill
    only their suffixes, at absolute positions through the block table
    (a prompt equal to the prefix recomputes its last token into a
    copy-on-write block). Streams equal the reference prefix engine's
    and the port's cold engine's."""
    jm, tm = request.getfixturevalue(head)
    plans = _shared_plans(7)
    plans.append((plans[1][0][:8], 5))        # the prefix alone: CoW
    kw = dict(max_slots=2, block_size=4, num_blocks=32, max_seq_len=32)
    je, te = _engines(jm, tm, f"gpt_prefix_{head}", prefix_cache=True, **kw)
    got = _serve(te, plans)
    assert got == _serve(je, plans)
    cold = ServeEngine(tm, name=f"t_gpt_cold_{head}", device="cpu", **kw)
    assert got == _serve(cold, plans)
    assert tobs.registry.get("serve.prefix_hits").value(
        engine=f"t_gpt_prefix_{head}") > 0
    assert tobs.registry.get("serve.cow_copies").value(
        engine=f"t_gpt_prefix_{head}") > 0


@pytest.mark.parametrize("burst", [2, 4])
def test_decode_bursts_on_the_captured_tick(untied, burst):
    """``decode_burst``: one graph per power-of-two burst length used, and
    the streams of the reference's burst engine and of single ticks."""
    jm, tm = untied
    rng = np.random.RandomState(9)
    plans = [(rng.randint(1, 83, n), k) for n, k in
             ((5, 9), (11, 6), (3, 12), (8, 7))]
    kw = dict(max_slots=3, block_size=4, num_blocks=40, max_seq_len=32)
    je, te = _engines(jm, tm, f"gpt_burst{burst}", decode_burst=burst, **kw)
    got = _serve(te, plans)
    assert got == _serve(je, plans)
    single = ServeEngine(tm, name=f"t_gpt_single{burst}", device="cpu", **kw)
    assert got == _serve(single, plans)
    assert te.decode_traces == len(te.burst_lens_used) == len(te._graphs)
    assert max(te.burst_lens_used) == burst


def test_preemption_under_a_small_pool(tied):
    """Youngest-first eviction and re-prefill (prompt plus generated
    tokens, at their absolute positions) keep every stream equal to the
    reference engine's and to its solo decode."""
    jm, tm = tied
    rng = np.random.RandomState(11)
    plans = [(rng.randint(1, 83, n), 12) for n in (7, 5, 9)]
    je, te = _engines(jm, tm, "gpt_preempt", max_slots=3, block_size=4,
                      num_blocks=10, max_seq_len=32)
    got = _serve(te, plans)
    assert tobs.registry.get("serve.preemptions").value(
        engine="t_gpt_preempt", reason="pool_exhausted") > 0
    assert got == _serve(je, plans)
    for out, (p, k) in zip(got, plans):
        assert out == _solo(tm, p, k)


def test_sampled_streams_within_the_port(tied):
    _, tm = tied
    rng = np.random.RandomState(12)
    plans = [(rng.randint(1, 83, n), 10) for n in (4, 9, 6)]
    kw = dict(max_slots=3, block_size=4, num_blocks=40, max_seq_len=32,
              device="cpu", seed=3)
    outs = [_serve(ServeEngine(tm, name=f"t_gpt_sample{i}", decode_burst=b,
                               **kw), plans, temperature=0.9)
            for i, b in enumerate((1, 1, 4))]
    assert outs[0] == outs[1] == outs[2]
    greedy = _serve(ServeEngine(tm, name="t_gpt_sample_greedy", **kw), plans)
    assert outs[0] != greedy
