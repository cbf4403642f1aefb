"""The port's serving plane (paddle_tpu_torch/serve) on the CPU.

- ``BlockPool`` / ``PrefixCache`` unit cases, mirroring
  tests/test_serve.py's pool cases;
- the port's ``ServeEngine`` against the reference's ``ServeEngine`` on
  the same bridged weights and requests, greedy, token for token:
  staggered arrivals, pool-pressure preemption, the prefix cache (shared
  prefix and a block-aligned full match that copies on write), and
  decode bursts;
- burst=N equal to burst=1 within the port, with eos latched mid-burst
  and with sampling; sampled streams reproducible from the engine seed
  (the port's generator is not jax.random, so sampled streams are held
  within the port only).

The paged attention runs its plain version here (CPU tensors); the
kernel path is driven on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serve import ServeEngine as JEngine

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serve import (BlockPool, PoolExhaustedError,
                                    PrefixCache, ServeEngine,
                                    default_serving_setup, run_load,
                                    warm_engine)

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


def _engine(model, jax_side, **kw):
    if jax_side:
        return JEngine(model, **kw)
    return ServeEngine(model, device="cpu", **kw)


# ---------------------------------------------------------------------------
# scenarios run through both engines
# ---------------------------------------------------------------------------
def _staggered(model, jax_side):
    rng = np.random.RandomState(0)
    eng = _engine(model, jax_side, max_slots=3, block_size=4, num_blocks=40,
                  max_seq_len=40, name="t_stag")
    plans = [(rng.randint(1, 97, n), k) for n, k in
             [(7, 6), (3, 9), (11, 5), (5, 8), (9, 4)]]
    reqs = [eng.submit(p, max_new_tokens=k) for p, k in plans[:3]]
    pending, steps = list(plans[3:]), 0
    while eng.has_work or pending:
        if pending and steps >= 2:      # arrivals mid-flight
            p, k = pending.pop(0)
            reqs.append(eng.submit(p, max_new_tokens=k))
        eng.step()
        steps += 1
    return reqs, eng


def _preempt(model, jax_side, burst=1):
    rng = np.random.RandomState(1)
    # pool too small for both working sets: the youngest is evicted at a
    # block boundary and recomputes on re-admission
    eng = _engine(model, jax_side, max_slots=2, block_size=4, num_blocks=7,
                  max_seq_len=28, name=f"t_press{burst}", decode_burst=burst)
    plans = [(rng.randint(1, 97, n), k)
             for n, k in [(10, 8), (9, 7), (5, 6)]]
    reqs = [eng.submit(p, max_new_tokens=k) for p, k in plans]
    eng.run(max_steps=2000)
    return reqs, eng


def _prefix_shared(model, jax_side):
    rng = np.random.RandomState(11)
    sysp = rng.randint(1, 97, 12)            # 3 full blocks at bs=4
    eng = _engine(model, jax_side, max_slots=3, block_size=4, num_blocks=40,
                  max_seq_len=40, name="t_pfx", prefix_cache=True,
                  decode_burst=4)
    plans = [(np.concatenate([sysp, rng.randint(1, 97, n)]), k)
             for n, k in [(5, 6), (3, 7), (7, 5)]]
    reqs = [eng.submit(plans[0][0], max_new_tokens=plans[0][1])]
    eng.run(max_steps=500)                   # its blocks become resident
    reqs += [eng.submit(p, max_new_tokens=k) for p, k in plans[1:]]
    eng.run(max_steps=2000)
    return reqs, eng


def _prefix_cow(model, jax_side):
    rng = np.random.RandomState(12)
    p = rng.randint(1, 97, 8)                # exactly 2 blocks at bs=4
    eng = _engine(model, jax_side, max_slots=2, block_size=4, num_blocks=24,
                  max_seq_len=32, name="t_cow", prefix_cache=True)
    r1 = eng.submit(p, max_new_tokens=6)
    eng.run(max_steps=500)
    r2 = eng.submit(p.copy(), max_new_tokens=6)   # full match -> CoW
    eng.run(max_steps=500)
    return [r1, r2], eng


SCENARIOS = {
    "staggered": _staggered,
    "preemption": _preempt,
    "preemption_burst8": lambda m, j: _preempt(m, j, burst=8),
    "prefix_shared_burst4": _prefix_shared,
    "prefix_cow": _prefix_cow,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_greedy_streams_match_reference_engine(models, name):
    jm, tm = models
    jreqs, jeng = SCENARIOS[name](jm, True)
    treqs, teng = SCENARIOS[name](tm, False)
    assert [r.output_ids for r in treqs] == [r.output_ids for r in jreqs]
    assert all(r.state == "FINISHED" for r in treqs)
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert [r.prefilled_tokens for r in treqs] == \
        [r.prefilled_tokens for r in jreqs]
    assert teng.pool.used_blocks == 0
    if name.startswith("preemption"):
        assert sum(r.preemptions for r in treqs) > 0
        assert treqs[0].preemptions == 0     # the oldest is never a victim
    if name == "prefix_cow":
        assert tobs.registry.get("serve.cow_copies").value(
            engine="t_cow") >= 1
        assert treqs[1].prefilled_tokens == 1
    if name.startswith("prefix_shared"):
        assert treqs[1].shared_blocks == treqs[2].shared_blocks == 3


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------
def _burst_run(model, burst, eos=None, temperature=0.0, seed=0):
    rng = np.random.RandomState(15)
    eng = ServeEngine(model, max_slots=3, block_size=4, num_blocks=48,
                      max_seq_len=40, name=f"t_burst{burst}",
                      decode_burst=burst, seed=seed, device="cpu")
    plans = [(rng.randint(1, 97, n), k) for n, k in [(7, 9), (3, 12),
                                                     (11, 6)]]
    reqs = [eng.submit(p, max_new_tokens=k, temperature=temperature,
                       eos_token_id=None if eos is None else eos[i])
            for i, (p, k) in enumerate(plans)]
    eng.run(max_steps=2000)
    return [r.output_ids for r in reqs], eng


def test_burst_equals_single_steps_with_eos_latch(models):
    _, tm = models
    plain, _ = _burst_run(tm, 1)
    # eos ids that first fire on a decode tick inside a burst
    eos = [next(t for i, t in enumerate(s) if i >= 2 and s.index(t) == i)
           for s in plain]
    ref, _ = _burst_run(tm, 1, eos=eos)
    got, eng = _burst_run(tm, 8, eos=eos)
    assert got == ref
    assert all(len(s) < len(p) for s, p in zip(got, plain))   # eos fired
    assert max(eng.burst_lens_used) > 1
    rts = tobs.registry.get("serve.host_roundtrips").value(engine="t_burst8")
    assert 0 < rts < sum(len(s) for s in got)


def test_sampled_streams_seed_reproducible_and_burst_invariant(models):
    _, tm = models
    a, _ = _burst_run(tm, 1, temperature=0.8, seed=11)
    b, _ = _burst_run(tm, 1, temperature=0.8, seed=11)
    c, _ = _burst_run(tm, 4, temperature=0.8, seed=11)
    d, _ = _burst_run(tm, 1, temperature=0.8, seed=12)
    assert a == b == c
    assert a != d
    assert all(0 <= t < 97 for s in a for t in s)


def test_idle_slots_never_write_the_pool(models):
    # torch has no mode="drop": idle rows must be left out of the KV
    # write, not clamped into some block
    _, tm = models
    eng = ServeEngine(tm, max_slots=3, block_size=4, num_blocks=16,
                      max_seq_len=32, name="t_fence", device="cpu")
    r = eng.submit(np.arange(1, 7), max_new_tokens=5)
    owned = None
    while eng.has_work:
        eng.step()
        owned = list(r.blocks) or owned
    untouched = [b for b in range(16) if b not in owned]
    for kc, vc in eng._caches:
        assert kc[:, untouched].abs().sum() == 0
        assert vc[:, untouched].abs().sum() == 0


def test_run_load_on_the_cpu_setup(models):
    config, prm = default_serving_setup("cpu")
    model = LlamaForCausalLM(config, device="cpu", seed=1).eval()
    eng = ServeEngine(model, max_slots=prm["slots"],
                      block_size=prm["block_size"],
                      num_blocks=prm["num_blocks"],
                      max_seq_len=prm["max_seq_len"], name="t_load",
                      device="cpu")
    warm_engine(eng)
    before = tpa.launches
    res = run_load(eng, rate=prm["rate"], n_requests=8,
                   prompt_len=prm["prompt_len"], max_new=prm["max_new"])
    assert tpa.launches == before            # CPU tensors never launch
    assert all(r.state == "FINISHED" for r in res.requests)
    assert res.total_tokens == sum(r.n_generated for r in res.requests)
    assert 0 < res.ttft_p50 <= res.ttft_p99 and res.tokens_per_sec > 0
    assert {"ttft_p50_seconds", "tokens_per_sec"} <= set(res.to_dict())


def test_submit_validation_and_unported_options(models):
    _, tm = models
    eng = ServeEngine(tm, max_slots=2, block_size=4, num_blocks=3,
                      max_seq_len=32, name="t_val", device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.arange(1, 30), max_new_tokens=10)
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit(np.arange(1, 14), max_new_tokens=8)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.array([], np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.arange(1, 4), max_new_tokens=0)
    assert tobs.registry.get("serve.requests_rejected").value(
        engine="t_val", reason="pool_too_small") == 1
    # tracing and SLOs are ported: trace=True attaches a tracer, and a
    # rule with fields SloRule lacks is refused as the reference does
    assert ServeEngine(tm, trace=True, device="cpu").tracer is not None
    with pytest.raises(TypeError, match="metric"):
        ServeEngine(tm, slo=[{"metric": "ttft"}], device="cpu")
    with pytest.raises(NotImplementedError, match="Llama"):
        ServeEngine(torch.nn.Linear(2, 2), device="cpu")


# ---------------------------------------------------------------------------
# pool and prefix bookkeeping (tests/test_serve.py's cases, on the port)
# ---------------------------------------------------------------------------
class TestBlockPool:
    def test_alloc_free_roundtrip(self):
        pool = BlockPool(8, 16)
        a = pool.alloc(3)
        assert len(a) == 3 and len(set(a)) == 3
        assert pool.free_blocks == 5 and pool.used_blocks == 3
        assert pool.occupancy == pytest.approx(3 / 8)
        pool.free(a)
        assert pool.free_blocks == 8

    def test_exhaustion_raises_clear_error(self):
        pool = BlockPool(4, 16)
        pool.alloc(3)
        with pytest.raises(PoolExhaustedError, match="exhausted"):
            pool.alloc(2)
        assert pool.free_blocks == 1         # a failed alloc is atomic
        assert pool.alloc(1)

    def test_double_free_rejected(self):
        pool = BlockPool(4, 16)
        a = pool.alloc(2)
        pool.free(a[:1])
        with pytest.raises(ValueError, match="already free"):
            pool.free(a[:1])
        with pytest.raises(ValueError, match="outside the pool"):
            pool.free([99])
        with pytest.raises(ValueError, match="already free"):
            pool.free([a[1], a[1]])

    def test_blocks_for_tokens(self):
        pool = BlockPool(8, 4)
        assert [pool.blocks_for_tokens(n) for n in (1, 4, 5, 8, 9)] == \
            [1, 1, 2, 2, 3]

    def test_acquire_release_refcounting(self):
        pool = BlockPool(8, 16)
        a = pool.alloc(2)
        pool.acquire(a)
        assert all(pool.refcount(b) == 2 for b in a)
        assert pool.release(a) == []
        assert pool.used_blocks == 2
        cached = pool.release(a, retain=a)
        assert sorted(cached) == sorted(a)
        assert pool.used_blocks == 0 and pool.cached_blocks == 2

    def test_refcount_underflow_is_double_free(self):
        pool = BlockPool(4, 16)
        a = pool.alloc(1)
        pool.acquire(a)
        with pytest.raises(ValueError, match="underflow"):
            pool.release(a * 3)
        assert pool.refcount(a[0]) == 2
        pool.release(a * 2)
        assert pool.free_blocks == 4

    def test_acquiring_a_free_block_rejected(self):
        pool = BlockPool(4, 16)
        a = pool.alloc(1)
        pool.release(a)
        with pytest.raises(ValueError, match="unallocated"):
            pool.acquire(a)

    def test_cached_blocks_revive_and_eviction_respects_refs(self):
        pool = BlockPool(4, 16)
        a = pool.alloc(2)
        pool.release(a, retain=a)
        pool.acquire(a[:1])
        assert pool.refcount(a[0]) == 1 and not pool.is_cached(a[0])
        with pytest.raises(ValueError, match="refcount-0"):
            pool.reclaim(a[:1])
        pool.reclaim(a[1:])
        assert pool.free_blocks == 3 and pool.cached_blocks == 0

    def test_alloc_never_hands_out_cached_blocks_implicitly(self):
        pool = BlockPool(4, 16)
        a = pool.alloc(4)
        pool.release(a, retain=a)
        with pytest.raises(PoolExhaustedError, match="cached"):
            pool.alloc(1)
        pool.reclaim(a[:2])
        assert pool.alloc(2)


class TestPrefixCache:
    def test_match_register_and_partial_blocks(self):
        pool = BlockPool(8, 4)
        pc = PrefixCache(4)
        blocks = pool.alloc(2)
        node = pc.register(pc.node_for([]), [1, 2, 3, 4], blocks[0])
        pc.register(node, [5, 6, 7, 8], blocks[1])
        assert pc.match([1, 2, 3, 4, 5, 6, 7, 8, 9]) == blocks
        assert pc.match([1, 2, 3, 4, 5, 6, 7]) == blocks[:1]  # partial tail
        assert pc.match([9, 2, 3, 4]) == []
        with pytest.raises(ValueError, match="full block"):
            pc.register(node, [1, 2], 5)

    def test_eviction_drops_orphaned_descendants(self):
        pool = BlockPool(4, 4)
        pc = PrefixCache(4)
        a, b = pool.alloc(2)
        node = pc.register(pc.node_for([]), [1, 2, 3, 4], a)
        pc.register(node, [5, 6, 7, 8], b)
        pc.note_cached(pool.release([a, b], retain=[a, b]))
        assert pc.evictable_blocks == 2
        assert pc.evict(pool, 1) == 2        # the child is unmatchable too
        assert pool.free_blocks == 4 and pc.match([1, 2, 3, 4]) == []
