"""Synthetic heavy-traffic load generator for the serving engine.

Counterpart of ``paddle_tpu/serve/load.py``. Poisson arrivals
(exponential inter-arrival gaps at ``rate`` req/s) of requests with
mixed prompt/output lengths, submitted against a live
:class:`~paddle_tpu_torch.serve.engine.ServeEngine` in wall-clock time
while the engine loop keeps stepping — so queueing, continuous batching
and preemption all happen under contention, and TTFT includes real
queue wait.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..core.place import resolve_device
from . import engine as _engine_mod
from .engine import ServeEngine

__all__ = ["run_load", "LoadResult", "default_serving_setup",
           "warm_engine"]


class _WallClock:
    """The default ``run_load`` clock: real wall time. Any object with
    ``time()`` and ``sleep()`` can stand in (a fake clock in tests)."""

    sleep = staticmethod(time.sleep)
    time = staticmethod(time.perf_counter)


def default_serving_setup(device=None):
    """ONE source for the serving model config and the engine/load
    defaults (the reference's ``default_serving_setup``). On the card
    (``device=None`` or ``"cuda"``; raises without one) it is the
    serving shape: a 10-layer, 2048-wide Llama (about 645M parameters),
    8 slots over a 96 x 128-token block pool. ``device="cpu"`` gives the
    tiny configuration the CPU tests use. Returns (config, params)."""
    from ..models import LlamaConfig

    dev = resolve_device(device)
    if dev.type == "cuda":
        config = LlamaConfig(
            vocab_size=32000, hidden_size=2048, intermediate_size=5632,
            num_hidden_layers=10, num_attention_heads=16,
            num_key_value_heads=16, max_position_embeddings=2048)
        params = dict(rate=30.0, requests=48, slots=8, num_blocks=96,
                      block_size=128, max_seq_len=1024,
                      prompt_len=(32, 128), max_new=(16, 64))
    else:
        config = LlamaConfig.tiny()
        params = dict(rate=300.0, requests=16, slots=3, num_blocks=24,
                      block_size=8, max_seq_len=48,
                      prompt_len=(4, 12), max_new=(4, 8))
    return config, params


def warm_engine(engine: ServeEngine, max_prompt_len=None):
    """Capture every reachable prefill bucket, cold and (with the prefix
    cache) suffix, the decode tick and every power-of-two burst length up
    to ``decode_burst`` (``ServeEngine.warm_burst``), outside the
    measured window, so the kernels' first-use build, the BLAS library's
    start-up, the allocator's growth and the graph captures are not
    billed to a served request's TTFT (a bucket first hit mid-load would
    bill its capture). The reference warms the same lengths to compile
    its jit buckets, with one difference: with the prefix cache on, the
    reference's cold warm-up prompts share their leading blocks, so from
    the second block on they prefill as suffixes and the cold buckets
    above one block stay cold; here the cache is emptied after each cold
    warm-up prompt, so every cold bucket is captured."""
    vocab = int(engine._p["embed"].shape[0])
    # the longest ADMISSIBLE prompt: max_new >= 1 bounds it at
    # max_seq_len - 1, and its n-token working set must fit the pool
    cap = min(engine.max_seq_len - 1,
              engine.pool.num_blocks * engine.block_size)
    if max_prompt_len is not None:
        cap = min(cap, int(max_prompt_len))
    lens, b = [], 8
    while b < cap:
        lens.append(b)
        b *= 2
    lens.append(cap)
    for n in dict.fromkeys(lens):
        if n < 1:
            continue
        req = engine.submit(np.arange(n) % (vocab - 1) + 1,
                            max_new_tokens=1, warmup=True)
        engine.run()
        if req.state != "FINISHED":   # pragma: no cover — engine contract
            raise RuntimeError("warm-up request did not finish")
        if engine._prefix is not None:
            # the next, longer prompt must not mount this one's blocks
            engine._prefix.reset(engine.pool)
    if engine._prefix is not None:
        # suffix prefills: a prompt that shares its first block with a
        # resident one prefills only the suffix — warm those lengths by
        # re-using one warm block and varying the suffix length
        bs = engine.block_size
        base = np.arange(bs) % (vocab - 1) + 1
        engine.submit(base, max_new_tokens=1, warmup=True)
        engine.run()
        for n in dict.fromkeys(min(s, cap - bs) for s in lens):
            if n < 1:
                continue
            suffix = (np.arange(n) + n) % (vocab - 1) + 1
            engine.submit(np.concatenate([base, suffix]),
                          max_new_tokens=1, warmup=True)
            engine.run()
        # drop the warm-up registrations so the measured run's
        # prefix_hits/blocks_shared reflect the WORKLOAD, not warm-up
        engine._prefix.reset(engine.pool)
    n = 1
    while n <= engine.decode_burst:
        engine.warm_burst(n)
        n *= 2


@dataclass
class LoadResult:
    """Aggregate outcome of one load run (seconds / tokens units)."""

    n_requests: int
    wall_seconds: float
    ttft_p50: float
    ttft_p99: float
    ttft_mean: float
    tokens_per_sec: float
    total_tokens: int
    preemptions: int
    engine_steps: int
    rejected: int = 0
    # prefix-cache + fused-burst accounting (this run's deltas):
    # blocks_saved == prefix_blocks_shared — every shared block is one
    # physical block NOT duplicated and block_size prefill tokens NOT
    # recomputed; prefill_tokens is what the engine actually prefilled
    # (compare against a cold-cache run to see the reduction)
    prefix_hits: int = 0
    prefix_blocks_shared: int = 0
    cow_copies: int = 0
    prefill_tokens: int = 0
    host_roundtrips: int = 0
    burst_tokens: int = 0
    requests: List = field(default_factory=list, repr=False)

    def to_dict(self) -> dict:
        return {
            "n_requests": self.n_requests,
            "wall_seconds": round(self.wall_seconds, 4),
            "ttft_p50_seconds": round(self.ttft_p50, 5),
            "ttft_p99_seconds": round(self.ttft_p99, 5),
            "ttft_mean_seconds": round(self.ttft_mean, 5),
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "total_tokens": self.total_tokens,
            "preemptions": self.preemptions,
            "engine_steps": self.engine_steps,
            "rejected": self.rejected,
            "prefix_hits": self.prefix_hits,
            "prefix_blocks_shared": self.prefix_blocks_shared,
            "blocks_saved": self.prefix_blocks_shared,
            "cow_copies": self.cow_copies,
            "prefill_tokens": self.prefill_tokens,
            "host_roundtrips": self.host_roundtrips,
            "burst_tokens": self.burst_tokens,
        }


def run_load(engine: ServeEngine, *, rate: float = 50.0,
             n_requests: int = 32, prompt_len=(4, 24),
             max_new=(4, 24), vocab_size: int | None = None,
             eos_token_id=None, temperature: float = 0.0,
             seed: int = 0, max_steps: int = 1_000_000,
             clock=None, shared_prefix_tokens: int = 0,
             shared_prefix_frac: float = 0.0) -> LoadResult:
    """Drive ``engine`` with Poisson traffic and return latency stats.

    Arrival times are pre-drawn (cumsum of Exp(1/rate) gaps) and each
    request is submitted the first time the wall clock passes its
    arrival; between arrivals the engine keeps stepping whatever is
    admitted. Prompt and output lengths are uniform over the given
    inclusive ranges. Returns exact (sample-based) p50/p99 TTFT —
    the ``serve.ttft_seconds`` histogram the engine records carries
    the same data in bucketed form for the metrics roll-up.

    ``clock`` is an object with ``time() -> seconds`` and
    ``sleep(seconds)`` (default: real wall clock). Deterministic runs
    pass a fake clock — ideally the same one the engine was built
    with, so arrivals and TTFTs share a timeline. The engine's device
    is the run's device.

    ``shared_prefix_tokens``/``shared_prefix_frac`` model the
    shared-system-prompt workload: a fraction of requests prepend ONE
    synthetic ``shared_prefix_tokens``-long prefix (drawn once per run)
    to their random prompt. Against a prefix-cache engine, every such
    request after the first mounts the prefix's full blocks instead of
    re-prefilling them — the result's ``prefix_blocks_shared`` /
    ``prefill_tokens`` quantify the saving.
    """
    clk = clock if clock is not None else _WallClock()
    if vocab_size is None:
        vocab_size = int(engine._p["embed"].shape[0])
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    prompts = [rng.integers(1, vocab_size,
                            size=rng.integers(prompt_len[0],
                                              prompt_len[1] + 1))
               for _ in range(n_requests)]
    news = rng.integers(max_new[0], max_new[1] + 1, size=n_requests)
    if shared_prefix_tokens > 0 and shared_prefix_frac > 0.0:
        prefix = rng.integers(1, vocab_size, size=int(shared_prefix_tokens))
        mask = rng.random(n_requests) < shared_prefix_frac
        prompts = [np.concatenate([prefix, p]) if m else p
                   for p, m in zip(prompts, mask)]

    submitted: List = []
    rejected = 0
    steps = 0
    steps0 = _metric_total("serve.decode_steps")
    preempt0 = _metric_total("serve.preemptions")
    base = {name: _metric_total(name) for name in (
        "serve.prefix_hits", "serve.prefix_blocks_shared",
        "serve.cow_copies", "serve.host_roundtrips",
        "serve.burst_tokens")}
    start = clk.time()
    i = 0
    while i < n_requests or engine.has_work:
        now = clk.time() - start
        while i < n_requests and arrivals[i] <= now:
            try:
                submitted.append(engine.submit(
                    prompts[i], max_new_tokens=int(news[i]),
                    eos_token_id=eos_token_id, temperature=temperature))
            except ValueError:
                # never-runnable under THIS engine's limits (a
                # deliberately tiny --num_blocks pool, a max_seq_len
                # shorter than the draw range): a real front door
                # returns 4xx and keeps serving — count it, keep going
                rejected += 1
            i += 1
        if engine.has_work:
            engine.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"run_load: exceeded max_steps={max_steps} with "
                    f"{len(engine.queue)} queued and {engine.n_active} "
                    f"active — the engine is not making progress")
        elif i < n_requests:
            clk.sleep(min(max(arrivals[i] - now, 0.0), 0.005))
    wall = clk.time() - start

    ttfts = np.array([r.ttft for r in submitted
                      if r.ttft is not None], np.float64)
    total_tokens = int(sum(r.n_generated for r in submitted))
    tps = total_tokens / wall if wall > 0 else 0.0
    _engine_mod._M_TOKENS_PER_SEC.set(round(tps, 2), engine=engine.name)

    def pct(q):
        return float(np.percentile(ttfts, q)) if ttfts.size else 0.0

    return LoadResult(
        n_requests=n_requests,
        wall_seconds=wall,
        ttft_p50=pct(50),
        ttft_p99=pct(99),
        ttft_mean=float(ttfts.mean()) if ttfts.size else 0.0,
        tokens_per_sec=tps,
        total_tokens=total_tokens,
        preemptions=_metric_total("serve.preemptions") - preempt0,
        engine_steps=_metric_total("serve.decode_steps") - steps0,
        rejected=rejected,
        prefix_hits=_metric_total("serve.prefix_hits") - base[
            "serve.prefix_hits"],
        prefix_blocks_shared=_metric_total(
            "serve.prefix_blocks_shared") - base[
                "serve.prefix_blocks_shared"],
        cow_copies=_metric_total("serve.cow_copies") - base[
            "serve.cow_copies"],
        prefill_tokens=int(sum(r.prefilled_tokens for r in submitted)),
        host_roundtrips=_metric_total("serve.host_roundtrips") - base[
            "serve.host_roundtrips"],
        burst_tokens=_metric_total("serve.burst_tokens") - base[
            "serve.burst_tokens"],
        requests=submitted,
    )


def _metric_total(name: str) -> int:
    from .. import observability as obs

    m = obs.registry.get(name)
    return int(m.total()) if m is not None else 0
