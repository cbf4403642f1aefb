"""Continuous-batching serving engine over the paged KV block pool.

Counterpart of ``paddle_tpu/serve/engine.py``, with the same scheduling
contract:

- **Admission: FIFO.** ``submit()`` refuses a request that could never
  run (``prompt + max_new_tokens`` over ``max_seq_len``, or a KV working
  set larger than the pool) with ``ValueError`` and queues the rest.
  Each ``step()`` admits from the queue head while a slot and blocks are
  free; the head blocks the line.
- **Continuous batching.** A finished stream frees its slot and blocks
  at once; the next queued request prefills into that slot on the next
  ``step()`` while the others keep decoding.
- **Eviction: youngest-first.** When a growing stream needs a block and
  the pool is dry, the most recently admitted stream is evicted and
  re-queued at the FRONT with its tokens (it re-prefills on
  re-admission). The oldest stream is never a victim.
- **Prefix cache** (``prefix_cache=True``): full blocks are shared
  between streams with equal prefixes, with copy-on-write when a prompt
  is matched in full (``serve/prefix.py``).
- **Decode bursts** (``decode_burst=N``): up to N decode ticks per
  scheduler pass, eos latched per row inside the burst, tokens copied
  to the host once per burst.

- **One captured decode step.** Slot state (tokens, lengths, block
  tables, active mask, temperatures, eos ids) enters the decode tick as
  data at fixed ``[max_slots, ...]`` shapes, packed into one int32
  tensor (one host-to-device copy a pass), so admission, finish and
  preemption churn never capture again: ``serve.decode_traces`` (and
  ``decode_traces``) stays at 1 for the life of the engine, or at
  ``len(burst_lens_used)`` in burst mode, one graph per power-of-two
  burst length.
- **Prefill buckets.** A prefill is padded to a power-of-two bucket
  (:func:`prefill_bucket`: at least 8, at most ``max_seq_len``) and runs
  through one captured graph per (kind, bucket), kind being the cold
  prefill or the prefix-cache suffix prefill. The ids, their count, the
  start position and the block-table row enter as data, packed into one
  int32 tensor; the graph returns the last real row's fp32 logits.
  ``serve.prefill_traces{bucket}`` (and ``prefill_traces``) counts the
  graphs made, as the reference counts its compiles, so the counts
  equal the reference's for the same submissions. Pad rows attend to
  the real keys only, their K/V go to the sink block (below) and their
  logits are never read.
- **Tracing and SLOs** (``trace=``, ``slo=``, or the reference's
  ``PADDLE_TPU_TRACE`` / ``PADDLE_TPU_SLO``): an
  ``observability.tracing.ServeTracer`` grows a span tree on every
  request (queue, prefill with its bucket, decode, preempt, resume,
  recompute) and an ``observability.slo.SloMonitor`` evaluates its rules
  at every step boundary. Their hooks are host-side, on the scheduler
  path, never inside a graph, so ``decode_traces`` stays 1 with tracing
  on. Both read the engine's ``clock``.

What differs from the reference, and why:

- The reference's compiled steps are jitted functions; here they are
  CUDA graphs (``jit/_capture.py``): the first call of the tick (of each
  burst length, of each prefill bucket) runs eagerly and is then
  captured, every later call replays it. Slot churn and prompt lengths
  within a bucket are data, so a graph never changes. On the CPU, and
  under ``jit.enable_capture(False)``, the same functions run eagerly on
  the same buffers; a capture that fails raises ``CaptureFailed``.
  ``warm_burst`` captures a length before traffic arrives and leaves the
  sampler's generator as it found it, so sampled streams do not depend
  on warm-up. Copy-on-write (``_cow``) stays eager.
- The KV pool is updated IN PLACE (``index_put_`` on a flat view of
  each layer's ``[KVH, blocks, block_size, DH]`` tensors), where the
  reference donated the pool buffers to each jitted call. Torch indexing
  has no ``mode="drop"``, so the pool holds one block more than
  ``BlockPool`` hands out, the sink block: every slot writes each tick,
  and the rows the reference fenced off with an out-of-range slot id
  (idle slots, rows latched at eos in a burst) write into the sink,
  which no block table holds and no attention reads.
- Sampling draws from a ``torch.Generator`` on the engine's device
  (seeded from ``seed``), so sampled streams are reproducible within the
  port but differ from the reference's ``jax.random`` streams; greedy
  streams match the reference token for token.
- The Llama and GPT families, as the reference. The reference's step
  also feeds its health monitor (``observability.health``), which the
  port does not have yet (ROADMAP queue A item 5).

The layer math is ``models/generation``'s (``_decoder_stack``): every
path (the decode tick, the cold prefill and the suffix prefill) embeds
its tokens at their absolute positions in the stream (GPT adds the
learned position rows, looked up on the device; Llama rotates by the
rope rows), and only the attention differs. A suffix prefill's pad rows
can sit past ``max_seq_len``, where the reference's ``jnp.take`` fills;
torch indexing would fault on the card, so their positions are clamped
to the last row of the tables.

Attention over the pool is ``ops/cuda/paged_attention``'s
``paged_attention_decode``: the hand-written CUDA kernel for CUDA
tensors (``attention_backend="auto"`` or ``"kernel"``), its plain
version for CPU tensors or with ``attention_backend="reference"``. Cold
prefill attention is the reference's plain fp32 softmax, not a kernel.
"""
from __future__ import annotations

import collections
import time
import weakref
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from .. import observability as obs
from ..core.generator import make_generator
from ..core.place import device_of, resolve_device
from ..incubate.nn.functional.inference_attention import _write_kv
from ..jit._capture import Graphed
from ..observability import slo as _slo_mod
from ..observability import tracing as _tracing_mod
from ..models import generation as _gen
from ..ops.cuda.paged_attention import paged_attention_decode
from .pool import BlockPool, PoolExhaustedError
from .prefix import PrefixCache

__all__ = ["ServeEngine", "Request", "PoolExhaustedError", "prefill_bucket"]

# --- serve. metric subsystem (the reference's names) --------------------
_M_QUEUE_DEPTH = obs.gauge(
    "serve.queue_depth", "requests waiting for a decode slot")
_M_POOL_OCCUPANCY = obs.gauge(
    "serve.pool_occupancy", "fraction of KV pool blocks allocated")
_M_BATCH_FILL = obs.gauge(
    "serve.batch_fill", "active streams / max_slots at the last step")
_M_TOKENS_PER_SEC = obs.gauge(
    "serve.tokens_per_sec", "aggregate generated tokens/sec over run()")
_M_ADMITTED = obs.counter(
    "serve.requests_admitted", "requests scheduled into a decode slot "
    "(re-admissions after preemption count again)")
_M_FINISHED = obs.counter(
    "serve.requests_finished", "requests completed, by reason "
    "(eos / max_new_tokens)")
_M_REJECTED = obs.counter(
    "serve.requests_rejected", "submissions refused at validation, by "
    "reason")
_M_PREEMPTIONS = obs.counter(
    "serve.preemptions", "streams evicted mid-decode, by reason")
_M_STALLS = obs.counter(
    "serve.admission_stalls", "scheduler passes where the queue head "
    "could not be admitted, by reason")
_M_TOKENS = obs.counter(
    "serve.tokens_generated", "tokens emitted across all streams")
_M_DECODE_STEPS = obs.counter(
    "serve.decode_steps", "batched decode steps executed")
_M_DECODE_TRACES = obs.counter(
    "serve.decode_traces", "times the persistent decode step was "
    "traced — slot churn must keep this at 1 per engine")
_M_PREFILL_TRACES = obs.counter(
    "serve.prefill_traces", "prefill graphs made, by length bucket")
_M_TTFT = obs.histogram(
    "serve.ttft_seconds", "submit -> first generated token wall time "
    "(queue wait included)")
_M_REQUEST_SECONDS = obs.histogram(
    "serve.request_seconds", "submit -> finish wall time per request")
_M_DECODE_SECONDS = obs.histogram(
    "serve.decode_step_seconds", "wall time of one batched decode pass "
    "(one tick, or one burst of ticks), tokens back on the host")
_M_PREFILL_SECONDS = obs.histogram(
    "serve.prefill_seconds", "wall time of one prefill call")
_M_PREFIX_HITS = obs.counter(
    "serve.prefix_hits", "admissions that mounted shared KV blocks "
    "from the prefix cache")
_M_PREFIX_BLOCKS = obs.counter(
    "serve.prefix_blocks_shared", "full KV blocks mounted read-only "
    "from the prefix cache at admission — prefill was skipped for "
    "those tokens")
_M_COW = obs.counter(
    "serve.cow_copies", "copy-on-write block duplications where a "
    "stream diverged inside a shared prefix block")
_M_BURST_TOKENS = obs.counter(
    "serve.burst_tokens", "tokens generated inside multi-step decode "
    "bursts")
_M_HOST_RT = obs.counter(
    "serve.host_roundtrips", "device->host token copies — one per "
    "decode pass, so decode_burst=N cuts this ~N x per token")

QUEUED = "QUEUED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"


def prefill_bucket(n: int, max_seq_len: int) -> int:
    """The padded length of an ``n``-token prefill: the next power of two,
    at least 8 and at most ``max_seq_len`` (the reference's buckets)."""
    return min(max(8, 1 << (n - 1).bit_length()), max_seq_len)


@dataclass
class Request:
    """One stream: prompt in, tokens out, scheduling state in between."""

    id: int
    prompt: np.ndarray                     # [t0] int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    temperature: float = 0.0               # 0.0 = greedy
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None
    state: str = QUEUED
    ids: List[int] = field(default_factory=list)   # prompt + generated
    blocks: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    admit_seq: int = -1                    # recency rank for eviction
    preemptions: int = 0
    warmup: bool = False                   # excluded from TTFT telemetry
    # prefix-cache bookkeeping (see the reference's Request)
    prefix_node: Optional[object] = field(default=None, repr=False)
    registered_upto: int = 0
    shared_blocks: int = 0
    prefilled_tokens: int = 0
    # span tree (observability.tracing.RequestTrace) when the engine
    # runs with tracing on; None otherwise
    trace: Optional[object] = field(default=None, repr=False)

    @property
    def n_prompt(self) -> int:
        return len(self.prompt)

    @property
    def n_generated(self) -> int:
        return len(self.ids) - self.n_prompt

    @property
    def output_ids(self) -> List[int]:
        """Generated tokens only (prompt excluded)."""
        return self.ids[self.n_prompt:]

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


class ServeEngine:
    """Continuous-batching server over a paged KV pool (module docstring
    has the contract). Llama and GPT families; a GPT model's
    ``max_position_embeddings`` must cover ``max_seq_len``.

    Usage::

        model = LlamaForCausalLM(cfg)                  # on the card
        eng = ServeEngine(model, max_slots=4, block_size=32,
                          num_blocks=64, max_seq_len=256)
        r1 = eng.submit(prompt_ids, max_new_tokens=32, eos_token_id=2)
        eng.run()
        print(r1.output_ids, r1.ttft)

    ``device=None`` means the card (raises without one); the model must
    already live on the engine's device. ``prefix_cache`` turns on
    cross-request KV block sharing; ``decode_burst`` is the most decode
    ticks run per scheduler pass (1 = one tick per step). ``clock`` is a
    zero-argument callable giving seconds (default
    ``time.perf_counter``): every request timestamp, tracer span and SLO
    window reads it. ``trace`` is True/False, a ready ``ServeTracer``, or
    None to read ``PADDLE_TPU_TRACE``; ``slo`` is a rule list
    (``SloRule`` s, dicts, inline JSON or a file path), a ready
    ``SloMonitor``, or None to read ``PADDLE_TPU_SLO``.
    """

    def __init__(self, model, *, max_slots: int = 4, block_size: int = 32,
                 num_blocks: int = 64, max_seq_len: int = 256,
                 seed: int = 0, name: str = "default",
                 attention_backend: str = "auto", clock=None,
                 trace=None, slo=None, prefix_cache: bool = False,
                 decode_burst: int = 1, device=None):
        if not hasattr(model, "llama") and not hasattr(model, "gpt"):
            raise NotImplementedError(
                "ServeEngine supports the Llama and GPT families (the "
                f"paged-decode surface); got {type(model).__name__}")
        self._p = _gen._decode_family(model)
        max_pos = self._p.get("max_positions")
        if max_pos is not None and max_seq_len > max_pos:
            raise ValueError(
                f"max_seq_len ({max_seq_len}) exceeds the model's learned "
                f"position table (max_position_embeddings={max_pos})")
        if max_slots < 1:
            raise ValueError(
                f"max_slots must be >= 1, got {max_slots} — with no "
                f"decode slot nothing can ever be admitted and every "
                f"step loop would spin forever")
        if attention_backend not in ("auto", "kernel", "reference"):
            raise ValueError(
                f"attention_backend must be 'auto', 'kernel' or "
                f"'reference', got {attention_backend!r}")
        self.device = resolve_device(device)
        if device_of(model) != self.device:
            raise ValueError(
                f"the model lives on {device_of(model)} but the engine runs "
                f"on {self.device}; build the model on the engine's device")
        self.name = str(name)
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len)
        self._clock = clock if clock is not None else time.perf_counter
        self.max_blocks_per_seq = -(-self.max_seq_len // self.block_size)
        self.pool = BlockPool(num_blocks, block_size)
        self._backend = attention_backend

        self._nh, self._nkv = self._p["nh"], self._p["nkv"]
        self._dh, self._L = self._p["dh"], len(self._p["layers"])
        self._dtype = self._p["embed"].dtype
        # one block past those the pool hands out: the sink (module
        # docstring)
        self._sink = self.pool.num_blocks
        shape = (self._nkv, self.pool.num_blocks + 1, self.block_size,
                 self._dh)
        self._caches = [
            (torch.zeros(shape, dtype=self._dtype, device=self.device),
             torch.zeros(shape, dtype=self._dtype, device=self.device))
            for _ in range(self._L)]
        if self._p["family"] == "llama":
            # the fp32 rope tables, built once, outside any capture
            _gen._rope_full(self._p, self.max_seq_len, self.device)

        # host-side slot state
        self._slots: List[Optional[Request]] = [None] * self.max_slots
        self._tables = np.zeros(
            (self.max_slots, self.max_blocks_per_seq), np.int32)
        self._lens = np.zeros(self.max_slots, np.int32)
        self._tokens = np.zeros(self.max_slots, np.int32)
        self._temps = np.zeros(self.max_slots, np.float32)
        self._eos = np.full(self.max_slots, -1, np.int32)   # -1 = none

        self._prefix: Optional[PrefixCache] = (
            PrefixCache(self.block_size) if prefix_cache else None)
        if int(decode_burst) < 1:
            raise ValueError(
                f"decode_burst must be >= 1, got {decode_burst}")
        self.decode_burst = int(decode_burst)
        # power-of-two burst lengths actually run; each is one captured
        # graph, so decode_traces == len(burst_lens_used) in burst mode
        self.burst_lens_used: set = set()
        # captured ticks by burst length (1 = the single tick), captured
        # prefills by (kind, bucket), and the counts of the reference's
        # compiled-step counters
        self._graphs: dict = {}
        self._prefill_graphs: dict = {}
        self.decode_traces = 0
        self.prefill_traces = 0

        self.queue: Deque[Request] = collections.deque()
        self.finished: List[Request] = []
        self._next_id = 0
        self._admit_counter = 0
        self._n_tokens = 0
        self._n_preempts = 0
        # decode-tick sampler (device) and first-token sampler (host)
        self._gen = make_generator(seed, self.device)
        self._rng = np.random.default_rng(seed)

        # request tracing and SLO monitors: host-side bookkeeping on the
        # scheduler path, never inside a graph
        if trace is None:
            trace = _tracing_mod.trace_enabled_from_env()
        if isinstance(trace, _tracing_mod.ServeTracer):
            self.tracer: Optional[_tracing_mod.ServeTracer] = trace
        elif trace:
            self.tracer = _tracing_mod.ServeTracer(
                self.name, self._clock, max_slots=self.max_slots)
        else:
            self.tracer = None
        if slo is None:
            slo = _slo_mod.rules_from_env() or None
        if isinstance(slo, _slo_mod.SloMonitor):
            self.slo: Optional[_slo_mod.SloMonitor] = slo
        elif slo:
            self.slo = _slo_mod.SloMonitor(
                slo, engine=self.name, clock=self._clock,
                exemplars=(self.tracer.exemplars if self.tracer
                           else None))
        else:
            self.slo = None

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0,
               warmup: bool = False) -> Request:
        """Validate and enqueue one stream (FIFO). Raises ``ValueError``
        for requests that could NEVER run; a request that merely has to
        wait for blocks is queued. ``warmup`` keeps the request out of
        the ``serve.ttft_seconds`` histogram."""
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            _M_REJECTED.inc(engine=self.name, reason="empty_prompt")
            raise ValueError("submit: prompt is empty")
        if max_new_tokens < 1:
            _M_REJECTED.inc(engine=self.name, reason="bad_max_new_tokens")
            raise ValueError(
                f"submit: max_new_tokens must be >= 1, got "
                f"{max_new_tokens}")
        total = prompt.size + int(max_new_tokens)
        if total > self.max_seq_len:
            _M_REJECTED.inc(engine=self.name, reason="too_long")
            raise ValueError(
                f"submit: prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) = {total} exceeds the engine's "
                f"max_seq_len ({self.max_seq_len})")
        # the last generated token is emitted but never written back, so
        # the KV working set is total - 1 positions
        need = self.pool.blocks_for_tokens(total - 1)
        if need > self.pool.num_blocks:
            _M_REJECTED.inc(engine=self.name, reason="pool_too_small")
            raise ValueError(
                f"submit: request needs {need} KV blocks "
                f"(block_size={self.block_size}) but the whole pool is "
                f"{self.pool.num_blocks} — it can never be admitted")
        req = Request(
            id=self._next_id, prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            eos_token_id=(None if eos_token_id is None
                          else int(eos_token_id)),
            temperature=float(temperature),
            submit_time=self._clock(),
            ids=[int(t) for t in prompt], warmup=bool(warmup))
        self._next_id += 1
        self.queue.append(req)
        if self.tracer is not None and not req.warmup:
            self.tracer.on_submit(req)
        _M_QUEUE_DEPTH.set(len(self.queue), engine=self.name)
        return req

    # -- engine loop -------------------------------------------------------
    @property
    def n_active(self) -> int:
        """Streams currently holding a decode slot."""
        return sum(1 for r in self._slots if r is not None)

    @property
    def has_work(self) -> bool:
        """True while anything is queued or decoding."""
        return bool(self.queue) or any(r is not None for r in self._slots)

    def step(self) -> int:
        """One scheduler iteration: admit from the queue into free slots
        (prefill), then one decode pass (one tick, or a burst) for every
        active stream. Returns the number of streams active this step."""
        serving_real_work = self.slo is not None and any(
            not r.warmup for r in self._live_requests())
        tok0, pre0 = self._n_tokens, self._n_preempts
        self._admit()
        n_active = self.n_active
        if n_active:
            if self.decode_burst > 1:
                self._decode_burst_once()
            else:
                self._decode_once()
        _M_QUEUE_DEPTH.set(len(self.queue), engine=self.name)
        _M_POOL_OCCUPANCY.set(round(self.pool.occupancy, 4),
                              engine=self.name)
        _M_BATCH_FILL.set(round(n_active / self.max_slots, 4),
                          engine=self.name)
        if serving_real_work:
            # step-boundary SLO evaluation, skipped while the only work
            # is warm-up (whose TTFT bills captures, not serving)
            self.slo.on_step(tokens=self._n_tokens - tok0,
                             preemptions=self._n_preempts - pre0,
                             now=self._clock())
        return n_active

    def _live_requests(self):
        yield from self.queue
        yield from (r for r in self._slots if r is not None)

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Drive :meth:`step` until queue and slots drain; returns the
        finished requests. Sets ``serve.tokens_per_sec`` over the run."""
        t0 = self._clock()
        tok0 = sum(r.n_generated for r in self.finished)
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"run(): exceeded max_steps={max_steps} with "
                    f"{len(self.queue)} queued and "
                    f"{sum(1 for r in self._slots if r)} active — "
                    f"scheduler is not making progress")
        dt = self._clock() - t0
        n_tok = sum(r.n_generated for r in self.finished) - tok0
        if dt > 0 and n_tok:
            _M_TOKENS_PER_SEC.set(round(n_tok / dt, 2), engine=self.name)
        return self.finished

    # -- scheduling --------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self._slots):
            if r is None:
                return i
        return None

    def _admit(self):
        """FIFO admission from the queue head into free slots, with the
        prefix cache's longest-prefix match and copy-on-write (see the
        reference's ``_admit``)."""
        bs = self.block_size
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                _M_STALLS.inc(engine=self.name, reason="no_free_slot")
                return
            req = self.queue[0]
            # resumed streams re-prefill prompt+generated minus the
            # pending last token; fresh streams prefill the prompt (a
            # COPY: _prefill appends the first token to req.ids)
            prefill_ids = list(req.ids[:-1] if req.n_generated > 0
                               else req.ids)
            n_pre = len(prefill_ids)
            matched: List[int] = []
            cow = False
            if self._prefix is not None:
                matched = self._prefix.match(prefill_ids)
                # a full-prompt match must still produce the last
                # token's logits: recompute it into a CoW copy
                cow = bool(matched) and len(matched) * bs >= n_pre
            read_only = matched[:-1] if cow else matched
            if read_only:
                self.pool.acquire(read_only)
                self._prefix.note_acquired(read_only)
            need = self.pool.blocks_for_tokens(n_pre) - len(read_only)
            evictable = (self._prefix.evictable_blocks
                         if self._prefix is not None else 0)
            if need > self.pool.free_blocks + evictable:
                # head-of-line blocking is the FIFO contract; put the
                # acquired prefix references back
                if read_only:
                    self._prefix.note_cached(
                        self.pool.release(read_only, retain=read_only))
                _M_STALLS.inc(engine=self.name, reason="no_free_blocks")
                return
            self.queue.popleft()
            fresh = self._alloc_blocks(need)
            req.blocks = list(read_only) + fresh
            req.shared_blocks = len(read_only)
            if cow:
                # fresh[0] sits at the divergence position: duplicate the
                # shared block's K/V so the recomputed last token writes
                # into private pages
                self._cow(matched[-1], fresh[0])
                _M_COW.inc(engine=self.name)
            if read_only or cow:
                _M_PREFIX_HITS.inc(engine=self.name)
                _M_PREFIX_BLOCKS.inc(len(read_only), engine=self.name)
            if self._prefix is not None:
                req.prefix_node = self._prefix.node_for(prefill_ids)
                req.registered_upto = len(matched)
            req.slot = slot
            req.state = RUNNING
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self._slots[slot] = req
            row = np.zeros(self.max_blocks_per_seq, np.int32)
            row[:len(req.blocks)] = req.blocks
            self._tables[slot] = row
            if self.tracer is not None:
                self.tracer.on_admit(req, slot,
                                     resumed=req.n_generated > 0)
            # shared tokens are resident KV the suffix attends to but
            # never recomputes; under CoW the suffix is the last token
            start = (n_pre - 1) if cow else len(read_only) * bs
            self._prefill(req, prefill_ids, start=start)
            _M_ADMITTED.inc(engine=self.name)
            if req.state is FINISHED:
                continue        # eos / max_new hit on the first token
            self._lens[slot] = n_pre
            self._tokens[slot] = req.ids[-1]
            self._temps[slot] = req.temperature
            self._eos[slot] = (-1 if req.eos_token_id is None
                               else req.eos_token_id)

    def _alloc_blocks(self, n: int) -> List[int]:
        """Pool alloc backed by prefix-cache eviction (LRU refcount-0
        cached blocks first). Raises ``PoolExhaustedError`` when even
        eviction cannot cover ``n``."""
        if self._prefix is not None and n > self.pool.free_blocks:
            self._prefix.evict(self.pool, n - self.pool.free_blocks)
        return self.pool.alloc(n)

    def _prefill(self, req: Request, prefill_ids: List[int],
                 start: int = 0):
        """Prefill this stream's KV. ``start`` tokens are already
        resident (mounted from the prefix cache), so only the suffix is
        computed — through the block table, where each suffix row attends
        to the shared prefix it never recomputed. ``start == 0`` is the
        cold path (in-prompt causal attention). Either runs padded to its
        bucket through that bucket's graph (:meth:`_run_prefill`)."""
        suffix = prefill_ids[start:]
        n = len(suffix)
        if self.tracer is not None:
            self.tracer.on_prefill(
                req, bucket=prefill_bucket(n, self.max_seq_len), tokens=n)
        req.prefilled_tokens += n
        with _M_PREFILL_SECONDS.time(engine=self.name):
            logits = self._run_prefill(suffix, start, self._tables[req.slot])
            if req.n_generated == 0:
                logits = logits.cpu().numpy()
        if req.n_generated == 0:
            # fresh stream: its FIRST token comes from the prefill logits
            # (the TTFT moment); resumed streams already hold theirs
            tok = self._sample_host(logits, req.temperature)
            now = self._clock()
            req.first_token_time = now
            if not req.warmup:
                _M_TTFT.observe(now - req.submit_time, engine=self.name)
                if self.slo is not None:
                    self.slo.observe_ttft(now - req.submit_time, now=now)
            if self.tracer is not None:
                self.tracer.on_first_token(req, now)
            self._append_token(req, tok)
        else:
            # resumed streams append nothing; their just-refilled full
            # blocks still need trie registration
            self._register_full_blocks(req)
        if self.tracer is not None and req.state is not FINISHED:
            self.tracer.on_decode_begin(req)

    def _sample_host(self, logits: np.ndarray, temperature: float) -> int:
        """First-token sampling (host-side, numpy, as the reference).
        Greedy at temperature 0."""
        if temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / max(temperature, 1e-6)
        z -= z.max()
        prob = np.exp(z)
        prob /= prob.sum()
        return int(self._rng.choice(logits.shape[0], p=prob))

    def _register_full_blocks(self, req: Request):
        """Register every newly-FULL block of this stream in the prefix
        trie (written positions are ``len(ids) - 1``)."""
        if self._prefix is None or req.prefix_node is None:
            return
        bs = self.block_size
        full = (len(req.ids) - 1) // bs
        while req.registered_upto < full:
            b = req.registered_upto
            req.prefix_node = self._prefix.register(
                req.prefix_node, req.ids[b * bs:(b + 1) * bs],
                req.blocks[b])
            req.registered_upto += 1

    def _release_blocks(self, req: Request):
        """Drop this stream's references; trie-registered blocks whose
        refcount hits 0 stay cached (matchable), the rest are freed."""
        if self._prefix is not None:
            retain = [b for b in req.blocks
                      if self._prefix.is_registered(b)]
            self._prefix.note_cached(
                self.pool.release(req.blocks, retain=retain))
        else:
            self.pool.free(req.blocks)
        req.blocks = []

    def _append_token(self, req: Request, tok: int,
                      now: Optional[float] = None):
        """``now`` carries the in-burst step-boundary timestamp of a token
        produced inside a burst; None reads the clock."""
        req.ids.append(int(tok))
        self._n_tokens += 1
        _M_TOKENS.inc(engine=self.name)
        self._register_full_blocks(req)
        if req.eos_token_id is not None and tok == req.eos_token_id:
            self._finish(req, "eos", now=now)
        elif req.n_generated >= req.max_new_tokens:
            self._finish(req, "max_new_tokens", now=now)

    def _finish(self, req: Request, reason: str,
                now: Optional[float] = None):
        self._release_blocks(req)
        if req.slot is not None:
            self._clear_slot(req.slot)
        req.slot = None
        req.state = FINISHED
        req.finish_reason = reason
        req.finish_time = self._clock() if now is None else now
        self.finished.append(req)
        _M_FINISHED.inc(engine=self.name, reason=reason)
        _M_REQUEST_SECONDS.observe(req.finish_time - req.submit_time,
                                   engine=self.name)
        if self.tracer is not None:
            self.tracer.on_finish(req)

    def _clear_slot(self, slot: int):
        self._slots[slot] = None
        self._tables[slot] = 0
        self._lens[slot] = 0
        self._tokens[slot] = 0
        self._temps[slot] = 0.0
        self._eos[slot] = -1

    def _preempt_youngest(self) -> Request:
        """Evict the most recently admitted active stream back to the
        FRONT of the queue; the oldest is never a victim."""
        victims = [r for r in self._slots if r is not None]
        victim = max(victims, key=lambda r: r.admit_seq)
        self._release_blocks(victim)
        self._clear_slot(victim.slot)
        victim.slot = None
        victim.state = QUEUED
        victim.preemptions += 1
        self._n_preempts += 1
        self.queue.appendleft(victim)
        _M_PREEMPTIONS.inc(engine=self.name, reason="pool_exhausted")
        if self.tracer is not None:
            self.tracer.on_preempt(victim)
        return victim

    def _ensure_blocks(self, lookahead: int = 1):
        """Every active stream needs the block its next token writes
        into; allocate at block boundaries, evicting youngest-first when
        the pool runs dry. ``lookahead > 1`` (bursts) pre-allocates for
        the next ``lookahead`` tokens, but only the must-have block is
        worth a preemption — otherwise the burst just shrinks."""
        for req in sorted((r for r in self._slots if r is not None),
                          key=lambda r: r.admit_seq):
            if req.slot is None:
                continue          # evicted by an older stream this pass
            la = max(1, min(lookahead,
                            req.max_new_tokens - req.n_generated))
            bi = int(self._lens[req.slot]) // self.block_size
            target = (int(self._lens[req.slot]) + la - 1) // self.block_size
            while target >= len(req.blocks):
                try:
                    new = self._alloc_blocks(1)
                except PoolExhaustedError:
                    if len(req.blocks) > bi:
                        break     # next token covered; burst shrinks
                    if self._preempt_youngest() is req:
                        break     # req went back to the queue itself
                    continue
                req.blocks.extend(new)
                self._tables[req.slot, len(req.blocks) - 1] = new[0]

    def _decode_once(self):
        self._ensure_blocks()
        active_np = np.array([r is not None for r in self._slots], bool)
        if not active_np.any():
            return                # everyone was preempted away
        t0 = self._clock()
        with _M_DECODE_SECONDS.time(engine=self.name):
            ys, _ = self._run_ticks(1, active_np)
        t1 = self._clock()
        _M_DECODE_STEPS.inc(engine=self.name)
        _M_HOST_RT.inc(engine=self.name)
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            self._lens[slot] += 1
            self._append_token(req, int(ys[0, slot]))
            if req.state is not FINISHED:
                self._tokens[slot] = req.ids[-1]
        if self.tracer is not None:
            # active_after: the runnable slots this step left behind; the
            # gap to the next step counts as host stall (PTL404) only
            # while someone was still waiting to decode
            self.tracer.on_decode_step(t0, t1, active_after=self.n_active,
                                       queued=len(self.queue))

    def _pick_burst_len(self) -> int:
        """Burst length: never cross a block boundary (blocks are
        allocated on the host) or any stream's max length mid-burst,
        rounded DOWN to a power of two (as the reference, which compiled
        one scan per power of two)."""
        n = self.decode_burst
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            cap = len(req.blocks) * self.block_size - int(
                self._lens[slot])
            n = min(n, cap, req.max_new_tokens - req.n_generated)
        n = max(1, n)
        return 1 << (n.bit_length() - 1)

    def _decode_burst_once(self):
        """One scheduler pass's worth of decode as a burst: N ticks run
        back to back on the device (sampling, eos latching and length
        advance included), then the host replays the emitted token
        matrix through the normal finish/registration bookkeeping, each
        token stamped at its interpolated in-burst step boundary."""
        self._ensure_blocks(lookahead=self.decode_burst)
        active_np = np.array([r is not None for r in self._slots], bool)
        if not active_np.any():
            return                # everyone was preempted away
        n = self._pick_burst_len()
        self.burst_lens_used.add(n)
        t0 = self._clock()
        with _M_DECODE_SECONDS.time(engine=self.name):
            ys, emitted = self._run_ticks(n, active_np)
        t1 = self._clock()
        _M_DECODE_STEPS.inc(n, engine=self.name)
        _M_HOST_RT.inc(engine=self.name)
        per_step = (t1 - t0) / n
        n_emitted = 0
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            for j in range(int(emitted[slot])):
                self._lens[slot] += 1
                n_emitted += 1
                self._append_token(req, int(ys[j, slot]),
                                   now=t0 + per_step * (j + 1))
                if req.state is FINISHED:
                    break
            if req.state is not FINISHED:
                self._tokens[slot] = req.ids[-1]
        _M_BURST_TOKENS.inc(n_emitted, engine=self.name)
        if self.tracer is not None:
            self.tracer.on_decode_step(t0, t1, active_after=self.n_active,
                                       queued=len(self.queue), tokens=n)

    def warm_burst(self, n: int):
        """Capture the ``n``-tick burst (``n`` = 1: the tick) and replay it
        once over idle slot state (every row inactive: the KV writes land
        in the sink block, the outputs are discarded), so kernel builds,
        the capture and the graph's first launch happen before serving
        traffic. The sampler's generator is given back its state, so the
        streams that follow do not depend on warm-up."""
        state = self._gen.get_state()
        idle = np.zeros(self.max_slots, bool)
        for _ in range(2):
            self._run_ticks(int(n), idle)
        self._gen.set_state(state)

    # -- device work -------------------------------------------------------
    def _packed_state(self, active_np: np.ndarray) -> torch.Tensor:
        """The host slot state as ONE int32 tensor (the pass's one
        host-to-device copy): tokens, lengths, temperatures (fp32 bits),
        eos ids and the active mask, ``max_slots`` each, then the block
        tables."""
        return torch.from_numpy(np.concatenate([
            self._tokens, self._lens, self._temps.view(np.int32), self._eos,
            active_np.astype(np.int32), self._tables.reshape(-1)]))

    @torch.no_grad()
    def _run_ticks(self, n: int, active_np: np.ndarray):
        """``n`` decode ticks over every slot from the host slot state,
        through the captured graph of length ``n`` (made on first use:
        ``decode_traces``). Returns (tokens [n, B], emitted per slot [B])
        as numpy — the one device-to-host copy of the pass."""
        graph = self._graphs.get(n)
        if graph is None:
            # a weak reference: the engine holds the graph, and a cycle
            # would keep the pool and the graph's memory alive after the
            # engine is dropped, until the garbage collector ran
            engine = weakref.ref(self)
            graph = self._graphs[n] = Graphed(
                lambda packed: engine()._ticks(n, packed), self.device,
                name=f"serve.decode[{n}]", generators=[self._gen],
                fresh_outputs=False)
            self.decode_traces += 1
            _M_DECODE_TRACES.inc(engine=self.name)
        out = graph(self._packed_state(active_np)).cpu().numpy()
        return out[:n], out[n]

    def _ticks(self, n, packed):
        """The captured function: ``n`` ticks of :meth:`_decode_core` at
        fixed shapes, each latching eos per row: a finished row keeps
        ticking but freezes (its length stops, its KV write goes to the
        sink, its later tokens are never read). Returns int32 ``[n + 1,
        B]``: each tick's tokens, then the tokens each slot emitted."""
        b = self.max_slots
        tokens, lens, temps, eos, live = packed[:5 * b].view(5, b)
        temps = temps.view(torch.float32)
        tables = packed[5 * b:].view(b, self.max_blocks_per_seq)
        live = live.bool()
        emitted = torch.zeros_like(tokens)
        ys = []
        for _ in range(n):
            nxt = self._decode_core(tokens, lens, live, tables, temps)
            hit = live & (eos >= 0) & (nxt == eos)
            tokens = torch.where(live, nxt, tokens)
            lens = torch.where(live, lens + 1, lens)
            emitted = emitted + live.to(torch.int32)
            live = live & ~hit
            ys.append(nxt)
        return torch.stack(ys + [emitted])

    def _decode_core(self, tokens, lens, live, tables, temps):
        """ONE batched decode tick over every slot: each slot writes its
        pending token's K/V (live rows into their block, the others into
        the sink), attends through the block tables (paged decode
        attention; rows that are not live have length 0), projects and
        samples."""
        b = self.max_slots
        nh, dh, bs = self._nh, self._dh, self.block_size
        pos = lens.long()
        lengths = torch.where(live, pos + 1, 0).to(torch.int32)
        bi = torch.clamp(pos // bs, 0, self.max_blocks_per_seq - 1)
        phys = tables.long().gather(1, bi[:, None])[:, 0]
        slot = torch.where(live, phys, self._sink) * bs + pos % bs

        def attn(q, _k, _v, kc, vc):
            return paged_attention_decode(
                q, kc, vc, lengths, tables,
                backend=self._backend).reshape(b, nh * dh)

        out = self._stack_layers(tokens.long(), pos, slot, attn)
        logits = _gen._head_logits(self._p, out).float()    # [B, V]
        return _gen._sample_slot_tokens(logits, temps, self._gen)

    def _stack_layers(self, tokens, pos, slot, attn):
        """ONE transformer stack for decode and both prefills: the
        family's stack (``generation._decoder_stack``) over ``tokens``
        [rows] at positions ``pos`` [rows], each layer's K/V scattered
        into the pool at ``slot`` before its attention. ``attn(q, k, v,
        kc, vc) -> [rows, nh*dh]`` is the only thing the callers differ
        in. Returns the normed hidden [rows, H]."""

        def layer_attn(li, q, k, v):
            kc, vc = self._caches[li]
            _write_kv(kc, vc, k, v, slot)
            return attn(q, k, v, kc, vc)

        return _gen._decoder_stack(self._p, tokens, pos, layer_attn,
                                   self.max_seq_len)

    @torch.no_grad()
    def _run_prefill(self, suffix, start: int, table_row: np.ndarray):
        """Prefill ``suffix`` (token ids at positions ``start ..``) into
        the blocks of ``table_row`` through the graph of its kind (cold
        when ``start`` is 0, else suffix) and bucket, made on first use
        (``prefill_traces``). The ids padded with 0 to the bucket, their
        count, ``start`` and the table row go in as ONE int32 tensor (one
        host-to-device copy). Returns the last real row's fp32 logits
        ``[V]`` on the device (the graph's own buffer: read it before the
        next prefill of this bucket)."""
        n = len(suffix)
        bucket = prefill_bucket(n, self.max_seq_len)
        cold = start == 0
        key = ("cold" if cold else "suffix", bucket)
        graph = self._prefill_graphs.get(key)
        if graph is None:
            engine = weakref.ref(self)      # as the decode graphs
            graph = self._prefill_graphs[key] = Graphed(
                lambda packed: engine()._prefill_core(cold, bucket, packed),
                self.device, name=f"serve.prefill[{key[0]},{bucket}]",
                fresh_outputs=False)
            self.prefill_traces += 1
            _M_PREFILL_TRACES.inc(engine=self.name, bucket=bucket)
        packed = np.zeros(bucket + 2 + self.max_blocks_per_seq, np.int32)
        packed[:n] = suffix
        packed[bucket:bucket + 2] = n, start
        packed[bucket + 2:] = table_row
        return graph(torch.from_numpy(packed))

    def _prefill_core(self, cold: bool, bucket: int, packed):
        """The captured prefill of one stream at ``bucket`` rows (the
        packed ids, ``n``, ``start``, the block-table row). Row ``i`` sits
        at position ``start + i``; rows past ``n`` are padding: their K/V
        go to the sink block and their outputs are never read. Cold
        (``start`` 0): causal self-attention over the prompt in a plain
        fp32 softmax, as the reference, pad keys masked (a pad row sees
        the real keys, so no row is all ``-inf``). Suffix: each row
        writes its K/V into the stream's blocks, then attends THROUGH the
        block table with the paged decode attention (length ``start + i +
        1``, 0 for pad rows), so it sees the shared resident prefix plus
        the suffix rows written so far. Returns the fp32 logits of row
        ``n - 1``, gathered on the device: nothing here reads ``n`` or
        ``start`` on the host."""
        nh, kvh, dh = self._nh, self._nkv, self._dh
        bs = self.block_size
        ids = packed[:bucket].long()
        n, start = packed[bucket].long(), packed[bucket + 1].long()
        table_row = packed[bucket + 2:]
        offs = torch.arange(bucket, device=self.device)
        valid = offs < n
        # pad rows of a suffix can pass max_seq_len: any row of the
        # tables will do for them
        positions = offs if cold else torch.clamp(
            start + offs, max=self.max_seq_len - 1)
        bi = torch.clamp(positions // bs, 0, self.max_blocks_per_seq - 1)
        phys = torch.where(valid, table_row.long()[bi], self._sink)
        slot = phys * bs + positions % bs

        if cold:
            group = nh // kvh
            causal = (offs[None, :] <= offs[:, None]) & valid[None, :]

            def attn(q, k, v, _kc, _vc):
                k_rep = (torch.repeat_interleave(k, group, dim=1)
                         if group > 1 else k)
                v_rep = (torch.repeat_interleave(v, group, dim=1)
                         if group > 1 else v)
                scores = torch.einsum("qhd,khd->hqk", q.float(),
                                      k_rep.float()) * (dh ** -0.5)
                scores = scores.masked_fill(~causal[None], float("-inf"))
                probs = torch.softmax(scores, dim=-1)
                return torch.einsum("hqk,khd->qhd", probs,
                                    v_rep.float()).reshape(bucket, nh * dh)
        else:
            lengths = torch.where(valid, positions + 1, 0).to(torch.int32)
            tables_rep = table_row[None, :].expand(bucket, -1)

            def attn(q, _k, _v, kc, vc):
                return paged_attention_decode(
                    q, kc, vc, lengths, tables_rep,
                    backend=self._backend).reshape(bucket, nh * dh)

        out = self._stack_layers(ids, positions, slot, attn)
        last = out.index_select(0, (n - 1).reshape(1))
        return _gen._head_logits(self._p, last)[0].float()

    @torch.no_grad()
    def _cow(self, src: int, dst: int):
        """Copy-on-write: duplicate one physical block's K/V across every
        layer into a private block, in place."""
        for kc, vc in self._caches:
            kc[:, dst] = kc[:, src]
            vc[:, dst] = vc[:, src]
