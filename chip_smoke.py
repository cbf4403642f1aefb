#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

Phases, each fatal on failure:

1. device  — the card's name and power limit, torch and CUDA versions;
2. build   — compile every kernel from ``paddle_tpu_torch/csrc`` (nvcc,
             one process per source, all at once);
3. kernels — each hand-written kernel (forward and backward) against
             its plain PyTorch version on the card, at the serving,
             prefill, training, packed-attention and calibration shapes,
             with its time beside the plain version's, a PyTorch library
             call's where one computes the same function, and its bound;
4. forward — ``LlamaForCausalLM`` at the serving width (bf16), counting
             kernel launches, then fp32 logits of kernels vs plain;
5. serve   — the continuous-batching ``ServeEngine`` under Poisson load
             through the paged kernel (``paged_decode_split_kernel``, by
             name, once per layer in a profiled decode step), its decode
             tick a replayed CUDA graph (one capture, launches counted
             through the replays) and every prefill a replayed graph of
             its power-of-two bucket (``warm_engine`` captured one per
             reachable bucket; none made under load), TTFT, tokens/s and
             the decode step beside the same load with eager prefills
             and ticks, the decode step eager and captured, serving's
             peak memory before and after warm-up; the same load traced
             (``trace=True``: every request's span tree valid and tiling
             its latency, each prefill span's bucket, the Chrome lanes,
             the serve-trace lint, tracing's overhead) and SLO monitors
             (one latched ``ttft_p99`` breach with its counter, event,
             PTL401 and flight dump; none at 60 s); every cold and
             suffix bucket of an uncapped warm-up with the prefix cache
             (the graphs' memory and capture seconds; captured = eager
             bf16 logits bit for bit; pad rows write only the sink;
             buckets 32, 64 and 128 timed cold and suffix, captured and
             eager: wall, kernel ms, kernels, paged launches); bf16
             sampled streams and fp32 greedy streams (cold, and prefix +
             4-tick bursts: one graph per burst length) equal with
             captured and eager ticks and prefills, and on the reference
             attention; every paged call of a bf16 run with the prefix
             cache (decode, bursts, suffix prefills) held against its
             plain version;
5b. generate — ``LlamaForCausalLM.generate`` at the serving width (bf16,
             8 left-padded prompts, 64 new tokens): dense, ``paged=True``
             at blocks 64 and 128 (the paged kernel once per layer per
             tick, the varlen forward once per prefill layer, both by
             name in a profile; in bf16 every call of both kernels
             of a further run at each block held against its plain
             version, and the score gap at each first token where the
             streams differ from the dense run's and from a run on the
             plain versions printed), sampled (one seed twice, bit for bit),
             beam search (4 beams) and ``generate_speculative`` (gamma
             4, a 2-layer draft); greedy, sampled and beam streams of
             captured ticks equal to eager ticks', speculative streams of
             captured rounds equal to eager rounds'; tokens/s, prefill and
             decode-tick (beam: tick; speculative: round) times eager and
             captured, the capture's cost a call; then fp32 token streams
             at 2 layers: dense = paged on the kernels = paged on the
             plain versions = speculative (captured rounds), sampled
             dense = paged;
6. train   — ``bench.py:bench_llama``'s training step (645M Llama, bf16,
             batch 4 x 2048, ``AdamW(multi_precision=True)``): launch
             counts per step, falling loss, tokens/s, MFU, peak memory and
             the device-busy share; then fp32 loss and gradients of the
             kernels vs the plain compositions at 2 layers; the
             multi-tensor AdamW update's device ms and kernels; the step
             under ``jit.to_static(full_graph=True)`` (a CUDA graph), each
             captured step against an eager step from the same state,
             timed eager and captured, peak memory;
6b. train-recipe — the same step with the usual LLM recipe
             (``AdamW`` over ``LinearWarmup(CosineAnnealingDecay)``,
             ``ClipGradByGlobalNorm(1.0)``, no decay on the RMSNorm
             weights): the same launches and routes, falling loss, the
             schedule's rates, the clip's and the update's device ms and
             kernels; the recipe step under ``to_static`` as in
             ``[train]``; then fp32 parameters under fp16 O1 ``auto_cast``
             with a ``GradScaler`` (the fp16 tensor-core flash route,
             fp32 RMSNorm inputs, the scale each step); then the card's
             update against the same update on the CPU at 2 layers;
7. varlen  — packed-sequence attention through ``flash_attn_unpadded``
             and ``flash_attn_varlen_qkvpacked`` (8 documents packed into
             8192 tokens, 16 heads of 128, bf16, causal), forward and
             ``.backward()``: launch counts, equal results of the two
             entry points, output vs the plain version, the kernels that
             ran by name (profiler);
8. calibrate — ``tools/conv_calibration.measure_shape`` of the port at
             ResNet-50 shapes 2 and 17 (batch 64) through the tiled
             matmul kernel, and the tiled kernel that ran by name;
9. gpt     — ``GPTForCausalLM`` at ``GPTConfig.gpt2_medium()``'s full
             width and depth (24 layers, 16 heads of 64, vocab 50304,
             tied head) in bf16: the dense flash kernels at its training
             shape [8, 16, 1024, 64] with dropout 0.1 (keep mask equal
             to the plain version's, forward and backward within the
             tolerance, timed beside ``F.scaled_dot_product_attention``);
             the training step (batch 8 x 1024, dropout 0.1, AdamW with
             masters: the tensor-core flash kernels once a layer, no
             RMSNorm kernel, falling loss, tokens/s, MFU, peak memory,
             busy share) and its fp32 2-layer check against the kernels'
             plain versions; then ``generate`` and ``ServeEngine`` through
             the phases of 5 and 5b with every check they make
             (``phase_generate`` and ``phase_serve`` take the family:
             ``llama_family``, ``gpt_family``);
10. bert   — ``BertForPretraining`` at ``BertConfig.base()`` (12 layers,
             hidden 768, 12 heads of 64) in bf16: the dense flash kernels
             at its shape [36, 12, 512, 64], not causal, dropout 0.1,
             without and with a padding key bias (``flash_at_shape``);
             the whole backward run after run from one state (the port's
             embeddings must give the same gradients every time,
             ``torch.nn.Embedding``'s are reported);
             ``bench.py:bench_bert``'s step (36 x 512, MLM + NSP, dropout
             0.1, ``AdamW(1e-4, multi_precision=True)``): sequences/s,
             tokens/s, MFU, peak memory, busy share, the flash kernels by
             name; a padded batch through ``attention_mask``; the step
             under ``jit.to_static`` against eager steps from the same
             state; the fp32 2-layer check on a padded batch;
11. moe    — ``ErnieMoeForCausalLM`` at ``bench.py:bench_moe``'s
             configuration (6 layers, hidden 2048, 16 heads of 128, 8
             experts of 1408, top-2, MoE on every second layer) in bf16:
             its step (4 x 2048, ``AdamW(3e-4, multi_precision=True)``;
             the flash and RMSNorm kernels by name, the tokens each MoE
             layer dropped, MFU by active parameters), captured against
             eager, the fp32 2-layer check; ``generate`` (8 prompts of
             128 tokens, 64 new: dense greedy, sampled, 4 beams) through
             ``phase_generate`` over ``moe_family``, captured ticks
             against eager ticks;
12. resnet — ``vision.models.resnet50`` at ``bench.py:bench_resnet``'s
             step (bf16 NCHW, 256 x 3 x 224 x 224, fp32 logits into
             cross-entropy, ``Momentum(0.1, 0.9, multi_precision=True)``):
             the forward and backward run after run from one state with
             cuDNN's deterministic algorithms (the port's default: the
             gradients must be the same every time) and without them
             (reported, with what determinism costs a pass); images/s,
             MFU, peak memory, busy share, no kernel of the port by
             counter or by name; the step under ``jit.to_static`` against
             eager steps from the same state (batch-norm buffers
             included); the fp32 check on ``resnet18`` at 64 x 64;
13. sdxl   — ``models.UNet2DConditionModel`` at ``bench.py:
             bench_sdxl_unet``'s geometry (399.6M parameters, bf16): the
             dense flash kernels at its attention shapes (the
             cross-attention's 77 keys first, then the self-attention at
             [32, 10, 1024, 64] and [32, 10, 256, 128]) against their
             plain versions and timed beside
             ``F.scaled_dot_product_attention``; the backward's
             determinism as in 12; its step (batch 32 of 4 x 64 x 64
             latents, a 32 x 77 x 2048 context, fp32 MSE,
             ``AdamW(1e-4, multi_precision=True)``): the tensor-core flash
             kernels twice a transformer block, by counter and by name at
             head dims 64 and 128, images/s, MFU from the analytic FLOP
             count, captured against eager, the fp32 check on one
             transformer level at 32 x 32 latents. The training phases of
             9-13 are one function, ``phase_model_train``, over a
             ``TrainSpec`` each (``GptTrain``, ``BertTrain``, ``MoeTrain``,
             ``ResnetTrain``, ``SdxlTrain``).
14. incubate — the fused surface of ``incubate.nn``: a 24-layer
             ``FusedMultiTransformer`` at GPT-2 medium's widths (bf16, 8
             x 1024): its eval forward launches the tensor-core flash
             forward 24 times and no other port kernel, its training
             step (dropout 0.1) the forward and backward 24 times each
             (by counter and by name), timed; the stack at 2 layers in
             fp32 against the plain composition; ``fused_rms_norm`` with
             bias and residual at [8192, 2048] bf16 (the RMSNorm forward
             and backward once each) against the plain composition;
             ``fused_multi_head_attention`` with a key-only mask, whose
             flash call takes the key bias and is held against its plain
             version;
15. functional — ``flash_attention_with_sparse_mask`` at [4, 2048, 16,
             128] bf16 causal, no start rows: rows 2 and 4 once each by
             counter (the ``sparse_mask`` path) and by name, each kernel
             against its plain version; with start rows the plain masked
             path (no port kernel) in fp32 against
             ``F.scaled_dot_product_attention`` with the same boolean
             visibility; both timed. Then 41 functions of the rest of
             ``nn.functional`` in fp32 on the card against the CPU, each
             backward twice (the functions whose gradients differ
             printed), and the dropouts seed for seed on the card;
16. vision — the 11 zoo families (``VISION_FAMILIES``) at ImageNet
             widths in bf16, batch 128 at 224 x 224 (LeNet 256 at 28,
             InceptionV3 299): each backward run twice from one state
             (deterministic cuDNN on and off), the step through
             ``phase_model_train`` over ``VisionTrain`` (as 12, with
             images/s, MFU from a conv + linear FLOP count, eager and
             captured), and the smallest configuration on the card
             against the CPU (fp32; ``vgg11`` fp64).
17. detection — ``vision.ops`` (plain torch: no kernel of the port, by
             counter and by name): every op in fp32 on the card against
             the CPU at a reduced size (selections equal, backwards
             twice from one state bit-equal); then at published
             detectors' shapes, on synthetic maps: Faster R-CNN R50-FPN
             (``FRCNN``: proposals on P2-P6, 512 RoIs an image through
             RoIAlign and back, 81-class decode, per-class NMS) and
             RoIPool / PSRoIPool on its stride-16 map (``POOLS``),
             YOLOv3-608 (``YOLO``: the loss of three heads and its
             backward, yolo_box and per-class NMS), PP-YOLO's DCNv2,
             yolo_box and MatrixNMS (``PPYOLO``), SSD300's 8732 priors
             and their encoding (``SSD``): each op's device ms forward
             and backward, host syncs a call of each selection op, each
             path's wall ms, peak memory.
18. observability — the port measuring itself (``phase_observability``):
             ``phase_train``'s step under a ``StepTimer``, eager and
             under ``jit.to_static``, each form's ``train.step_seconds``
             (device time between CUDA events) within 5% of its synced
             wall, its FLOPs (``measure_flops``) equal to
             ``llama_step_flops``, its launches the counters'; the
             memory gauges against the allocator and a faulting step's
             flight dump with ``device_memory``; a ``Profiler`` window's
             port kernels by name and class against the counters, its
             device total within 5% of ``profile_kernels``'; serving
             under ``run_load`` with and without a ``HealthMonitor`` (one
             sample an engine step, the hook's host cost).
19. distributed — the port's distributed runtime at world 1 on NCCL
             (``phase_distributed``): ``init_parallel_env`` must bring
             up NCCL; every collective on bf16 and fp32 tensors equal to
             its world-1 value, host us a call, the
             ``comm.collective_calls`` series counting every call;
             ``DataParallel`` around ``phase_train``'s step: wrapped =
             unwrapped bit for bit over 3 steps from one state, the
             captured wrapped step = its eager twin bit for bit, each
             form's step ms, busy share, peak memory, the reducer's
             buckets. One card: no multi-rank NCCL path runs here.
20. tensor_parallel — the shard plans (``phase_tensor_parallel``):
             ``fleet.init`` at mp 1 on NCCL; ``bench_llama``'s step
             under ``llama_shard_plan`` and GPT-2 medium's under
             ``gpt_shard_plan``, each = its unsharded step bit for bit
             over 3 steps from one state, eager and captured, rows 2-5
             by name as often, no op reaching a ``DTensor``, step ms,
             busy share, peak memory and host µs both ways (the eager
             forms also timed in turns); then mp 2 as two gloo ranks on
             the one card (``--tp-rank``), the Llama's width at 2
             layers, each rank's kernels at its local shapes.
21. expert_parallel — expert parallelism (``phase_expert_parallel``):
             NCCL at world 1; ``bench_moe``'s ERNIE-MoE under
             ``ernie_moe_shard_plan`` on dp 1 x ep 1 = itself unplanned
             bit for bit over 3 steps, eager and captured, as in 20;
             ``FusedMoELayer`` with a ``moe_group`` (the einsum path)
             against its plain dense dispatch, timed beside the index
             path; then ep 2 as two gloo ranks on the one card
             (``--ep-rank``), 2 layers, 4 of the 8 experts a rank,
             held as 20's mp 2.
22. sharding — ZeRO (``phase_sharding``): ``group_sharded_parallel``
             at ``"os"``, ``"os_g"`` and ``"p_g_os"`` at world 1 on NCCL
             (nothing to shard at one rank: each = the plain step bit for
             bit, eager and captured; step ms, peak memory); then each
             level as two gloo ranks on the card (``--zero-rank``),
             the Llama's width at 2 layers, each rank on half of the
             batch, held against the unsharded full batch as 20's mp 2,
             with each rank's bytes of parameters and optimizer states
             over its own at no sharding.

Each phase prints its seconds.

Each kernel's ``launches`` in the ``kernels`` line is its count on its
own main path (``main_path``: serve, train, varlen or calibrate); the
paged and varlen-forward entries also carry their counts on the
``generate`` path under ``launches_by_path``, and every entry its counts
on GPT's paths (``gpt_train``, ``gpt_generate``: one call, ``gpt_serve``,
``gpt_serve_prefill``: one captured suffix prefill of bucket 128; Llama's
is ``serve_prefill``),
BERT's (``bert_train``), ERNIE-MoE's (``moe_train``, ``moe_generate``:
the dense greedy call, which reaches no kernel), ResNet-50's
(``resnet_train``: none), the UNet's (``sdxl_train``), the
``incubate`` path's (the stack's training step and one
``fused_rms_norm`` forward and backward), ``sparse_mask`` (one
``flash_attention_with_sparse_mask`` forward and backward) and the zoo's
(``vision_train``: none), the detection ops' (``detection``: none) and
the ``DataParallel`` step's (``distributed``: its eager timed steps) and
the shard plans' (``tensor_parallel``, ``gpt_tensor_parallel``,
``expert_parallel``: their sharded eager timed steps).

The paged kernel is held at the serving, GQA, decode-step and
suffix-prefill shapes (``PAGED_SHAPES``) with the L2 cold and warm, and
at the neighbouring split lengths (``PAGED_SPLITS``).

The dense and varlen flash kernels take a route fixed by the dtype: fp32
runs the CUDA-core kernels, bf16 and fp16 the tensor-core kernels
(``FLASH_KERNELS``, ``VARLEN_KERNELS``); varlen head dims above 256 take
the wide kernels in every dtype (``VARLEN_WIDE_KERNELS``; above 1536 in
column ranges, one block each). The kernel
phases check every route against the plain versions (the varlen kernels
at every head dim they are compiled for, 32 to 256 by 32, at two they pad
to, and at 288, 320, 512, 1024, 1568, 2048 and 3072 on the wide route,
which the profiler must show by name); the bf16 forward, training and
varlen phases read the
profiler's per-kernel counts and fail unless only the tensor-core kernels
ran. RMSNorm takes one of three variants by shape and alignment (vector,
chunked, scalar; ``RMS_CASES``), each checked in every dtype; the
training step must run the vector variant's kernels (``RMS_TRAIN_KERNELS``).
The tiled matmul has one route, the tensor cores, and the calibrate path
fails if any other tiled kernel ran. A recording that fails such a check
by name is taken again (``recorded``, at most ``PROFILE_TRIES`` in all):
the profiler drops events now and then, and a failed recording counts as
lost events only where a later one passes and shows every launch it did.

The last lines are the ``train``, ``train_recipe``, ``generate``
(Llama's beam and speculative numbers), ``gpt``, ``bert``, ``moe``,
``resnet``, ``sdxl``, ``incubate``, ``functional``, ``vision``,
``detection``, ``observability``, ``distributed``, ``tensor_parallel``,
``expert_parallel`` and ``sharding`` JSON,
the
``kernels`` JSON, the ``nvidia-smi`` name/power line, and
``{"ok": true, "device": {...}}``.

Run: ``python3 chip_smoke.py`` from the repository root on a machine with
one CUDA card. Without a card, or without the package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean wall time of one call on the device's clock: CUDA events
    around ``iters`` back-to-back calls after ``warmup`` calls (host
    launch gaps included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


#: host pause after recording starts, before the first recorded call (s)
PROFILE_START_GAP = 0.05
#: host pause after the last recorded call has finished on the card,
#: before recording stops (s)
PROFILE_END_GAP = 0.05


def profiled(fn, n: int, cpu: bool = False):
    """``torch.profiler``'s event averages over ``n`` calls of ``fn``,
    after one more call in the profiler's warm-up step and a pause of
    ``PROFILE_START_GAP`` once recording has started: a recorded call that
    begins at the start of recording can lose its first kernels (a bf16
    forward once lost its first layer, one flash launch of 10) or the
    whole trace. Recording stops ``PROFILE_END_GAP`` after the last call
    has finished on the card, so that the records of its last kernels are
    complete when the profiler collects them. The schedule's own
    ``ProfilerStep#`` ranges, which span each step on the device too, are
    left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    got = []        # the events are cleared when the recorded steps end
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=n),
                 on_trace_ready=lambda p: got.append(p.key_averages())) as prof:
        for i in range(n + 1):
            fn()
            torch.cuda.synchronize()
            if i == n:          # recording stops at this step
                time.sleep(PROFILE_END_GAP)
            prof.step()
            if i == 0:          # recording starts at this step
                time.sleep(PROFILE_START_GAP)
    return [e for e in got[0] if not e.key.startswith("ProfilerStep")]


#: recordings that a check of launches by name may take of one call
PROFILE_TRIES = 3


def recorded(take, launches, check_fn, label):
    """``take()`` records a call under the profiler, ``launches(out)`` is
    its kernel name -> launches, and ``check_fn(out)`` checks them by name
    (raising ``PhaseError``). The profiler drops events now and then even
    well inside its window (5 of the 150 paged launches of one profiled
    generate call), so a recording that fails its check is taken again,
    up to ``PROFILE_TRIES`` in all. A failed recording is admitted as lost
    events only where a later one passes and shows at least every launch
    the failed one showed: a loss removes launches and never adds one.
    Else, and where no recording passes, the phase fails. Returns the
    passing recording."""
    failed = []
    for i in range(PROFILE_TRIES):
        out = take()
        try:
            check_fn(out)
        except PhaseError as exc:
            failed.append((launches(out), exc))
            log(f"  {label}: recording {i + 1} of {PROFILE_TRIES} failed "
                f"its launch check ({exc})")
            continue
        got = launches(out)
        for lost, exc in failed:
            extra = {k: (c, got.get(k, 0)) for k, c in lost.items()
                     if c > got.get(k, 0)}
            check(not extra,
                  f"{label}: a failed recording ran launches the passing one "
                  f"did not (name: (failed, passed)) {extra}, so it lost no "
                  f"events: {exc}")
        if failed:
            log(f"  {label}: recording {i + 1} passed and holds every launch "
                f"of the {len(failed)} failed one(s): they lost events")
        return out
    raise failed[-1][1]


def _per_kernel(out):
    """The kernel name -> launches of a ``profile_kernels`` result."""
    return out[1]


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: the summed duration of every GPU
    kernel and copy it ran, from ``torch.profiler`` over ``iters`` calls.
    Host launch gaps are excluded, so a kernel shorter than its Python
    launch is still timed as the card runs it. Falls back to
    :func:`time_ms` (and says so) if the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = sum(_dev_us(e) for e in profiled(fn, iters)
                if e.device_type == DeviceType.CUDA)
    if total <= 0:
        log("  (profiler saw no device time: timing with CUDA events)")
        return time_ms(fn, iters, warmup)
    return total / iters / 1e3


def max_err(a, b) -> float:
    """Max |a - b| over entries where both are finite; inf/NaN placement
    must agree exactly (else inf)."""
    import torch

    a, b = a.float(), b.float()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return math.inf
    if not torch.equal(a[~fa], b[~fb]):      # -inf vs +inf, or NaN
        return math.inf
    if not fa.any():
        return 0.0
    return float((a[fa] - b[fb]).abs().max())


def tolerance(dtype, atol: float):
    """(atol, rtol) for comparing a kernel's output in ``dtype`` with its
    plain version. Both accumulate in fp32 and round once, so an fp32
    output may differ by ``atol`` (the fp32 accumulation order) and a
    bf16/fp16 output by that plus two units in the last place of the
    value itself (``2 * eps * |ref|``): a tolerance that scales with the
    output, so a kernel that drops part of the context fails even where
    outputs are small."""
    import torch

    if dtype == torch.float32:
        return atol, 0.0
    return atol, 2 * torch.finfo(dtype).eps


def close_err(a, b, atol: float, rtol: float):
    """(max |a - b|, worst share of the tolerance): the second is
    max |a - b| / (atol + rtol * |b|) over entries where both are finite,
    and must be <= 1. inf/NaN placement must agree exactly (else inf)."""
    err = max_err(a, b)
    if not math.isfinite(err) or err == 0.0:
        return err, err
    a, b = a.float(), b.float()
    fin = b.isfinite()
    share = (a[fin] - b[fin]).abs() / (atol + rtol * b[fin].abs())
    return err, float(share.max())


def _template_args(rest: str):
    """The template arguments that open the rest of a mangled kernel name
    (``I...E``): element types by name, integers as written, booleans as
    true / false; a repeated type (``S0_``) is the one before it, as in
    every kernel here."""
    types = (("13__nv_bfloat16", "bf16"), ("6__half", "fp16"), ("f", "fp32"))
    args, i = [], 1
    if not rest.startswith("I"):
        return args
    while i < len(rest) and rest[i] != "E":
        code = next((c for c in types if rest.startswith(c[0], i)), None)
        if code:
            args.append(code[1])
            i += len(code[0])
            continue
        m = re.match(r"Li(\d+)E", rest[i:])
        if m:
            args.append(m.group(1))
            i += m.end()
            continue
        m = re.match(r"Lb([01])E", rest[i:])
        if m:
            args.append(("false", "true")[int(m.group(1))])
            i += m.end()
            continue
        m = re.match(r"S\d*_", rest[i:])     # a type named before: T again
        if not (m and args):
            break
        args.append(args[-1])
        i += m.end()
    return args


def ptxas_table(text: str):
    """One line per kernel of a ``ptxas -v`` log: name<template args>
    (element types, head dim or accesses per thread), registers and spill
    bytes (stores / loads), each kernel once."""
    rows, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            args = _template_args(m.group(2)[n:])
            name = m.group(2)[:n] + (f"<{', '.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill {m.group(1)} / {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            row = f"{name}: {m.group(1)} registers, {spill}"
            if row not in rows:
                rows.append(row)
            name = None
    return rows


def bound_ms(n_bytes: float, flops: float, dtype_name: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timings(kernel, plain, library, n_bytes, flops, dtype_name,
            plain_iters=20):
    """Device ms of the kernel, its plain version and the library call
    (None when there is none), and the bound: a dict of the kernels-line
    numbers."""
    b_ms, by = bound_ms(n_bytes, flops, dtype_name)
    return dict(ms=device_ms(kernel),
                plain_ms=device_ms(plain, iters=plain_iters),
                library_ms=None if library is None else device_ms(library),
                bound_ms=b_ms, bound_by=by)


def show(label, t):
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    log(f"  {label}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"library {lib}, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")


def library_grad(torch, fn, inputs, grad):
    """A callable that runs the backward of ``fn(*inputs)`` for ``grad``
    on a kept graph (``torch.autograd.grad(..., retain_graph=True)``)."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------
#: RMSNorm checks: (rows, hidden, x's offset in elements from an aligned
#: start, the variant ``_launch_config`` must pick, forward and backward)
RMS_CASES = ((8, 2048, 0, "vector"), (2048, 2048, 0, "vector"),
             (8192, 2048, 0, "vector"), (300, 2047, 0, "scalar"),
             (100, 2048, 1, "scalar"), (64, 65536, 0, "chunked"))
#: (x, w) dtypes of the RMSNorm checks
RMS_DTYPES = (("float32", "float32"), ("bfloat16", "bfloat16"),
              ("float16", "float16"), ("bfloat16", "float32"))
#: each variant's kernels (csrc/rms_norm.cu), forward and backward
RMS_KERNELS = {
    "vector": ("rms_norm_fwd_vec_kernel", "rms_norm_bwd_vec_kernel"),
    "chunked": ("rms_norm_fwd_rows_kernel<T, W, 16 / sizeof(T)>",
                "rms_norm_bwd_stats_kernel + rms_norm_bwd_cols_kernel"
                "<T, W, 16 / sizeof(T)>"),
    "scalar": ("rms_norm_fwd_rows_kernel<T, W, 1>",
               "rms_norm_bwd_stats_kernel + rms_norm_bwd_cols_kernel"
               "<T, W, 1>"),
}


#: the vector variant's launch choices timed beside the rule's at
#: [8192, 2048] bf16: (accesses a lane, warps per row) x blocks per SM
RMS_CHOICES = ((1, 8), (2, 4), (4, 2))
RMS_CHOICE_BLOCKS_PER_SM = (1, 2, 4, 8)


def rms_choices(torch, rn, x, w, gy, eps, sms):
    """Device ms of the RMSNorm vector kernels, forward and backward, at
    each launch choice of ``RMS_CHOICES`` x ``RMS_CHOICE_BLOCKS_PER_SM``
    (``_launch_config`` replaced for the call): the evidence for the
    rule's constants. Keyed "fwd|bwd nv/wpr/grid"."""
    rows = x.shape[0]
    rule = rn._launch_config
    out = {}
    try:
        for backward, (nv, wpr), per_sm in itertools.product(
                (False, True), RMS_CHOICES, RMS_CHOICE_BLOCKS_PER_SM):
            grid = min(-(-rows // (8 // wpr)), per_sm * sms)
            cfg = rn.LaunchConfig("vector", 8, nv, wpr, (grid, 1),
                                  grid if backward else 0)
            rn._launch_config = lambda *a, cfg=cfg, **k: cfg
            fn = (lambda: rn.rms_norm_bwd(x, w, gy, eps=eps)) if backward \
                else (lambda: rn.rms_norm_fwd(x, w, eps=eps))
            out[f"{'bwd' if backward else 'fwd'} {nv}/{wpr}/{grid}"] = \
                device_ms(fn)
    finally:
        rn._launch_config = rule
    return out


def phase_rms_norm(torch, dev, report):
    """RMSNorm forward and backward kernels vs ``rms_norm_reference`` /
    ``rms_norm_bwd_reference`` in every variant (``RMS_CASES``): hidden
    2048 at the decode (8 rows), serving-prefill (2048) and training
    (8192) row counts takes the vector variant; hidden 2047, or x one
    element off a 16-byte boundary, the scalar one; hidden 65536 the
    chunked one (the backward at 65536 raised before the redesign); each
    in fp32, bf16, fp16 and x bf16 with w fp32 (``RMS_DTYPES``). Two
    backward calls on the same inputs must give the same bits. Both
    compute in fp32 and round once: tolerance ``tolerance(dtype, 1e-5)``
    for y and dx, i.e. 1e-5 (fp32) plus two output ulps (bf16, fp16); dw,
    a sum over up to 8192 rows of values up to ~300,
    ``tolerance(w dtype, 1e-3)`` (the fp32 sum taken in block partials
    instead of one pass). Then the times at 8, 2048 and 8192 rows x 2048,
    bf16, forward and backward, beside the plain version, ``F.rms_norm``
    and its backward, and the byte bound."""
    from paddle_tpu_torch.ops.cuda import _build, rms_norm as rn

    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(1)
    eps = 1e-6
    main = {}
    for (xn, wn), (rows, hidden, off, variant) in itertools.product(
            RMS_DTYPES, RMS_CASES):
        xdt, wdt = getattr(torch, xn), getattr(torch, wn)
        x = torch.randn(rows * hidden + off, generator=g, device=dev).to(
            xdt)[off:].view(rows, hidden)
        w = (1 + 0.1 * torch.randn(hidden, generator=g, device=dev)).to(wdt)
        gy = torch.randn(rows, hidden, generator=g, device=dev).to(xdt)
        aligned = rn._aligned(x, w)
        picked = {rn._launch_config(rows, hidden, xdt, backward=b,
                                    aligned=aligned).variant
                  for b in (False, True)}
        check(picked == {variant}, f"rms_norm [{rows}, {hidden}] offset "
                                   f"{off} {xn}: variant {picked}, want "
                                   f"{variant}")
        y = rn.rms_norm_fwd(x, w, eps=eps)
        dx, dw = rn.rms_norm_bwd(x, w, gy, eps=eps)
        dx2, dw2 = rn.rms_norm_bwd(x, w, gy, eps=eps)
        ref = rn.rms_norm_reference(x, w, eps=eps)
        rdx, rdw = rn.rms_norm_bwd_reference(x, w, gy, eps=eps)
        torch.cuda.synchronize()
        atol, rtol = tolerance(xdt, 1e-5)
        atol_w, rtol_w = tolerance(wdt, 1e-3)
        e_y, s_y = close_err(y, ref, atol, rtol)
        e_dx, s_dx = close_err(dx, rdx, atol, rtol)
        e_dw, s_dw = close_err(dw, rdw, atol_w, rtol_w)
        same = bool(torch.equal(dx, dx2)) and bool(torch.equal(dw, dw2))
        log(f"  rms_norm {variant} [{rows}, {hidden}] x {xn}"
            f"{f' (offset {off})' if off else ''}, w {wn}: y err {e_y:.3g} "
            f"({s_y:.3g} of the tolerance), dx err {e_dx:.3g} ({s_dx:.3g}), "
            f"dw err {e_dw:.3g} ({s_dw:.3g} of {atol_w} + {rtol_w:.3g}|ref|, "
            f"|dw| max {float(rdw.float().abs().max()):.3g}); two backward "
            f"calls equal: {same}")
        check(max(s_y, s_dx, s_dw) <= 1.0,
              f"rms_norm {variant} [{rows}, {hidden}] {xn}/{wn}: y {e_y} "
              f"dx {e_dx} dw {e_dw}")
        check(same, f"rms_norm_bwd {variant} [{rows}, {hidden}] {xn}/{wn}: "
                    f"two calls differ")
        if hidden == 2048 and not off and xn == wn == "bfloat16":
            main[rows] = (x, w, gy, e_y, max(e_dx, e_dw))
        del x, w, gy, y, dx, dw, dx2, dw2, ref, rdx, rdw

    times = {}
    for rows, (x, w, gy, e_fwd, e_bwd) in main.items():
        fwd = timings(lambda: rn.rms_norm_fwd(x, w, eps=eps),
                      lambda: rn.rms_norm_reference(x, w, eps=eps),
                      lambda: F.rms_norm(x, (x.shape[-1],), w, eps),
                      nbytes(x, x, w), 4 * x.numel(), "float32")
        show(f"rms_norm [{rows}, 2048] bf16", fwd)
        bwd = timings(lambda: rn.rms_norm_bwd(x, w, gy, eps=eps),
                      lambda: rn.rms_norm_bwd_reference(x, w, gy, eps=eps),
                      library_grad(torch, lambda a, b: F.rms_norm(
                          a, (a.shape[-1],), b, eps), (x, w), gy),
                      nbytes(x, w, gy, x, w), 10 * x.numel(), "float32")
        show(f"rms_norm_bwd [{rows}, 2048] bf16", bwd)
        times[rows] = (dict(max_abs_err=e_fwd, **fwd),
                       dict(max_abs_err=e_bwd, **bwd))
    x, w, gy = main[8192][:3]
    choices = rms_choices(torch, rn, x, w, gy, eps, _build.sm_count(dev))
    picked = [rn._launch_config(8192, 2048, torch.bfloat16, backward=b)
              for b in (False, True)]
    log(f"  rms_norm [8192, 2048] bf16 vector launch choices (nv/wpr/grid, "
        f"ms; the rule picks fwd {picked[0].nv}/{picked[0].wpr}/"
        f"{picked[0].grid[0]}, bwd {picked[1].nv}/{picked[1].wpr}/"
        f"{picked[1].grid[0]}): " + "; ".join(
            f"{k} {v:.4f}" for k, v in choices.items()))
    for key, name, i, line in (
            ("rms_norm", "rms_norm_fwd", 0, 53),
            ("rms_norm_bwd", "rms_norm_bwd", 1, 75)):
        report[key] = dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/rms_norm.cu",
            replaces=f"paddle_tpu/ops/pallas/rms_norm.py:{line}",
            kernels={v: pair[i] for v, pair in RMS_KERNELS.items()},
            **times[8192][i], at_2048_rows=times[2048][i],
            at_8_rows=times[8][i], launch_choices={
                k[4:]: v for k, v in choices.items()
                if k.startswith(("fwd", "bwd")[i])})


def kernel_ms(torch, fn, pattern, iters: int = 20, flush=None) -> float:
    """Device ms per call of the kernels whose profiler name contains
    ``pattern``, over ``iters`` calls of ``fn`` (after 3 warm-up calls).
    With ``flush``, a tensor larger than the 50 MB L2, it is zeroed
    before every call, so each call finds the cache cold, as a decode step
    finds a layer's pages after the other layers' weights and pages have
    passed through it; the zeroing kernel is not counted."""
    from torch.autograd import DeviceType

    def call():
        if flush is not None:
            flush.zero_()
        fn()

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    total = sum(_dev_us(e) for e in profiled(call, iters)
                if e.device_type == DeviceType.CUDA and pattern in e.key)
    check(total > 0, f"the profiler saw no {pattern} kernel")
    return total / iters / 1e3


def _pages_case(torch, dev, g, b, nh, kvh, dh, page, pps, num_pages, lens,
                dtype, one_table=False):
    """Random q and pools, and a block table per row: distinct pages where
    the pool has enough, or (``one_table``) one table for every row, as
    the engine's suffix prefill passes it."""
    q = torch.randn(b, nh, dh, generator=g, device=dev).to(dtype)
    kp = torch.randn(kvh, num_pages, page, dh, generator=g, device=dev).to(dtype)
    vp = torch.randn(kvh, num_pages, page, dh, generator=g, device=dev).to(dtype)
    perm = torch.randperm(num_pages, generator=g, device=dev)
    if one_table:
        tables = perm[:pps].to(torch.int32).repeat(b, 1)
    elif b * pps <= num_pages:
        tables = perm[:b * pps].reshape(b, pps).to(torch.int32)
    else:
        tables = torch.randint(0, num_pages, (b, pps), generator=g,
                               device=dev, dtype=torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, lengths, tables


def paged_bound(args, lens):
    """(bound ms, by, unique K/V bytes) of one paged decode call: each K/V
    row that some length covers read once (rows shared through one table
    count once), q and lengths and tables read and out written once; the
    operations are 4 * NH * DH per (row, key) pair."""
    q, kp, _, lengths, tables = args
    kvh, _, page, dh = kp.shape
    covered = {(p, t % page) for row, n in zip(tables.tolist(), lens)
               for t, p in ((t, row[t // page]) for t in range(n))}
    kv_bytes = 2 * kvh * len(covered) * dh * kp.element_size()
    n_bytes = (kv_bytes + 2 * q.numel() * q.element_size()
               + 4 * (lengths.numel() + tables.numel()))
    flops = 4 * q.shape[1] * sum(lens) * dh
    return (*bound_ms(n_bytes, flops, "bfloat16"), kv_bytes)


#: the paged decode kernel's timed shapes, bf16, D 128, page 128, 8 pages
#: per row (max_seq_len 1024), a 96-page pool: name -> (rows, q heads, kv
#: heads, lengths, one table for every row). (a) the kernel table's shape
#: (ragged, 0 and page edges); (b) a decode step of run_load (8 streams
#: 64-192 tokens into their generation); (c) the engine's suffix prefill
#: (128 suffix rows over one table, lengths 1..128); (d) the llama3-8b GQA
#: layout at (a)'s lengths; (e) one row of one token, the fixed cost of a
#: call
PAGED_TABLE_LENS = [0, 1, 127, 128, 129, 256, 700, 1024]
PAGED_SHAPES = {
    "a": (8, 16, 16, PAGED_TABLE_LENS, False),
    "b": (8, 16, 16, [64, 96, 112, 128, 144, 160, 176, 192], False),
    "c": (128, 16, 16, list(range(1, 129)), True),
    "d": (8, 32, 8, PAGED_TABLE_LENS, False),
    "e": (1, 16, 16, [1], False),
}
#: split lengths (tokens) timed beside the launch rule's at (a) and (b)
PAGED_SPLITS = (64, 128, 256)


def phase_paged(torch, dev, report):
    """Paged decode kernel vs ``paged_attention_decode_reference``: at the
    serving shape (8 slots, 16 heads, DH 128, page 128, 8 pages per
    sequence, a 96-page pool) with ragged lengths including 0 and exact
    page edges, at the llama3-8b GQA layout (32 q heads over 8 kv heads),
    at DH 64 and 256 in both layouts, at ``PAGED_SHAPES`` (b) and (c),
    and at ``generate``'s default page of 64 (16 pages per sequence, a
    192-page pool) in both layouts, in fp32, bf16 and fp16. Both accumulate in fp32 (the kernel online,
    per split and then across splits, the reference in one softmax) and
    round once: tolerance ``tolerance(dtype, 1e-5)``, i.e. 1e-5 (fp32)
    plus two output ulps of |out| (bf16, fp16). A length-0 row must be
    exactly 0, and a second call must give the same bits. Then the times
    at ``PAGED_SHAPES`` with the L2 cold and warm, and at each split
    length of ``PAGED_SPLITS`` at (a) and (b), each checked first."""
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    cases = [(f"nh={nh} kvh={kvh} D {dh}", (8, nh, kvh, PAGED_TABLE_LENS,
                                            False), dh, 128)
             for dh in (128, 64, 256) for nh, kvh in ((16, 16), (32, 8))]
    cases += [(f"shape ({key}) D 128", PAGED_SHAPES[key], 128, 128)
              for key in ("b", "c")]
    # generate's default block size: pages of 64 over the same tokens
    cases += [(f"page 64 nh={nh} kvh={kvh} D 128", (8, nh, kvh,
                                                    PAGED_TABLE_LENS, False),
               128, 64) for nh, kvh in ((16, 16), (32, 8))]
    for label, (b, nh, kvh, lens, one), dh, page in cases:
        for dt in (f32, bf16, torch.float16):
            args = _pages_case(torch, dev, g, b, nh, kvh, dh, page,
                               1024 // page, 96 * 128 // page, lens, dt,
                               one_table=one)
            out = pa.paged_attention_decode(*args, backend="kernel")
            again = pa.paged_attention_decode(*args, backend="kernel")
            ref = pa.paged_attention_decode(*args, backend="reference")
            torch.cuda.synchronize()
            atol, rtol = tolerance(dt, 1e-5)
            err, share = close_err(out, ref, atol, rtol)
            name = str(dt).replace("torch.", "")
            same = bool(torch.equal(out, again))
            log(f"  paged_decode {label} {name}: max_abs_err={err:.3g}, "
                f"{share:.3g} of the tolerance ({atol} + {rtol:.3g}|ref|), "
                f"second call bit-equal: {same}")
            check(share <= 1.0, f"paged {label} {name} {err}")
            check(same, f"paged {label} {name}: two calls differ")
            zero = [i for i, n in enumerate(lens) if n == 0]
            check(all(bool((out[i] == 0).all()) for i in zero),
                  "paged: a length-0 row is not 0")
            if dt == bf16:
                worst = max(worst, err)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    at = {}
    for key, (b, nh, kvh, lens, one) in PAGED_SHAPES.items():
        args = _pages_case(torch, dev, g, b, nh, kvh, 128, 128, 8, 96, lens,
                           bf16, one_table=one)

        def kernel():
            return pa.paged_attention_decode(*args, backend="kernel")

        b_ms, by, kv_bytes = paged_bound(args, lens)
        t = dict(ms=kernel_ms(torch, kernel, "paged_decode", flush=flush),
                 warm_ms=kernel_ms(torch, kernel, "paged_decode"),
                 plain_ms=device_ms(lambda: pa.paged_attention_decode(
                     *args, backend="reference"), iters=5),
                 bound_ms=b_ms, bound_by=by, kv_bytes=kv_bytes)
        at[key] = t
        log(f"  paged_decode ({key}) {b} rows {nh}/{kvh} heads bf16: kernel "
            f"{t['ms']:.4f} ms (L2 cold), {t['warm_ms']:.4f} ms (warm), "
            f"plain {t['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({by}, "
            f"{kv_bytes / 1e6:.2f} MB of K/V), {b_ms / t['ms']:.1%} of it")
        if key in ("a", "b", "c"):
            t["split_choices"] = paged_splits(torch, pa, args, flush, _build)
    del flush
    a = at["a"]
    report["paged"] = dict(
        name="paged_attention_decode", route="cuda",
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:163",
        kernels=list(PAGED_KERNELS), max_abs_err=worst,
        ms=a["ms"], warm_ms=a["warm_ms"], plain_ms=a["plain_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=None,
        at={k: v for k, v in at.items() if k != "a"})
    torch.cuda.empty_cache()


def paged_splits(torch, pa, args, flush, _build):
    """Kernel ms (L2 cold) at each split length of ``PAGED_SPLITS``, with
    ``_split_plan`` told the length; each checked against the plain
    version first. The launch rule's own choice is marked."""
    real = pa._split_plan
    q, kp = args[0], args[1]
    rule = real(args[4].shape[1], kp.shape[2], q.shape[0], kp.shape[0],
                q.shape[2], q.element_size(), _build.sm_count(q.device),
                group=q.shape[1] // kp.shape[0])
    ref = pa.paged_attention_decode(*args, backend="reference")
    atol, rtol = tolerance(q.dtype, 1e-5)
    got = {}
    try:
        for split in PAGED_SPLITS:
            pa._split_plan = (lambda *a, _s=split, **kw:
                              real(*a, **kw, split_tokens=_s))
            out = pa.paged_attention_decode(*args, backend="kernel")
            err, share = close_err(out, ref, atol, rtol)
            check(share <= 1.0, f"paged split {split}: {err}")
            got[split] = kernel_ms(torch, lambda: pa.paged_attention_decode(
                *args, backend="kernel"), "paged_decode", flush=flush)
    finally:
        pa._split_plan = real
    log(f"    split tokens (rule: {rule.split_tokens}, grid {rule.grid}, "
        f"{rule.stage_rows}-row stages): "
        + "; ".join(f"{s} {ms:.4f} ms" for s, ms in got.items()))
    return got


def phase_flash(torch, dev, report):
    """Flash-forward kernel vs ``_flash_fwd_reference``: causal and not,
    Sq != Sk, GQA, [1, Sk] and [B, Sk] key biases, fully masked rows
    (lse -inf), and dropout 0.1 at a fixed seed, whose keep mask must be
    identical in every dtype (read back through one-hot values). fp32
    runs the CUDA-core kernel, bf16 and fp16 the tensor-core kernel (P
    split hi + lo for P.V). Both accumulate in fp32 (the kernel tile by
    tile) and round once: tolerance
    ``tolerance(dtype, 1e-4)``, i.e. 1e-4 (fp32, sums over up to 512
    keys) plus two output ulps of |out| (bf16, fp16); lse within 1e-4."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, dt):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    def run(q, k, v, seed=None, bias=None, causal=False, rate=0.0):
        scale = q.shape[-1] ** -0.5
        got = fa._flash_fwd_kernel(q, k, v, seed, bias, causal=causal,
                                   scale=scale, dropout_rate=rate)
        ref = fa._flash_fwd_reference(q, k, v, seed, bias, causal=causal,
                                      scale=scale, dropout_rate=rate)
        torch.cuda.synchronize()
        return got, ref

    f32, bf16 = torch.float32, torch.bfloat16
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    bias_b = torch.zeros(2, 300, device=dev)
    bias_b[0] = float("-inf")            # batch 0: every key masked
    bias_b[1, ::3] = -1e9
    bias_1 = rnd(1, 300, dt=f32)
    cases = [
        ("causal B4 H16 S512 D128", (4, 16, 16, 512, 512, 128), dict(causal=True)),
        ("noncausal Sq100 Sk300 D64", (2, 4, 4, 100, 300, 64), {}),
        ("causal Sq80 Sk48 GQA8/2 (masked rows)", (2, 8, 2, 80, 48, 128),
         dict(causal=True)),
        ("bias[1,Sk] GQA4/1", (2, 4, 1, 64, 300, 128), dict(bias=bias_1)),
        ("bias[B,Sk] with a masked batch", (2, 4, 4, 64, 300, 64),
         dict(bias=bias_b)),
        ("causal dropout 0.1", (2, 4, 2, 128, 128, 128),
         dict(causal=True, seed=seed, rate=0.1)),
        ("causal Sq1 Sk77 GQA4/2 D64 (one row)", (3, 4, 2, 1, 77, 64),
         dict(causal=True)),
    ]
    main_err = None
    for label, (b, h, hkv, sq, sk, d), kw in cases:
        for dt in (f32, bf16, torch.float16):
            q, k, v = rnd(b, h, sq, d, dt=dt), rnd(b, hkv, sk, d, dt=dt), \
                rnd(b, hkv, sk, d, dt=dt)
            (out, lse), (rout, rlse) = run(q, k, v, **kw)
            name = str(dt).replace("torch.", "")
            atol, rtol = tolerance(dt, 1e-4)
            e_out, share = close_err(out, rout, atol, rtol)
            e_lse = max_err(lse, rlse)
            log(f"  flash {label} {name}: out err {e_out:.3g}, {share:.3g} of "
                f"the tolerance ({atol} + {rtol:.3g}|ref|), lse err "
                f"{e_lse:.3g} (tol 1e-4)")
            check(share <= 1.0 and e_lse <= 1e-4, f"flash {label} {name}")
            if label.startswith("causal Sq80"):
                check(bool(torch.isinf(lse[:, :, :32]).all()),
                      "flash: fully masked rows must give lse -inf")
                check(bool((out[:, :, :32] == 0).all()),
                      "flash: fully masked rows must give out 0")
            if label.startswith("causal B4") and dt == bf16:
                main_err = e_out
                main = (q, k, v)
    # the keep mask itself, on both routes: q = 0 gives every visible key
    # p = 1, and one-hot values (exact in every dtype) make
    # out[row, d] = keep[row, d] / (1 - rate) / l
    b, h, s, d = 2, 4, 96, 128
    for dt in (f32, bf16, torch.float16):
        q = torch.zeros(b, h, s, d, device=dev, dtype=dt)
        v = torch.eye(d, device=dev, dtype=dt)[:s].expand(b, h, s, d) \
            .contiguous()
        k = rnd(b, h, s, d, dt=dt)
        (out, _), (rout, _) = run(q, k, v, seed=seed, causal=True, rate=0.1)
        kept, rkept = out > 0, rout > 0
        n_kept, rn_kept = int(kept.sum()), int(rkept.sum())
        name = str(dt).replace("torch.", "")
        log(f"  flash dropout keep mask {name}: kernel keeps {n_kept}, plain "
            f"keeps {rn_kept}, identical={bool(torch.equal(kept, rkept))}")
        check(torch.equal(kept, rkept), f"flash dropout keep mask differs "
                                        f"({name})")
    # a contiguous view that starts off a 16-byte boundary: the tensor-core
    # route copies it first (16-byte row copies), with the same result
    b, h, s, d = 2, 4, 70, 64
    buf = rnd(3 * b * h * s * d + 1, dt=bf16)
    q, k, v = (buf[1 + i * b * h * s * d:1 + (i + 1) * b * h * s * d]
               .view(b, h, s, d) for i in range(3))
    out, lse = fa._flash_fwd_kernel(q, k, v, None, None, causal=True,
                                    scale=d ** -0.5, dropout_rate=0.0)
    aout, alse = fa._flash_fwd_kernel(q.clone(), k.clone(), v.clone(), None,
                                      None, causal=True, scale=d ** -0.5,
                                      dropout_rate=0.0)
    torch.cuda.synchronize()
    log(f"  flash on views off a 16-byte boundary (q at byte "
        f"{q.data_ptr() % 16}): equal to aligned copies "
        f"{bool(torch.equal(out, aout) and torch.equal(lse, alse))}")
    check(torch.equal(out, aout) and torch.equal(lse, alse),
          "flash on misaligned views differs")

    def fwd_times(q, k, v):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        sc = d ** -0.5
        return timings(
            lambda: fa._flash_fwd_kernel(q, k, v, None, None, causal=True,
                                         scale=sc, dropout_rate=0.0),
            lambda: fa._flash_fwd_reference(q, k, v, causal=True, scale=sc),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True),
            nbytes(q, k, v, q) + b * h * sq * 4,
            4 * b * h * sq * sk * d / 2, "bfloat16", plain_iters=5)

    serve_t = fwd_times(*main)
    show("flash causal [4,16,512,128] bf16", serve_t)
    # the training shape in both half dtypes: bf16 (the bf16 step) and
    # fp16 (the fp16 O1 step), out and lse
    train_errs = {}
    for dt in (torch.float16, bf16):
        q, k, v = (rnd(4, 16, 2048, 128, dt=dt) for _ in range(3))
        (out, lse), (rout, rlse) = run(q, k, v, causal=True)
        name = str(dt).replace("torch.", "")
        atol, rtol = tolerance(dt, 1e-4)
        e_out, share = close_err(out, rout, atol, rtol)
        e_lse = max_err(lse, rlse)
        log(f"  flash causal [4,16,2048,128] {name} (training shape): out "
            f"err {e_out:.3g}, {share:.3g} of the tolerance, lse err "
            f"{e_lse:.3g} (tol 1e-4)")
        check(share <= 1.0 and e_lse <= 1e-4,
              f"flash at the training shape ({name})")
        train_errs[name] = dict(max_abs_err=e_out, share=share,
                                lse_err=e_lse)
        del out, lse, rout, rlse
    err = e_out                          # bf16's, the dtype timed below
    t = fwd_times(q, k, v)
    show("flash causal [4,16,2048,128] bf16 (training shape)", t)
    report["flash"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:190",
        kernels=dict(zip(("bf16/fp16", "fp32"), FLASH_KERNELS["fwd"])),
        max_abs_err=err, **t,
        at_serving_shape=dict(max_abs_err=main_err, **serve_t),
        at_training_shape=train_errs)


def phase_flash_bwd(torch, dev, report):
    """Flash-backward kernels vs ``_flash_bwd_reference``, both fed the
    forward kernel's out and lse: the training shape (causal
    [4,16,2048,128]) and, at small shapes, Sq != Sk, GQA with fully
    masked rows (whose gradients must be exactly 0), [1, Sk] and [B, Sk]
    key biases with a fully masked batch, and dropout 0.1 at a fixed
    seed (the same keep bits as the forward). fp32 runs the CUDA-core
    kernels, bf16 and fp16 the tensor-core kernels (P and dS split
    hi + lo). Both accumulate in fp32 (the kernels tile by tile, the GQA
    group inside the block; the plain version in whole einsums) and round
    once: tolerance
    ``tolerance(dtype, 1e-4)`` on each of dq, dk, dv, i.e. 1e-4 (fp32,
    sums over up to 2048 keys or rows of gradients up to ~10) plus two
    output ulps (bf16, fp16)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(8)

    def rnd(*shape, dt):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    f32, bf16 = torch.float32, torch.bfloat16
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    bias_b = torch.zeros(2, 300, device=dev)
    bias_b[0] = float("-inf")
    bias_b[1, ::3] = -1e9
    cases = [
        ("causal B4 H16 S2048 D128 (training shape)",
         (4, 16, 16, 2048, 2048, 128), dict(causal=True)),
        ("noncausal Sq100 Sk300 D64", (2, 4, 4, 100, 300, 64), {}),
        ("causal Sq80 Sk48 GQA8/2 (masked rows)", (2, 8, 2, 80, 48, 128),
         dict(causal=True)),
        ("bias[1,Sk] GQA4/1", (2, 4, 1, 64, 300, 128),
         dict(bias=rnd(1, 300, dt=f32))),
        ("bias[B,Sk] with a masked batch", (2, 4, 4, 64, 300, 64),
         dict(bias=bias_b)),
        ("causal dropout 0.1 GQA4/2", (2, 4, 2, 128, 128, 128),
         dict(causal=True, seed=seed, rate=0.1)),
        ("causal Sq1 Sk77 GQA4/2 D64 (one row)", (3, 4, 2, 1, 77, 64),
         dict(causal=True)),
    ]
    main = None
    for label, (b, h, hkv, sq, sk, d), kw in cases:
        for dt in (f32, bf16, torch.float16):
            q, k, v = rnd(b, h, sq, d, dt=dt), rnd(b, hkv, sk, d, dt=dt), \
                rnd(b, hkv, sk, d, dt=dt)
            do = rnd(b, h, sq, d, dt=dt)
            args = (kw.get("seed"), kw.get("bias"))
            st = dict(causal=kw.get("causal", False), scale=d ** -0.5,
                      dropout_rate=kw.get("rate", 0.0))
            out, lse = fa._flash_fwd_kernel(q, k, v, *args, **st)
            got = fa._flash_bwd_kernel(q, k, v, out, lse, do, *args, **st)
            ref = fa._flash_bwd_reference(q, k, v, out, lse, do, *args, **st)
            torch.cuda.synchronize()
            name = str(dt).replace("torch.", "")
            atol, rtol = tolerance(dt, 1e-4)
            res = [close_err(a, r, atol, rtol) for a, r in zip(got, ref)]
            log(f"  flash_bwd {label} {name}: " + ", ".join(
                f"{n} err {e:.3g} ({sh:.3g} of the tolerance)"
                for n, (e, sh) in zip(("dq", "dk", "dv"), res)))
            check(all(sh <= 1.0 for _, sh in res), f"flash_bwd {label} {name}")
            if label.startswith("causal Sq80"):
                check(bool((got[0][:, :, :32] == 0).all()),
                      "flash_bwd: fully masked rows must give dq 0")
            if label.startswith("bias[B"):
                check(all(bool((x[0] == 0).all()) for x in got),
                      "flash_bwd: a fully masked batch must give 0 grads")
            if label.startswith("causal B4") and dt == bf16:
                main = (q, k, v, out, lse, do, max(e for e, _ in res))
            del q, k, v, do, out, lse, got, ref
    q, k, v, out, lse, do, err = main
    b, h, sq, d = q.shape
    sk = k.shape[2]
    sc = d ** -0.5
    kw = dict(causal=True, scale=sc, dropout_rate=0.0)
    t = timings(
        lambda: fa._flash_bwd_kernel(q, k, v, out, lse, do, None, None, **kw),
        lambda: fa._flash_bwd_reference(q, k, v, out, lse, do, **kw),
        library_grad(torch, lambda a, b_, c: torch.nn.functional
                     .scaled_dot_product_attention(a, b_, c, is_causal=True),
                     (q, k, v), do),
        nbytes(q, k, v, out, do, q, k, v) + lse.numel() * 4,
        5 * 2 * b * h * sq * sk * d / 2, "bfloat16", plain_iters=5)
    show("flash_bwd causal [4,16,2048,128] bf16", t)
    report["flash_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:404",
        kernels={"bf16/fp16": [FLASH_KERNELS["dq"][0],
                               FLASH_KERNELS["dkv"][0]],
                 "fp32": [FLASH_KERNELS["dq"][1], FLASH_KERNELS["dkv"][1]]},
        max_abs_err=err, **t)
    del main, q, k, v, out, lse, do
    torch.cuda.empty_cache()


#: the varlen full-width case: bench_llama's 4 x 2048 token budget packed
#: from documents of unequal length, boundaries off the 32-row tiles
VARLEN_LENS = [1801, 377, 2048, 655, 1013, 250, 1537, 511]
VARLEN_HEADS, VARLEN_DIM = 16, 128


def _cu(torch, lens, dev):
    return torch.tensor([0, *itertools.accumulate(lens)], dtype=torch.int32,
                        device=dev)


def _varlen_library(torch, q, k, v, cu, max_len, out_ref, do):
    """One PyTorch call for the same varlen causal attention, timed beside
    the kernels and never on the port's path: the varlen flash behind
    nested-tensor SDPA (``aten._flash_attention_forward`` / ``_backward``
    with ``cum_seq_q`` / ``cum_seq_k``). Returns (forward callable,
    backward callable, what it is); the callables are None, and the text
    says why, where this torch has no such call for these inputs."""
    scale = q.shape[-1] ** -0.5
    aten = torch.ops.aten
    try:
        res = aten._flash_attention_forward(q, k, v, cu, cu, max_len, max_len,
                                            0.0, True, False, scale=scale)
        out, lse, rng_state, unused = res[0], res[1], res[2], res[3]
        bwd = aten._flash_attention_backward(do, q, k, v, out, lse, cu, cu,
                                             max_len, max_len, 0.0, True,
                                             rng_state, unused, scale=scale)
        torch.cuda.synchronize()
    except Exception as exc:      # no varlen flash in this torch build
        return None, None, f"none: aten._flash_attention_forward on " \
            f"packed inputs raised {type(exc).__name__}: {exc}"[:300]
    del bwd
    err = max_err(out, out_ref)
    return (lambda: aten._flash_attention_forward(
        q, k, v, cu, cu, max_len, max_len, 0.0, True, False, scale=scale),
        lambda: aten._flash_attention_backward(
            do, q, k, v, out, lse, cu, cu, max_len, max_len, 0.0, True,
            rng_state, unused, scale=scale),
        f"aten._flash_attention_forward/_backward (varlen, cum_seq_q/k); "
        f"its output differs from the kernel's by {err:.3g}")


def phase_varlen(torch, dev, report):
    """The varlen kernels (forward, backward dq and dk/dv) vs
    ``_vflash_fwd_reference`` / ``_vflash_bwd_reference``, the backward
    from the forward kernel's out and lse: the full-width case (packed
    T 8192 from ``VARLEN_LENS``, 16 heads of 128, bf16, causal) and, at
    small T, GQA 16/4 with a zero-length segment, len_k != len_q causal
    and not, rows past cu[-1], segments shorter than 16 rows inside one
    64-row tile, dropout 0.1 at a fixed seed (keep mask compared through
    one-hot values), and every head dim the kernels are compiled for (32
    to 256 by 32) or pad to (80 -> 96, 200 -> 224), and head dims above
    256 (288, 300 -> 320, 512, 1024, and above 1536 in column ranges 1537
    -> 1568, 2048, 3072), in fp32, bf16 and fp16 (up to D 256 fp32 takes
    the CUDA-core kernels, bf16 and fp16 the tensor-core kernels; above it
    every dtype the wide kernels, which the profiler must show by name,
    once each per call at D 288 and at D 1568 in two column ranges); bf16
    views that the kernel cannot read in place (token stride not a
    multiple of 8, start off a 16-byte boundary) must give the output of
    their contiguous copies exactly.
    Both accumulate in fp32 (the kernels tile by tile) and round once:
    tolerance ``tolerance(dtype, 1e-4)`` on out, dq, dk and dv, i.e. 1e-4
    (fp32, sums over up to 2048 keys) plus two output ulps (bf16, fp16);
    lse within 1e-4. Then one segment of 2048 against the dense forward
    kernel at [1, 16, 2048, 128], within the same tolerance. Then the
    timings: the full-width case, 4 x 2048 packed beside the dense
    kernels, and the head-dim sweep (``VARLEN_SWEEP_DIMS``, then the wide
    kernels' ``VARLEN_WIDE_DIMS``, then D 2048 on a quarter of the
    packing) against the library."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_attention_varlen as fv

    g = torch.Generator(device=dev).manual_seed(10)

    def rnd(*shape, dt):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    f32, bf16 = torch.float32, torch.bfloat16
    seed = torch.tensor([2024], dtype=torch.int32, device=dev)
    cases = [
        ("full width T8192 H16 D128 causal", VARLEN_LENS, VARLEN_LENS, 16,
         16, 128, dict(causal=True)),
        ("GQA 16/4 with a zero-length segment", [300, 0, 211, 89],
         [300, 0, 211, 89], 16, 4, 128, dict(causal=True)),
        ("len_k != len_q causal, rows past cu[-1]", [100, 37, 250, 0],
         [180, 20, 250, 9], 8, 2, 128, dict(causal=True, extra_q=13)),
        ("len_k != len_q noncausal D64", [100, 37, 250], [180, 20, 250], 8,
         8, 64, {}),
        ("dropout 0.1 GQA 8/2", [129, 64, 300], [129, 64, 300], 8, 2, 128,
         dict(causal=True, seed=seed, rate=0.1)),
        ("segments of 9 and 5 rows inside 64-row tiles", [40, 9, 70, 5, 100],
         [40, 9, 70, 5, 100], 8, 2, 128, dict(causal=True)),
        ("D 32 GQA 8/2", [129, 64, 300], [129, 64, 300], 8, 2, 32,
         dict(causal=True)),
        ("D 80 (padded to 96) dropout 0.1 GQA 8/2", [129, 64, 300],
         [129, 64, 300], 8, 2, 80, dict(causal=True, seed=seed, rate=0.1)),
        ("D 96 len_k != len_q", [100, 37, 250], [180, 20, 250], 8, 4, 96,
         dict(causal=True)),
        ("D 160 GQA 8/2 segments inside tiles", [40, 9, 70, 5, 300],
         [40, 9, 70, 5, 300], 8, 2, 160, dict(causal=True)),
        ("D 192 noncausal", [100, 37, 250], [180, 20, 250], 4, 4, 192, {}),
        ("D 200 (padded to 224) GQA 8/2", [129, 64, 300], [129, 64, 300], 8,
         2, 200, dict(causal=True)),
        ("D 256 GQA 8/2 segments inside tiles", [40, 9, 70, 5, 300],
         [40, 9, 70, 5, 300], 8, 2, 256, dict(causal=True)),
        ("D 256 dropout 0.1 len_k != len_q noncausal", [100, 37, 250],
         [180, 20, 250], 4, 2, 256, dict(seed=seed, rate=0.1)),
        ("D 288 (wide) GQA 8/2 segments inside tiles", [40, 9, 70, 5, 300],
         [40, 9, 70, 5, 300], 8, 2, 288, dict(causal=True)),
        ("D 300 (wide, padded to 320) dropout 0.1 GQA 8/2", [129, 64, 300],
         [129, 64, 300], 8, 2, 300, dict(causal=True, seed=seed, rate=0.1)),
        ("D 512 (wide) len_k != len_q, rows past cu[-1]", [100, 37, 250, 0],
         [180, 20, 250, 9], 4, 2, 512, dict(causal=True, extra_q=13)),
        ("D 1024 (wide) dropout 0.1 len_k != len_q noncausal",
         [100, 37, 250], [180, 20, 250], 4, 2, 1024,
         dict(seed=seed, rate=0.1)),
        ("D 1537 (wide, padded to 1568: column ranges 800 + 768) GQA 8/2",
         [40, 9, 70, 5, 300], [40, 9, 70, 5, 300], 8, 2, 1537,
         dict(causal=True)),
        ("D 2048 (wide, column ranges 2 x 1024) GQA 8/2 segments inside "
         "tiles", [40, 9, 70, 5, 300], [40, 9, 70, 5, 300], 8, 2, 2048,
         dict(causal=True)),
        ("D 3072 (wide, column ranges 2 x 1536) dropout 0.1 len_k != len_q "
         "noncausal", [100, 37, 250], [180, 20, 250], 4, 2, 3072,
         dict(seed=seed, rate=0.1)),
    ]
    main = None
    for label, lq, lk, h, hkv, d, kw in cases:
        cu_q, cu_k = _cu(torch, lq, dev), _cu(torch, lk, dev)
        tq, tk = sum(lq) + kw.get("extra_q", 0), sum(lk)
        st = dict(causal=kw.get("causal", False), scale=d ** -0.5,
                  dropout_rate=kw.get("rate", 0.0))
        dts = (bf16,) if label.startswith("full") else (f32, bf16,
                                                        torch.float16)
        for dt in dts:
            q, k, v = rnd(tq, h, d, dt=dt), rnd(tk, hkv, d, dt=dt), \
                rnd(tk, hkv, d, dt=dt)
            do = rnd(tq, h, d, dt=dt)
            args = (q, k, v, cu_q, cu_k)
            out, lse = fv._vflash_fwd_kernel(*args, kw.get("seed"), **st)
            rout, rlse = fv._vflash_fwd_reference(*args, kw.get("seed"), **st)
            got = fv._vflash_bwd_kernel(*args, out, lse, do, kw.get("seed"),
                                        **st)
            ref = fv._vflash_bwd_reference(*args, out, lse, do,
                                           kw.get("seed"), **st)
            torch.cuda.synchronize()
            name = str(dt).replace("torch.", "")
            atol, rtol = tolerance(dt, 1e-4)
            e_out, s_out = close_err(out, rout, atol, rtol)
            e_lse = max_err(lse, rlse)
            res = [close_err(a, r, atol, rtol) for a, r in zip(got, ref)]
            log(f"  vflash {label} {name}: out err {e_out:.3g} ({s_out:.3g} "
                f"of the tolerance), lse err {e_lse:.3g} (tol 1e-4); " +
                ", ".join(f"{n} err {e:.3g} ({sh:.3g})" for n, (e, sh) in
                          zip(("dq", "dk", "dv"), res)))
            check(s_out <= 1.0 and e_lse <= 1e-4, f"vflash {label} {name}")
            check(all(sh <= 1.0 for _, sh in res),
                  f"vflash_bwd {label} {name}")
            if "rows past" in label:
                # the first 17 rows of segment 1 see no key (len_k 20 <
                # len_q 37 under bottom-right causal), nor do the rows past
                # cu[-1]; no row sees the 9 keys of segment 3 (len_q 0)
                dead = [slice(100, 117), slice(sum(lq), tq)]
                check(all(bool(torch.isinf(lse[:, s]).all())
                          and bool((out[s] == 0).all())
                          and bool((got[0][s] == 0).all()) for s in dead),
                      "vflash: rows that see no key must give lse -inf, "
                      "out 0 and dq 0")
                check(bool((got[1][sum(lk[:3]):] == 0).all())
                      and bool((got[2][sum(lk[:3]):] == 0).all()),
                      "vflash: keys no row sees must give dk, dv 0")
            if label.startswith("full"):
                main = (q, k, v, cu_q, out, lse, do, e_out,
                        max(e for e, _ in res))
            del q, k, v, do, out, lse, rout, rlse, got, ref
    # the keep mask itself: q = 0 gives every visible key p = 1, and
    # one-hot values make out[row, d] = keep[row, d] / (1 - rate) / l
    cu = _cu(torch, [50, 78], dev)
    st = dict(causal=True, scale=128 ** -0.5, dropout_rate=0.1)
    k32 = rnd(128, 2, 128, dt=f32)
    for dt in (f32, bf16, torch.float16):
        q = torch.zeros(128, 4, 128, device=dev, dtype=dt)
        v = torch.eye(128, device=dev, dtype=dt)[:, None, :].expand(
            128, 2, 128).contiguous()
        k = k32.to(dt)
        out, _ = fv._vflash_fwd_kernel(q, k, v, cu, cu, seed, **st)
        rout, _ = fv._vflash_fwd_reference(q, k, v, cu, cu, seed, **st)
        kept, rkept = out > 0, rout > 0
        name = str(dt).replace("torch.", "")
        log(f"  vflash dropout keep mask {name}: kernel keeps "
            f"{int(kept.sum())}, plain keeps {int(rkept.sum())}, "
            f"identical={bool(torch.equal(kept, rkept))}")
        check(torch.equal(kept, rkept), f"vflash dropout keep mask differs "
                                        f"({name})")
    # views the tensor-core forward cannot read in place are copied first:
    # the output equals that of their contiguous copies
    lens = [100, 37, 250]
    cu = _cu(torch, lens, dev)
    t_v = sum(lens)
    k, v = rnd(t_v, 2, 128, dt=bf16), rnd(t_v, 2, 128, dt=bf16)
    st = dict(causal=True, scale=128 ** -0.5, dropout_rate=0.0)
    views = {
        "token stride 8 * 128 + 4": rnd(t_v, 8 * 128 + 4, dt=bf16)[
            :, :8 * 128].unflatten(1, (8, 128)),
        "start 2 bytes off 16": rnd(t_v * 8 * 128 + 1, dt=bf16)[1:].view(
            t_v, 8, 128),
    }
    for label, qv in views.items():
        out, lse = fv._vflash_fwd_kernel(qv, k, v, cu, cu, None, **st)
        cout, clse = fv._vflash_fwd_kernel(qv.contiguous().clone(), k, v, cu,
                                           cu, None, **st)
        torch.cuda.synchronize()
        same = bool(torch.equal(out, cout)) and bool(torch.equal(lse, clse))
        log(f"  vflash bf16 view, {label} (stride {qv.stride(0)}, data_ptr "
            f"% 16 = {qv.data_ptr() % 16}): equals its contiguous copy: {same}")
        check(same, f"vflash view {label} differs from its contiguous copy")
    # one segment of 2048 is the dense kernel's causal attention
    q, k, v = (rnd(2048, 16, 128, dt=bf16) for _ in range(3))
    cu = _cu(torch, [2048], dev)
    out, lse = fv._vflash_fwd_kernel(q, k, v, cu, cu, None, causal=True,
                                     scale=128 ** -0.5, dropout_rate=0.0)
    dout, dlse = fa._flash_fwd_kernel(
        *(t.transpose(0, 1)[None].contiguous() for t in (q, k, v)), None,
        None, causal=True, scale=128 ** -0.5, dropout_rate=0.0)
    torch.cuda.synchronize()
    atol, rtol = tolerance(bf16, 1e-4)
    e_out, share = close_err(out, dout[0].transpose(0, 1), atol, rtol)
    e_lse = max_err(lse, dlse[0])
    log(f"  vflash one segment of 2048 vs the dense flash kernel at "
        f"[1,16,2048,128] bf16: out err {e_out:.3g} ({share:.3g} of the "
        f"tolerance), lse err {e_lse:.3g}")
    check(share <= 1.0 and e_lse <= 1e-4, "vflash vs dense flash")
    del q, k, v, out, lse, dout, dlse
    # above 256 every dtype takes the wide kernels, once each per call and
    # no other varlen kernel (by name): one launch with one block per
    # column range above 1536 too
    cu = _cu(torch, [40, 9, 70, 5, 300], dev)
    wide = list(VARLEN_WIDE_KERNELS.values())
    others = [n for pair in VARLEN_KERNELS.values() for n in pair]
    for d, dt in itertools.product((288, 1568), (f32, bf16, torch.float16)):
        q, k, v, do = (rnd(424, 8, d, dt=dt) for _ in range(4))
        st = dict(causal=True, scale=d ** -0.5, dropout_rate=0.0)
        out, lse = fv._vflash_fwd_kernel(q, k, v, cu, cu, None, **st)

        def fwd_bwd():
            fv._vflash_fwd_kernel(q, k, v, cu, cu, None, **st)
            fv._vflash_bwd_kernel(q, k, v, cu, cu, out, lse, do, None, **st)

        fwd_bwd()
        name = str(dt).replace("torch.", "")

        def wide_route(per_kernel):
            got = named_launches(per_kernel, wide + others)
            check(all(got[n] == 1 for n in wide)
                  and not any(got[n] for n in others),
                  f"vflash D {d} {name} ran {got}, want each wide kernel "
                  f"once")

        got = named_launches(
            recorded(lambda: kernel_counts(torch, fwd_bwd, 2),
                     lambda pk: pk, wide_route, f"vflash D {d} {name}"),
            wide + others)
        log(f"  vflash D {d} {name} ({fv._wide_column_ranges(d)[0]} column "
            f"ranges), forward + backward, kernels per call: "
            f"{ {n: c for n, c in got.items() if c} }")
        del q, k, v, do, out, lse

    q, k, v, cu, out, lse, do, e_fwd, e_bwd = main
    t_tok, h, d = q.shape
    cols = torch.arange(t_tok, device=dev)
    seg_q, seg_k, bound = fv._seg_vectors(cu, cu, t_tok, t_tok)
    n_pairs = int(((seg_q[:, None] == seg_k[None, :])
                   & (cols[None, :] <= bound[:, None])).sum())
    check(n_pairs == sum(n * (n + 1) // 2 for n in VARLEN_LENS),
          f"visible pairs {n_pairs}")
    fwd_flops = 4 * d * h * n_pairs
    st = dict(causal=True, scale=d ** -0.5, dropout_rate=0.0)
    args = (q, k, v, cu, cu)
    lib_fwd, lib_bwd, lib_note = _varlen_library(
        torch, q, k, v, cu, max(VARLEN_LENS), out, do)
    log(f"  vflash library: {lib_note}")
    t = timings(lambda: fv._vflash_fwd_kernel(*args, None, **st),
                lambda: fv._vflash_fwd_reference(*args, None, **st), lib_fwd,
                nbytes(q, k, v, out, lse, cu), fwd_flops, "bfloat16",
                plain_iters=5)
    show("vflash T8192 H16 D128 causal bf16", t)
    report["vflash"] = dict(
        name="flash_attn_varlen_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention_varlen.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention_varlen.py:158",
        kernels=dict(zip(("bf16/fp16", "fp32"), VARLEN_KERNELS["fwd"]),
                     **{"D > 256": VARLEN_WIDE_KERNELS["fwd"]}),
        max_abs_err=e_fwd, library=lib_note, **t)
    t = timings(
        lambda: fv._vflash_bwd_kernel(*args, out, lse, do, None, **st),
        lambda: fv._vflash_bwd_reference(*args, out, lse, do, None, **st),
        lib_bwd, nbytes(q, k, v, out, do, lse, cu, q, k, v),
        2.5 * fwd_flops, "bfloat16", plain_iters=5)
    show("vflash_bwd (dq + dk/dv kernels) T8192 H16 D128 causal bf16", t)
    report["vflash_bwd"] = dict(
        name="flash_attn_varlen_bwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention_varlen.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention_varlen.py:328",
        kernels={"bf16/fp16": [VARLEN_KERNELS["dq"][0],
                               VARLEN_KERNELS["dkv"][0]],
                 "fp32": [VARLEN_KERNELS["dq"][1], VARLEN_KERNELS["dkv"][1]],
                 "D > 256": [VARLEN_WIDE_KERNELS["dq"],
                             VARLEN_WIDE_KERNELS["dkv"]]},
        max_abs_err=e_bwd, library=lib_note, **t)
    del main, q, k, v, out, lse, do, args, lib_fwd, lib_bwd
    # equal work: 4 segments of 2048 is the dense kernels' training shape
    # [4, 16, 2048, 128] packed, so the ratio is the cost per tile; the
    # forward once more with q, k, v sliced from [T, 17, 128] tensors, a
    # token stride that is not a power of two
    cu = _cu(torch, [2048] * 4, dev)
    q, k, v, do = (rnd(8192, 16, 128, dt=bf16) for _ in range(4))
    args = (q, k, v, cu, cu)
    out, lse = fv._vflash_fwd_kernel(*args, None, **st)
    wide = [rnd(8192, 17, 128, dt=bf16)[:, :16] for _ in range(3)]
    for key, fn in (("vflash", lambda: fv._vflash_fwd_kernel(
            *args, None, **st)), ("vflash_bwd", lambda: fv._vflash_bwd_kernel(
                *args, out, lse, do, None, **st))):
        dense = "flash" if key == "vflash" else "flash_bwd"
        ms = device_ms(fn)
        report[key]["at_4x2048"] = dict(ms=ms,
                                        dense_ms=report[dense]["ms"])
        log(f"  {key} at 4 x 2048 (the dense training shape, packed): "
            f"{ms:.4f} ms vs the dense kernel's {report[dense]['ms']:.4f} "
            f"ms ({ms / report[dense]['ms']:.2f}x)")
    ms = device_ms(lambda: fv._vflash_fwd_kernel(*wide, cu, cu, None, **st))
    report["vflash"]["at_4x2048"]["token_stride_17x128_ms"] = ms
    log(f"  vflash at 4 x 2048, token stride 17 x 128: {ms:.4f} ms")
    del q, k, v, do, out, lse, args, wide
    torch.cuda.empty_cache()
    varlen_sweep(torch, dev, report)


#: head dims of the varlen timing sweep (the full-width packing, 16 heads):
#: the compiled kernels', then the wide kernels' (no library call takes
#: them)
VARLEN_SWEEP_DIMS = (32, 64, 96, 128, 256)
VARLEN_WIDE_DIMS = (288, 512, 1024)
#: a quarter of the full-width packing (each of ``VARLEN_LENS`` over 4,
#: 2048 tokens), where the sweep times D 2048 (two column ranges)
VARLEN_QUARTER_LENS = [450, 94, 512, 164, 253, 63, 384, 128]


def varlen_sweep(torch, dev, report):
    """The varlen forward and backward kernels at each head dim of
    ``VARLEN_SWEEP_DIMS`` and ``VARLEN_WIDE_DIMS`` on the full-width
    packing (T 8192 from ``VARLEN_LENS``, 16 heads, bf16, causal): held
    against the plain version at ``tolerance(bfloat16, 1e-4)`` (lse
    within 1e-4), then timed beside the library's varlen flash (none
    above D 256) and the bound. Kept under
    ``report["vflash"]["d_sweep"]`` and ``report["vflash_bwd"]["d_sweep"]``
    by head dim; then D 2048 on ``VARLEN_QUARTER_LENS`` (5 calls each)
    under ``d_sweep[2048]``."""
    from paddle_tpu_torch.ops.cuda import flash_attention_varlen as fv

    g = torch.Generator(device=dev).manual_seed(13)
    bf16 = torch.bfloat16
    atol, rtol = tolerance(bf16, 1e-4)
    h = VARLEN_HEADS
    for key in ("vflash", "vflash_bwd"):
        report[key]["d_sweep"] = {}
    for d, lens in [(d, VARLEN_LENS) for d in
                    VARLEN_SWEEP_DIMS + VARLEN_WIDE_DIMS] + [
                        (2048, VARLEN_QUARTER_LENS)]:
        t_tok, cu = sum(lens), _cu(torch, lens, dev)
        n_pairs = sum(n * (n + 1) // 2 for n in lens)
        iters = 5 if d > 1536 else 20
        q, k, v, do = (torch.randn(t_tok, h, d, generator=g, device=dev)
                       .to(bf16) for _ in range(4))
        st = dict(causal=True, scale=d ** -0.5, dropout_rate=0.0)
        args = (q, k, v, cu, cu)
        out, lse = fv._vflash_fwd_kernel(*args, None, **st)
        got = fv._vflash_bwd_kernel(*args, out, lse, do, None, **st)
        rout, rlse = fv._vflash_fwd_reference(*args, **st)
        ref = fv._vflash_bwd_reference(*args, out, lse, do, **st)
        torch.cuda.synchronize()
        shares = [close_err(out, rout, atol, rtol)[1]] + [
            close_err(a, r, atol, rtol)[1] for a, r in zip(got, ref)]
        e_lse = max_err(lse, rlse)
        log(f"  vflash sweep D {d} ({t_tok} tokens): out, dq, dk, dv "
            f"{', '.join(f'{x:.3g}' for x in shares)} of the tolerance, lse "
            f"err {e_lse:.3g}")
        check(max(shares) <= 1.0 and e_lse <= 1e-4, f"vflash sweep D {d}")
        del rout, rlse, ref, got
        lib_fwd, lib_bwd, _ = _varlen_library(
            torch, q, k, v, cu, max(lens), out, do)
        flops = 4 * d * h * n_pairs
        for key, kernel, lib, n_bytes, fl in (
                ("vflash", lambda: fv._vflash_fwd_kernel(*args, None, **st),
                 lib_fwd, nbytes(q, k, v, out, lse, cu), flops),
                ("vflash_bwd", lambda: fv._vflash_bwd_kernel(
                    *args, out, lse, do, None, **st), lib_bwd,
                 nbytes(q, k, v, out, do, lse, cu, q, k, v), 2.5 * flops)):
            b_ms, by = bound_ms(n_bytes, fl, "bfloat16")
            t = dict(ms=device_ms(kernel, iters=iters),
                     library_ms=None if lib is None else device_ms(lib),
                     bound_ms=b_ms, bound_by=by, tokens=t_tok)
            report[key]["d_sweep"][d] = t
            lib_s = "none" if lib is None else f"{t['library_ms']:.4f} ms"
            log(f"  {key} sweep D {d} ({t_tok} tokens): kernel "
                f"{t['ms']:.4f} ms, library {lib_s}, bound {b_ms:.4f} ms "
                f"({by})")
        del q, k, v, do, out, lse, args, lib_fwd, lib_bwd
        torch.cuda.empty_cache()


#: conv_calibration's ResNet-50 shapes 2 and 17 at batch 64: the probe's
#: (m, kp, np), K and C_out padded to 128
TILED_MM_SHAPES = {2: (200704, 640, 128), 17: (3136, 4608, 512)}


#: small shapes of the tiled-matmul check: (m, k, n) with m and n not
#: tile multiples, aligned (k, n multiples of 8: 16-byte copies) and not
#: (element copies), in one K range and split into several
TILED_MM_SMALL = {"ragged": (1000, 300, 200),
                  "aligned, m and n not tile multiples": (1000, 320, 200),
                  "aligned, over a wave of tiles": (20000, 320, 200),
                  "unaligned, over a wave of tiles": (20000, 300, 196),
                  "aligned, split K": (1000, 2000, 200),
                  "unaligned, split K": (1000, 2004, 196)}


def phase_tiled_mm(torch, dev, report):
    """The calibration probe's tiled matmul kernel vs ``tiled_mm_reference``
    (an fp32 product of the bf16 operands, rounded once) at ResNet-50
    shapes 2 and 17 and at the ``TILED_MM_SMALL`` shapes.
    Both accumulate in fp32 and round once to bf16: tolerance
    ``tolerance(bfloat16, 1e-4)``, i.e. 1e-4 plus two bf16 ulps of |ref|
    (sums of up to 4608 products in another order can round to the
    neighbouring bf16 value)."""
    from paddle_tpu_torch.ops.cuda import _build, tiled_mm as tm

    g = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16
    atol, rtol = tolerance(bf16, 1e-4)
    times = {}
    for label, (m, k, n) in list(TILED_MM_SMALL.items()) + [
            (f"shape {i}", mkn) for i, mkn in TILED_MM_SHAPES.items()]:
        a = torch.randn(m, k, generator=g, device=dev).to(bf16)
        b = (torch.randn(k, n, generator=g, device=dev) * 0.05).to(bf16)
        out = tm._tiled_mm_kernel(a, b)
        ref = tm.tiled_mm_reference(a, b)
        torch.cuda.synchronize()
        err, share = close_err(out, ref, atol, rtol)
        splits = tm._tile_config(m, k, n, _build.sm_count(dev))
        log(f"  tiled_mm {label} [{m},{k}]x[{k},{n}] bf16, {splits} K "
            f"range(s): max_abs_err={err:.3g}, {share:.3g} of the "
            f"tolerance ({atol} + {rtol:.3g}|ref|)")
        check(share <= 1.0, f"tiled_mm {label} err {err}")
        if label in TILED_MM_SMALL:
            continue
        t = timings(lambda: tm._tiled_mm_kernel(a, b),
                    lambda: tm.tiled_mm_reference(a, b),
                    lambda: torch.matmul(a, b), nbytes(a, b, out),
                    2 * m * k * n, "bfloat16", plain_iters=5)
        show(f"tiled_mm {label} [{m},{k}]x[{k},{n}] bf16", t)
        times[label] = dict(max_abs_err=err, k_splits=splits, **t)
        del a, b, out, ref
    report["tiled_mm"] = dict(
        name="tiled_mm", route="cuda", source="paddle_tpu_torch/csrc/tiled_mm.cu",
        replaces="tools/conv_calibration.py:145", kernels=list(TILED_KERNELS),
        **times["shape 2"], at_shape_17=times["shape 17"])
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# main-path phases
# ---------------------------------------------------------------------------
def _counters():
    """Each kernel's launch count: report key -> (module, attribute)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_attention_varlen as fv
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import rms_norm as rn
    from paddle_tpu_torch.ops.cuda import tiled_mm as tm

    return {"flash": (fa, "launches"), "flash_bwd": (fa, "bwd_launches"),
            "rms_norm": (rn, "launches"), "rms_norm_bwd": (rn, "bwd_launches"),
            "paged": (pa, "launches"), "vflash": (fv, "launches"),
            "vflash_bwd": (fv, "dq_launches"),
            "vflash_bwd_dkv": (fv, "dkv_launches"),
            "tiled_mm": (tm, "launches")}


#: each kernel's main path: the one run whose count is its ``launches``
MAIN_PATH = {"paged": "serve", "flash": "train", "flash_bwd": "train",
             "rms_norm": "train", "rms_norm_bwd": "train", "vflash": "varlen",
             "vflash_bwd": "varlen", "tiled_mm": "calibrate"}


def reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def record_launches(report, path, counts):
    """Keep each kernel's count from one main-path run under
    ``launches_by_path[path]``."""
    for key, n in counts.items():
        if key == "vflash_bwd_dkv":     # the second kernel of vflash_bwd
            report["vflash_bwd"].setdefault("dkv_launches_by_path", {})[
                path] = n
        else:
            report[key].setdefault("launches_by_path", {})[path] = n


def phase_forward(torch, dev, report):
    """``LlamaForCausalLM`` at ``default_serving_setup``'s width (10
    layers, hidden 2048, 16 heads of 128, vocab 32000), batch 4 x 512.
    bf16: the flash kernel must launch once per layer and the RMSNorm
    kernel twice per layer plus the final norm, and the profiler must
    show the tensor-core flash kernel once per layer and the CUDA-core
    one never. fp32 (TF32 off): logits
    through the kernels vs the same model on its plain compositions
    (flags off); tolerance 1e-3 absolute on logits of magnitude ~3
    (fp32 sums in another order through 10 layers)."""
    import dataclasses

    from paddle_tpu_torch.core.flags import flags_scope
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serve import default_serving_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, _ = default_serving_setup(dev)
    nl = config.num_hidden_layers
    g = torch.Generator(device=dev).manual_seed(4)
    ids = torch.randint(1, config.vocab_size, (4, 512), generator=g,
                        device=dev)
    model = LlamaForCausalLM(dataclasses.replace(config, dtype="bfloat16"),
                             device=dev, seed=0).eval()
    log(f"  model: {model.num_parameters() / 1e6:.1f}M parameters, bf16, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
    with torch.inference_mode():
        model(ids[:, :8])                 # first use: libraries, allocator
        torch.cuda.synchronize()
        reset_counts()
        logits = model(ids)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"  bf16 forward [4, 512]: launches {counts}")
        check(tuple(logits.shape) == (4, 512, config.vocab_size),
              f"forward logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "forward logits not finite")
        check(counts["flash"] == nl, f"flash launches {counts['flash']} != {nl}")
        check(counts["rms_norm"] == 2 * nl + 1,
              f"rms_norm launches {counts['rms_norm']} != {2 * nl + 1}")
        record_launches(report, "forward", counts)
        fwd_ms = time_ms(lambda: model(ids), iters=5, warmup=1)
        with flags_scope(use_cuda_flash_attention=False,
                         use_cuda_rms_norm=False):
            fwd_plain = time_ms(lambda: model(ids), iters=5, warmup=1)
        log(f"  bf16 forward [4, 512]: kernels {fwd_ms:.3f} ms, plain "
            f"compositions {fwd_plain:.3f} ms "
            f"({4 * 512 / fwd_ms * 1e3:.0f} tokens/s with kernels)")
        # device time too: the wall times above include host launch gaps,
        # which vary between calls on a shared host
        recorded(lambda: profile_kernels(torch, lambda: model(ids), 3,
                                         fwd_ms,
                                         "bf16 forward [4, 512], kernels"),
                 _per_kernel,
                 lambda out: check_flash_route(out[1], {"fwd": nl},
                                               "bf16 forward [4, 512]"),
                 "bf16 forward [4, 512]")
        with flags_scope(use_cuda_flash_attention=False,
                         use_cuda_rms_norm=False):
            profile_kernels(torch, lambda: model(ids), 3, fwd_plain,
                            "bf16 forward [4, 512], plain compositions")
        del model, logits
        model = LlamaForCausalLM(config, device=dev, seed=0).eval()
        k_logits = model(ids)
        with flags_scope(use_cuda_flash_attention=False,
                         use_cuda_rms_norm=False):
            p_logits = model(ids)
        torch.cuda.synchronize()
        err = max_err(k_logits, p_logits)
        log(f"  fp32 forward logits, kernels vs plain: max_abs_err={err:.3g} "
            f"(tol 1e-3, |logits| max {float(p_logits.abs().max()):.3g})")
        check(err <= 1e-3, f"fp32 forward logits differ by {err}")
    del model, k_logits, p_logits
    torch.cuda.empty_cache()


def profile_decode(torch, eng, vocab, label, steps):
    """Where a full-batch decode step's time goes: 8 streams past their
    prefill, ``steps`` decode steps timed on the host clock, then the
    same number under ``torch.profiler`` for the device kernel time by
    name. Busy share = kernel time per step / unprofiled step time.
    Returns (wall ms, kernel ms, launches per step of each kernel by
    name)."""
    g = torch.Generator().manual_seed(6)
    for _ in range(eng.max_slots):
        eng.submit(torch.randint(1, vocab, (64,), generator=g).tolist(),
                   max_new_tokens=2 * steps + 4)
    eng.step()                                  # admissions + prefills
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    busy, per_kernel = profile_kernels(
        torch, eng.step, steps, wall_ms,
        f"decode step ({eng.max_slots} streams, {label})")
    eng.run()
    return wall_ms, busy, per_kernel


@contextlib.contextmanager
def eager_ticks():
    """Every captured path of the port (the serving tick, ``generate``'s
    ticks, ``to_static``) runs eagerly inside the block."""
    from paddle_tpu_torch import jit

    jit.enable_capture(False)
    try:
        yield
    finally:
        jit.enable_capture(True)


#: the dense flash kernels of each step, (tensor cores: bf16/fp16, CUDA
#: cores: fp32); a dtype runs one route only
FLASH_KERNELS = {
    "fwd": ("flash_fwd_tc_kernel", "flash_fwd_kernel"),
    "dq": ("flash_bwd_dq_tc_kernel", "flash_bwd_dq_kernel"),
    "dkv": ("flash_bwd_dkv_tc_kernel", "flash_bwd_dkv_kernel"),
}


def named_launches(per_kernel, names):
    """Launches of each kernel of ``names`` in ``per_kernel`` (profiler
    kernel name -> launches per call). A name counts where it is not
    preceded by a letter, so ``vflash_*`` (the varlen kernels) never count
    as dense flash kernels; mangled names count too. No name of a route is
    a part of another's."""
    return {n: sum(c for key, c in per_kernel.items()
                   if re.search(rf"(?<![a-z]){n}", key)) for n in names}


def check_flash_route(per_kernel, want, label, lost=0):
    """Fail unless the profile ran each tensor-core flash kernel ``want``
    (step -> count) times, or as many less at most ``lost`` that the
    profiler lost, and no CUDA-core flash kernel."""
    got = named_launches(per_kernel,
                         [n for pair in FLASH_KERNELS.values() for n in pair])
    log(f"  {label}: dense flash kernels {got}")
    for step, (tc, cc) in FLASH_KERNELS.items():
        check(got[cc] == 0, f"{label}: the CUDA-core {cc} ran ({got[cc]} "
                            f"launches) on a half-precision path")
        n = want.get(step, 0)
        check(n - min(lost, n) <= got[tc] <= n,
              f"{label}: {tc} launched {got[tc]} times, want {n}"
              + (f" ({lost} lost to the profiler admitted)" if lost else ""))


#: the varlen kernels of each step, (tensor cores: bf16/fp16, CUDA cores:
#: fp32); a dtype runs one route only
VARLEN_KERNELS = {
    "fwd": ("vflash_fwd_tc_kernel", "vflash_fwd_kernel"),
    "dq": ("vflash_bwd_dq_tc_kernel", "vflash_bwd_dq_kernel"),
    "dkv": ("vflash_bwd_dkv_tc_kernel", "vflash_bwd_dkv_kernel"),
}
#: the varlen kernels of head dims above 256, every dtype
VARLEN_WIDE_KERNELS = {"fwd": "vflash_fwd_wide_kernel",
                       "dq": "vflash_bwd_dq_wide_kernel",
                       "dkv": "vflash_bwd_dkv_wide_kernel"}
#: the RMSNorm kernels of the training step (hidden 2048, bf16: the vector
#: variant) with their launches per step: forward, backward, dw reduction
RMS_TRAIN_KERNELS = ("rms_norm_fwd_vec_kernel", "rms_norm_bwd_vec_kernel",
                     "rms_norm_dw_reduce_kernel")
#: the tiled matmul's kernels: the tensor-core product, and the pass that
#: adds the K ranges' fp32 partials where the shape splits K
TILED_KERNELS = ("tiled_mm_tc_kernel", "tiled_mm_reduce_kernel")


#: the paged decode kernel (one launch per call, every dtype: the
#: split-context kernel, which merges a row's splits itself)
PAGED_KERNELS = ("paged_decode_split_kernel",)


#: profiler kernel names by kind, for the per-kind sums of profile_kernels
KERNEL_KINDS = (
    ("varlen flash (port)", ("vflash_",)),
    ("flash (port)", ("flash_fwd_kernel", "flash_fwd_tc_kernel",
                      "flash_bwd_")),
    ("tiled matmul (port)", ("tiled_mm_",)),
    ("RMSNorm (port)", ("rms_norm_",)),
    ("paged decode (port)", PAGED_KERNELS),
    ("convolution layout copies (cuDNN)", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "Conv",
                             "cudnn")),
    ("batch / group norm", ("batch_norm", "BatchNorm", "GroupNorm",
                            "group_norm", "RowwiseMoments", "FusedParams",
                            "GammaBeta", "ComputeInternalGradients")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "Gemm", "cutlass", "sm90_xmma")),
)


def kernel_counts(torch, fn, n):
    """Launches per call of each device kernel by name: ``fn`` run ``n``
    times under the profiler."""
    from torch.autograd import DeviceType

    return {e.key: e.count // n for e in profiled(fn, n)
            if e.device_type == DeviceType.CUDA}


def profile_kernels(torch, fn, n, wall_ms, label):
    """Run ``fn`` ``n`` times under ``torch.profiler`` and print the
    device kernel time per call by kernel name, and the busy share
    against ``wall_ms`` (the unprofiled time of one call). Returns the
    kernel ms per call (None if the profiler saw no kernels) and the
    launches per call of each kernel by name."""
    from torch.autograd import DeviceType

    kernels = [e for e in profiled(fn, n, cpu=True)
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_dev_us(e) for e in kernels) / n / 1e3
    per_kernel = {e.key: e.count // n for e in kernels}
    if busy_ms <= 0:
        log(f"  {label}: {wall_ms:.3f} ms; device time not measured (the "
            f"profiler saw no kernels)")
        return None, per_kernel
    log(f"  {label}: {wall_ms:.3f} ms wall, {busy_ms:.3f} ms of kernels "
        f"({busy_ms / wall_ms:.1%} busy, "
        f"{sum(e.count for e in kernels) / n:.0f} kernels per call)")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:6]:
        log(f"    {_dev_us(e) / n / 1e3:8.4f} ms/call  x{e.count // n:<4d}"
            f" {e.key[:90]}")
    kinds = {}
    for e in kernels:
        kind = next((k for k, pats in KERNEL_KINDS if any(
            p in e.key for p in pats)), "other (elementwise, copies, "
                                          "reductions)")
        ms, cnt = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + _dev_us(e) / n / 1e3, cnt + e.count // n)
    log("    by kind: " + "; ".join(
        f"{k} {ms:.3f} ms x{cnt}" for k, (ms, cnt) in
        sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    return busy_ms, per_kernel


class Family:
    """A decoder family on the main path of ``phase_serve`` and
    ``phase_generate``: ``tag`` prefixes its engines' names and its launch
    paths ("" for Llama, so its paths stay ``serve`` and ``generate``),
    ``label`` its log lines, ``prm`` is ``default_serving_setup``'s engine
    and load settings, and ``model(bf16=True, layers=None, seed=0)``
    builds it at full width on the card in eval mode (fp32 where ``bf16``
    is False, ``layers`` cutting the depth). ``paged`` is False for a
    family that decodes on the dense cache only (ERNIE-MoE: no
    ``paged=True``, speculative decoding or serving), and
    ``prompt_lens`` the ``generate`` prompts' lengths (None:
    ``GEN_PROMPT_LENS``)."""

    def __init__(self, tag, label, model, prm, paged=True, prompt_lens=None):
        self.tag, self.label, self.model, self.prm = tag, label, model, prm
        self.paged, self.prompt_lens = paged, prompt_lens


def llama_family(torch, dev):
    """``default_serving_setup``'s Llama: 10 layers, hidden 2048, 16 heads
    of 128, vocab 32000."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serve import default_serving_setup

    config, prm = default_serving_setup(dev)

    def model(bf16=True, layers=None, seed=0):
        cfg = dataclasses.replace(
            config, num_hidden_layers=layers or config.num_hidden_layers,
            **({"dtype": "bfloat16"} if bf16 else {}))
        return LlamaForCausalLM(cfg, device=dev, seed=seed).eval()

    return Family("", "Llama", model, prm)


def gpt_family(torch, dev):
    """``GPTConfig.gpt2_medium()`` (``gpt_model``): 24 layers, hidden 1024,
    16 heads of 64, vocab 50304, tied head; served with
    ``default_serving_setup``'s engine and load (max_seq_len 1024: the
    whole position table)."""
    from paddle_tpu_torch.serve import default_serving_setup

    def model(bf16=True, layers=None, seed=0):
        kw = {"num_hidden_layers": layers} if layers else {}
        return gpt_model(torch, dev, seed=seed, bf16=bf16, **kw).eval()

    return Family("gpt_", "GPT", model, default_serving_setup(dev)[1])


def moe_family(torch, dev):
    """bench_moe's ERNIE-MoE (``moe_model``: 6 layers, hidden 2048, 16
    heads of 128, 8 experts of 1408, top-2, MoE on every second layer);
    dense cache only, from 8 prompts of ``GEN_PROMPT_LENS[0]`` tokens (the
    reference refuses ragged prompts, ``paged=True`` and speculative
    decoding for MoE models)."""

    def model(bf16=True, layers=None, seed=0):
        return moe_model(torch, dev, bf16, layers, seed).eval()

    return Family("moe_", "ERNIE-MoE", model, None, paged=False,
                  prompt_lens=[GEN_PROMPT_LENS[0]] * len(GEN_PROMPT_LENS))


#: prefill buckets timed one by one, cold and suffix, captured and eager
PREFILL_PROFILE_BUCKETS = (32, 64, 128)
#: timed calls of one prefill (wall), and calls under the profiler
PREFILL_ITERS = 10
PREFILL_PROFILE_CALLS = 3


def reachable_buckets(eng, cap, prefix):
    """The (kind, bucket) prefill graphs ``warm_engine`` captures up to
    prompts of ``cap`` tokens: cold buckets for 1..cap tokens and, with
    the prefix cache, suffix buckets for the suffixes behind one cached
    block (1..cap - block_size)."""
    from paddle_tpu_torch.serve.engine import prefill_bucket

    want = {("cold", prefill_bucket(n, eng.max_seq_len))
            for n in range(1, cap + 1)}
    if prefix:
        want |= {("suffix", prefill_bucket(n, eng.max_seq_len))
                 for n in range(1, cap - eng.block_size + 1)}
    return want


def check_prefill_graphs(eng, want, label):
    """``eng`` made exactly the prefill graphs ``want``, each captured,
    counted by ``prefill_traces`` and by the ``serve.prefill_traces``
    bucket labels. Prints each capture's seconds."""
    from paddle_tpu_torch import observability as obs

    graphs = eng._prefill_graphs
    labels = sorted(int(ls["bucket"]) for ls in obs.registry.get(
        "serve.prefill_traces").labelsets() if ls["engine"] == eng.name)
    log(f"  {label}: {len(graphs)} prefill graphs, capture ms " + ", ".join(
        f"{k[0]} {k[1]}: {(g.capture_seconds or 0) * 1e3:.1f}"
        for k, g in sorted(graphs.items())))
    check(set(graphs) == want and eng.prefill_traces == len(want),
          f"{label}: prefill graphs {sorted(graphs)} ({eng.prefill_traces} "
          f"counted), want {sorted(want)}")
    check(all(g.captured for g in graphs.values()),
          f"{label}: a prefill graph was not captured")
    check(labels == sorted({b for _, b in want}),
          f"{label}: serve.prefill_traces buckets {labels}")


def prefill_kernels(torch, fn):
    """Device ms and kernels a call of ``fn`` from ``torch.profiler`` (CUDA
    activity only) over ``PREFILL_PROFILE_CALLS`` calls; ms None if the
    profiler saw no kernels."""
    from torch.autograd import DeviceType

    n = PREFILL_PROFILE_CALLS
    kernels = [e for e in profiled(fn, n) if e.device_type == DeviceType.CUDA]
    ms = sum(_dev_us(e) for e in kernels) / n / 1e3
    return (ms or None), sum(e.count for e in kernels) // n


def stream_table(eng, start, n):
    """Blocks from ``eng``'s pool for positions 0 .. start + n - 1 of one
    stream, and its block-table row."""
    blocks = eng.pool.alloc(eng.pool.blocks_for_tokens(start + n))
    return blocks, blocks + [0] * (eng.max_blocks_per_seq - len(blocks))


def load_line(res, dstep):
    return (f"TTFT p50 {res.ttft_p50 * 1e3:.2f} ms p99 "
            f"{res.ttft_p99 * 1e3:.2f} ms, {res.tokens_per_sec:.1f} tokens/s, "
            f"decode step mean {dstep * 1e3:.3f} ms")


def serve_buckets(torch, dev, report, fam, engine, model, nl):
    """The prefill graphs at ``default_serving_setup``'s whole length: an
    engine with the prefix cache warmed with no prompt cap captures every
    cold and suffix bucket (8 .. 1024, 16 graphs); serving's memory before
    and after, each capture's seconds. Then, for each bucket, one prompt
    through the captured prefill and through the same function eagerly
    (``eager_ticks``): the bf16 logits must be equal bit for bit; a cold
    and a suffix prefill with pad rows must leave every pool block but the
    stream's own and the sink as it was; and the buckets of
    ``PREFILL_PROFILE_BUCKETS``, cold and suffix, captured and eager: wall
    ms, kernel ms and kernels a call, and the paged kernel's launches a
    prefill (through the replays: ``nl`` a suffix prefill, none cold)."""
    from paddle_tpu_torch.serve import warm_engine
    from paddle_tpu_torch.serve.engine import prefill_bucket

    name = f"{fam.tag}smoke_buckets"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = engine(model, name, prefix_cache=True)
    alloc0, res0 = (torch.cuda.memory_allocated(dev),
                    torch.cuda.memory_reserved(dev))
    t0 = time.perf_counter()
    warm_engine(eng)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    alloc1, res1 = (torch.cuda.memory_allocated(dev),
                    torch.cuda.memory_reserved(dev))
    peak = torch.cuda.max_memory_allocated(dev)
    cap = min(eng.max_seq_len - 1, eng.pool.num_blocks * eng.block_size)
    check_prefill_graphs(eng, reachable_buckets(eng, cap, True),
                         f"{fam.label} warm_engine, no prompt cap")
    log(f"  {fam.label} warm_engine (prefix cache, prompts up to {cap}): "
        f"{warm_s:.2f} s; device memory allocated {alloc0 / 2**30:.3f} -> "
        f"{alloc1 / 2**30:.3f} GiB, reserved {res0 / 2**30:.3f} -> "
        f"{res1 / 2**30:.3f} GiB (the graphs' pools: "
        f"{(res1 - res0) / 2**30:.3f} GiB), peak {peak / 2**30:.3f} GiB; "
        f"{smi_line()}")
    out = dict(graphs=len(eng._prefill_graphs), warm_seconds=warm_s,
               reserved_before=res0, reserved_after=res1, peak_bytes=peak,
               capture_ms={f"{k}{b}": (g.capture_seconds or 0.0) * 1e3
                           for (k, b), g in sorted(eng._prefill_graphs.items())})

    g = torch.Generator().manual_seed(12)
    vocab, bs = model.config.vocab_size, eng.block_size

    def ids(n):
        return torch.randint(1, vocab, (n,), generator=g).tolist()

    # captured = eager, bit for bit, one prompt per bucket (padded)
    same = []
    for kind, bucket in sorted(eng._prefill_graphs):
        start = 0 if kind == "cold" else bs
        n = min(bucket // 2 + 1, eng.max_seq_len - 1 - start)
        blocks, row = stream_table(eng, start, n)
        prompt = ids(n)
        got = eng._run_prefill(prompt, start, row).clone()
        with eager_ticks():
            want = eng._run_prefill(prompt, start, row).clone()
        same.append(bool(torch.equal(got, want)))
        if not same[-1]:
            log(f"    {kind} {bucket}: captured vs eager logits differ by "
                f"{(got - want).abs().max().item():.3g}")
        eng.pool.free(blocks)
    log(f"  bf16 prefill logits, captured vs eager, one prompt per bucket: "
        f"{sum(same)}/{len(same)} equal bit for bit")
    check(all(same), f"{fam.label}: captured prefill logits != eager")

    # pad rows write only the sink: every other block outside the stream's
    # table is as it was
    n = min(65, eng.max_seq_len - 1 - bs)
    for kind, start in (("cold", 0), ("suffix", bs)):
        blocks, row = stream_table(eng, start, n)
        before = [(k.clone(), v.clone()) for k, v in eng._caches]
        eng._run_prefill(ids(n), start, row)
        torch.cuda.synchronize()
        keep = torch.tensor([b for b in range(eng.pool.num_blocks + 1)
                             if b not in blocks and b != eng._sink],
                            device=dev)
        changed = sum(int(not torch.equal(a.index_select(1, keep),
                                          c.index_select(1, keep)))
                      for (k0, v0), (k1, v1) in zip(before, eng._caches)
                      for a, c in ((k0, k1), (v0, v1)))
        log(f"  {kind} prefill of {n} tokens in bucket "
            f"{prefill_bucket(n, eng.max_seq_len)} (pad rows to the sink): "
            f"{changed} of {2 * nl} K/V pools changed outside the "
            f"stream's {len(blocks)} blocks and the sink")
        check(changed == 0, f"{fam.label} {kind} prefill wrote outside its "
                            f"blocks and the sink")
        del before
        eng.pool.free(blocks)

    # prefill by bucket
    by_bucket = {}
    for bucket in PREFILL_PROFILE_BUCKETS:
        for kind, start in (("cold", 0), ("suffix", bs)):
            blocks, row = stream_table(eng, start, bucket)
            prompt = ids(bucket)

            def call():
                return eng._run_prefill(prompt, start, row).cpu()

            for mode in ("captured", "eager"):
                with (eager_ticks() if mode == "eager"
                      else contextlib.nullcontext()):
                    call()
                    torch.cuda.synchronize()
                    reset_counts()
                    t0 = time.perf_counter()
                    for _ in range(PREFILL_ITERS):
                        call()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) / PREFILL_ITERS * 1e3
                    counts = read_counts()
                    paged = counts["paged"] / PREFILL_ITERS
                    busy, kernels = prefill_kernels(torch, call)
                by_bucket[f"{kind}{bucket}_{mode}"] = dict(
                    wall_ms=wall, kernel_ms=busy, kernels=kernels,
                    paged_launches=paged)
                want = nl if kind == "suffix" else 0
                check(paged == want,
                      f"{fam.label} {kind} prefill {bucket} {mode}: "
                      f"{paged} paged launches a prefill, want {want}")
                if kind == "suffix" and mode == "captured" and bucket == 128:
                    record_launches(report, f"{fam.tag}serve_prefill",
                                    {k: v // PREFILL_ITERS
                                     for k, v in counts.items()})
            eng.pool.free(blocks)
    log(f"  {fam.label} prefill by bucket, wall ms / kernel ms (busy) / "
        f"kernels a call / paged launches a call; {smi_line()}:")
    for k, v in by_bucket.items():
        busy = (f"{v['kernel_ms']:.3f} ({v['kernel_ms'] / v['wall_ms']:.1%})"
                if v["kernel_ms"] else "not measured")
        log(f"    {k:18s} {v['wall_ms']:8.3f} / {busy} / {v['kernels']} / "
            f"{v['paged_launches']:g}")
    out["by_bucket"] = by_bucket
    del eng
    torch.cuda.empty_cache()
    return out


def serve_tracing(torch, fam, engine, model, prm, res_off, n_req):
    """The load of ``phase_serve`` on an engine with ``trace=True``: every
    request traced, every doc valid (no PTL403), each request's leaf
    phases tiling its latency within 1e-6 s, each prefill span's bucket
    the bucket function of its tokens, the decode tick still one graph;
    the Chrome trace written, read back, one lane per slot plus the queue
    and engine lanes; the serve-trace lint's PTL404 / PTL405 counts and
    the decode gap; tracing's overhead against the untraced load
    (``check_tracing_overhead``; printed, not checked: at 30 req/s the
    load's tokens/s is bound by the arrivals)."""
    import os
    import tempfile

    from paddle_tpu_torch.observability.tracing import (
        check_tracing_overhead, validate_trace)
    from paddle_tpu_torch.serve import run_load, warm_engine
    from paddle_tpu_torch.serve.engine import prefill_bucket
    from paddle_tpu_torch.static.analysis import lint_serve_trace

    eng = engine(model, f"{fam.tag}smoke_traced", trace=True)
    warm_engine(eng, max_prompt_len=prm["prompt_len"][1])
    res = run_load(eng, rate=prm["rate"], n_requests=n_req,
                   prompt_len=prm["prompt_len"], max_new=prm["max_new"],
                   seed=0)
    tr = eng.tracer
    dump = tr.dump_dict()
    bad, worst_tile, buckets = 0, 0.0, 0
    for doc in dump["requests"]:
        bad += len(validate_trace(doc).diagnostics)
        leaves = sum(c["seconds"] for c in doc["spans"]["children"])
        worst_tile = max(worst_tile, abs(leaves - doc["latency_seconds"]))
        for c in doc["spans"]["children"]:
            a = c.get("attrs", {})
            if "bucket" in a:
                buckets += 1
                check(a["bucket"] == prefill_bucket(a["tokens"],
                                                    eng.max_seq_len),
                      f"prefill span {a} of request {doc['id']}: the bucket "
                      f"is not its tokens'")
    check(tr.n_traced == n_req == len(dump["requests"]) and bad == 0,
          f"{fam.label} tracing: {tr.n_traced} of {n_req} traced, {bad} "
          f"PTL403 findings")
    check(worst_tile <= 1e-6, f"leaf phases miss the latency by {worst_tile}")
    check(eng.decode_traces == 1, f"decode_traces {eng.decode_traces} with "
                                  f"tracing on, want 1")
    with tempfile.TemporaryDirectory() as d:
        path = tr.write_chrome_trace(os.path.join(d, "serve_trace.json"))
        with open(path) as f:
            chrome = json.load(f)
    lanes = {e["tid"] for e in chrome["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    n_x = sum(e["ph"] == "X" for e in chrome["traceEvents"])
    check(len(lanes) == eng.max_slots + 2,
          f"Chrome trace lanes {sorted(lanes)}, want {eng.max_slots + 2}")
    lint = lint_serve_trace(dump)
    n404, n405 = len(lint.by_code("PTL404")), len(lint.by_code("PTL405"))
    guard = check_tracing_overhead(res.tokens_per_sec, res_off.tokens_per_sec,
                                   engine=eng.name)
    overhead = (100.0 * (res_off.tokens_per_sec - res.tokens_per_sec)
                / res_off.tokens_per_sec)
    log(f"  {fam.label} traced run_load: {tr.n_traced} requests traced, "
        f"{len(dump['decode_steps'])} decode steps, {buckets} prefill spans "
        f"with their bucket, leaves tile latency within {worst_tile:.2g} s; "
        f"Chrome trace {n_x} spans on {len(lanes)} lanes; lint PTL404 "
        f"{n404}, PTL405 {n405}, decode gap {tr.total_decode_gap * 1e3:.2f} "
        f"ms; TTFT p50 {res.ttft_p50 * 1e3:.2f} ms p99 "
        f"{res.ttft_p99 * 1e3:.2f} ms, {res.tokens_per_sec:.1f} tokens/s "
        f"(untraced {res_off.tokens_per_sec:.1f}); tracing overhead "
        f"{overhead:.2f}% "
        f"of tokens/s (PTL402 {'fired' if guard.diagnostics else 'silent'})")
    log(tr.exemplars.render())
    out = dict(n_traced=tr.n_traced, ptl404=n404, ptl405=n405,
               decode_gap_s=tr.total_decode_gap, overhead_pct=overhead,
               ptl402=bool(guard.diagnostics),
               ttft_p50_ms=res.ttft_p50 * 1e3, ttft_p99_ms=res.ttft_p99 * 1e3,
               tokens_per_s=res.tokens_per_sec)
    del eng
    return out


def serve_slo(torch, fam, engine, model, prm):
    """SLO monitors with ``PADDLE_TPU_FLIGHT_DIR`` on a temporary
    directory: an engine with a ``ttft_p99`` rule at 1e-6 s (min_samples
    3) over 8 requests latches exactly one breach, and leaves its
    ``trace.slo_breaches`` count, its ``trace.slo_breach`` event, PTL401
    on the monitor's report and one flight dump (reason ``slo_breach``,
    the tail exemplars in its context); the rule at 60 s latches none."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import observability as obs

    g = torch.Generator().manual_seed(13)
    lo, hi = prm["prompt_len"]
    prompts = [torch.randint(1, model.config.vocab_size, (int(n),),
                             generator=g).tolist()
               for n in torch.randint(lo, hi + 1, (8,), generator=g)]
    d = tempfile.mkdtemp()
    prev = os.environ.get(obs.flight.FLIGHT_DIR_ENV)
    os.environ[obs.flight.FLIGHT_DIR_ENV] = d
    obs.enable()
    try:
        for threshold, want in ((1e-6, 1), (60.0, 0)):
            name = f"{fam.tag}smoke_slo{want}"
            eng = engine(model, name, trace=True, slo=[dict(
                name="ttft", kind="ttft_p99", threshold=threshold,
                min_samples=3)])
            before = set(os.listdir(d))
            for p in prompts:
                eng.submit(p, max_new_tokens=2)
            eng.run()
            count = obs.registry.get("trace.slo_breaches").value(
                engine=name, rule="ttft")
            evs = [e for e in obs.events("trace.slo_breach")
                   if e.fields.get("engine") == name]
            dumps = []
            for f in sorted(set(os.listdir(d)) - before):
                with open(os.path.join(d, f)) as fh:
                    dumps.append(json.load(fh))
            ptl = eng.slo.report.by_code("PTL401")
            kept = [len(x["context"].get("exemplars", {}).get("worst_ttft",
                                                                ()))
                    for x in dumps]
            log(f"  {fam.label} SLO ttft_p99 <= {threshold:g} s: "
                f"{len(eng.slo.breaches)} breaches, counter {count}, "
                f"{len(evs)} events, {len(ptl)} PTL401, flight dumps "
                f"{[x['reason'] for x in dumps]} with {kept} exemplars")
            check(len(eng.slo.breaches) == count == len(evs) == len(ptl)
                  == len(dumps) == want,
                  f"{fam.label} SLO at {threshold}: want {want} breach")
            if want:
                check(dumps[0]["reason"] == "slo_breach" and kept[0] > 0,
                      "the breach dump holds no tail exemplars")
                log("    " + ptl[0].render().replace("\n", "\n    "))
            del eng
    finally:
        obs.disable()
        if prev is None:
            os.environ.pop(obs.flight.FLIGHT_DIR_ENV, None)
        else:
            os.environ[obs.flight.FLIGHT_DIR_ENV] = prev
        shutil.rmtree(d, ignore_errors=True)


def phase_serve(torch, dev, report, fam):
    """The ``default_serving_setup`` engine (8 slots, 96 x 128-token
    blocks, max_seq_len 1024) over the family ``fam`` in bf16 under
    Poisson load: every request finishes, ``warm_engine`` captured the
    decode tick once (``decode_traces`` 1) and one prefill graph per
    bucket prompts of up to 128 tokens reach, every decode step and
    every prefill replayed them, the paged kernel launching once per
    layer per step through the replays; the same load with eager
    prefills and ticks beside it; the decode step profiled with eager
    and captured ticks; serving's peak memory. Then ``serve_tracing``,
    ``serve_slo`` and ``serve_buckets``. bf16 sampled streams (temperature 0.8, one
    seed) equal with captured and eager ticks. A bf16 run with the prefix
    cache and 4-tick bursts on eager ticks holds every paged call (decode
    ticks, bursts and suffix prefills) against its plain version on the
    same inputs (``checked_paged_attention``). Then fp32 greedy streams
    with captured kernel ticks, eager kernel ticks and captured
    reference-attention ticks must be equal token for token, cold and
    with the prefix cache and 4-tick decode bursts on (the suffix prefill
    runs the paged kernel over a bucket of rows; one graph per burst
    length used); eager ticks are eager prefills too. Returns the
    serving numbers."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serve import ServeEngine, run_load, warm_engine

    prm = fam.prm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = fam.model()
    config = model.config
    nl = config.num_hidden_layers
    smoke = f"{fam.tag}smoke"

    def engine(model, name, backend="auto", **kw):
        return ServeEngine(
            model, max_slots=prm["slots"], block_size=prm["block_size"],
            num_blocks=prm["num_blocks"], max_seq_len=prm["max_seq_len"],
            name=name, attention_backend=backend, device=dev, **kw)

    eng = engine(model, smoke)
    log(f"  {fam.label}: {model.num_parameters() / 1e6:.1f}M parameters, "
        f"bf16; KV pool {2 * nl * eng._caches[0][0].numel() * 2 / 2**30:.2f}"
        f" GiB bf16 (the sink block included)")
    torch.cuda.synchronize()
    peak0 = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    warm_engine(eng, max_prompt_len=prm["prompt_len"][1])
    torch.cuda.synchronize()
    peak_warm = torch.cuda.max_memory_allocated(dev)
    log(f"  warm_engine: {time.perf_counter() - t0:.2f} s (the tick "
        f"captured in {(eng._graphs[1].capture_seconds or 0) * 1e3:.1f} ms); "
        f"peak device memory {peak0 / 2**30:.3f} GiB before, "
        f"{peak_warm / 2**30:.3f} GiB after")
    check(eng.decode_traces == 1 and eng._graphs[1].captured,
          f"{fam.label} warm_engine: decode_traces {eng.decode_traces}, "
          f"want 1 captured")
    # one captured graph per bucket prompts of 1..128 tokens reach
    want = reachable_buckets(eng, prm["prompt_len"][1], False)
    check_prefill_graphs(eng, want, f"{fam.label} warm_engine")
    n_req = 24
    reset_counts()
    replays = eng._graphs[1].replays
    pre_calls = {k: (g.calls, g.replays)
                 for k, g in eng._prefill_graphs.items()}
    dstat = obs.registry.get("serve.decode_step_seconds").stats
    d0 = dstat(engine=smoke)
    res = run_load(eng, rate=prm["rate"], n_requests=n_req,
                   prompt_len=prm["prompt_len"], max_new=prm["max_new"],
                   seed=0)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    done = sum(r.state == "FINISHED" for r in res.requests)
    d1 = dstat(engine=smoke)
    dstep = dict(avg=(d1["sum"] - d0["sum"]) / max(1, d1["count"] - d0["count"]),
                 min=d1["min"])
    replays = eng._graphs[1].replays - replays
    prefills = sum(g.calls - pre_calls[k][0]
                   for k, g in eng._prefill_graphs.items())
    pre_replays = sum(g.replays - pre_calls[k][1]
                      for k, g in eng._prefill_graphs.items())
    log(f"  {fam.label} run_load prefills: {prefills} calls, {pre_replays} "
        f"graph replays, prefill_traces {eng.prefill_traces} (no graph "
        f"made in the load)")
    check(set(eng._prefill_graphs) == want and eng.prefill_traces == len(want)
          and prefills == pre_replays >= n_req,
          f"{fam.label} run_load: {prefills} prefills, {pre_replays} "
          f"replays, graphs {sorted(eng._prefill_graphs)}")
    log(f"  {fam.label} run_load: {done}/{n_req} finished, "
        f"{res.total_tokens} tokens in {res.wall_seconds:.3f} s = "
        f"{res.tokens_per_sec:.1f} tokens/s, TTFT p50 "
        f"{res.ttft_p50 * 1e3:.2f} ms p99 {res.ttft_p99 * 1e3:.2f} ms, "
        f"{res.engine_steps} decode steps ({replays} graph replays), decode "
        f"step mean {dstep['avg'] * 1e3:.3f} ms (min "
        f"{dstep['min'] * 1e3:.3f}), preemptions {res.preemptions}, "
        f"decode_traces {eng.decode_traces}, launches {counts}; "
        f"{smi_line()}")
    log(f"  serving peak device memory: {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated: the model, the KV pool, the graph's pool)")
    check(done == n_req and res.rejected == 0,
          f"{fam.label}: only {done} of {n_req} requests finished")
    check(eng.decode_traces == 1 and obs.registry.get(
        "serve.decode_traces").value(engine=smoke) == 1,
          f"decode_traces {eng.decode_traces} after run_load, want 1")
    check(replays == res.engine_steps,
          f"{replays} graph replays for {res.engine_steps} decode steps")
    # the paged kernel's workspace on the capture stream: the graph holds
    # it, and every replayed launch left its arrival counters 0
    from paddle_tpu_torch.jit import _capture
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    ws = pa._workspace_of(dev, _capture._capture_stream(dev))
    check(ws is not None and eng._graphs[1]._keep is ws
          and int(ws[1].abs().sum()) == 0,
          "the capture stream's paged workspace is not the graph's, or its "
          "counters are not 0 after the replays")
    log(f"  paged workspace of the capture stream: {ws[0].numel()} fp32 "
        f"partials, {ws[1].numel()} counters, all 0 after {replays} replays")
    check(counts["paged"] > 0, "the paged kernel never launched")
    check(counts["paged"] == nl * res.engine_steps,
          f"paged launches {counts['paged']} != layers x decode steps "
          f"{nl * res.engine_steps}")
    record_launches(report, f"{fam.tag}serve", counts)
    # the same load (seed, arrivals, prompts) with eager prefills and
    # ticks on the same buckets
    e0 = dstat(engine=smoke)
    with eager_ticks():
        res_e = run_load(eng, rate=prm["rate"], n_requests=n_req,
                         prompt_len=prm["prompt_len"],
                         max_new=prm["max_new"], seed=0)
    torch.cuda.synchronize()
    e1 = dstat(engine=smoke)
    dstep_e = (e1["sum"] - e0["sum"]) / max(1, e1["count"] - e0["count"])
    log(f"  {fam.label} run_load, captured prefills and ticks: "
        f"{load_line(res, dstep['avg'])}; eager: {load_line(res_e, dstep_e)}"
        f"; {smi_line()}")
    check(eng.prefill_traces == len(want), "the eager load made a graph")
    decode = {}
    for label in ("eager", "captured"):
        with (eager_ticks() if label == "eager" else contextlib.nullcontext()):
            reset_counts()

            def paged_route(out):
                got = named_launches(out[2], PAGED_KERNELS)
                check(all(n == nl for n in got.values()),
                      f"{fam.label} {label} decode step ran the paged "
                      f"kernels {got}, want {nl} each")

            wall, busy, per_kernel = recorded(
                lambda: profile_decode(
                    torch, eng, config.vocab_size, f"{fam.label}, {label}",
                    steps=GEN_PROFILE_LAYER_TICKS // nl),
                lambda out: out[2], paged_route,
                f"{fam.label} {label} decode step")
        got = named_launches(per_kernel, PAGED_KERNELS)
        decode[label] = dict(wall_ms=wall, kernel_ms=busy,
                             launches=sum(per_kernel.values()))
        log(f"  decode step, {label}: {wall:.3f} ms wall, {busy} ms of "
            f"kernels, {decode[label]['launches']} kernels; paged kernels "
            f"{got}")
    out = dict(tokens_per_s=res.tokens_per_sec,
               ttft_p50_ms=res.ttft_p50 * 1e3, ttft_p99_ms=res.ttft_p99 * 1e3,
               decode_steps=res.engine_steps, paged_launches=counts["paged"],
               peak_bytes=peak, peak_bytes_before_warm=peak0,
               peak_bytes_after_warm=peak_warm, decode_step=decode,
               decode_step_ms=dstep["avg"] * 1e3,
               eager_prefill_load=dict(
                   tokens_per_s=res_e.tokens_per_sec,
                   ttft_p50_ms=res_e.ttft_p50 * 1e3,
                   ttft_p99_ms=res_e.ttft_p99 * 1e3,
                   decode_step_ms=dstep_e * 1e3))
    del eng
    t0 = time.perf_counter()
    out["tracing"] = serve_tracing(torch, fam, engine, model, prm, res, n_req)
    t1 = time.perf_counter()
    serve_slo(torch, fam, engine, model, prm)
    t2 = time.perf_counter()
    out["prefill"] = serve_buckets(torch, dev, report, fam, engine, model, nl)
    log(f"  ({fam.label} serve: tracing {t1 - t0:.1f} s, SLOs {t2 - t1:.1f} "
        f"s, buckets {time.perf_counter() - t2:.1f} s)")

    # bf16 sampled streams from one seed: captured = eager, token for token
    rng = torch.Generator().manual_seed(4)
    lo, hi = prm["prompt_len"]
    sampled = [torch.randint(1, config.vocab_size, (int(n),),
                             generator=rng).tolist()
               for n in torch.randint(lo, hi + 1, (8,), generator=rng)]
    streams = {}
    for label in ("captured", "eager"):
        with (eager_ticks() if label == "eager" else contextlib.nullcontext()):
            eng = engine(model, f"{smoke}_sampled_{label}", seed=7)
            reqs = [eng.submit(p, max_new_tokens=24, temperature=0.8)
                    for p in sampled]
            eng.run()
            streams[label] = [r.output_ids for r in reqs]
            del eng
    same = sum(a == b for a, b in zip(streams["captured"], streams["eager"]))
    log(f"  bf16 sampled streams (temperature 0.8, seed 7), captured vs "
        f"eager ticks: {same}/{len(sampled)} identical")
    check(same == len(sampled), "bf16 sampled streams: captured != eager")

    rng = torch.Generator().manual_seed(5)

    def rand_ids(n):
        return torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()

    # half the prompts share a two-block prefix, so the prefix-cache runs
    # prefill their suffixes through the paged kernel
    shared = rand_ids(2 * prm["block_size"])
    plans = [((shared if i % 2 else []) + rand_ids(
        int(torch.randint(lo, hi + 1, (1,), generator=rng))), 16)
        for i in range(12)]
    prefix = dict(prefix_cache=True, decode_burst=4)

    # bf16, the paged kernel at this path's shapes: every call of a run
    # with the prefix cache and bursts (decode, bursts, suffix prefills)
    # against its plain version; the checks read the host, so the ticks
    # are eager
    worst = {}
    name = f"{smoke}_checked"
    with checked_paged_attention(worst), eager_ticks():
        reset_counts()
        eng = engine(model, name, **prefix)
        for p, k in plans:
            eng.submit(p, max_new_tokens=k)
        eng.run()
        launched = read_counts()["paged"]
        del eng
    calls, err, share = worst.get("paged", (0, 0.0, 0.0))
    hits = obs.registry.get("serve.prefix_hits").value(engine=name)
    log(f"  bf16 {report['paged']['name']} at serving's shapes (prefix "
        f"cache, {hits} hits, bursts of 4), {calls} calls vs the plain "
        f"version: max_abs_err={err:.3g}, {share:.3g} of the tolerance")
    check(calls == launched and calls > 0 and hits > 0 and share <= 1.0,
          f"{fam.label} serving's paged calls: {calls} checked of {launched} "
          f"launched, {hits} prefix hits, {share:.3g} of the tolerance")
    out["paged_max_abs_err"] = err
    del model
    torch.cuda.empty_cache()

    model = fam.model(bf16=False)
    streams = {}
    for mode, kw in (("cold", {}), ("prefix+burst4", prefix)):
        for backend, ticks in (("kernel", "captured"), ("kernel", "eager"),
                               ("reference", "captured")):
            name = f"{smoke}_{mode}_{backend}_{ticks}"
            with (eager_ticks() if ticks == "eager"
                  else contextlib.nullcontext()):
                eng = engine(model, name, backend, **kw)
                reqs = [eng.submit(p, max_new_tokens=k) for p, k in plans]
                eng.run()
            streams[mode, backend, ticks] = [r.output_ids for r in reqs]
            hits = obs.registry.get("serve.prefix_hits").value(engine=name)
            want = len(eng.burst_lens_used) if kw else 1
            check(eng.decode_traces == want,
                  f"{name}: decode_traces {eng.decode_traces}, want {want} "
                  f"(burst lengths {sorted(eng.burst_lens_used)})")
            if ticks == "captured":
                check(all(g.captured for g in itertools.chain(
                    eng._graphs.values(), eng._prefill_graphs.values())),
                      f"{name}: a tick or prefill graph was not captured")
            lens = sorted(eng.burst_lens_used)
            del eng
        ref = streams[mode, "kernel", "captured"]
        same = {k: sum(a == b for a, b in zip(ref, streams[mode, *k]))
                for k in (("kernel", "eager"), ("reference", "captured"))}
        label = (f"{mode}, {hits} prefix hits, burst lengths {lens}" if kw
                 else mode)
        log(f"  fp32 {fam.label} greedy streams ({label}), captured kernel "
            f"ticks and prefills vs eager: {same['kernel', 'eager']}/"
            f"{len(plans)}, vs captured reference attention: "
            f"{same['reference', 'captured']}/{len(plans)} identical")
        check(all(n == len(plans) for n in same.values()),
              f"fp32 {fam.label} {mode}: the captured, eager and reference "
              f"streams differ")
        if kw:
            check(hits > 0, "the prefix-cache run never hit the cache")
    same = sum(a == b for a, b in zip(streams["cold", "kernel", "captured"],
                                      streams["prefix+burst4", "kernel",
                                              "captured"]))
    log(f"  fp32 greedy streams, cold vs prefix+burst4 (kernel): {same}/"
        f"{len(plans)} identical (not required: a shared prefix changes the "
        f"order of the sums)")
    del model
    torch.cuda.empty_cache()
    return out


#: generate's prompts: 8 rows left-padded with pad id 0 to 128 tokens,
#: real lengths across the 64- and 128-token block edges; new tokens a row
GEN_PROMPT_LENS = [128, 97, 64, 33, 128, 80, 50, 111]
GEN_NEW = 64
#: decode layers a profile may record (layers x ticks): a profile of too
#: many kernels loses launches (a 64-token Llama call, about 33k kernels,
#: lost 5 of 630 paged; GPT's eager 16-token call, about 10.3k, 1 of
#: 360), so a profiled ``generate`` call decodes, and a profiled window
#: of serving decode steps holds, 150 // layers ticks: Llama's 15 (about
#: 8.6k kernels eager), GPT's 6
GEN_PROFILE_LAYER_TICKS = 150
#: sampling knobs of the sampled runs, speculative decoding's gamma and
#: beam search's beams
GEN_SAMPLE = dict(do_sample=True, top_k=50, top_p=0.9, seed=3)
GEN_GAMMA = 4
GEN_BEAMS = 4


def _gen_prompts(torch, config, lens, seed):
    """Left-padded prompts [len(lens), max(lens)] (pad id 0, ids from
    1..vocab-1 by a seeded CPU generator; ``generate`` moves them to the
    model's device) and each row's pad count."""
    g = torch.Generator().manual_seed(seed)
    t0 = max(lens)
    ids = torch.zeros(len(lens), t0, dtype=torch.long)
    for r, n in enumerate(lens):
        ids[r, t0 - n:] = torch.randint(1, config.vocab_size, (n,),
                                        generator=g)
    return ids, [t0 - n for n in lens]


@contextlib.contextmanager
def plain_paged_attention():
    """``generate(paged=True)`` through the two kernels' plain versions:
    the names ``inference_attention`` calls are swapped for the block."""
    from paddle_tpu_torch.incubate.nn.functional import (
        inference_attention as ia)
    from paddle_tpu_torch.ops.cuda import flash_attention_varlen as fv
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    saved = ia.paged_attention_decode, ia.flash_attn_varlen_thd
    ia.paged_attention_decode = functools.partial(
        pa.paged_attention_decode, backend="reference")
    ia.flash_attn_varlen_thd = (
        lambda q, k, v, cu_q, cu_k, causal: fv._vflash_fwd_reference(
            q, k, v, cu_q, cu_k, causal=causal,
            scale=1.0 / math.sqrt(q.shape[-1])))
    try:
        yield
    finally:
        ia.paged_attention_decode, ia.flash_attn_varlen_thd = saved


@contextlib.contextmanager
def checked_paged_attention(worst):
    """``generate(paged=True)`` and ``ServeEngine`` on the kernels, each
    call of the two held against its plain version on the same inputs
    (the pools as the call found them) at the tolerance of the kernel's
    own phase: paged ``tolerance(dtype, 1e-5)``, varlen
    ``tolerance(dtype, 1e-4)``. The calls return the kernels' outputs.
    ``worst`` collects, per counter key, [calls, max abs err, worst share
    of the tolerance]."""
    from paddle_tpu_torch.incubate.nn.functional import (
        inference_attention as ia)
    from paddle_tpu_torch.ops.cuda import flash_attention_varlen as fv
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.serve import engine as se

    saved = kernel_paged, kernel_varlen = (ia.paged_attention_decode,
                                           ia.flash_attn_varlen_thd)
    saved_engine = se.paged_attention_decode

    def note(key, out, ref, base):
        err, share = close_err(out, ref, *tolerance(out.dtype, base))
        w = worst.setdefault(key, [0, 0.0, 0.0])
        w[:] = w[0] + 1, max(w[1], err), max(w[2], share)

    def paged(q, kc, vc, lengths, tables, **kw):
        out = kernel_paged(q, kc, vc, lengths, tables, **kw)
        note("paged", out, pa.paged_attention_decode(
            q, kc, vc, lengths, tables, backend="reference"), 1e-5)
        return out

    def varlen(q, k, v, cu_q, cu_k, causal):
        out, lse = kernel_varlen(q, k, v, cu_q, cu_k, causal=causal)
        note("vflash", out, fv._vflash_fwd_reference(
            q, k, v, cu_q, cu_k, causal=causal,
            scale=1.0 / math.sqrt(q.shape[-1]))[0], 1e-4)
        return out, lse

    ia.paged_attention_decode, ia.flash_attn_varlen_thd = paged, varlen
    se.paged_attention_decode = paged
    try:
        yield
    finally:
        ia.paged_attention_decode, ia.flash_attn_varlen_thd = saved
        se.paged_attention_decode = saved_engine


def first_diffs(torch, a, b, t0):
    """Per row, the first new token where the streams ``a`` and ``b``
    differ (None where the row is equal)."""
    return [int((a[r] != b[r]).int().argmax()) - t0
            if bool((a[r] != b[r]).any()) else None for r in range(a.shape[0])]


def check_streams(torch, model, pads, a, b, label, sample=None,
                  required=True):
    """Fail unless the token streams ``a`` and ``b`` [B, t0 + n] are equal,
    or each row that differs does so first where the two tokens it chose
    score within ``tolerance(float32, 1e-4)`` of each other: the logits
    of the model's full-prefix forward on the row's common prefix, in
    fp32 (for sampled streams filtered and perturbed by the same Gumbel
    draw, replayed from ``sample``'s seed). Each first difference is
    printed with that score gap, the gap in units in the last place of
    the model's logits dtype at the larger score, and the rank of ``b``'s
    token among the scores. With ``required`` False nothing is checked
    (a bf16 model: its logits round to 8 bits). Returns the gaps."""
    from paddle_tpu_torch.core.generator import make_generator
    from paddle_tpu_torch.models import generation as gen

    atol, _ = tolerance(torch.float32, 1e-4)
    t0 = a.shape[1] - GEN_NEW
    diff = a != b
    gaps = []
    for r in diff.any(dim=1).nonzero().flatten().tolist():
        j = int(diff[r].int().argmax())
        with torch.no_grad():
            logits = model(a[r:r + 1, pads[r]:j])[0, -1]
        scores = logits.float()
        if sample is not None:
            g = make_generator(sample["seed"], a.device)
            for _ in range(j - t0 + 1):       # one draw a token, as generate
                noise = torch.empty(a.shape[0], scores.shape[0],
                                    device=a.device).exponential_(generator=g)
            scores = gen._filter_logits(
                scores[None], 1.0, sample["top_k"], sample["top_p"])[0]
            scores = scores - torch.log(noise[r])
        sa, sb = float(scores[a[r, j]]), float(scores[b[r, j]])
        gap = abs(sa - sb)
        top = max(abs(sa), abs(sb))
        ulp = torch.finfo(logits.dtype).eps * 2.0 ** math.floor(
            math.log2(top)) if top > 0 else 0.0
        rank = int((scores > sb).sum())
        gaps.append(dict(row=r, new_token=j - t0, gap=gap,
                         ulps=gap / ulp if ulp else None, rank_b=rank))
        log(f"  {label}: row {r} differs first at new token {j - t0} "
            f"({int(a[r, j])} vs {int(b[r, j])}), score gap {gap:.3g} = "
            f"{gap / ulp if ulp else math.inf:.3g} {logits.dtype} ulps at "
            f"|score| {top:.3g}, the second token ranked {rank} "
            + (f"(near-tie if <= {atol:g})" if required
               else "(reported, not required)"))
        if required:
            check(gap <= atol, f"{label}: row {r} differs at new token "
                               f"{j - t0}, not at a near-tie (gap {gap:.3g})")
    return gaps


def device_table(torch, fn, n):
    """Kernel name -> (launches, device ms) per call of ``fn``, over ``n``
    profiled calls."""
    from torch.autograd import DeviceType

    return {e.key: (e.count // n, _dev_us(e) / n / 1e3)
            for e in profiled(fn, n) if e.device_type == DeviceType.CUDA}


def timed_call(torch, fn):
    """(result, wall ms, the warm-up call's result) of ``fn``, timed after
    one warm-up call."""
    first = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, first


def tick_numbers(torch, call, prof_new, all_ms):
    """A decode tick of ``call(n)`` (a ``generate`` call of ``n`` new
    tokens), as ``phase_generate`` measures the dense tick: the wall of
    the ``GEN_NEW``-token call (``all_ms``, timed by the caller) less the
    1-token call over ``GEN_NEW - 1`` ticks, and the kernels (device ms
    and launches) of the profiled ``prof_new``-token call less the
    1-token call over ``prof_new - 1``."""
    _, one_ms, _ = timed_call(torch, lambda: call(1))
    tab = {n: device_table(torch, lambda: call(n), 1) for n in (1, prof_new)}
    kernel_ms, launches = (
        sum((1 if n > 1 else -1) * v[i] for n, t in tab.items()
            for v in t.values()) / (prof_new - 1) for i in (1, 0))
    wall = (all_ms - one_ms) / (GEN_NEW - 1)
    return dict(wall_ms=wall, kernel_ms=kernel_ms, busy=kernel_ms / wall,
                launches=launches, prefill_ms=one_ms)


def capture_cost(site, since):
    """Mean host wall ms of the captures of ``site`` (a ``Graphed``'s
    first call: its warm-up run and the capture) after ``since`` (a
    ``stats`` of ``jit.graph_capture_seconds``), and their number."""
    from paddle_tpu_torch import observability as obs

    s = obs.registry.get("jit.graph_capture_seconds").stats(site=site)
    n = s["count"] - since["count"]
    return ((s["sum"] - since["sum"]) / n * 1e3 if n else None), n


def beam_both_ways(torch, fam, model, ids, run, prof_new):
    """Beam search (``GEN_BEAMS`` beams, the pad ids as tokens: beam search
    takes no ragged prompts) with captured ticks and with eager ticks
    (``eager_ticks``): the two must give the same tokens. For each:
    tokens/s of the ``GEN_NEW``-token call, the tick's wall and kernel ms,
    busy share and kernels (``tick_numbers``), and the capture's cost a
    call (site ``generate.beam``)."""
    from paddle_tpu_torch import observability as obs

    t0 = ids.shape[1]
    capture = obs.registry.get("jit.graph_capture_seconds")

    def call(n):
        return model.generate(ids, max_new_tokens=n, num_beams=GEN_BEAMS)

    out, streams = {}, {}
    for mode in ("captured", "eager"):
        since = capture.stats(site="generate.beam")
        with (eager_ticks() if mode == "eager"
              else contextlib.nullcontext()):
            streams[mode], _ = run(f"beam search, {GEN_BEAMS} beams, {mode} "
                                   f"ticks", lambda: call(GEN_NEW))
            all_ms = ids.shape[0] * GEN_NEW / run.last_tokens_per_s * 1e3
            tick = tick_numbers(torch, call, prof_new, all_ms)
        cap_ms, n_cap = capture_cost("generate.beam", since)
        check((n_cap > 0) == (mode == "captured"),
              f"{fam.label} beam, {mode} ticks: {n_cap} captures")
        out[mode] = dict(tick, tokens_per_s=ids.shape[0] * GEN_NEW / all_ms
                         * 1e3, call_ms=all_ms, capture_ms=cap_ms)
        log(f"  {fam.label} beam tick, {mode}: {tick['wall_ms']:.3f} ms "
            f"wall, {tick['kernel_ms']:.3f} ms of kernels "
            f"({tick['busy']:.1%} busy), {tick['launches']:.0f} kernels; "
            f"{out[mode]['tokens_per_s']:.1f} tokens/s; the capture's cost a "
            f"call "
            + ("not measured" if cap_ms is None else f"{cap_ms:.2f} ms")
            + f" ({n_cap} calls)")
    check(torch.equal(streams["captured"], streams["eager"]),
          f"bf16 {fam.label} beam search: captured ticks differ from eager "
          f"ticks {first_diffs(torch, streams['captured'], streams['eager'], t0)}")
    log(f"  bf16 {fam.label} beam search: captured ticks = eager ticks, token "
        f"for token")
    return out


def speculative_both_ways(torch, fam, model, draft, one, run, prof_new):
    """``generate_speculative`` of the one prompt ``one`` with the 2-layer
    ``draft``, gamma ``GEN_GAMMA``, with captured rounds and with eager
    rounds (``eager_ticks``): the two must give the same tokens. For
    each: tokens/s of the ``GEN_NEW``-token call, its rounds and mean
    accepted drafts a round (the ``generate.speculative_*`` counters), a
    round's wall ms (that call less the 1-token call, over the rounds
    between them: the prefill and the capture fall out) and kernel ms
    (the profiled ``prof_new``-token call less the 1-token call, over
    their rounds), and the capture's cost a call (site
    ``generate.speculative``)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models.generation import generate_speculative

    rounds = obs.registry.get("generate.speculative_rounds")
    accepted = obs.registry.get("generate.speculative_accepted")
    capture = obs.registry.get("jit.graph_capture_seconds")
    out, streams = {}, {}
    for mode in ("captured", "eager"):
        since = capture.stats(site="generate.speculative")
        counted = {}

        def call(n=GEN_NEW):
            r0, a0 = rounds.total(), accepted.total()
            toks = generate_speculative(model, draft, one, max_new_tokens=n,
                                        gamma=GEN_GAMMA)
            counted[n] = (rounds.total() - r0, accepted.total() - a0)
            return toks

        with (eager_ticks() if mode == "eager"
              else contextlib.nullcontext()):
            streams[mode], _ = run(
                f"generate_speculative, the {one.shape[1]}-token prompt, "
                f"gamma {GEN_GAMMA}, 2-layer draft, {mode} rounds", call,
                rows=1)
            tps = run.last_tokens_per_s
            all_ms = GEN_NEW / tps * 1e3
            n_rounds, n_acc = counted[GEN_NEW]     # the timed call's
            _, one_ms, _ = timed_call(torch, lambda: call(1))
            kern = {n: sum(v[1] for v in device_table(
                torch, lambda: call(n), 1).values()) for n in (1, prof_new)}
        cap_ms, n_cap = capture_cost("generate.speculative", since)
        check((n_cap > 0) == (mode == "captured") and n_rounds > 1,
              f"{fam.label} speculative, {mode} rounds: {n_cap} captures, "
              f"{n_rounds} rounds")
        wall = (all_ms - one_ms) / (n_rounds - counted[1][0])
        kernel = (kern[prof_new] - kern[1]) / (counted[prof_new][0]
                                               - counted[1][0])
        out[mode] = dict(tokens_per_s=tps, rounds=n_rounds,
                         accepted_per_round=n_acc / n_rounds, round_ms=wall,
                         round_kernel_ms=kernel, busy=kernel / wall,
                         capture_ms=cap_ms)
        log(f"  {fam.label} speculative, {mode} rounds: {n_rounds} rounds, "
            f"{n_acc / n_rounds:.2f} drafts accepted a round; a round "
            f"{wall:.3f} ms wall, {kernel:.3f} ms of kernels ({kernel / wall:.1%}"
            f" busy); {tps:.1f} tokens/s; the capture's cost a call "
            + ("not measured" if cap_ms is None else f"{cap_ms:.2f} ms")
            + f" ({n_cap} calls)")
    check(torch.equal(streams["captured"], streams["eager"]),
          f"bf16 {fam.label} speculative: captured rounds differ from eager "
          f"rounds {first_diffs(torch, streams['captured'], streams['eager'], one.shape[1])}")
    log(f"  bf16 {fam.label} speculative: captured rounds = eager rounds, "
        f"token for token")
    return out


def phase_generate(torch, dev, report, fam):
    """``generate`` of the family ``fam`` at full width in bf16 (Llama:
    ``default_serving_setup``'s 10 layers, hidden 2048, 16 heads of 128;
    GPT: gpt2_medium's 24 layers, 16 heads of 64), 8 left-padded prompts
    (``GEN_PROMPT_LENS``), 64 new tokens, each run timed after one warm-up
    call: dense greedy; ``paged=True`` at block 64 and 128, which must
    launch ``paged_decode_split_kernel`` once per layer per tick (L x 63)
    and the varlen forward once per layer (L), and no other kernel of the
    port, the profiler showing both by name on the tensor-core varlen
    route; at both blocks, every paged and varlen call of a further run
    held against its plain version on the same inputs
    (``checked_paged_attention``) and the tokens of a run on the plain
    versions reported beside the dense run's, with the score gap at each
    row's first differing token (``check_streams``, reported, not
    required in bf16); sampled (top-k 50, top-p 0.9), dense and paged,
    the two calls of one seed equal bit for bit; beam search with 4
    beams, captured and eager ticks giving equal tokens
    (``beam_both_ways``: tokens/s, the tick and the capture's cost both
    ways); ``generate_speculative`` of the 128-token prompt with a 2-layer
    draft of the same family and widths, gamma 4, captured and eager
    rounds giving equal tokens (``speculative_both_ways``: rounds,
    accepted drafts, ms a round). Prints tokens/s,
    prefill and decode-tick times (a tick: the 64-token call less the
    1-token call, over 63; its kernels from profiles of a longer call
    and the 1-token call: 16 new tokens for Llama, 7 for GPT,
    ``GEN_PROFILE_LAYER_TICKS``) and where a tick's kernel time goes.
    Then fp32 at 2 layers (TF32 off): greedy dense (plain), paged on the
    kernels and paged on their plain versions give equal tokens,
    speculative decoding (captured rounds) equals the dense greedy
    stream, and sampled
    dense and paged streams are equal (``check_streams`` admits a
    near-tie). A family without ``paged`` (ERNIE-MoE) runs the dense
    greedy, sampled and beam calls and the dense tick only, from
    same-length prompts (``fam.prompt_lens``). Every call captures its
    tick once (the
    first tick eager, the rest replays); the bf16 greedy and sampled
    streams must equal those of eager ticks (``eager_ticks``), the
    checked run's ticks are eager, and the tick is timed both ways, with
    the capture's own cost a call (``jit.graph_capture_seconds``).
    Returns the numbers."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models.generation import generate_speculative

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    model = fam.model()
    config = model.config
    nl = config.num_hidden_layers
    lens = fam.prompt_lens or GEN_PROMPT_LENS
    ids, pads = _gen_prompts(torch, config, lens, 8)
    pad = {"pad_token_id": 0} if any(pads) else {}
    b, t0 = ids.shape
    ticks = GEN_NEW - 1
    prof_new = 1 + GEN_PROFILE_LAYER_TICKS // nl
    tc, cc = VARLEN_KERNELS["fwd"]
    res = {"tokens_per_s": {}}

    def gen(model, n=GEN_NEW, **kw):
        return lambda: model.generate(ids, max_new_tokens=n, **pad, **kw)

    def run(label, fn, rows=b):
        """Time ``fn``; its output must be on the card, prompt + 64 ids
        in range."""
        out, ms, first = timed_call(torch, fn)
        check(out.device == dev and out.shape[1] == t0 + GEN_NEW
              and bool(((out >= 0) & (out < config.vocab_size)).all()),
              f"{fam.label} {label}: output {tuple(out.shape)} on "
              f"{out.device}")
        log(f"  {fam.label} {label}: {ms:.1f} ms, "
            f"{rows * GEN_NEW / ms * 1e3:.1f} tokens/s")
        res["tokens_per_s"][label] = run.last_tokens_per_s = (
            rows * GEN_NEW / ms * 1e3)
        return out, first

    log(f"  {fam.label}, {model.num_parameters() / 1e6:.1f}M parameters, "
        f"bf16, {b} prompts of {lens} tokens"
        + (f" (left-padded to {t0})" if pad else "")
        + f", {GEN_NEW} new tokens; {smi_line()}")
    reset_counts()
    dense, _ = run("dense greedy", gen(model))
    if not fam.paged:
        record_launches(report, f"{fam.tag}generate", read_counts())
    with eager_ticks():
        eager = gen(model)()
    check(torch.equal(eager, dense), f"bf16 {fam.label} dense greedy: the "
          f"captured ticks' tokens differ from the eager ticks' (first "
          f"differing new token per row {first_diffs(torch, dense, eager, t0)})")
    log("  bf16 dense greedy: captured ticks = eager ticks, token for token")
    if fam.paged:
        paged = {}
        for block in (64, 128):
            fn = gen(model, paged=True, block_size=block)
            paged[block], _ = run(f"paged greedy, block {block}",
                                  lambda: (reset_counts(), fn())[1])
            counts = read_counts()
            log(f"    launches of the timed call: {counts}")
            check(counts["paged"] == nl * ticks and counts["vflash"] == nl,
                  f"{fam.label} paged block {block}: paged launches "
                  f"{counts['paged']} (want {nl * ticks}), varlen forward "
                  f"{counts['vflash']} (want {nl})")
            check(not any(n for k, n in counts.items()
                          if k not in ("paged", "vflash")),
                  f"{fam.label} paged block {block}: other kernels launched: "
                  f"{counts}")
            if block == 64:
                record_launches(report, f"{fam.tag}generate", counts)
        # the two kernels at the shapes of this path, bf16: every call of a
        # checked run against its plain version (the run must give the timed
        # run's tokens); then the stream of a run on the plain versions
        worst = {}
        res["bf16_gaps"] = {}
        for block in (64, 128):
            fn = gen(model, paged=True, block_size=block)
            # the checks read the host, so this run's ticks are eager: its
            # tokens are the eager ticks', and must be the captured run's
            with checked_paged_attention(worst), eager_ticks():
                again = fn()
            check(torch.equal(again, paged[block]),
                  f"{fam.label} paged block {block}: the checked run's (eager "
                  f"ticks) tokens differ from the timed run's (captured "
                  f"ticks)")
            with plain_paged_attention():
                plain = fn()
            log(f"  bf16 paged (block {block}), first differing new token per "
                f"row (None: equal; reported, not required): vs dense "
                f"{first_diffs(torch, paged[block], dense, t0)}, vs paged on "
                f"the plain versions "
                f"{first_diffs(torch, paged[block], plain, t0)}")
            for other, against in (("dense", dense), ("plain", plain)):
                res["bf16_gaps"][f"block{block}_vs_{other}"] = check_streams(
                    torch, model, pads, paged[block], against,
                    f"bf16 paged block {block} vs {other}", required=False)
        for key, want in (("paged", 2 * nl * ticks), ("vflash", 2 * nl)):
            calls, err, share = worst[key]
            log(f"  bf16 {report[key]['name']} at generate's shapes (blocks "
                f"64 "
                f"and 128), {calls} calls vs the plain version: max_abs_err="
                f"{err:.3g}, {share:.3g} of the tolerance")
            check(calls == want and share <= 1.0,
                  f"{fam.label} generate's {key} calls: {calls} checked (want "
                  f"{want}), {share:.3g} of the tolerance")
            res[f"{key}_max_abs_err"] = err
    modes = (("dense", {}), ("paged", dict(paged=True)))[:1 + fam.paged]
    for label, kw in ((f"sampled {m}", kw) for m, kw in modes):
        out, first = run(label, gen(model, **GEN_SAMPLE, **kw))
        check(torch.equal(out, first),
              f"bf16 {fam.label} {label}: two calls with one seed differ")
        with eager_ticks():
            eager = gen(model, **GEN_SAMPLE, **kw)()
        check(torch.equal(out, eager),
              f"bf16 {fam.label} {label}: captured ticks differ from eager "
              f"ticks {first_diffs(torch, out, eager, t0)}")
    log("  bf16 sampled, one seed twice: equal bit for bit, and equal to the "
        f"eager ticks' streams ({', '.join(m for m, _ in modes)})")
    res["beam"] = beam_both_ways(torch, fam, model, ids, run, prof_new)
    if fam.paged:
        draft = fam.model(layers=2, seed=1)
        res["speculative"] = speculative_both_ways(torch, fam, model, draft,
                                                   ids[:1], run, prof_new)
        del draft

    # prefill and the decode tick: the wall of the 64-token call less the
    # 1-token call, the kernels of the profiled 16-token call less the
    # 1-token call (the paged run last: its profile is checked below),
    # with eager ticks and with captured ticks (a call captures its tick
    # once: the first tick runs eagerly, the others are replays)
    capture = obs.registry.get("jit.graph_capture_seconds")
    cap0 = {label: capture.stats(site=f"generate.{label}")
            for label, _ in modes}
    tick_ms = {}

    def launches_of(t):
        return {k: v[0] for k, v in t.items()}

    def paged_route(t, mode):
        """The profiled paged call ran the paged kernel once a layer a
        tick and the tensor-core varlen forward once a layer."""
        got = named_launches(launches_of(t), PAGED_KERNELS + (tc, cc))
        want = nl * (prof_new - 1)
        check(got[PAGED_KERNELS[0]] == want and got[tc] == nl
              and got[cc] == 0,
              f"profiled {fam.label} paged generate ({mode} ticks) ran "
              f"{got}, want {PAGED_KERNELS[0]} {want} times, {tc} {nl} "
              f"times and {cc} never")

    for mode in ("eager", "captured"):
        for label, kw in modes:
            with (eager_ticks() if mode == "eager"
                  else contextlib.nullcontext()):
                _, one_ms, _ = timed_call(torch, gen(model, 1, **kw))
                _, all_ms, _ = timed_call(torch, gen(model, **kw))
                tab = {1: device_table(torch, gen(model, 1, **kw), 1)}
                take = functools.partial(device_table, torch,
                                         gen(model, prof_new, **kw), 1)
                tab[prof_new] = take() if label != "paged" else recorded(
                    take, launches_of,
                    functools.partial(paged_route, mode=mode),
                    f"profiled {fam.label} paged generate ({mode} ticks)")

            def per_tick(pats, i):
                """Launches (i=0) or device ms (i=1) of the kernels
                matching ``pats`` (all with None) in a tick."""
                return sum((1 if n > 1 else -1) * v[i]
                           for n, t in tab.items() for k, v in t.items()
                           if pats is None or any(p in k for p in pats)
                           ) / (prof_new - 1)

            wall, busy = (all_ms - one_ms) / (GEN_NEW - 1), per_tick(None, 1)
            kinds = {kind: per_tick(pats, 1) for kind, pats in KERNEL_KINDS}
            kinds["other"] = busy - sum(kinds.values())
            tick_ms[mode, label] = dict(wall_ms=wall, kernel_ms=busy,
                                        launches=per_tick(None, 0),
                                        prefill_ms=one_ms)
            log(f"  {fam.label} {label} decode tick, {mode}: {wall:.3f} ms "
                f"wall, {busy:.3f} ms of kernels ({busy / wall:.1%} busy), "
                f"{per_tick(None, 0):.0f} kernels; by kind "
                + ", ".join(f"{k} {ms:.3f}" for k, ms in kinds.items()
                            if abs(ms) >= 5e-4)
                + f"; prefill (the 1-token call) {one_ms:.2f} ms wall, "
                f"{sum(v[1] for v in tab[1].values()):.3f} ms of kernels")
        if fam.paged:
            paged_ms = kinds["paged decode (port)"]
            got = named_launches(launches_of(tab[prof_new]),
                                 PAGED_KERNELS + (tc, cc))
            log(f"  paged tick, {mode}: {PAGED_KERNELS[0]} {paged_ms:.4f} ms "
                f"({paged_ms / busy:.1%} of the tick's kernels); launches of "
                f"the "
                f"profiled {prof_new}-token call by name {got}")
    cap = {}
    for label, s0 in cap0.items():
        s = capture.stats(site=f"generate.{label}")
        n = s["count"] - s0["count"]
        cap[label] = (s["sum"] - s0["sum"]) / n * 1e3 if n else None
        log(f"  the capture's own cost per {label} call (first tick + "
            f"capture, host wall, mean over this phase's {n} calls): "
            + ("not measured" if cap[label] is None
               else f"{cap[label]:.2f} ms"))
    res["ticks"] = {f"{label}_{mode}": v for (mode, label), v in
                    tick_ms.items()}
    res["capture_ms"] = cap
    del model
    torch.cuda.empty_cache()
    if not fam.paged:
        return res

    # fp32 at 2 layers, full width: the kernels against the plain versions
    model = fam.model(bf16=False, layers=2)
    draft = fam.model(bf16=False, layers=2, seed=1)
    dense = gen(model)()
    reset_counts()
    paged = gen(model, paged=True)()
    counts = read_counts()
    check(counts["paged"] == 2 * ticks and counts["vflash"] == 2,
          f"fp32 {fam.label} paged generate launches {counts}")
    with plain_paged_attention():
        reset_counts()
        plain = gen(model, paged=True)()
        check(not any(read_counts().values()),
              "the plain paged run launched a kernel")
    check_streams(torch, model, pads, dense, paged,
                  f"fp32 {fam.label} greedy, dense vs paged (kernels)")
    check_streams(torch, model, pads, paged, plain,
                  f"fp32 {fam.label} greedy, paged kernels vs plain")
    one = ids[:1]                              # 128 real tokens
    capture = obs.registry.get("jit.graph_capture_seconds")
    spec0 = capture.stats(site="generate.speculative")["count"]
    check_streams(torch, model, [0],
                  generate_speculative(model, draft, one,
                                       max_new_tokens=GEN_NEW,
                                       gamma=GEN_GAMMA),
                  model.generate(one, max_new_tokens=GEN_NEW),
                  f"fp32 {fam.label} speculative (captured rounds) vs dense "
                  f"greedy")
    check(capture.stats(site="generate.speculative")["count"] == spec0 + 1,
          f"fp32 {fam.label} speculative: its rounds were not captured")
    sampled = [gen(model, **GEN_SAMPLE, **kw)() for kw in ({}, dict(paged=True))]
    check_streams(torch, model, pads, *sampled,
                  f"fp32 {fam.label} sampled, dense vs paged (kernels)",
                  sample=GEN_SAMPLE)
    log(f"  fp32 {fam.label}, 2 layers: greedy dense = paged (kernels) = "
        f"paged (plain), speculative (captured rounds) = dense greedy, "
        f"sampled dense = paged "
        f"(a near-tie is printed above if one was admitted)")
    del model, draft
    torch.cuda.empty_cache()
    return res


#: bench.py:bench_llama's training configuration (bench.py:258-264)
TRAIN_CONFIG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                    num_hidden_layers=10, num_attention_heads=16,
                    num_key_value_heads=16, max_position_embeddings=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5


def train_launches(nl):
    """Each counter's launches per training step of ``nl`` layers: flash
    forward and backward once a layer, RMSNorm forward and backward twice
    a layer and once for the final norm, no other kernel."""
    return {"flash": nl, "flash_bwd": nl, "rms_norm": 2 * nl + 1,
            "rms_norm_bwd": 2 * nl + 1, "paged": 0, "vflash": 0,
            "vflash_bwd": 0, "vflash_bwd_dkv": 0, "tiled_mm": 0}


def step_rates(dt, n_params, nl, hid, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               steps=TRAIN_STEPS):
    """(step ms, tokens/s, MFU) of ``steps`` steps of ``batch`` x ``seq``
    tokens in ``dt`` s; MFU is bench.py's formula (bench.py:310-312)
    against the bf16 peak."""
    tok_s = batch * seq * steps / dt
    attn_flops = 12 * nl * hid * seq
    mfu = tok_s * (6 * n_params + attn_flops) / PEAK_FLOPS["bfloat16"]
    return dt / steps * 1e3, tok_s, mfu


def _llama_loss(model, ids, labels):
    return model(ids, labels=labels)[0]


def check_train_kernels(per_kernel, nl, label):
    """A profiled bf16 step ran the tensor-core flash kernels and the
    vector RMSNorm kernels, each the step's count, by name."""
    check_flash_route(per_kernel, {"fwd": nl, "dq": nl, "dkv": nl}, label)
    got = named_launches(per_kernel, RMS_TRAIN_KERNELS)
    log(f"  {label}: RMSNorm kernels {got}")
    check(all(c == 2 * nl + 1 for c in got.values()),
          f"{label}: RMSNorm kernels {got}, want {2 * nl + 1} each")


def phase_train(torch, dev, report):
    """``bench.py:bench_llama``'s step at its full width and depth (645M
    parameters, bf16, batch 4 x 2048, labels = ids rolled by one,
    ``AdamW(learning_rate=3e-4, multi_precision=True)``, weight decay
    0.01): one warm-up step, then ``TRAIN_STEPS`` timed steps on the same
    batch. Every step must launch flash forward and backward once per
    layer and the RMSNorm forward and backward twice per layer plus the
    final norm, and the profiled step must show the tensor-core flash
    forward, dq and dk/dv kernels once per layer each and no CUDA-core
    flash kernel; every loss must be finite and the last below the first.
    MFU is bench.py's formula (bench.py:310-312) against the 989 TFLOP/s
    bf16 peak. Then 2 layers at full width in fp32 (TF32 off), batch
    2 x 512: the loss and every parameter gradient through the kernels
    vs through the plain compositions (flags off). Tolerances: loss 1e-4
    absolute (a mean of ~10.4 over 1022 tokens, fp32 sums in another
    order); each gradient within 1e-4 of its own max |g| (the kernels
    and the plain einsums sum in another order; the CPU tests measure
    about 1e-6 between two fp32 implementations). The full-width step is
    also timed on the plain compositions (flags off) for comparison.
    Then the step under ``jit.to_static(full_graph=True)``
    (``static_vs_eager``)."""
    import dataclasses

    from paddle_tpu_torch.core.flags import flags_scope
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    config = LlamaConfig(**TRAIN_CONFIG, dtype="bfloat16")
    nl, hid = config.num_hidden_layers, config.hidden_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = LlamaForCausalLM(config, device=dev, seed=0)
    n_params = model.num_parameters()
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                multi_precision=True)
    ids, labels = train_batch(torch, config, dev)

    def step():
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    t0 = time.perf_counter()
    warm = float(step())
    log(f"  model: {n_params / 1e6:.1f}M parameters, bf16; warm-up step "
        f"{time.perf_counter() - t0:.2f} s, loss {warm:.4f}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  {TRAIN_STEPS} steps: launches {counts}, losses "
        f"{[round(x, 4) for x in losses]}")
    for key, n in train_launches(nl).items():
        check(counts[key] == n * TRAIN_STEPS,
              f"{key} launches {counts[key]} != {n} x {TRAIN_STEPS} steps")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    record_launches(report, "train", counts)
    step_ms, tok_s, mfu = step_rates(dt, n_params, nl, hid)
    log(f"  train step: {step_ms:.2f} ms mean, {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} (bench.py's formula, 989 TFLOP/s bf16 peak), peak "
        f"memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    busy, per_kernel = recorded(
        lambda: profile_kernels(torch, step, 1, step_ms,
                                "train step, kernels"),
        _per_kernel,
        lambda out: check_train_kernels(out[1], nl, "bf16 train step"),
        "bf16 train step")
    # the optimizer's share of the step: AdamW's update alone, device time
    loss, _ = model(ids, labels=labels)
    loss.backward()
    opt_ms = device_ms(opt.step, iters=3, warmup=1)
    opt_launches = sum(kernel_counts(torch, opt.step, 1).values())
    opt.clear_grad()
    log(f"  AdamW step alone (multi-tensor update): {opt_ms:.2f} ms of "
        f"device time and {opt_launches} kernels per update")
    # the same step on the plain compositions (flags off), for comparison
    with flags_scope(use_cuda_flash_attention=False, use_cuda_rms_norm=False):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) / 3 * 1e3
        profile_kernels(torch, step, 1, plain_ms,
                        "train step, plain compositions")
    report["train"] = dict(step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu,
                           peak_bytes=peak, losses=losses,
                           busy_share=None if busy is None else busy / step_ms,
                           optimizer_ms=opt_ms,
                           optimizer_launches=opt_launches,
                           plain_step_ms=plain_ms)
    del model, opt
    torch.cuda.empty_cache()
    report["train"]["to_static"] = static_vs_eager(
        torch, dev, lambda: LlamaForCausalLM(config, device=dev, seed=0),
        (ids, labels), _llama_loss,
        lambda m: (AdamW(learning_rate=3e-4, parameters=m.parameters(),
                         multi_precision=True), None), "bf16 train",
        train_launches(nl), lambda pk, lb: check_train_kernels(pk, nl, lb))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = LlamaForCausalLM(dataclasses.replace(
        config, num_hidden_layers=2, dtype="float32"), device=dev, seed=0)
    ids2 = ids[:2, :512]
    labels2 = labels[:2, :512].clone()
    labels2[:, -1] = -100

    def loss_and_grads():
        loss, _ = model(ids2, labels=labels2)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    reset_counts()
    k_loss, k_grads = loss_and_grads()
    k_counts = read_counts()
    with flags_scope(use_cuda_flash_attention=False, use_cuda_rms_norm=False):
        p_loss, p_grads = loss_and_grads()
    torch.cuda.synchronize()
    check(read_counts() == k_counts, "the plain run launched a kernel")
    check(min(k_counts[k] for k in ("flash", "flash_bwd", "rms_norm",
                                    "rms_norm_bwd")) > 0,
          f"the fp32 kernel run missed a kernel: {k_counts}")
    worst = max(((float((k_grads[n] - gp).abs().max())
                  / float(gp.abs().max()), n) for n, gp in p_grads.items()))
    log(f"  fp32 2 layers [2, 512], kernels vs plain: loss {k_loss:.6f} vs "
        f"{p_loss:.6f} (diff {abs(k_loss - p_loss):.3g}, tol 1e-4); worst "
        f"gradient {worst[1]} off by {worst[0]:.3g} of its max |g| "
        f"(tol 1e-4) over {len(p_grads)} gradients")
    check(abs(k_loss - p_loss) <= 1e-4, "fp32 training loss differs")
    check(worst[0] <= 1e-4, f"fp32 gradient {worst[1]} differs")
    del model, k_grads, p_grads
    torch.cuda.empty_cache()


#: a captured training step against an eager step from the same state:
#: each fp32 master weight within this many fp32 units in the last place
#: of its operands (the master before the step and the eager update).
#: The captured update computes the rate, step size and bias corrections
#: in fp32 on the card and divides the denominator by the step size
#: (``optimizers.py::_adam_foreach_device``: eight roundings on the way
#: to the update), where the eager one rounds host doubles once into an
#: ``addcdiv`` (seven): at most 7.5 ulps of the update apart, plus the
#: decay factor's and the sum's roundings, one ulp of the master each
#: side. Each bf16 parameter must be its master rounded once (so the two
#: lie at most one bf16 ulp apart where the masters straddle a rounding
#: edge); the moments and the loss must be equal.
STATIC_MASTER_ULPS = 10


def _master_share(new_c, new_e, old):
    """Worst ``|new_c - new_e|`` over ``STATIC_MASTER_ULPS`` fp32 ulps of
    the larger operand of the eager update (``|old|`` or ``|new_e -
    old|``): must be <= 1."""
    import torch

    scale = torch.maximum(old.abs(), (new_e - old).abs())
    ulp = STATIC_MASTER_ULPS * torch.finfo(torch.float32).eps * scale
    return float(((new_c - new_e).abs() / ulp.clamp(min=1e-38)).max())


def static_vs_eager(torch, dev, make_model, batch, loss_of, make_opt, label,
                    want, check_route, generators=lambda m: [],
                    steps=TRAIN_STEPS):
    """The train step under ``jit.to_static(full_graph=True)`` against the
    same step run eagerly. ``make_model()`` -> a model made from seed 0;
    the step is ``loss_of(model, *batch)``, its backward and the
    optimizer's step; ``make_opt(model)`` -> (optimizer, scheduler or
    None; the caller steps the scheduler after each call); ``want`` the
    launches of one step by counter and ``check_route(per_kernel,
    label)`` the kernels a profiled step must run by name;
    ``generators(model)`` the model's explicit generators, whose states
    the eager model takes from the captured one before each compared
    step (so both draw the same dropout and routing); its buffers (batch
    norm's running statistics) are copied too, and must come out equal.

    First the captured run alone, from a model made from seed 0:
    ``steps`` calls (the first one the warm-up and the capture), then
    ``steps`` timed calls, whose launch counts through the graph's
    replays must be the eager step's, one profiled call
    (``check_route``), the peak and reserved memory. Then ``steps`` more
    captured calls, each
    against one eager step of a second model and optimizer given the
    captured run's state just before it (parameters, masters, moments,
    step count, the scheduler's state): the same loss, the moments
    equal, the masters within ``STATIC_MASTER_ULPS`` of their operands
    (``_master_share``), each parameter its master rounded once. Two
    free-running trajectories are not compared element by element:
    Adam's step is about ``lr * sign(g)``, so a one-ulp difference in one
    step moves entries near zero by up to ``2 lr`` in the next. Then the eager model's step timed and profiled the same
    way. ``jit.fallbacks`` must stay 0. Returns the numbers."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import observability as obs

    def trainer(mode):
        model = make_model()
        opt, sched = make_opt(model)

        def step(*xs):
            loss = loss_of(model, *xs)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        fn = jit.to_static(step, full_graph=True) if mode == "captured" \
            else step

        def call():
            out = fn(*batch)
            if sched is not None:
                sched.step()
            return out
        return model, opt, sched, fn, call

    def timed(mode, call):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        counts = read_counts()
        for key in counts:
            check(counts[key] == want.get(key, 0) * steps,
                  f"{label} ({mode}): {key} launches {counts[key]} != "
                  f"{want.get(key, 0)} x {steps}")
        busy, per_kernel = recorded(
            lambda: profile_kernels(torch, call, 1, step_ms,
                                    f"{label} step, {mode}"),
            _per_kernel, lambda out: check_route(out[1],
                                                 f"{label} step, {mode}"),
            f"{label} step, {mode}")
        return dict(step_ms=step_ms, busy_share=None if busy is None
                    else busy / step_ms, launches=counts)

    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cm, co, csched, cfn, ccall = trainer("captured")
    t0 = time.perf_counter()
    first = [float(ccall()) for _ in range(steps)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    entries = list(cfn._cache.values())
    check(len(entries) == 1 and entries[0].graphed.captured,
          f"{label}: to_static made {len(entries)} entries, or did not "
          f"capture")
    out["captured"] = timed("captured", ccall)
    out["captured"].update(
        losses=first, first_steps_s=first_s,
        capture_s=entries[0].graphed.capture_seconds,
        peak_bytes=torch.cuda.max_memory_allocated(dev),
        reserved_bytes=torch.cuda.max_memory_reserved(dev))
    log(f"  {label}, captured: losses {[round(x, 5) for x in first]} "
        f"({first_s:.2f} s for the first {steps}, the warm-up step "
        f"and capture {entries[0].graphed.capture_seconds or 0:.2f} s of "
        f"them), "
        f"then {out['captured']['step_ms']:.2f} ms a step; peak memory "
        f"{out['captured']['peak_bytes'] / 2**30:.2f} GiB allocated, "
        f"{out['captured']['reserved_bytes'] / 2**30:.2f} GiB reserved")

    em, eo, es, _, ecall = trainer("eager")
    eo._ensure_accumulators()
    cps, eps_ = list(cm.parameters()), list(em.parameters())
    worst = dict(loss=0.0, master_share=0.0, param_abs=0.0, params_apart=0,
                 rounded_once=True, moments_equal=True, buffers_equal=True)
    with torch.no_grad():
        for _ in range(steps):
            for pc, pe in zip(cps, eps_):
                pe.copy_(pc)
                eo._master_weights[id(pe)].copy_(co._master_weights[id(pc)])
                for name in co._accum_names:
                    eo._accumulators[name][id(pe)].copy_(
                        co._accumulators[name][id(pc)])
            for bc, be in zip(cm.buffers(), em.buffers()):
                be.copy_(bc)
            eo._step_count = co._step_count
            for gc, ge in zip(generators(cm), generators(em)):
                ge.set_state(gc.get_state())
            if es is not None:
                es.set_state_dict(csched.state_dict())
            old = [co._master_weights[id(pc)].clone() for pc in cps]
            with torch.enable_grad():
                le, lc = float(ecall()), float(ccall())
            worst["loss"] = max(worst["loss"], abs(le - lc))
            for pc, pe, mo in zip(cps, eps_, old):
                mc, me = co._master_weights[id(pc)], eo._master_weights[id(pe)]
                worst["master_share"] = max(worst["master_share"],
                                            _master_share(mc, me, mo))
                worst["rounded_once"] &= bool(
                    torch.equal(pc, mc.to(pc.dtype))
                    and torch.equal(pe, me.to(pe.dtype)))
                worst["param_abs"] = max(worst["param_abs"], float(
                    (pc.float() - pe.float()).abs().max()))
                worst["params_apart"] += int((pc != pe).sum())
                worst["moments_equal"] &= all(
                    torch.equal(co._accumulators[n][id(pc)],
                                eo._accumulators[n][id(pe)])
                    for n in co._accum_names)
            worst["buffers_equal"] &= all(
                torch.equal(bc, be)
                for bc, be in zip(cm.buffers(), em.buffers()))
            del old
    fallbacks = obs.registry.get("jit.fallbacks").total()
    n_params = sum(p.numel() for p in cps)
    log(f"  {label}: {steps} captured steps each against an eager "
        f"step from the same state: loss diff {worst['loss']:.3g} (want 0), "
        f"moments equal {worst['moments_equal']}, buffers equal "
        f"{worst['buffers_equal']}, masters at "
        f"{worst['master_share']:.3g} of {STATIC_MASTER_ULPS} fp32 ulps of "
        f"their operands (tol 1), each bf16 parameter its master rounded "
        f"once {worst['rounded_once']}; {worst['params_apart']} of "
        f"{steps} x {n_params} bf16 entries apart, at most "
        f"{worst['param_abs']:.3g}; jit.fallbacks {fallbacks}")
    check(worst["loss"] == 0.0 and worst["moments_equal"]
          and worst["buffers_equal"],
          f"{label}: captured and eager steps from one state differ: {worst}")
    check(worst["master_share"] <= 1.0 and worst["rounded_once"],
          f"{label}: captured update off the eager one: {worst}")
    check(fallbacks == 0, f"{label}: jit.fallbacks {fallbacks}")
    del cm, co, csched, cfn, ccall, cps, eps_
    torch.cuda.empty_cache()
    out["eager"] = timed("eager", ecall)
    log(f"  {label}: step {out['eager']['step_ms']:.2f} ms eager, "
        f"{out['captured']['step_ms']:.2f} ms captured")
    del em, eo, es, ecall
    torch.cuda.empty_cache()
    out["same_state"] = worst
    return out


RECIPE_WARMUP, RECIPE_PEAK_LR, RECIPE_CLIP = 2, 3e-4, 1.0
RECIPE_FP16_STEPS = 3


def recipe_optimizer(named_params):
    """``bench_llama``'s AdamW with the usual LLM recipe: a linear warm-up
    from 0 over ``RECIPE_WARMUP`` steps into a cosine decay over
    ``TRAIN_STEPS``, a clip of the global gradient norm at
    ``RECIPE_CLIP``, and no decay on the RMSNorm weights, named through
    ``named_parameters()`` pairs. Returns (optimizer, scheduler); the
    caller steps the scheduler."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    sched = lr.LinearWarmup(
        lr.CosineAnnealingDecay(RECIPE_PEAK_LR, T_max=TRAIN_STEPS),
        warmup_steps=RECIPE_WARMUP, start_lr=0.0, end_lr=RECIPE_PEAK_LR)
    opt = AdamW(learning_rate=sched, parameters=named_params,
                multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(RECIPE_CLIP),
                apply_decay_param_fun=lambda n: not n.endswith("norm.weight"))
    return opt, sched


def train_batch(torch, config, dev):
    """``phase_train``'s batch: ids from a seeded generator, labels = ids
    rolled by one."""
    g = torch.Generator(device=dev).manual_seed(9)
    ids = torch.randint(0, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=g, device=dev)
    return ids, torch.roll(ids, -1, dims=1)


def phase_train_recipe(torch, dev, report):
    """The training step with the full recipe (``recipe_optimizer``) at
    ``phase_train``'s width, depth and batch (bf16, fp32 masters): one
    warm-up step, then ``TRAIN_STEPS`` timed steps, the scheduler stepped
    after each. Every step must launch rows 2-5 as ``[train]`` does
    (tensor-core flash, the vector RMSNorm kernels), the losses must be
    finite and fall, and the rate each step must be the scheduler's
    sequence. Measured: step ms, tokens/s, MFU, peak memory, busy share;
    the clip alone and the multi-tensor update alone (device ms and
    kernels). Then the fp16 O1 run: the same model in fp32 under
    ``amp.auto_cast(level="O1", dtype="float16")`` with
    ``GradScaler(init_loss_scaling=2**15)`` and ``[train]``'s
    ``AdamW(3e-4)``, ``RECIPE_FP16_STEPS`` steps:
    the fp16 tensor-core flash route, fp32 RMSNorm inputs, finite
    losses, the scale each step. Then the update on the card against the
    same update on the CPU (``update_card_vs_cpu``). The recipe step
    under ``jit.to_static(full_graph=True)`` runs after the bf16 part
    (``static_vs_eager``; the scheduler stepped outside the function)."""
    import dataclasses

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, lr

    config = LlamaConfig(**TRAIN_CONFIG, dtype="bfloat16")
    nl, hid = config.num_hidden_layers, config.hidden_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = LlamaForCausalLM(config, device=dev, seed=0)
    n_params = model.num_parameters()
    opt, sched = recipe_optimizer(model.named_parameters())
    ids, labels = train_batch(torch, config, dev)
    rates = []

    def step():
        loss, _ = model(ids, labels=labels)
        loss.backward()
        rates.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.detach()

    t0 = time.perf_counter()
    warm = float(step())
    log(f"  bf16 recipe: warm-up step {time.perf_counter() - t0:.2f} s, "
        f"loss {warm:.4f}")
    torch.cuda.synchronize()
    reset_counts()
    alloc0 = torch.cuda.memory_stats(dev)
    t0 = time.perf_counter()
    losses = [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated(dev)
    alloc = {k: torch.cuda.memory_stats(dev)[k] - alloc0[k]
             for k in ("num_alloc_retries", "num_device_alloc",
                       "num_device_free")}
    want_rates = []
    ref = lr.LinearWarmup(
        lr.CosineAnnealingDecay(RECIPE_PEAK_LR, T_max=TRAIN_STEPS),
        warmup_steps=RECIPE_WARMUP, start_lr=0.0, end_lr=RECIPE_PEAK_LR)
    for _ in range(TRAIN_STEPS + 1):
        want_rates.append(ref())
        ref.step()
    log(f"  {TRAIN_STEPS} steps: launches {counts}, losses "
        f"{[round(x, 4) for x in losses]}, rates {rates}")
    check(rates == want_rates, f"rates {rates} != the schedule {want_rates}")
    for key, n in train_launches(nl).items():
        check(counts[key] == n * TRAIN_STEPS,
              f"recipe: {key} launches {counts[key]} != {n} x {TRAIN_STEPS}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    record_launches(report, "train-recipe", counts)
    step_ms, tok_s, mfu = step_rates(dt, n_params, nl, hid)
    log(f"  recipe step: {step_ms:.2f} ms mean, {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} (bench.py's formula), peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated); the caching "
        f"allocator over the timed steps: {alloc}")
    busy, per_kernel = recorded(
        lambda: profile_kernels(torch, step, 1, step_ms,
                                "recipe step, kernels"),
        _per_kernel,
        lambda out: check_train_kernels(out[1], nl, "bf16 recipe step"),
        "bf16 recipe step")
    # the clip's scale on the card: each product in fp32, rounded once
    from paddle_tpu_torch.core.foreach import scale_in_fp32_

    g = torch.randn(1 << 20, generator=torch.Generator(device=dev)
                    .manual_seed(3), device=dev).bfloat16()
    factor = torch.tensor(0.123456789, device=dev)
    want = (g.float() * factor).bfloat16()
    got, naive = [g.clone()], [g.clone()]
    scale_in_fp32_(got, factor)
    torch._foreach_mul_(naive, factor)
    off = int((naive[0] != want).sum())
    log(f"  bf16 x fp32 scale: scale_in_fp32_ equal to the fp32 product "
        f"rounded once: {torch.equal(got[0], want)}; _foreach_mul_ by the "
        f"same 0-dim tensor differs at {off} of {g.numel()}")
    check(torch.equal(got[0], want), "scale_in_fp32_ is not the fp32 product")
    # the clip alone and the update alone, on one step's gradients
    loss, _ = model(ids, labels=labels)
    loss.backward()
    pairs = [(p, p.grad) for p in opt._parameter_list]
    grads = [g for _, g in pairs]
    norm = float(torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads, 2, dtype=torch.float32))))
    clip = opt._grad_clip
    clip_ms = device_ms(lambda: clip(pairs), iters=3, warmup=1)
    clip_launches = sum(kernel_counts(torch, lambda: clip(pairs), 1).values())
    opt._grad_clip = None
    update_ms = device_ms(opt.step, iters=3, warmup=1)
    update_launches = sum(kernel_counts(torch, opt.step, 1).values())
    opt._grad_clip = clip
    opt.clear_grad()
    log(f"  global gradient norm {norm:.4g} (clip {RECIPE_CLIP}); clip alone "
        f"{clip_ms:.3f} ms of device time in {clip_launches} kernels; "
        f"update alone {update_ms:.2f} ms in {update_launches} kernels")
    report["train_recipe"] = dict(
        step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu, peak_bytes=peak,
        losses=losses, rates=rates[:TRAIN_STEPS + 1],   # the profiled
        # steps above appended more
        busy_share=None if busy is None else busy / step_ms,
        clip_ms=clip_ms, clip_launches=clip_launches, update_ms=update_ms,
        update_launches=update_launches, grad_norm=norm)
    del model, opt, pairs, grads
    torch.cuda.empty_cache()
    report["train_recipe"]["to_static"] = static_vs_eager(
        torch, dev, lambda: LlamaForCausalLM(config, device=dev, seed=0),
        (ids, labels), _llama_loss,
        lambda m: recipe_optimizer(m.named_parameters()), "bf16 recipe",
        train_launches(nl), lambda pk, lb: check_train_kernels(pk, nl, lb))

    # fp16 O1: fp32 parameters, autocast to fp16, dynamic loss scaling
    torch.cuda.reset_peak_memory_stats(dev)
    model = LlamaForCausalLM(dataclasses.replace(config, dtype="float32"),
                             device=dev, seed=0)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    norm_inputs = set()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: norm_inputs.add(a[0].dtype))
        for n, m in model.named_modules() if n.endswith("norm")]

    def o1_step():
        with amp.auto_cast(level="O1", dtype="float16"):
            loss, _ = model(ids, labels=labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        return loss.detach()

    o1 = [(float(o1_step()), scaler._scale)]          # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(RECIPE_FP16_STEPS):
        o1.append((float(o1_step()), scaler._scale))
    torch.cuda.synchronize()
    o1_ms = (time.perf_counter() - t0) / RECIPE_FP16_STEPS * 1e3
    counts = read_counts()
    log(f"  fp16 O1, a warm-up and {RECIPE_FP16_STEPS} timed steps: "
        f"{o1_ms:.2f} ms mean, (loss, scale) {o1}, launches "
        f"{counts}, RMSNorm inputs {sorted(map(str, norm_inputs))}, peak "
        f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for key, n in train_launches(nl).items():
        check(counts[key] == n * RECIPE_FP16_STEPS,
              f"fp16 O1: {key} launches {counts[key]} != {n} x "
              f"{RECIPE_FP16_STEPS}")
    check(all(math.isfinite(x) for x, _ in o1), f"fp16 O1 losses {o1}")
    check(norm_inputs == {torch.float32},
          f"fp16 O1: RMSNorm received {norm_inputs}, not the fp32 stream")
    o1_busy, per_kernel = recorded(
        lambda: profile_kernels(torch, o1_step, 1, o1_ms,
                                "fp16 O1 step, kernels"),
        _per_kernel,
        lambda out: check_flash_route(out[1], {"fwd": nl, "dq": nl,
                                               "dkv": nl}, "fp16 O1 step"),
        "fp16 O1 step")
    for h in hooks:
        h.remove()
    # an inf, then a NaN, in one gradient: the scaler skips the update
    # and halves the scale
    for bad in (math.inf, math.nan):
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        params = list(model.parameters())
        params[3].grad.view(-1)[5] = bad
        before, scale = params[3].detach()[:4].clone(), scaler._scale
        scaler.step(opt)
        opt.clear_grad()
        check(scaler._found_inf and scaler._scale == scale / 2
              and torch.equal(params[3].detach()[:4], before),
              f"GradScaler did not skip a step with a gradient of {bad}")
    log(f"  GradScaler skipped the steps with an inf and a NaN gradient; "
        f"scale {scaler._scale}")
    report["train_recipe"].update(
        fp16_o1_step_ms=o1_ms, fp16_o1_losses=[x for x, _ in o1],
        fp16_o1_scales=[s for _, s in o1],
        fp16_o1_busy_share=None if o1_busy is None else o1_busy / o1_ms)
    del model, opt
    torch.cuda.empty_cache()
    report["train_recipe"]["card_vs_cpu"] = {
        dtype: update_card_vs_cpu(torch, dev, dataclasses.replace(
            config, num_hidden_layers=2, dtype=dtype), ids, labels)
        for dtype in ("float32", "bfloat16")}


def update_card_vs_cpu(torch, dev, config, ids, labels):
    """One recipe step of a 2-layer model at full width on the card, then
    the next step's update twice from the same state: on the card, and
    on the CPU from copies of the parameters, gradients and optimizer
    state (``state_dict``: masters, moments and the scheduler). This
    holds the card's multi-tensor update, clip included, against the CPU
    path the CPU tests hold against the reference.

    fp32 parameters: each clip takes its own global norm, and every
    parameter and moment must agree within 1e-6. bf16 parameters with
    fp32 masters (the main path's configuration): the card's global
    norm (fp32) and the CPU's (fp64, rounded) may differ in their last
    bits (an fp64 norm is printed beside them), which moves some clipped
    bf16 gradients to neighbouring values, so both clips take the
    card's scale. Then
    masters and moments must agree within 1e-6, each bf16 parameter
    must be its master rounded once on both devices (as
    test_torch_optimizer.py holds them), and card and CPU parameters
    must agree within one bf16 ulp (2 ** -7 relative) plus the masters'
    1e-6: near zero, masters an fp32 rounding apart are many bf16 ulps
    of the value apart. A third update, on the CPU with its own scale,
    is reported and not checked. Returns the readings."""
    import copy

    from paddle_tpu_torch.models import LlamaForCausalLM

    model = LlamaForCausalLM(config, device=dev, seed=0)
    opt, sched = recipe_optimizer(model.named_parameters())
    ids, labels = ids[:2, :512], labels[:2, :512]
    model(ids, labels=labels)[0].backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    model(ids, labels=labels)[0].backward()         # the compared step's
    named = dict(model.named_parameters())
    low = next(iter(named.values())).dtype != torch.float32
    state = {k: v.detach().cpu().clone() if torch.is_tensor(v)
             else copy.deepcopy(v) for k, v in opt.state_dict().items()}
    before = {n: (p.detach().cpu().clone(), p.grad.detach().cpu().clone())
              for n, p in named.items()}
    clip = opt._grad_clip
    card_scale = clip._scale([p.grad for p in named.values()],
                             list(named.values()))

    def cpu_update(scale):
        cpu = {}
        for n, (value, grad) in before.items():
            cpu[n] = torch.nn.Parameter(value.clone())
            cpu[n].grad = grad.clone()
        cpu_opt = recipe_optimizer(list(cpu.items()))[0]
        cpu_opt.set_state_dict(state)
        own = cpu_opt._grad_clip._scale([p.grad for p in cpu.values()],
                                        list(cpu.values()))
        if scale is not None:
            cpu_opt._grad_clip._scale = lambda *a: scale
        cpu_opt.step()
        return cpu, cpu_opt, own

    def compare(cpu, cpu_opt):
        """The readings of one CPU update against the card's: the worst
        |card - cpu| over fp32 state and fp32 parameters (and where); for
        bf16 parameters, whether each equals its master rounded once on
        both devices, the worst |card - cpu| over one bf16 ulp plus the
        masters' 1e-6 (``bound``), the entries apart, the worst share of
        one ulp alone and the largest |value| more than one ulp apart."""
        r = dict(worst=0.0, where=None)
        cpu_state = cpu_opt.state_dict()
        for key, t in opt.state_dict().items():
            if torch.is_tensor(t):
                err = max_err(t.cpu(), cpu_state[key])
                if err > r["worst"]:
                    r.update(worst=err, where=key)
        if low:
            r.update(rounded=True, bound=0.0, off=0, ulps=0.0, beyond=0.0)
        for n, p in named.items():
            a, b = p.detach().cpu().float(), cpu[n].detach().float()
            if not low:
                err = max_err(a, b)
                if err > r["worst"]:
                    r.update(worst=err, where=n)
                continue
            r["rounded"] &= bool(
                torch.equal(p, opt._master_weights[id(p)].bfloat16())
                and torch.equal(cpu[n], cpu_opt._master_weights[
                    id(cpu[n])].bfloat16()))
            diff = (a - b).abs()
            apart = diff > 0
            if not apart.any():
                continue
            ulp = 2 ** -7 * torch.maximum(a.abs(), b.abs())[apart]
            d = diff[apart]
            r["off"] += int(apart.sum())
            r["bound"] = max(r["bound"], float((d / (ulp + 1e-6)).max()))
            r["ulps"] = max(r["ulps"], float((d / ulp).max()))
            far = d > ulp
            if far.any():
                r["beyond"] = max(r["beyond"], float(
                    (ulp[far] * 2 ** 7).max()))
        return r

    def bf16_line(r):
        return (f"bf16 parameters each its master rounded once "
                f"{r['rounded']}; {r['off']} entries apart, worst "
                f"{r['bound']:.3g} of one bf16 ulp + 1e-6 (tol 1), "
                f"{r['ulps']:.3g} of one ulp alone (entries beyond one ulp "
                f"lie at |value| <= {r['beyond']:.3g})")

    if low:
        clip._scale = lambda *a: card_scale
    opt.step()
    torch.cuda.synchronize()
    if low:
        del clip._scale                 # the class's own method again
    cpu, cpu_opt, cpu_scale = cpu_update(card_scale.cpu() if low else None)
    r = compare(cpu, cpu_opt)
    kind = "bf16 + fp32 masters" if low else "fp32"
    n_params = sum(p.numel() for p in named.values())
    n_state = sum(torch.is_tensor(t) for t in state.values())
    norm64 = torch.linalg.vector_norm(torch.stack(
        [g.double().norm() for _, g in before.values()]))
    scale64 = RECIPE_CLIP / max(float(norm64), RECIPE_CLIP)
    scales = (f"clip scale card {float(card_scale)!r}, CPU "
              f"{float(cpu_scale)!r}, fp64 {scale64!r}"
              + (", both use the card's" if low else ""))
    log(f"  update card vs CPU, 2 layers {kind}, {n_params / 1e6:.1f}M "
        f"parameters ({n_state} state tensors; {scales}): worst "
        f"{r['worst']:.3g} at {r['where']} (tol 1e-6)"
        + (f"; {bf16_line(r)}" if low else ""))
    check(r["worst"] <= 1e-6, f"card vs CPU update ({kind}): {r['where']} "
                              f"off by {r['worst']}")
    if low:
        check(r["rounded"], "card vs CPU update: a bf16 parameter is not "
                            "its master rounded once")
        check(r["bound"] <= 1.0, f"card vs CPU update ({kind}): bf16 "
                                 f"parameters {r['bound']} of one ulp + 1e-6 "
                                 f"apart")
    out = dict(card_scale=float(card_scale), cpu_scale=float(cpu_scale),
               fp64_scale=scale64, **r)
    if low:
        del cpu, cpu_opt
        cpu, cpu_opt, _ = cpu_update(None)
        r = compare(cpu, cpu_opt)
        log(f"    (not checked) the CPU with its own clip scale: worst "
            f"{r['worst']:.3g} at {r['where']}; {bf16_line(r)}")
        out["own_scale"] = r
    del model, opt, named, before, cpu, cpu_opt
    torch.cuda.empty_cache()
    return out


def phase_varlen_path(torch, dev, report):
    """The packed-attention path a user takes: ``flash_attn_unpadded`` at
    the full-width case (packed T 8192 from ``VARLEN_LENS``, 16 heads of
    128, bf16, causal) on leaf tensors, then ``.backward()``; and the same
    values through ``flash_attn_varlen_qkvpacked`` from one [T, 3, H, D]
    tensor, then ``.backward()``. Each call must launch the forward, dq
    and dk/dv kernels exactly once and no other kernel. The two calls
    read the same values, so their outputs and gradients must be equal;
    the output must be finite and within ``tolerance(bfloat16, 1e-4)`` of
    the plain version on the same inputs. Then a forward + backward under
    the profiler must show each tensor-core kernel (``vflash_fwd_tc_kernel``,
    ``vflash_bwd_dq_tc_kernel``, ``vflash_bwd_dkv_tc_kernel``) once per
    call and no CUDA-core or wide varlen kernel; its kernel time is the
    path's forward + backward ms."""
    import paddle_tpu_torch.nn.functional as TF
    from paddle_tpu_torch.ops.cuda import flash_attention_varlen as fv

    g = torch.Generator(device=dev).manual_seed(12)
    t_tok, h, d = sum(VARLEN_LENS), VARLEN_HEADS, VARLEN_DIM
    cu = _cu(torch, VARLEN_LENS, dev)
    qkv = torch.randn(t_tok, 3, h, d, generator=g, device=dev).to(
        torch.bfloat16)
    do = torch.randn(t_tok, h, d, generator=g, device=dev).to(torch.bfloat16)
    leaves = [qkv[:, i].contiguous().requires_grad_() for i in range(3)]
    qkv.requires_grad_()
    mx = max(VARLEN_LENS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out, sm = TF.flash_attn_unpadded(*leaves, cu, cu, mx, mx, d ** -0.5,
                                     causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    pout, _ = TF.flash_attn_varlen_qkvpacked(qkv, cu, cu, mx, mx,
                                             scale=d ** -0.5, causal=True)
    pout.backward(do)
    torch.cuda.synchronize()
    counts2 = read_counts()
    log(f"  flash_attn_unpadded [{t_tok}, {h}, {d}] bf16 causal, forward + "
        f"backward: {wall_ms:.2f} ms wall (first call), launches {counts}; "
        f"with flash_attn_varlen_qkvpacked too: {counts2}")
    varlen_keys = ("vflash", "vflash_bwd", "vflash_bwd_dkv")
    for key, n in counts2.items():
        want = 2 if key in varlen_keys else 0
        check(n == want and counts[key] == want // 2,
              f"{key} launches {counts[key]}, {n} != {want // 2}, {want}")
    check(sm is None and tuple(out.shape) == (t_tok, h, d),
          f"flash_attn_unpadded returned {tuple(out.shape)}, {sm!r}")
    check(bool(torch.isfinite(out).all()), "varlen output not finite")
    check(all(bool(torch.isfinite(t.grad).all()) for t in leaves),
          "varlen gradients not finite")
    same = bool(torch.equal(out, pout)) and all(
        bool(torch.equal(t.grad, qkv.grad[:, i]))
        for i, t in enumerate(leaves))
    log(f"  qkvpacked output and gradients equal the unpadded call's: "
        f"{same}")
    check(same, "flash_attn_varlen_qkvpacked differs from "
                "flash_attn_unpadded on the same values")
    ref, _ = fv._vflash_fwd_reference(*(t.detach() for t in leaves), cu, cu,
                                      causal=True, scale=d ** -0.5)
    atol, rtol = tolerance(torch.bfloat16, 1e-4)
    err, share = close_err(out.detach(), ref, atol, rtol)
    log(f"  output vs the plain version: max_abs_err={err:.3g}, {share:.3g} "
        f"of the tolerance")
    check(share <= 1.0, f"varlen path output differs by {err}")
    record_launches(report, "varlen", counts2)

    # which kernels the path ran, by name: each tensor-core kernel once per
    # call, never a CUDA-core one
    def fwd_bwd():
        o, _ = TF.flash_attn_unpadded(*leaves, cu, cu, mx, mx, d ** -0.5,
                                      causal=True)
        o.backward(do)

    fwd_bwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd_bwd()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    names = [n for pair in VARLEN_KERNELS.values() for n in pair]

    def varlen_route(out):
        got = named_launches(out[1], names)
        log(f"  varlen kernels per call: {got}")
        for tc, cc in VARLEN_KERNELS.values():
            check(got[tc] == 1 and got[cc] == 0,
                  f"varlen path: {tc} launched {got[tc]} times per call, "
                  f"want 1; the CUDA-core {cc} {got[cc]}, want 0")

    busy_ms, per_kernel = recorded(
        lambda: profile_kernels(torch, fwd_bwd, 2, wall_ms,
                                "flash_attn_unpadded forward + backward"),
        _per_kernel, varlen_route, "varlen path")
    wide = named_launches(per_kernel, list(VARLEN_WIDE_KERNELS.values()))
    check(not any(wide.values()), f"varlen path at D {d} ran a wide kernel: "
                                  f"{wide}")
    report["vflash"]["path_fwd_bwd_kernel_ms"] = busy_ms
    del qkv, do, leaves, out, pout, ref
    torch.cuda.empty_cache()


#: conv_calibration's shapes the calibrate path measures, batch and iters
CALIBRATE_SHAPES, CALIBRATE_BATCH, CALIBRATE_ITERS = (2, 17), 64, 5


def phase_calibrate(torch, dev, report):
    """``paddle_tpu_torch.tools.conv_calibration.measure_shape`` at
    ResNet-50 shapes 2 and 17, batch 64, ``CALIBRATE_ITERS`` timed calls
    each after its 3 warm-up calls: the tiled kernel must launch exactly
    that often and every time must be a positive finite number. Prints
    each shape's JSON line as ``--shape i`` does. Then one more call per
    shape under the profiler, which must show the tensor-core tiled
    kernel 4 times, its reduce pass 4 times where the shape splits K
    (``TILED_KERNELS``), and no other tiled kernel."""
    from paddle_tpu_torch.ops.cuda import _build, tiled_mm as tm
    from paddle_tpu_torch.tools import conv_calibration as cc

    reset_counts()
    for i in CALIBRATE_SHAPES:
        r = cc.shape_record(i, CALIBRATE_BATCH, CALIBRATE_ITERS)
        times = [r[k] for k in ("t_conv", "t_gemm", "t_pallas")]
        log(f"  shape {i}: {json.dumps(r)}")
        log("    TFLOP/s: conv {:.1f}, gemm {:.1f}, tiled kernel {:.1f}".format(
            *(r["flops"] / t / 1e12 for t in times)))
        check(all(math.isfinite(t) and t > 0 for t in times),
              f"calibration times {r}")
    torch.cuda.synchronize()
    counts = read_counts()
    want = len(CALIBRATE_SHAPES) * (3 + CALIBRATE_ITERS)
    log(f"  launches {counts}")
    for key, n in counts.items():
        check(n == (want if key == "tiled_mm" else 0),
              f"{key} launches {n} on the calibrate path")
    record_launches(report, "calibrate", counts)
    # which tiled kernels the path ran, by name: only the tensor-core one,
    # and its reduce pass where the shape splits K (3 warm-up + 1 timed
    # call per shape)
    for i in CALIBRATE_SHAPES:
        d = cc.conv_dims(*cc.RESNET50_CONVS[i][:6], CALIBRATE_BATCH)
        split = tm._tile_config(d["m"], d["kp"], d["np"],
                                _build.sm_count(dev)) > 1
        t0 = time.perf_counter()
        cc.shape_record(i, CALIBRATE_BATCH, 1)
        wall_ms = (time.perf_counter() - t0) * 1e3
        want = {TILED_KERNELS[0]: 4, TILED_KERNELS[1]: 4 if split else 0}

        def tiled_route(out):
            tiled = {k: c for k, c in out[1].items() if "tiled_mm" in k}
            log(f"  shape {i} tiled kernels: {tiled}")
            check(named_launches(tiled, TILED_KERNELS) == want
                  and sum(tiled.values()) == sum(want.values()),
                  f"calibrate shape {i}: tiled kernels {tiled}, want {want} "
                  f"and no other")

        recorded(lambda: profile_kernels(
            torch, lambda: cc.shape_record(i, CALIBRATE_BATCH, 1), 1,
            wall_ms, f"calibrate shape {i}, one timed call"),
            _per_kernel, tiled_route, f"calibrate shape {i}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# [gpt]: the GPT-2 family at GPTConfig.gpt2_medium's full width and depth
# ---------------------------------------------------------------------------
#: the [gpt] training batch and steps; the attention shape they give rows 2
#: and 4 is [GPT_BATCH, 16 heads, GPT_SEQ, 64]
GPT_BATCH, GPT_SEQ, GPT_STEPS = 8, 1024, 5
#: GPT-2's dropout rates (attention and hidden), the train phase's
GPT_DROPOUT = 0.1


def gpt_model(torch, dev, seed=0, bf16=True, **kw):
    """``GPTConfig.gpt2_medium()`` (``kw`` replaces fields) on the card,
    cast to bf16 unless ``bf16`` is False (the reference has no dtype
    field)."""
    import dataclasses

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    config = dataclasses.replace(GPTConfig.gpt2_medium(), **kw)
    model = GPTForCausalLM(config, device=dev, seed=seed)
    return model.to(torch.bfloat16) if bf16 else model


@contextlib.contextmanager
def plain_flash():
    """The dense flash entry points on their plain versions (the same
    counter-hash dropout mask) for the block: the kernels' names in
    ``ops/cuda/flash_attention`` are swapped."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    saved = fa._flash_fwd_kernel, fa._flash_bwd_kernel
    fa._flash_fwd_kernel, fa._flash_bwd_kernel = (fa._flash_fwd_reference,
                                                  fa._flash_bwd_reference)
    try:
        yield
    finally:
        fa._flash_fwd_kernel, fa._flash_bwd_kernel = saved


def flash_at_shape(torch, dev, report, key, b, h, s, d, causal,
                   dropout, bias=None, sk=None):
    """Rows 2 and 4 at a model's training shape, q [b, h, s, d] and k, v
    [b, h, sk, d] (``sk`` = ``s`` unless given: a cross-attention's
    context), in bf16, at dropout rate ``dropout`` with a fixed seed,
    causal or not, with the key bias ``bias`` ([b, sk] fp32, the padding
    mask's ``-1e4`` on padded keys) or none. With dropout the forward's
    keep mask, read back through one-hot values (q = 0 gives every
    visible key the same p, so with v one-hot on the d keys of block c,
    out[i, j] > 0 exactly where key d c + j is visible and kept; one call
    a block), must equal the plain version's; out within
    ``tolerance(bf16, 1e-4)`` and lse within 1e-4 on random inputs, and
    dq, dk, dv within ``tolerance(bf16, 1e-4)``. Then each kernel timed
    beside its plain version, ``F.scaled_dot_product_attention`` on the
    same inputs at the same dropout rate (the bias as its additive mask;
    its backward on a kept graph) and its bound: the work of the visible
    (query, key) pairs, a padded key's none. Kept under
    ``report[...][key]``."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    sk = s if sk is None else sk
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(12)
    seed = torch.tensor([2024], dtype=torch.int32, device=dev)
    st = dict(causal=causal, scale=d ** -0.5, dropout_rate=dropout)
    what = (f"[{b},{h},{s},{d}]" + (f" x {sk} keys" if sk != s else "")
            + f" bf16, {'causal' if causal else 'not causal'}"
            f", dropout {dropout}"
            + (", key bias" if bias is not None else ""))

    def rnd(n=s):
        return torch.randn(b, h, n, d, generator=g, device=dev).to(bf16)

    # the visible (query, key) pairs: below the diagonal, or every
    # unpadded key of the row
    keys = b * sk if bias is None else int((bias > -1.0).sum())
    pairs = (b * h * s * (s + 1) // 2 if causal else h * s * keys)
    same, n_kept = True, pairs
    if dropout > 0.0:
        q0, k = torch.zeros(b, h, s, d, device=dev, dtype=bf16), rnd()
        eye = torch.eye(d, device=dev, dtype=bf16)
        n_kept = 0
        for c in range(s // d):
            v = torch.zeros(b, h, s, d, device=dev, dtype=bf16)
            v[:, :, c * d:(c + 1) * d] = eye
            kept = fa._flash_fwd_kernel(q0, k, v, seed, bias, **st)[0] > 0
            rkept = fa._flash_fwd_reference(q0, k, v, seed, bias,
                                            **st)[0] > 0
            same = same and torch.equal(kept, rkept)
            n_kept += int(kept.sum())
        log(f"  flash dropout keep mask at {what}: kernel keeps {n_kept} of "
            f"{pairs} visible (q, k) pairs ({n_kept / pairs:.4f}), identical "
            f"to the plain version's: {same}")
        check(same, f"flash keep mask at {what} differs from the plain "
                    f"version's")
        del q0, k, v, kept, rkept
    q, k, v, do = rnd(), rnd(sk), rnd(sk), rnd()
    out, lse = fa._flash_fwd_kernel(q, k, v, seed, bias, **st)
    rout, rlse = fa._flash_fwd_reference(q, k, v, seed, bias, **st)
    tol = tolerance(bf16, 1e-4)
    e_out, share = close_err(out, rout, *tol)
    e_lse = max_err(lse, rlse)
    got = fa._flash_bwd_kernel(q, k, v, out, lse, do, seed, bias, **st)
    ref = fa._flash_bwd_reference(q, k, v, out, lse, do, seed, bias, **st)
    torch.cuda.synchronize()
    res = [close_err(a, r, *tol) for a, r in zip(got, ref)]
    log(f"  flash at {what}: out err {e_out:.3g} ({share:.3g} of the "
        f"tolerance), lse err {e_lse:.3g}; "
        + ", ".join(f"{n} err {e:.3g} ({sh:.3g} of the tolerance)"
                    for n, (e, sh) in zip(("dq", "dk", "dv"), res)))
    check(share <= 1.0 and e_lse <= 1e-4, f"flash forward at {what}")
    check(all(sh <= 1.0 for _, sh in res), f"flash backward at {what}")
    del rout, rlse, got, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None if bias is None else bias[:, None, None, :].to(bf16)
    extra = 0 if bias is None else nbytes(bias)
    fwd = timings(
        lambda: fa._flash_fwd_kernel(q, k, v, seed, bias, **st),
        lambda: fa._flash_fwd_reference(q, k, v, seed, bias, **st),
        lambda: sdpa(q, k, v, attn_mask=mask, is_causal=causal,
                     dropout_p=dropout),
        nbytes(q, k, v, q) + b * h * s * 4 + extra, 4 * pairs * d,
        "bfloat16", plain_iters=5)
    show(f"flash {what}", fwd)
    bwd = timings(
        lambda: fa._flash_bwd_kernel(q, k, v, out, lse, do, seed, bias, **st),
        lambda: fa._flash_bwd_reference(q, k, v, out, lse, do, seed, bias,
                                        **st),
        library_grad(torch, lambda a, b_, c: sdpa(
            a, b_, c, attn_mask=mask, is_causal=causal, dropout_p=dropout),
            (q, k, v), do),
        nbytes(q, k, v, out, do, q, k, v) + lse.numel() * 4 + extra,
        5 * 2 * pairs * d, "bfloat16", plain_iters=5)
    show(f"flash_bwd {what}", bwd)
    shape = dict(shape=[b, h, s, d], dtype="bfloat16", causal=causal,
                 dropout=dropout, key_bias=bias is not None)
    if sk != s:
        shape["keys"] = sk
    report["flash"][key] = dict(
        max_abs_err=e_out, share=share, lse_err=e_lse, keep_mask_equal=same,
        keep_rate=n_kept / pairs, **shape, **fwd)
    report["flash_bwd"][key] = dict(
        max_abs_err=max(e for e, _ in res), **shape, **bwd)
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()


class TrainSpec:
    """A model's training step for ``phase_model_train``: ``model(torch,
    dev, bf16=True, layers=None)`` at full width (``layers`` cuts the
    depth, fp32 where ``bf16`` is False), its batch, the fp32 check's
    batch (``small``: two rows of 512 tokens), its loss and optimizer,
    the launches of one step by counter (``launches``; every other
    counter 0), the kernels a profiled bf16 step must run by name
    (``check_route``), its rates, the context that puts the kernels'
    plain versions in place (``plain``), the model's explicit generators
    (restored before each run of the fp32 check, copied from the
    captured model to the eager one by ``static_vs_eager``) and
    ``extra``, a model's own checks after the timed steps."""

    tag = label = ""
    steps = 5
    to_static = False
    #: parameter-name endings whose gradient is 0 in exact arithmetic:
    #: the fp32 check holds them below 1e-6 of the largest gradient
    #: instead of to their own (rounding-noise) scale
    zero_grads = ()

    def depth(self, model):
        """The count ``launches`` and ``check_route`` take: the model's
        layers."""
        return model.config.num_hidden_layers

    def loss_fell(self, warm, losses):
        """Whether the timed steps' losses show training: the last below
        the first."""
        return losses[-1] < losses[0]

    def launches(self, nl):
        return dict(flash=nl, flash_bwd=nl)

    def check_route(self, per_kernel, nl, label):
        """The tensor-core flash kernels once a layer, no RMSNorm."""
        check_flash_route(per_kernel, {"fwd": nl, "dq": nl, "dkv": nl},
                          label)
        rms = {k: c for k, c in per_kernel.items() if "rms_norm" in k}
        check(not rms, f"{label} ran RMSNorm kernels {rms}")

    def plain(self):
        return plain_flash()

    def rates(self, dt, model, batch):
        """bench.py's formula (step_rates) over the batch's tokens."""
        cfg = model.config
        step_ms, tok_s, mfu = step_rates(
            dt, model.num_parameters(), cfg.num_hidden_layers,
            cfg.hidden_size, *batch[0].shape, self.steps)
        return dict(step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu)

    def extra(self, torch, dev, model, opt, batch, out):
        pass

    def fp32_check(self, torch, dev, batch):
        """The fp32 check at the end of ``phase_model_train``."""
        return fp32_kernels_vs_plain(torch, dev, self, batch)


def _ids_and_labels(torch, cfg, dev, rows, seq):
    """Ids from a seeded generator on the card, labels = ids rolled by
    one."""
    g = torch.Generator(device=dev).manual_seed(9)
    ids = torch.randint(0, cfg.vocab_size, (rows, seq), generator=g,
                        device=dev)
    return ids, torch.roll(ids, -1, dims=1)


def _small_lm(batch):
    """Two rows of 512 tokens of an (ids, labels) batch, each row's last
    label ignored."""
    ids, labels = batch
    labels2 = labels[:2, :512].clone()
    labels2[:, -1] = -100
    return ids[:2, :512], labels2


class GptTrain(TrainSpec):
    """GPT-2 medium (24 layers, hidden 1024, 16 heads of 64, vocab 50304,
    tied head, about 355M parameters), batch 8 x 1024, dropout 0.1 in
    attention (inside the flash kernels) and hidden states,
    ``AdamW(3e-4, multi_precision=True)`` with weight decay 0.01."""

    tag, label, steps = "gpt", "GPT", GPT_STEPS

    def model(self, torch, dev, bf16=True, layers=None):
        kw = {"num_hidden_layers": layers} if layers else {}
        return gpt_model(torch, dev, bf16=bf16, **kw)

    def batch(self, torch, cfg, dev):
        return _ids_and_labels(torch, cfg, dev, GPT_BATCH, GPT_SEQ)

    small = staticmethod(_small_lm)

    def loss(self, model, ids, labels):
        return model(ids, labels=labels)[0]

    def opt(self, model):
        from paddle_tpu_torch.optimizer import AdamW

        return AdamW(learning_rate=3e-4, parameters=model.parameters(),
                     multi_precision=True, weight_decay=0.01)

    def generators(self, model):
        return [model.dropout_generator]


#: bench.py:bench_bert's batch (bench.py:780): 36 sequences of 512 tokens
BERT_BATCH, BERT_SEQ = 36, 512
#: BERT-base's dropout rates (attention and hidden)
BERT_DROPOUT = 0.1


def bert_padding(torch, dev, rows, seq, seed):
    """A [rows, seq] int64 padding mask (1 keep, 0 pad): each row pads its
    last n keys, n drawn uniformly from 0 to seq / 4 (the first row 0,
    the second seq / 4), from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pads = torch.randint(0, seq // 4 + 1, (rows,), generator=g, device=dev)
    pads[0], pads[min(1, rows - 1)] = 0, seq // 4
    return (torch.arange(seq, device=dev)[None, :]
            < (seq - pads)[:, None]).long()


class BertTrain(TrainSpec):
    """``bench.py:bench_bert``'s step: ``BertConfig.base()`` (12 layers,
    hidden 768, 12 heads of 64, vocab 30522, about 110M parameters) in
    bf16, MLM + NSP, batch 36 x 512 (token types 0 then 1, MLM labels on
    15% of positions, random NSP labels), dropout 0.1 in attention
    (inside the flash kernels, not causal) and hidden states,
    ``AdamW(1e-4, multi_precision=True)``. MFU is bench.py's formula
    (bench.py:822-825). The fp32 check runs a padded batch (the mask as
    the kernels' key bias)."""

    tag, label, to_static = "bert", "BERT", True
    # q . b_k shifts a row's logits by one constant, which softmax drops
    zero_grads = ("k_proj.bias",)

    def model(self, torch, dev, bf16=True, layers=None):
        import dataclasses

        from paddle_tpu_torch.models import BertConfig, BertForPretraining

        cfg = BertConfig.base()
        if layers:
            cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
        model = BertForPretraining(cfg, device=dev, seed=0)
        return model.to(torch.bfloat16) if bf16 else model

    def batch(self, torch, cfg, dev):
        g = torch.Generator(device=dev).manual_seed(9)
        shape = (BERT_BATCH, BERT_SEQ)
        ids = torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev)
        tt = (torch.arange(BERT_SEQ, device=dev) >= BERT_SEQ // 2).long(
            ).expand(shape).contiguous()
        mlm = torch.where(torch.rand(shape, generator=g, device=dev) < 0.15,
                          ids, -100)
        nsp = torch.randint(0, 2, (BERT_BATCH, 1), generator=g, device=dev)
        return ids, tt, mlm, nsp

    def small(self, batch):
        import torch

        mask = bert_padding(torch, batch[0].device, 2, BERT_SEQ, 6)
        return tuple(t[:2] for t in batch) + (mask,)

    def loss(self, model, ids, tt, mlm, nsp, mask=None):
        return model(ids, tt, attention_mask=mask, masked_lm_labels=mlm,
                     next_sentence_labels=nsp)[0]

    def opt(self, model):
        from paddle_tpu_torch.optimizer import AdamW

        return AdamW(learning_rate=1e-4, parameters=model.parameters(),
                     multi_precision=True)

    def generators(self, model):
        return [model.dropout_generator]

    def rates(self, dt, model, batch):
        out = super().rates(dt, model, batch)
        out["sequences_per_s"] = BERT_BATCH * self.steps / dt
        return out

    def extra(self, torch, dev, model, opt, batch, out):
        """A padded batch through ``attention_mask`` (0-25% of each row's
        keys, ``bert_padding``): one training step launches the flash
        forward and backward once a layer with the key bias and gives a
        finite loss; in eval mode, new ids on the padded positions leave
        every unpadded position's MLM logits equal bit for bit (a padded
        key's -1e4 bias gives it p = 0 in fp32)."""
        nl = model.config.num_hidden_layers
        mask = bert_padding(torch, dev, BERT_BATCH, BERT_SEQ, 5)
        reset_counts()
        loss = self.loss(model, *batch, mask)
        loss.backward()
        opt.step()
        opt.clear_grad()
        counts = read_counts()
        loss = float(loss)
        check(counts["flash"] == nl and counts["flash_bwd"] == nl
              and math.isfinite(loss),
              f"padded BERT step: launches {counts}, loss {loss}")
        model.eval()
        ids, tt = batch[0], batch[1]
        other = torch.where(mask.bool(), ids,
                            (ids + 7) % model.config.vocab_size)
        with torch.no_grad():
            a = model(ids, tt, attention_mask=mask)[0]
            b = model(other, tt, attention_mask=mask)[0]
        model.train()
        keep = mask.bool()
        same = torch.equal(a[keep], b[keep])
        pads = int((~keep).sum())
        log(f"  padded BERT batch ({pads} of {mask.numel()} keys padded, "
            f"0-25% a row): step loss {loss:.4f}, launches "
            f"{ {k: n for k, n in counts.items() if n} }; new ids on the "
            f"padded positions leave the unpadded MLM logits equal: {same}")
        check(same, "BERT: padded keys changed unpadded outputs")
        out["padded"] = dict(loss=loss, padded_keys=pads,
                             unpadded_logits_equal=same)


#: bench.py:bench_moe's ERNIE-MoE configuration (bench.py:694-700) and
#: batch: 6 layers, hidden 2048, 16 heads of 128, 8 experts of width 1408,
#: top-2, MoE on every second layer
MOE_CONFIG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                  moe_intermediate_size=1408, num_hidden_layers=6,
                  num_attention_heads=16, num_key_value_heads=16,
                  num_experts=8, moe_top_k=2, max_position_embeddings=2048)
MOE_BATCH, MOE_SEQ = 4, 2048


def moe_model(torch, dev, bf16=True, layers=None, seed=0):
    """``MOE_CONFIG`` on the card in bf16 (fp32 where ``bf16`` is False),
    ``layers`` cutting the depth."""
    from paddle_tpu_torch.models import ErnieMoeConfig, ErnieMoeForCausalLM

    cfg = dict(MOE_CONFIG, dtype="bfloat16" if bf16 else "float32")
    if layers:
        cfg["num_hidden_layers"] = layers
    return ErnieMoeForCausalLM(ErnieMoeConfig(**cfg), device=dev, seed=seed)


class MoeTrain(TrainSpec):
    """``bench.py:bench_moe``'s step (``MOE_CONFIG``, about 470M
    parameters, bf16, batch 4 x 2048, labels = ids rolled by one, GShard
    gates with random routing, ``AdamW(3e-4, multi_precision=True)``).
    Each step launches rows 2-5 as Llama's does (``train_launches``);
    MFU is bench.py's active-parameter formula (bench.py:736-745: the
    non-expert parameters and top-k / E of the experts'). The fp32 check
    runs the plain compositions (flags off) with the routing generator
    restored, so both runs draw the same random routing."""

    tag, label, to_static = "moe", "ERNIE-MoE", True

    def model(self, torch, dev, bf16=True, layers=None):
        return moe_model(torch, dev, bf16, layers)

    def batch(self, torch, cfg, dev):
        return _ids_and_labels(torch, cfg, dev, MOE_BATCH, MOE_SEQ)

    small = staticmethod(_small_lm)

    def loss(self, model, ids, labels):
        return model(ids, labels=labels)[0]

    def opt(self, model):
        from paddle_tpu_torch.optimizer import AdamW

        return AdamW(learning_rate=3e-4, parameters=model.parameters(),
                     multi_precision=True)

    def launches(self, nl):
        return {k: n for k, n in train_launches(nl).items() if n}

    def check_route(self, per_kernel, nl, label):
        check_train_kernels(per_kernel, nl, label)

    def plain(self):
        from paddle_tpu_torch.core.flags import flags_scope

        return flags_scope(use_cuda_flash_attention=False,
                           use_cuda_rms_norm=False)

    def generators(self, model):
        return [model.routing_generator]

    def rates(self, dt, model, batch):
        cfg = model.config
        tok_s = batch[0].numel() * self.steps / dt
        n_params = model.num_parameters()
        experts = sum(p.numel() for n, p in model.named_parameters()
                      if ".experts." in n)
        active = n_params - experts + experts * cfg.moe_top_k / cfg.num_experts
        return dict(step_ms=dt / self.steps * 1e3, tokens_per_s=tok_s,
                    mfu=tok_s * 6 * active / PEAK_FLOPS["bfloat16"],
                    active_params=active)

    def extra(self, torch, dev, model, opt, batch, out):
        """Tokens each MoE layer dropped in one step: the routing of every
        MoE layer read from ``moe_layer._route`` (the (token, choice)
        pairs routed, those past the expert's capacity, the tokens left
        with no expert)."""
        from paddle_tpu_torch.incubate.distributed.models.moe import (
            moe_layer as ml)

        seen, real = [], ml._route

        def spy(*a, **k):
            seen.append(real(*a, **k))
            return seen[-1]

        ml._route = spy
        try:
            loss = self.loss(model, *batch)
            loss.backward()
            opt.step()
            opt.clear_grad()
        finally:
            ml._route = real
        layers = []
        for r in seen:
            raw_tv, keep = r[1], r[3]
            live = raw_tv > 0
            layers.append(dict(
                routed=int(live.sum()), dropped=int((live & ~keep).sum()),
                tokens_without_expert=int((~keep).all(1).sum())))
        log(f"  {self.label} routing in one step, per MoE layer "
            f"({batch[0].numel()} tokens, top-{model.config.moe_top_k}, "
            f"capacity factor 1.2): {layers}")
        check(len(layers) == sum(l.is_moe for l in model.model.layers),
              f"{self.label}: {len(layers)} routings for the MoE layers")
        out["routing"] = layers


#: bench.py:bench_resnet's batch and resolution (bench.py:619)
RESNET_BATCH, RESNET_HW = 256, 224
#: ResNet-50's forward FLOPs an image at 224 x 224 (bench.py:663)
RESNET_FWD_FLOPS = 4.1e9
#: the port's kernels by report key, none of which ResNet may launch
PORT_KERNELS = ("flash_", "vflash_", "rms_norm_", "paged_decode",
                "tiled_mm_")


class ResnetTrain(TrainSpec):
    """``bench.py:bench_resnet``'s step: ``resnet50(num_classes=1000)`` in
    bf16, a random batch of 256 x 3 x 224 x 224 and labels from a seeded
    generator, fp32 logits into cross-entropy, ``Momentum(0.1, 0.9,
    multi_precision=True)``. It reaches no kernel of the port (the
    reference leaves convolution, batch norm and pooling to XLA): every
    launch count is 0 and the profiled step runs no port kernel. MFU is
    bench.py's (4.1 GFLOP x 3 an image at 224). The fp32 check runs
    ``resnet18`` on 8 images cropped to 64 x 64."""

    tag, label, to_static = "resnet", "ResNet-50", True

    def model(self, torch, dev, bf16=True, layers=None):
        from paddle_tpu_torch.vision.models import resnet18, resnet50

        model = (resnet18 if layers else resnet50)(num_classes=1000,
                                                   device=dev, seed=0)
        return model.to(torch.bfloat16) if bf16 else model

    def depth(self, model):
        return 0

    def loss_fell(self, warm, losses):
        """The first update lowers the loss. At lr 0.1 from random weights
        on one fixed batch, the later ones overshoot and come back (fp32
        on the CPU, batch 32 at 112 x 112: 7.29, 7.19, 15.18, 22.71,
        18.03, 13.27), so the last step need not be the lowest."""
        return losses[0] < warm

    def launches(self, nl):
        return {}

    def check_route(self, per_kernel, nl, label):
        ran = {k: c for k, c in per_kernel.items()
               if any(p in k for p in PORT_KERNELS)}
        log(f"  {label}: kernels of the port {ran or 'none'}")
        check(not ran, f"{label} ran kernels of the port: {ran}")

    def plain(self):
        return contextlib.nullcontext()

    def batch(self, torch, cfg, dev):
        g = torch.Generator(device=dev).manual_seed(9)
        x = torch.rand(RESNET_BATCH, 3, RESNET_HW, RESNET_HW, generator=g,
                       device=dev).to(torch.bfloat16)
        y = torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device=dev)
        return x, y

    def small(self, batch):
        x, y = batch
        return x[:8, :, :64, :64].float(), y[:8]

    def loss(self, model, x, y):
        from paddle_tpu_torch.nn import functional as F

        return F.cross_entropy(model(x).float(), y)

    def opt(self, model):
        from paddle_tpu_torch.optimizer import Momentum

        return Momentum(learning_rate=0.1, momentum=0.9,
                        parameters=model.parameters(), multi_precision=True)

    def generators(self, model):
        return []

    def rates(self, dt, model, batch):
        ips = RESNET_BATCH * self.steps / dt
        flops = 3 * RESNET_FWD_FLOPS * (RESNET_HW / 224) ** 2
        return dict(step_ms=dt / self.steps * 1e3, images_per_s=ips,
                    mfu=ips * flops / PEAK_FLOPS["bfloat16"])


#: bench.py:bench_sdxl_unet's configuration (bench.py:920-926): SDXL's
#: channels, attention levels and context width at one layer a block
SDXL_CONFIG = dict(in_channels=4, out_channels=4, sample_size=64,
                   block_out_channels=(320, 640, 1280), layers_per_block=1,
                   attention_levels=(False, True, True),
                   num_attention_heads=10, cross_attention_dim=2048,
                   norm_num_groups=32)
#: the fp32 check's UNet: one transformer level (640 channels, 10 heads
#: of 64) at 32 x 32 latents
SDXL_SMALL = dict(SDXL_CONFIG, sample_size=32, block_out_channels=(320, 640),
                  attention_levels=(False, True))
#: bench.py's batch and context length (bench.py:934)
SDXL_BATCH, SDXL_CTX = 32, 77


def unet_fwd_flops(cfg, batch, ctx_len):
    """Forward FLOPs of ``UNet2DConditionModel`` at ``cfg`` (a
    ``UNetConfig``): convolutions, linears and attention products along
    the model's channel and resolution flow, norms and activations left
    out; the count of ``bench.py:_unet_fwd_flops_analytic``
    (bench.py:832)."""
    chs = list(cfg.block_out_channels)
    temb = chs[0] * cfg.time_embed_mult
    hw0, xdim, b = cfg.sample_size, cfg.cross_attention_dim, batch

    def conv(cin, cout, h, w, k=3):
        return 2 * b * cout * h * w * cin * k * k

    def res_block(cin, cout, h, w):
        f = conv(cin, cout, h, w) + conv(cout, cout, h, w) + 2 * b * temb * cout
        return f + (conv(cin, cout, h, w, k=1) if cin != cout else 0)

    def attn_block(ch, h, w):
        n = h * w

        def lin(i, o, rows):
            return 2 * b * rows * i * o

        return (2 * lin(ch, ch, n) + 4 * lin(ch, ch, n) + 4 * b * n * n * ch
                + 2 * lin(ch, ch, n) + 2 * lin(xdim, ch, ctx_len)
                + 4 * b * n * ctx_len * ch + 2 * lin(ch, 4 * ch, n))

    total = conv(cfg.in_channels, chs[0], hw0, hw0)
    skip_chs, in_ch = [chs[0]], chs[0]
    for level, out_ch in enumerate(chs):
        h = hw0 >> level
        for _ in range(cfg.layers_per_block):
            total += res_block(in_ch, out_ch, h, h)
            if cfg.attention_levels[level]:
                total += attn_block(out_ch, h, h)
            in_ch = out_ch
            skip_chs.append(in_ch)
        if level < len(chs) - 1:
            total += conv(in_ch, in_ch, h // 2, h // 2)
            skip_chs.append(in_ch)
    h_mid = hw0 >> (len(chs) - 1)
    total += 2 * res_block(in_ch, in_ch, h_mid, h_mid)
    total += attn_block(in_ch, h_mid, h_mid)
    for level, out_ch in reversed(list(enumerate(chs))):
        h = hw0 >> level
        for _ in range(cfg.layers_per_block + 1):
            total += res_block(in_ch + skip_chs.pop(), out_ch, h, h)
            if cfg.attention_levels[level]:
                total += attn_block(out_ch, h, h)
            in_ch = out_ch
        if level > 0:
            total += conv(in_ch, in_ch, 2 * h, 2 * h)
    return total + conv(chs[0], cfg.out_channels, hw0, hw0)


def flash_launches_by_head_dim(per_kernel, dims=(64, 128)):
    """Launches of each tensor-core flash kernel at each head dim in a
    profile, read from the kernels' template arguments (demangled or
    mangled names)."""
    out = {}
    for step, (tc, _) in FLASH_KERNELS.items():
        for d in dims:
            out[f"{step}_d{d}"] = sum(
                c for key, c in per_kernel.items()
                if re.search(rf"(?<![a-z]){tc}(<[^<>]*\b{d}\b|I\w*?Li{d}E)",
                             key))
    return out


class SdxlTrain(TrainSpec):
    """``bench.py:bench_sdxl_unet``'s step at the TPU configuration's
    geometry (``SDXL_CONFIG``: 399.6M parameters) in bf16: latents 32 x 4
    x 64 x 64, timesteps in [0, 1000), a 32 x 77 x 2048 context, fp32 MSE
    against a noise target, ``AdamW(1e-4, multi_precision=True)``. Its
    attention runs the flash kernels: two calls (self and cross) in each
    of its 7 transformer blocks, at head dim 64 (640 channels, 32 x 32)
    and 128 (1280 channels, 16 x 16); the cross-attention's keys are the
    77 context tokens. MFU from the analytic count (``unet_fwd_flops``)
    x 3. The fp32 check runs ``SDXL_SMALL`` on two rows cropped to 32 x
    32 latents."""

    tag, label, to_static = "sdxl", "SDXL UNet", True

    def model(self, torch, dev, bf16=True, layers=None):
        from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig

        cfg = UNetConfig(**(SDXL_SMALL if layers else SDXL_CONFIG))
        model = UNet2DConditionModel(cfg, device=dev, seed=0)
        return model.to(torch.bfloat16) if bf16 else model

    def depth(self, model):
        from paddle_tpu_torch.models.unet_diffusion import TransformerBlock2D

        return sum(isinstance(m, TransformerBlock2D) for m in model.modules())

    def launches(self, nl):
        return dict(flash=2 * nl, flash_bwd=2 * nl)

    def check_route(self, per_kernel, nl, label):
        """The tensor-core flash kernels twice a transformer block (by
        name), at head dims 64 and 128 as the blocks' widths give them;
        no RMSNorm kernel."""
        super().check_route(per_kernel, 2 * nl, label)
        by_dim = flash_launches_by_head_dim(per_kernel)
        log(f"  {label}: tensor-core flash kernels by head dim {by_dim}")
        want = {}
        for level, ch in enumerate(SDXL_CONFIG["block_out_channels"]):
            if SDXL_CONFIG["attention_levels"][level]:
                d = ch // SDXL_CONFIG["num_attention_heads"]
                # down 1 + up 2 a level, and the middle block at the last
                blocks = 3 + (level == len(SDXL_CONFIG["attention_levels"])
                              - 1)
                for step in FLASH_KERNELS:
                    want[f"{step}_d{d}"] = 2 * blocks
        check(by_dim == want, f"{label}: flash launches by head dim "
                              f"{by_dim}, want {want}")

    def batch(self, torch, cfg, dev):
        g = torch.Generator(device=dev).manual_seed(9)
        hw, bf16 = cfg.sample_size, torch.bfloat16
        shape = (SDXL_BATCH, cfg.in_channels, hw, hw)
        noisy = torch.randn(shape, generator=g, device=dev).to(bf16)
        target = torch.randn(shape, generator=g, device=dev).to(bf16)
        t = torch.randint(0, 1000, (SDXL_BATCH,), generator=g, device=dev)
        ctx = torch.randn(SDXL_BATCH, SDXL_CTX, cfg.cross_attention_dim,
                          generator=g, device=dev).to(bf16)
        return noisy, t, ctx, target

    def small(self, batch):
        x, t, ctx, target = batch
        hw = SDXL_SMALL["sample_size"]
        return (x[:2, :, :hw, :hw].float(), t[:2], ctx[:2].float(),
                target[:2, :, :hw, :hw].float())

    def loss(self, model, x, t, ctx, target):
        pred = model(x, t, ctx)
        return ((pred.float() - target.float()) ** 2).mean()

    def opt(self, model):
        from paddle_tpu_torch.optimizer import AdamW

        return AdamW(learning_rate=1e-4, parameters=model.parameters(),
                     multi_precision=True)

    def generators(self, model):
        return []

    def rates(self, dt, model, batch):
        ips = SDXL_BATCH * self.steps / dt
        flops = 3 * unet_fwd_flops(model.config, SDXL_BATCH, SDXL_CTX)
        return dict(step_ms=dt / self.steps * 1e3, images_per_s=ips,
                    mfu=ips / SDXL_BATCH * flops / PEAK_FLOPS["bfloat16"],
                    fwd_flops=flops / 3)


def phase_model_train(torch, dev, report, spec):
    """A model's training step at full width and depth in bf16 (``spec``,
    a ``TrainSpec``): one warm-up step and ``spec.steps`` timed steps on
    one batch. Every step must launch the kernels of ``spec.launches``
    and no other kernel of the port, the profiled step must show the
    kernels of ``spec.check_route`` by name, and the loss must fall.
    Prints tokens/s, MFU, peak memory and the busy share; then
    ``spec.extra``, and with ``spec.to_static`` the step under
    ``jit.to_static(full_graph=True)`` (``static_vs_eager``). Then 2
    layers in fp32 (``spec.fp32_check``: by default
    ``fp32_kernels_vs_plain``, the loss and every gradient through the
    kernels against the same step on their plain versions, to
    ``[train]``'s tolerances). Returns the numbers."""
    label = spec.label
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = spec.model(torch, dev).train()
    nl = spec.depth(model)
    n_params = model.num_parameters()
    opt = spec.opt(model)
    batch = spec.batch(torch, getattr(model, "config", None), dev)

    def step():
        loss = spec.loss(model, *batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    t0 = time.perf_counter()
    warm = float(step())
    log(f"  {label}: {n_params / 1e6:.1f}M parameters, bf16, batch "
        f"{list(batch[0].shape)}; warm-up step "
        f"{time.perf_counter() - t0:.2f} s, loss {warm:.4f}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(spec.steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  {spec.steps} steps: launches {counts}, losses "
        f"{[round(x, 4) for x in losses]}")
    want = {key: 0 for key in counts}
    want.update({k: n * spec.steps for k, n in spec.launches(nl).items()})
    check(counts == want, f"{label} train launches {counts}, want {want}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(spec.loss_fell(warm, losses),
          f"{label} loss did not fall: {warm} then {losses}")
    record_launches(report, f"{spec.tag}_train", counts)
    rates = spec.rates(dt, model, batch)
    log(f"  {label} train step: {rates['step_ms']:.2f} ms mean, "
        + ", ".join(f"{rates[k]:.{p}f} {unit}" for k, p, unit in (
            ("tokens_per_s", 1, "tokens/s"),
            ("sequences_per_s", 2, "sequences/s"),
            ("images_per_s", 2, "images/s")) if k in rates)
        + f", MFU {rates['mfu']:.4f} (bench.py's formula, 989 TFLOP/s bf16 "
        f"peak), peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)"
        f"; {smi_line()}")
    busy, per_kernel = recorded(
        lambda: profile_kernels(torch, step, 1, rates["step_ms"],
                                f"{label} train step, kernels"),
        _per_kernel,
        lambda out: spec.check_route(out[1], nl, f"bf16 {label} train step"),
        f"bf16 {label} train step")
    out = dict(rates, peak_bytes=peak, losses=losses, n_params=n_params,
               busy_share=None if busy is None
               else busy / rates["step_ms"])
    spec.extra(torch, dev, model, opt, batch, out)
    del model, opt
    torch.cuda.empty_cache()
    if spec.to_static:
        out["to_static"] = static_vs_eager(
            torch, dev, lambda: spec.model(torch, dev).train(), batch,
            spec.loss, lambda m: (spec.opt(m), None), f"bf16 {label}",
            spec.launches(nl), lambda pk, lb: spec.check_route(pk, nl, lb),
            spec.generators, steps=spec.steps)

    out["fp32_check"] = spec.fp32_check(torch, dev, batch)
    return out


def fp32_kernels_vs_plain(torch, dev, spec, batch):
    """``phase_model_train``'s fp32 check for a model on the port's
    kernels: 2 layers (``spec.model``'s ``layers=2``), TF32 off, training
    mode, ``spec.small``'s batch, the generators restored before each
    run; the loss and every gradient through the kernels against the same
    step on their plain versions (``spec.plain``): loss 1e-4, each
    gradient 1e-4 of its own max |g|. Returns the numbers."""
    label = spec.label
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = spec.model(torch, dev, bf16=False, layers=2).train()
    small = spec.small(batch)
    gens = spec.generators(model)
    states = [g.get_state() for g in gens]

    def loss_and_grads():
        for g, st in zip(gens, states):
            g.set_state(st)
        loss = spec.loss(model, *small)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    reset_counts()
    k_loss, k_grads = loss_and_grads()
    k_counts = read_counts()
    with spec.plain():
        p_loss, p_grads = loss_and_grads()
    torch.cuda.synchronize()
    check(read_counts() == k_counts, f"the plain {label} run launched a "
                                     f"kernel")
    check(all(k_counts[k] == n
              for k, n in spec.launches(spec.depth(model)).items()),
          f"the fp32 {label} kernel run's launches {k_counts}")
    zero = {n for n in p_grads if n.endswith(spec.zero_grads)}
    worst = max(((float((k_grads[n] - gp).abs().max())
                  / float(gp.abs().max()), n)
                 for n, gp in p_grads.items() if n not in zero))
    top = max(float(g.abs().max()) for g in p_grads.values())
    noise = max((float(g[n].abs().max()) for g in (k_grads, p_grads)
                 for n in zero), default=0.0)
    log(f"  fp32 {label} 2 layers, kernels vs plain versions: loss "
        f"{k_loss:.6f} vs {p_loss:.6f} (diff {abs(k_loss - p_loss):.3g}, tol "
        f"1e-4); worst gradient {worst[1]} off by {worst[0]:.3g} of its max "
        f"|g| (tol 1e-4) over {len(p_grads) - len(zero)} gradients"
        + (f"; the {len(zero)} gradients 0 in exact arithmetic at most "
           f"{noise:.3g} ({noise / top:.3g} of the largest |g|, tol 1e-6)"
           if zero else ""))
    check(abs(k_loss - p_loss) <= 1e-4, f"fp32 {label} training loss differs")
    check(worst[0] <= 1e-4, f"fp32 {label} gradient {worst[1]} differs")
    check(noise <= 1e-6 * top, f"fp32 {label}: a gradient that is 0 in "
                               f"exact arithmetic is {noise:.3g}")
    res = dict(loss_diff=abs(k_loss - p_loss), worst_grad_share=worst[0],
               launches=k_counts)
    del model, k_grads, p_grads
    torch.cuda.empty_cache()
    return res




def run_parts(torch, dev, report, key, label, parts):
    """Run a model's phases in order, each ``part(torch, dev, report)``,
    keeping what each returns under ``report[key][name]`` and printing
    its seconds."""
    report[key] = {}
    for name, part in parts:
        t0 = time.perf_counter()
        out = part(torch, dev, report)
        if out is not None:
            report[key][name] = out
        log(f"  ({label} {name}: {time.perf_counter() - t0:.1f} s)")


def phase_gpt(torch, dev, report):
    """The ``[gpt]`` phase: rows 2 and 4 at GPT's shape [8, 16, 1024, 64],
    causal, dropout 0.1 (``flash_at_shape``), the training step
    (``phase_model_train`` over ``GptTrain``), then ``generate`` and
    ``ServeEngine`` through ``phase_generate`` and ``phase_serve`` over
    ``gpt_family``."""
    fam = gpt_family(torch, dev)
    run_parts(torch, dev, report, "gpt", fam.label, (
        ("kernels", functools.partial(
            flash_at_shape, key="at_gpt_shape", b=GPT_BATCH, h=16,
            s=GPT_SEQ, d=64, causal=True, dropout=GPT_DROPOUT)),
        ("train", functools.partial(phase_model_train, spec=GptTrain())),
        ("generate", functools.partial(phase_generate, fam=fam)),
        ("serve", functools.partial(phase_serve, fam=fam))))


def phase_bert_kernels(torch, dev, report):
    """Rows 2 and 4 at BERT-base's training shape, [36, 12, 512, 64], not
    causal, dropout 0.1, without a bias and with the key bias of a
    padding mask over 0-25% of each row's keys (``bert_padding``)
    (``flash_at_shape``)."""
    shape = (BERT_BATCH, 12, BERT_SEQ, 64)
    flash_at_shape(torch, dev, report, "at_bert_shape", *shape,
                   causal=False, dropout=BERT_DROPOUT)
    mask = bert_padding(torch, dev, BERT_BATCH, BERT_SEQ, 5)
    flash_at_shape(torch, dev, report, "at_bert_shape_key_bias", *shape,
                   causal=False, dropout=BERT_DROPOUT,
                   bias=(1.0 - mask.float()) * -1e4)


#: BERT backward passes from one state per embedding implementation
EMBEDDING_RUNS = 20


def phase_embedding_determinism(torch, dev, report):
    """BERT-base's forward and backward (bf16, training mode, batch 36 x
    512, the dropout generator restored before each pass)
    ``EMBEDDING_RUNS`` times from one state, each pass's gradients against
    the first pass's: with the port's ``Embedding`` (``_row_sums``, no
    atomics) every gradient must be the same every time; with the three
    embeddings swapped for ``torch.nn.Embedding`` (the same parameters)
    the passes whose gradients differ, and which parameters, are
    reported. A captured step can equal an eager one only if the step is
    deterministic."""
    from paddle_tpu_torch.nn.functional.common import Embedding

    spec = BertTrain()
    model = spec.model(torch, dev).train()
    batch = spec.batch(torch, model.config, dev)
    state = model.dropout_generator.get_state()
    embs = model.bert.embeddings
    names = ("word_embeddings", "position_embeddings",
             "token_type_embeddings")
    out = {}
    for cls in (Embedding, torch.nn.Embedding):
        for name in names:
            getattr(embs, name).__class__ = cls
        first, differ = None, {}
        for run in range(EMBEDDING_RUNS):
            model.dropout_generator.set_state(state)
            spec.loss(model, *batch).backward()
            grads = {n: p.grad for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            if first is None:
                first = grads
                continue
            for n, g in grads.items():
                if not torch.equal(g, first[n]):
                    differ[n] = differ.get(n, 0) + 1
        runs = max(differ.values(), default=0)
        label = "port" if cls is Embedding else "torch"
        out[label] = dict(runs_differing=runs, by_parameter=differ)
        log(f"  BERT backward from one state, {EMBEDDING_RUNS} passes, "
            f"embeddings {cls.__module__}.{cls.__name__}: gradients of "
            f"{len(differ)} parameters differ from the first pass's "
            f"({differ or 'none'})")
        check(cls is not Embedding or not differ,
              f"BERT's gradients differ from run to run with the port's "
              f"embeddings: {differ}")
    del model, first, grads
    torch.cuda.empty_cache()
    return out


#: backward passes from one state per cuDNN setting
CONV_RUNS = 20


@contextlib.contextmanager
def default_cudnn():
    """The port's convolutions on cuDNN's default choice of algorithms for
    the block: ``nn/functional/conv.py``'s ``_deterministic_cudnn``
    swapped for a no-op."""
    from paddle_tpu_torch.nn.functional import conv

    saved = conv._deterministic_cudnn
    conv._deterministic_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        conv._deterministic_cudnn = saved


def phase_backward_determinism(torch, dev, report, spec, runs=CONV_RUNS):
    """``spec``'s model at full width (bf16, training mode, its batch):
    the forward and backward ``runs`` times from one state with the
    port's convolutions as they are (cuDNN's deterministic algorithms),
    then on cuDNN's default choice (``default_cudnn``), each pass's
    gradients against the first pass's of its setting. As they are,
    every gradient must be the same every time; on the default choice,
    the parameters whose gradients differed are reported, and the median
    time of a pass (the first left out) is given both ways: what the
    determinism costs. The model's generators (its dropout) start every
    pass from the same state. Then one more pass under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, whose
    warnings name the ops torch has no deterministic path for."""
    import warnings

    model = spec.model(torch, dev).train()
    batch = spec.batch(torch, getattr(model, "config", None), dev)
    gens = spec.generators(model)
    states = [g.get_state() for g in gens]
    out = {}
    for on in (True, False):
        first, differ, times = None, {}, []
        with contextlib.nullcontext() if on else default_cudnn():
            for run in range(runs):
                for g, st in zip(gens, states):
                    g.set_state(st)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                spec.loss(model, *batch).backward()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                grads = {n: p.grad for n, p in model.named_parameters()}
                model.zero_grad(set_to_none=True)
                if first is None:
                    first = grads
                    continue
                for n, g in grads.items():
                    if not torch.equal(g, first[n]):
                        differ[n] = differ.get(n, 0) + 1
        label = "on" if on else "off"
        ms = sorted(times[1:])[(len(times) - 1) // 2] * 1e3
        out[label] = dict(runs_differing=max(differ.values(), default=0),
                          parameters_differing=len(differ),
                          pass_ms=ms, by_parameter=differ)
        log(f"  {spec.label} forward + backward from one state, {runs} "
            f"passes, deterministic cuDNN {label}: {ms:.2f} ms a pass; "
            f"gradients of {len(differ)} parameters differ from the first "
            f"pass's in up to {out[label]['runs_differing']} passes "
            f"({sorted(differ)[:6] or 'none'})")
        check(not on or not differ,
              f"{spec.label}: gradients differ from run to run with "
              f"deterministic convolutions: {differ}")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            spec.loss(model, *batch).backward()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    names = sorted({str(w.message).split(" does not have")[0].split(
        " is not deterministic")[0][:120] for w in seen
        if "determinis" in str(w.message)})
    log(f"  {spec.label}: ops torch names as without a deterministic path: "
        f"{names or 'none'}")
    out["nondeterministic_ops"] = names
    out["cost"] = out["on"]["pass_ms"] / out["off"]["pass_ms"] - 1.0
    del model, first, grads
    torch.cuda.empty_cache()
    return out


def phase_resnet(torch, dev, report):
    """The ``[resnet]`` phase: the backward's determinism at ResNet-50's
    full batch (``phase_backward_determinism``), then ``bench_resnet``'s
    step (``phase_model_train`` over ``ResnetTrain``)."""
    spec = ResnetTrain()
    run_parts(torch, dev, report, "resnet", spec.label, (
        ("determinism", functools.partial(phase_backward_determinism,
                                          spec=spec)),
        ("train", functools.partial(phase_model_train, spec=spec))))


def phase_sdxl_kernels(torch, dev, report):
    """Rows 2 and 4 at the SDXL UNet's attention shapes, bf16, not
    causal, no dropout (``flash_at_shape``): the cross-attention first
    (32 x 10 heads, 1024 queries of 64 and 256 of 128, against the 77
    context tokens: Sk is no multiple of a key tile), then the
    self-attention at [32, 10, 1024, 64] and [32, 10, 256, 128]."""
    h = SDXL_CONFIG["num_attention_heads"]
    for d, s in ((64, 1024), (128, 256)):
        flash_at_shape(torch, dev, report, f"at_sdxl_cross_d{d}", SDXL_BATCH,
                       h, s, d, causal=False, dropout=0.0, sk=SDXL_CTX)
    for d, s in ((64, 1024), (128, 256)):
        flash_at_shape(torch, dev, report, f"at_sdxl_self_d{d}", SDXL_BATCH,
                       h, s, d, causal=False, dropout=0.0)


def phase_sdxl(torch, dev, report):
    """The ``[sdxl]`` phase: rows 2 and 4 at the UNet's attention shapes
    (``phase_sdxl_kernels``), the backward's determinism at its full
    batch, then ``bench_sdxl_unet``'s step (``phase_model_train`` over
    ``SdxlTrain``)."""
    spec = SdxlTrain()
    run_parts(torch, dev, report, "sdxl", spec.label, (
        ("kernels", phase_sdxl_kernels),
        ("determinism", functools.partial(phase_backward_determinism,
                                          spec=spec, runs=CONV_RUNS // 2)),
        ("train", functools.partial(phase_model_train, spec=spec))))


def phase_bert(torch, dev, report):
    """The ``[bert]`` phase: rows 2 and 4 at BERT's shape, the embedding
    gradient's determinism at its shapes, then ``bench_bert``'s step
    (``phase_model_train`` over ``BertTrain``)."""
    run_parts(torch, dev, report, "bert", "BERT", (
        ("kernels", phase_bert_kernels),
        ("embedding", phase_embedding_determinism),
        ("train", functools.partial(phase_model_train, spec=BertTrain()))))


def phase_moe(torch, dev, report):
    """The ``[moe]`` phase: ``bench_moe``'s step (``phase_model_train``
    over ``MoeTrain``), then ``generate`` through ``phase_generate`` over
    ``moe_family`` (dense greedy, sampled, 4 beams)."""
    fam = moe_family(torch, dev)
    run_parts(torch, dev, report, "moe", fam.label, (
        ("train", functools.partial(phase_model_train, spec=MoeTrain())),
        ("generate", functools.partial(phase_generate, fam=fam))))


#: ``FusedMultiTransformer`` of the ``[incubate]`` phase: GPT-2 medium's
#: widths (embed 1024, 16 heads of 64, FFN 4096, 24 layers, gelu,
#: pre-LN) and its input [INCUBATE_BATCH, INCUBATE_SEQ, 1024]
INCUBATE_STACK = dict(embed_dim=1024, num_heads=16, dim_feedforward=4096,
                      num_layers=24, activation="gelu", normalize_before=True)
INCUBATE_BATCH, INCUBATE_SEQ = 8, 1024
INCUBATE_DROPOUT = 0.1
#: ``fused_rms_norm``'s rows and hidden size in the ``[incubate]`` phase,
#: and the calls its profile records
INCUBATE_RMS = (8192, 2048)
INCUBATE_RMS_PROFILED = 5


@contextlib.contextmanager
def flags(**values):
    """The port's flags set to ``values`` for the block."""
    from paddle_tpu_torch.core.flags import set_flags

    prev = set_flags(values)
    try:
        yield
    finally:
        set_flags(prev)


def port_launches(per_kernel, allowed):
    """Launches by name of the port's kernels (``PORT_KERNELS``) in
    ``per_kernel`` other than those named in ``allowed``."""
    return {k: c for k, c in per_kernel.items()
            if any(p in k for p in PORT_KERNELS)
            and not any(re.search(rf"(?<![a-z]){a}", k) for a in allowed)}


def incubate_stack(torch, dev, report, res):
    """(a) ``FusedMultiTransformer`` at ``INCUBATE_STACK`` in bf16: an eval
    forward must launch ``flash_fwd_tc_kernel`` once a layer (by counter
    and by name) and no other kernel of the port; a training forward and
    backward (dropout ``INCUBATE_DROPOUT`` from an explicit generator)
    the forward and ``flash_bwd_dq_tc_kernel`` / ``flash_bwd_dkv_tc_kernel``
    once a layer each. Prints forward ms, step ms, tokens/s, busy share
    and peak memory. Returns the step's launch counts."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer

    nl = INCUBATE_STACK["num_layers"]
    b, s, e = INCUBATE_BATCH, INCUBATE_SEQ, INCUBATE_STACK["embed_dim"]
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(7)
    model = FusedMultiTransformer(**INCUBATE_STACK,
                                  dropout_rate=INCUBATE_DROPOUT, device=dev,
                                  dtype=torch.bfloat16, seed=0,
                                  generator=gen)
    x = torch.randn(b, s, e, generator=torch.Generator(device=dev)
                    .manual_seed(8), device=dev).to(torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  FusedMultiTransformer {INCUBATE_STACK}, {n_params / 1e6:.1f}M "
        f"parameters, bf16, input [{b}, {s}, {e}]")

    model.eval()
    with torch.no_grad():
        def fwd():
            return model(x)

        out = fwd()
        check(bool(torch.isfinite(out).all()) and out.shape == x.shape,
              f"FusedMultiTransformer eval forward: {tuple(out.shape)}, "
              f"finite {bool(torch.isfinite(out).all())}")
        reset_counts()
        fwd()
        counts = read_counts()
        check(counts["flash"] == nl and not any(
            n for k, n in counts.items() if k != "flash"),
            f"FusedMultiTransformer eval forward launched {counts}, want "
            f"flash {nl} and nothing else")
        fwd_ms = time_ms(fwd, iters=10)
        busy, per_kernel = recorded(
            lambda: profile_kernels(torch, fwd, 3, fwd_ms,
                                    "incubate stack, eval forward"),
            _per_kernel,
            lambda out: check_flash_route(out[1], {"fwd": nl},
                                          "incubate stack forward"),
            "incubate stack forward")
    other = port_launches(per_kernel, [FLASH_KERNELS["fwd"][0]])
    check(not other, f"incubate stack forward ran other port kernels "
                     f"{other}")

    model.train()
    w = torch.randn(b, s, e, generator=torch.Generator(device=dev)
                    .manual_seed(9), device=dev).to(torch.bfloat16)

    def step():
        model.zero_grad(set_to_none=True)
        loss = (model(x).float() * w.float()).mean()
        loss.backward()
        return loss

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss = step()
    torch.cuda.synchronize()
    step_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(loss)) and all(
        p.grad is not None and bool(torch.isfinite(p.grad).all())
        for p in model.parameters()),
        "incubate stack step: a non-finite loss or gradient")
    check(step_counts["flash"] == nl and step_counts["flash_bwd"] == nl
          and not any(n for k, n in step_counts.items()
                      if k not in ("flash", "flash_bwd")),
          f"incubate stack step launched {step_counts}, want flash {nl} and "
          f"flash_bwd {nl}")
    step_ms = time_ms(step, iters=5, warmup=1)
    sbusy, per_kernel = recorded(
        lambda: profile_kernels(torch, step, 2, step_ms,
                                "incubate stack, training step"),
        _per_kernel,
        lambda out: check_flash_route(out[1], {"fwd": nl, "dq": nl,
                                               "dkv": nl},
                                      "incubate stack step"),
        "incubate stack step")
    other = port_launches(per_kernel, [tc for tc, _ in FLASH_KERNELS.values()])
    check(not other, f"incubate stack step ran other port kernels {other}")
    tps = b * s / step_ms * 1e3
    log(f"  incubate stack: eval forward {fwd_ms:.2f} ms, training step "
        f"(dropout {INCUBATE_DROPOUT}) {step_ms:.2f} ms, {tps:.0f} tokens/s, "
        f"peak allocated {peak / 2**30:.2f} GiB; {smi_line()}")
    res["stack"] = dict(forward_ms=fwd_ms, step_ms=step_ms, tokens_per_s=tps,
                        forward_busy=None if busy is None else busy / fwd_ms,
                        step_busy=None if sbusy is None else sbusy / step_ms,
                        peak_bytes=peak, params=n_params)
    del model, x, w
    torch.cuda.empty_cache()
    return step_counts


def incubate_stack_fp32(torch, dev, res):
    """(b) The stack at 2 layers in fp32 (TF32 off), eval mode: output and
    input gradient on the kernels (the CUDA-core flash route) against the
    same call with ``use_cuda_flash_attention`` off (the plain
    composition), at ``tolerance(float32, 1e-4)``."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer

    b, s, e = INCUBATE_BATCH, INCUBATE_SEQ, INCUBATE_STACK["embed_dim"]
    model = FusedMultiTransformer(**dict(INCUBATE_STACK, num_layers=2),
                                  device=dev, seed=1).eval()
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(b, s, e, generator=g, device=dev)
    w = torch.randn(b, s, e, generator=g, device=dev)

    def run():
        xi = x.clone().requires_grad_()
        out = model(xi)
        (out * w).sum().backward()
        return out.detach(), xi.grad

    reset_counts()
    got = run()
    counts = read_counts()
    check(counts["flash"] == 2 and counts["flash_bwd"] == 2,
          f"fp32 incubate stack launched {counts}")
    with flags(use_cuda_flash_attention=False):
        reset_counts()
        want = run()
        check(not any(read_counts().values()),
              "the plain fp32 incubate stack launched a kernel")
    atol, rtol = tolerance(torch.float32, 1e-4)
    for name, a, ref in zip(("output", "input gradient"), got, want):
        err, share = close_err(a, ref, atol, rtol)
        log(f"  fp32 incubate stack, 2 layers, {name} on the kernels vs the "
            f"plain composition: max_abs_err={err:.3g}, {share:.3g} of the "
            f"tolerance")
        check(share <= 1.0, f"fp32 incubate stack {name}: {share:.3g} of the "
                            f"tolerance")
        res.setdefault("fp32_max_abs_err", {})[name] = err
    del model
    torch.cuda.empty_cache()


def incubate_rms(torch, dev, res):
    """(c) ``fused_rms_norm`` with ``bias`` and ``residual`` at
    ``INCUBATE_RMS`` in bf16, backward from ``out``'s gradient (so the
    gradient of x is the RMSNorm backward's own output, not that plus
    ``residual_out``'s gradient, whose sum cancels to values far below
    its terms): one forward and backward must launch the RMSNorm forward
    and backward once each (by counter and by name). ``out``,
    ``residual_out`` and the gradients of x and the weight are held
    against the same call with ``use_cuda_rms_norm`` off (the plain
    composition) at ``tolerance(bf16, 1e-4)`` (the weight's, a sum over
    the rows, at ``tolerance(bf16, 1e-3)``); the residual's gradient
    must equal x's, and the bias's must be x's summed over the rows
    within two bf16 units of the sum of their magnitudes. Returns the
    launch counts."""
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm

    rows, hid = INCUBATE_RMS
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    x, res_in, gy = rnd(rows, hid), rnd(rows, hid), rnd(rows, hid)
    wt, bias = rnd(hid, scale=0.1) + 1, rnd(hid, scale=0.1)

    def run():
        leaves = [t.clone().requires_grad_() for t in (x, wt, bias, res_in)]
        out, res_out = fused_rms_norm(leaves[0], leaves[1], epsilon=1e-6,
                                      bias=leaves[2], residual=leaves[3])
        out.backward(gy)
        return [out.detach(), res_out.detach()] + [t.grad for t in leaves]

    reset_counts()
    got = run()
    counts = read_counts()
    check(counts["rms_norm"] == 1 and counts["rms_norm_bwd"] == 1
          and not any(n for k, n in counts.items()
                      if k not in ("rms_norm", "rms_norm_bwd")),
          f"fused_rms_norm launched {counts}, want the RMSNorm forward and "
          f"backward once each")
    # the counters above show one launch each a call; the profile shows
    # the route (the vector variant) by name, over INCUBATE_RMS_PROFILED
    # calls of a fraction of a millisecond each: one profile of a single
    # call recorded none of its kernels once, so a lost launch is admitted
    # and a second one a call is not
    from torch.autograd import DeviceType

    n = INCUBATE_RMS_PROFILED
    names = named_launches(
        {e.key: e.count for e in profiled(run, n, cpu=True)
         if e.device_type == DeviceType.CUDA}, RMS_TRAIN_KERNELS[:2])
    check(all(1 <= c <= n for c in names.values()),
          f"fused_rms_norm's profile of {n} calls ran {names}, want each "
          f"once a call")
    with flags(use_cuda_rms_norm=False):
        want = run()
    for name, a, ref, base in zip(("out", "residual_out", "dx", "dweight"),
                                  got, want, (1e-4, 1e-4, 1e-4, 1e-3)):
        err, share = close_err(a, ref, *tolerance(bf16, base))
        log(f"  fused_rms_norm [{rows}, {hid}] bf16, bias + residual, {name} "
            f"on the kernels vs plain: max_abs_err={err:.3g}, {share:.3g} "
            f"of the tolerance")
        check(share <= 1.0, f"fused_rms_norm {name}: {share:.3g} of the "
                            f"tolerance")
        res.setdefault("rms_max_abs_err", {})[name] = err
    dx, dbias, dres = got[2], got[4], got[5]
    sums = dx.float().sum(0)
    bias_share = float(((dbias.float() - sums).abs() / (
        2 * torch.finfo(bf16).eps * dx.float().abs().sum(0) + 1e-6)).max())
    check(torch.equal(dres, dx) and bias_share <= 1.0,
          f"fused_rms_norm: d(residual) equal to dx {torch.equal(dres, dx)}, "
          f"d(bias) {bias_share:.3g} of its bound")
    log(f"  fused_rms_norm: d(residual) = dx bit for bit, d(bias) = dx "
        f"summed over the rows ({bias_share:.3g} of the bound); the RMSNorm "
        f"kernels by name over {n} profiled calls {names}")
    return counts


def incubate_mha(torch, dev, res):
    """(d) ``fused_multi_head_attention`` at GPT-2 medium's widths (x
    [8, 1024, 1024] bf16, 16 heads of 64, pre-LN) with a key-only mask
    [8, 1, 1, 1024] (the last 0-25% of each row's keys masked): it must
    reach ``flash_attention_fused`` with the mask as its key bias and
    launch the forward once; that call is held against its plain version
    on the same inputs at ``tolerance(bf16, 1e-4)``, and the block's
    output against the block on the plain version is reported."""
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_multi_head_attention)
    from paddle_tpu_torch.nn.functional import attention as ta

    b, s, e, h = INCUBATE_BATCH, INCUBATE_SEQ, 1024, 16
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    x = rnd(b, s, e)
    qkv_w, lin_w = rnd(3, h, e // h, e, scale=0.03), rnd(e, e, scale=0.03)
    qkv_b, lin_b = rnd(3, h, e // h, scale=0.02), rnd(e, scale=0.02)
    ln_s, ln_b = rnd(e, scale=0.1) + 1, rnd(e, scale=0.1)
    keep = torch.randint(int(s * 0.75), s + 1, (b,), generator=g, device=dev)
    mask = torch.where(torch.arange(s, device=dev)[None] < keep[:, None],
                       0.0, -1e4).reshape(b, 1, 1, s)
    calls = []
    real = ta.flash_attention_fused

    def checked(q, k, v, **kw):
        out = real(q, k, v, **kw)
        with plain_flash():
            ref = real(q, k, v, **kw)
        calls.append((kw.get("key_bias") is not None,
                      close_err(out, ref, *tolerance(bf16, 1e-4))))
        return out

    def block():
        return fused_multi_head_attention(
            x, qkv_w, lin_w, pre_layer_norm=True, pre_ln_scale=ln_s,
            pre_ln_bias=ln_b, qkv_bias=qkv_b, linear_bias=lin_b,
            attn_mask=mask, training=False)

    with torch.no_grad():
        reset_counts()
        ta.flash_attention_fused = checked
        try:
            out = block()
        finally:
            ta.flash_attention_fused = real
        counts = read_counts()
        check(counts["flash"] == 1, f"fused_multi_head_attention launched "
                                    f"{counts}")
        check(len(calls) == 1 and calls[0][0],
              f"fused_multi_head_attention's flash calls (key bias, err): "
              f"{calls}")
        err, share = calls[0][1]
        log(f"  fused_multi_head_attention, key-only mask [{b}, 1, 1, {s}]: "
            f"the key-bias flash call vs its plain version max_abs_err="
            f"{err:.3g}, {share:.3g} of the tolerance")
        check(share <= 1.0, f"fused_multi_head_attention's flash call: "
                            f"{share:.3g} of the tolerance")
        with plain_flash():
            plain = block()
        block_err = max_err(out, plain)
        scale = float(plain.float().abs().max())
        log(f"  fused_multi_head_attention block on the kernel vs on the "
            f"plain version: max_abs_err={block_err:.3g} at max |out| "
            f"{scale:.3g} (reported; the kernel's call is the check)")
        check(math.isfinite(block_err), "fused_multi_head_attention: "
                                        "non-finite output")
    res["mha"] = dict(flash_max_abs_err=err, flash_share=share,
                      block_max_abs_err=block_err)


def phase_incubate(torch, dev, report):
    """The ``[incubate]`` phase: the fused ops and layers of
    ``incubate.nn`` reaching rows 2-5 from their own entry points
    (``incubate_stack``, ``incubate_stack_fp32``, ``incubate_rms``,
    ``incubate_mha``). Their launches are kept under
    ``launches_by_path["incubate"]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    stack_counts = incubate_stack(torch, dev, report, res)
    incubate_stack_fp32(torch, dev, res)
    rms_counts = incubate_rms(torch, dev, res)
    incubate_mha(torch, dev, res)
    record_launches(report, "incubate", {
        k: stack_counts[k] + rms_counts[k] for k in stack_counts})
    report["incubate"] = res


# ---------------------------------------------------------------------------
# [functional]: the rest of nn.functional on the card
# ---------------------------------------------------------------------------
#: ``flash_attention_with_sparse_mask``'s shape, [B, S, H, D], bf16, causal
SPARSE_SHAPE = (4, 2048, 16, 128)
#: the calls of ``flash_attention_with_sparse_mask`` its route check profiles
SPARSE_PROFILED = 5


def sparse_start_rows(torch, dev, b, h, s, seed):
    """Start rows [B, H, S] (int32): key column j is masked from a query
    row drawn in (j, S], so each key stays visible to its own row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    span = torch.randint(1, s + 1, (b, h, s), generator=g, device=dev)
    return torch.clamp(torch.arange(s, device=dev) + span, max=s).to(
        torch.int32)


def sparse_mask_call(torch, q, k, v, do, rows=None):
    """``flash_attention_with_sparse_mask`` forward and backward (``do``
    the output's gradient): (out, [dq, dk, dv])."""
    from paddle_tpu_torch.nn import functional as F

    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.flash_attention_with_sparse_mask(
        *qkv, attn_mask_start_row_indices=rows, is_causal=True)
    out.backward(do)
    return out.detach(), [t.grad for t in qkv]


def functional_sparse_mask(torch, dev, report):
    """(a) ``flash_attention_with_sparse_mask`` at ``SPARSE_SHAPE``, bf16,
    causal, no start rows: one forward and backward must launch rows 2
    and 4 once each by counter (the ``sparse_mask`` path) and
    ``flash_fwd_tc_kernel``, ``flash_bwd_dq_tc_kernel`` and
    ``flash_bwd_dkv_tc_kernel`` once each a call by name (over
    ``SPARSE_PROFILED`` profiled calls). Each kernel is held
    against its plain version on the same inputs at ``tolerance(bf16,
    1e-4)``: the output against the call on the plain versions, the
    gradients against the call whose backward alone is the plain version
    (it reads the kernel forward's output and lse, as the kernel
    backward does). With start rows it takes the plain masked path (no port
    kernel) and is held in fp32 against ``F.scaled_dot_product_attention``
    with the same visibility as a boolean mask (1e-4). Both calls timed.
    Returns the numbers."""
    b, s, h, d = SPARSE_SHAPE
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(bf16)
                   for _ in range(4))
    what = f"[{b},{s},{h},{d}] bf16 causal"
    torch.cuda.synchronize()
    reset_counts()
    out, grads = sparse_mask_call(torch, q, k, v, do)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {key: 0 for key in counts}
    want.update(flash=1, flash_bwd=1)
    log(f"  flash_attention_with_sparse_mask {what}, no start rows: "
        f"launches {counts}")
    check(counts == want, f"sparse-mask call launches {counts}, want {want}")
    record_launches(report, "sparse_mask", counts)
    # the route by name over SPARSE_PROFILED calls: the profile of one
    # call lost its dkv launch in each of three recordings of one run, so
    # one launch of each kernel lost to the profiler is admitted and a
    # second one a call is not (the counters above show one launch each)
    from torch.autograd import DeviceType

    n = SPARSE_PROFILED
    recorded(lambda: {e.key: e.count for e in profiled(
        lambda: sparse_mask_call(torch, q, k, v, do), n)
        if e.device_type == DeviceType.CUDA},
        lambda pk: pk,
        lambda pk: check_flash_route(pk, {"fwd": n, "dq": n, "dkv": n},
                                     "flash_attention_with_sparse_mask",
                                     lost=1),
        "flash_attention_with_sparse_mask")
    # each kernel against its plain version on the same inputs: the
    # forward on q, k, v; the backward on the kernel forward's out and lse
    with plain_flash():
        rout, _ = sparse_mask_call(torch, q, k, v, do)
    fa = sys.modules["paddle_tpu_torch.ops.cuda.flash_attention"]
    saved = fa._flash_bwd_kernel
    fa._flash_bwd_kernel = fa._flash_bwd_reference
    try:
        _, rgrads = sparse_mask_call(torch, q, k, v, do)
    finally:
        fa._flash_bwd_kernel = saved
    tol = tolerance(bf16, 1e-4)
    e_out, sh = close_err(out, rout, *tol)
    res = [close_err(a, r, *tol) for a, r in zip(grads, rgrads)]
    log(f"  ... against the plain versions: out err {e_out:.3g} ({sh:.3g} "
        f"of the tolerance), "
        + ", ".join(f"{n} err {e:.3g} ({x:.3g})"
                    for n, (e, x) in zip(("dq", "dk", "dv"), res)))
    check(sh <= 1.0 and all(x <= 1.0 for _, x in res),
          "flash_attention_with_sparse_mask differs from the plain versions")
    del rout, rgrads, out, grads
    ms = time_ms(lambda: sparse_mask_call(torch, q, k, v, do), iters=10)
    rows = sparse_start_rows(torch, dev, b, h, s, 22)
    reset_counts()
    sparse_mask_call(torch, q, k, v, do, rows)
    torch.cuda.synchronize()
    check(not any(read_counts().values()),
          f"the start-rows call launched a port kernel: {read_counts()}")
    ms_rows = time_ms(lambda: sparse_mask_call(torch, q, k, v, do, rows),
                      iters=3, warmup=1)
    log(f"  forward + backward {ms:.3f} ms without start rows (rows 2 and "
        f"4), {ms_rows:.3f} ms with them (the [B, H, S, S] mask, plain "
        f"masked path); {smi_line()}")
    # the start rows in fp32 against a boolean-mask composition
    f32 = [t.float() for t in (q, k, v, do)]
    out, grads = sparse_mask_call(torch, *f32, rows)
    i = torch.arange(s, device=dev)
    seen = (i[:, None] >= i[None, :]) & (i[:, None] < rows[:, :, None, :])
    qkv = [t.detach().transpose(1, 2).requires_grad_() for t in f32[:3]]
    ref = torch.nn.functional.scaled_dot_product_attention(
        *qkv, attn_mask=seen).transpose(1, 2)
    ref.backward(f32[3])
    tol = tolerance(torch.float32, 1e-4)
    e32, sh32 = close_err(out, ref.detach(), *tol)
    res32 = [close_err(a, r.grad.transpose(1, 2), *tol)
             for a, r in zip(grads, qkv)]
    log(f"  start rows, fp32 against F.scaled_dot_product_attention with the "
        f"same visibility: out err {e32:.3g}, grads "
        + ", ".join(f"{e:.3g}" for e, _ in res32) + " (tol 1e-4)")
    check(sh32 <= 1.0 and all(x <= 1.0 for _, x in res32),
          "flash_attention_with_sparse_mask with start rows differs in fp32")
    del out, grads, ref, qkv, f32, seen
    torch.cuda.empty_cache()
    return dict(shape=list(SPARSE_SHAPE), dtype="bfloat16", ms=ms,
                start_rows_ms=ms_rows, max_abs_err=e_out,
                grad_errs=[e for e, _ in res], fp32_start_rows_err=e32,
                launches=counts)


def _csr_pattern(torch, g, b, h, s):
    """A CSR pattern (offsets [B, H, S + 1], columns [B, H, nnz]) with the
    diagonal and about a third of the other entries in every row."""
    rows = [[sorted(set(torch.nonzero(torch.rand(s, generator=g) < 0.35)
                        .flatten().tolist()) | {r}) for r in range(s)]
            for _ in range(b * h)]
    nnz = max(sum(len(c) for c in bh) for bh in rows)
    offs = torch.zeros(b * h, s + 1, dtype=torch.int32)
    cols = torch.zeros(b * h, nnz, dtype=torch.int32)
    for n, bh in enumerate(rows):
        flat = [c for r in bh for c in r]
        offs[n, 1:] = torch.tensor([len(r) for r in bh]).cumsum(0)
        cols[n, :len(flat)] = torch.tensor(flat)
    return offs.reshape(b, h, s + 1), cols.reshape(b, h, nnz)


def _functional_cases(torch, F):
    """(name, function, make(g) -> (arguments, keyword arguments, indices
    of the float arguments whose gradient is compared)), inputs drawn on
    the CPU from the generator ``g``. Every new function of
    ``nn.functional`` in fp32 at a small size."""
    def rn(g, *shape, lo=None, hi=None):
        x = torch.randn(*shape, generator=g)
        return x if lo is None else lo + (hi - lo) * torch.rand(
            *shape, generator=g)

    def ri(g, hi, *shape):
        return torch.randint(0, hi, shape, generator=g)

    def pooled(g, nd, **kw):
        x = rn(g, *((2, 3) + (8,) * nd))
        return getattr(F, f"max_pool{nd}d")(x, return_mask=True, **kw)

    def inplace(name):
        return lambda x, **kw: getattr(F, name)(x * 1.0, **kw)

    def sparse(g):
        q, k, v = (rn(g, 2, 2, 16, 8) for _ in range(3))
        offs, cols = _csr_pattern(torch, g, 2, 2, 16)
        kpm = torch.zeros(2, 16)
        kpm[0, -3:] = -1e9
        return [q, k, v, offs, cols], dict(key_padding_mask=kpm), (0, 1, 2)

    def ctc(g):
        labels = ri(g, 4, 3, 3) + 1
        return ([rn(g, 12, 3, 5), labels, torch.tensor([12, 9, 11]),
                 torch.tensor([3, 0, 2])], dict(reduction="none"), (0,))

    def adaptive(g):
        return ([rn(g, 9, 6), ri(g, 12, 9), rn(g, 6, 6),
                 [(rn(g, 6, 3), rn(g, 3, 4)), (rn(g, 6, 2), rn(g, 2, 4))],
                 [4, 8, 12]], {}, (0, 2))

    def unpool(nd, **kw):
        def make(g):
            out, mask = pooled(g, nd, **kw)
            return [out, mask], kw, (0,)
        return make

    return [
        ("pad reflect NCHW", F.pad, lambda g: (
            [rn(g, 2, 3, 6, 7)], dict(pad=[2, 1, 3, 2], mode="reflect"),
            (0,))),
        ("pad replicate NHWC", F.pad, lambda g: (
            [rn(g, 2, 6, 7, 3)], dict(pad=[3, 1, 2, 2], mode="replicate",
                                      data_format="NHWC"), (0,))),
        ("pad circular full form", F.pad, lambda g: (
            [rn(g, 3, 2, 5)], dict(pad=[1, 2, 0, 1, 4, 3],
                                   mode="circular"), (0,))),
        ("pad constant", F.pad, lambda g: (
            [rn(g, 2, 3, 5)], dict(pad=[1, 2], value=0.5), (0,))),
        ("cosine_similarity", F.cosine_similarity, lambda g: (
            [rn(g, 6, 9), rn(g, 6, 9)], {}, (0, 1))),
        ("bilinear", F.bilinear, lambda g: (
            [rn(g, 5, 3), rn(g, 5, 4), rn(g, 6, 3, 4), rn(g, 1, 6)], {},
            (0, 1, 2, 3))),
        ("label_smooth", F.label_smooth, lambda g: (
            [torch.eye(6)[ri(g, 6, 8)]], dict(epsilon=0.2), (0,))),
        *[(f"{n}", inplace(n), lambda g, kw=kw: ([rn(g, 5, 6)], kw, (0,)))
          for n, kw in (("elu_", dict(alpha=0.7)),
                        ("hardtanh_", dict(min=-0.5, max=0.8)),
                        ("leaky_relu_", dict(negative_slope=0.2)),
                        ("softmax_", dict(axis=0)), ("tanh_", {}),
                        ("thresholded_relu_", dict(threshold=0.3)))],
        ("sparse_attention", F.sparse_attention, sparse),
        ("flash_attention_with_sparse_mask fp32",
         F.flash_attention_with_sparse_mask, lambda g: (
             [rn(g, 2, 64, 2, 64) * 0.5 for _ in range(3)], {}, (0, 1, 2))),
        ("flash_attention_with_sparse_mask start rows",
         F.flash_attention_with_sparse_mask, lambda g: (
             [rn(g, 2, 64, 2, 64) * 0.5 for _ in range(3)]
             + [torch.clamp(torch.arange(64) + 1 + ri(g, 64, 2, 2, 64),
                            max=64).int()], {}, (0, 1, 2))),
        ("ctc_loss", F.ctc_loss, ctc),
        ("rnnt_loss", F.rnnt_loss, lambda g: (
            [rn(g, 2, 6, 4, 6), ri(g, 5, 2, 3) + 1, torch.tensor([6, 4]),
             torch.tensor([3, 1])], dict(reduction="none"), (0,))),
        ("hsigmoid_loss", F.hsigmoid_loss, lambda g: (
            [rn(g, 8, 4), ri(g, 7, 8, 1), 7, rn(g, 6, 4), rn(g, 6, 1)], {},
            (0, 3, 4))),
        ("hsigmoid_loss custom", F.hsigmoid_loss, lambda g: (
            [rn(g, 4, 5), torch.arange(4), 6, rn(g, 6, 5), rn(g, 6, 1),
             torch.tensor([[0, 1, 3], [0, 2, -1], [0, 1, 4], [0, 2, 5]]),
             ri(g, 2, 4, 3)], {}, (0, 3, 4))),
        ("poisson_nll_loss", F.poisson_nll_loss, lambda g: (
            [rn(g, 5, 4), rn(g, 5, 4, lo=0.0, hi=4.0)],
            dict(full=True, reduction="none"), (0,))),
        ("gaussian_nll_loss", F.gaussian_nll_loss, lambda g: (
            [rn(g, 6, 3), rn(g, 6, 3), rn(g, 6, 3, lo=0.01, hi=2.0)],
            dict(full=True, reduction="sum"), (0, 1, 2))),
        ("multi_margin_loss", F.multi_margin_loss, lambda g: (
            [rn(g, 6, 5), ri(g, 5, 6)], dict(p=2, weight=rn(
                g, 5, lo=0.5, hi=2.0), reduction="none"), (0,))),
        ("triplet_margin_with_distance_loss",
         F.triplet_margin_with_distance_loss, lambda g: (
             [rn(g, 5, 6), rn(g, 5, 6), rn(g, 5, 6)], dict(swap=True,
                                                           margin=2.0),
             (0, 1, 2))),
        ("dice_loss", F.dice_loss, lambda g: (
            [torch.softmax(rn(g, 6, 4), -1), ri(g, 4, 6, 1)], {}, (0,))),
        ("pairwise_distance", F.pairwise_distance, lambda g: (
            [rn(g, 4, 7), rn(g, 4, 7)], dict(p=3.0), (0, 1))),
        ("margin_cross_entropy", F.margin_cross_entropy, lambda g: (
            [torch.tanh(rn(g, 6, 8)), ri(g, 8, 6, 1)],
            dict(return_softmax=True, scale=8.0, reduction="none"), (0,))),
        ("adaptive_log_softmax_with_loss",
         F.adaptive_log_softmax_with_loss, adaptive),
        ("sequence_mask", F.sequence_mask, lambda g: (
            [torch.tensor([3, 0, 5, 1])], dict(maxlen=6), ())),
        ("max_unpool1d", F.max_unpool1d, unpool(1, kernel_size=3, stride=2)),
        ("max_unpool2d", F.max_unpool2d, unpool(2, kernel_size=2)),
        ("max_unpool3d", F.max_unpool3d, unpool(3, kernel_size=2)),
        ("lp_pool1d", F.lp_pool1d, lambda g: (
            [rn(g, 2, 3, 11, lo=0.1, hi=2.0)], dict(
                norm_type=3, kernel_size=3, stride=2, ceil_mode=True),
            (0,))),
        ("lp_pool2d", F.lp_pool2d, lambda g: (
            [rn(g, 2, 3, 8, 7, lo=0.1, hi=2.0)], dict(
                norm_type=2, kernel_size=2), (0,))),
        ("fractional_max_pool2d", F.fractional_max_pool2d, lambda g: (
            [rn(g, 2, 3, 11, 9)], dict(output_size=(4, 3), random_u=0.3,
                                       return_mask=True), (0,))),
        ("fractional_max_pool3d", F.fractional_max_pool3d, lambda g: (
            [rn(g, 1, 2, 8, 8, 8)], dict(output_size=3, kernel_size=2,
                                         random_u=0.9), (0,))),
        ("affine_grid", F.affine_grid, lambda g: (
            [rn(g, 2, 2, 3)], dict(out_shape=[2, 3, 5, 4],
                                   align_corners=False), (0,))),
        ("grid_sample bilinear reflection", F.grid_sample, lambda g: (
            [rn(g, 2, 3, 5, 7), rn(g, 2, 4, 6, 2, lo=-1.4, hi=1.4)],
            dict(padding_mode="reflection", align_corners=False), (0, 1))),
        ("grid_sample nearest zeros", F.grid_sample, lambda g: (
            [rn(g, 2, 3, 5, 7), rn(g, 2, 4, 6, 2, lo=-1.4, hi=1.4)],
            dict(mode="nearest"), (0,))),
        ("temporal_shift", F.temporal_shift, lambda g: (
            [rn(g, 6, 8, 3, 4)], dict(seg_num=3), (0,))),
        ("gather_tree", F.gather_tree, lambda g: (
            [ri(g, 50, 5, 3, 4), ri(g, 4, 5, 3, 4)], {}, ())),
    ]


def _moved(value, dev, grad=False):
    """A copy of ``value`` (tensors in lists and tuples too) on ``dev``,
    a leaf that requires grad where ``grad``."""
    import torch

    if isinstance(value, torch.Tensor):
        t = value.detach().to(dev, copy=True)
        return t.requires_grad_() if grad else t
    if isinstance(value, (list, tuple)):
        return type(value)(_moved(v, dev) for v in value)
    return value


def functional_card_vs_cpu(torch, dev, report):
    """(b) Every new function of ``nn.functional`` (``_functional_cases``)
    in fp32, TF32 off: forward, and the backward of ``sum(out * w)``
    (``w`` fixed random weights), on the card against the same call on
    the CPU: outputs within 1e-5 of their own max |value| (absolute below
    1; integer outputs equal), gradients within 1e-4 of their own max
    |g|. The card's backward runs twice from one state; the functions
    whose gradients differ between the runs are printed (not a failure:
    torch names no deterministic path for some). The dropouts, which
    draw from a generator on the card, are held within the card: one
    seed twice equal bit for bit, ``p = 0`` the identity. Returns the
    numbers."""
    from paddle_tpu_torch.nn import functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst_out, worst_grad, differ, failed = (0.0, ""), (0.0, ""), [], []
    for name, fn, make in _functional_cases(torch, F):
        g = torch.Generator().manual_seed(sum(map(ord, name)))
        args, kw, grads = make(g)
        weights = []

        def run(device):
            xs = [_moved(a, device, i in grads) for i, a in enumerate(args)]
            out = fn(*xs, **{k: _moved(v, device) for k, v in kw.items()})
            outs = list(out) if isinstance(out, tuple) else [out]
            if not weights:
                weights.extend(torch.randn(o.shape, generator=g)
                               for o in outs)
            if grads:
                sum((o * w.to(device)).sum() for o, w in zip(
                    outs, weights) if o.is_floating_point()).backward()
            return ([o.detach().cpu() for o in outs],
                    [xs[i].grad.cpu() for i in grads])

        c_out, c_grad = run("cpu")
        d_out, d_grad = run(dev)
        _, d_grad2 = run(dev)
        for got, want in zip(d_out, c_out):
            if not want.is_floating_point():
                if not torch.equal(got, want):
                    failed.append(f"{name} output")
                continue
            err = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1.0)
            worst_out = max(worst_out, (err, name))
            if err > 1e-5:
                failed.append(f"{name} output {err:.3g}")
        for i, got, want in zip(grads, d_grad, c_grad):
            err = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1.0)
            worst_grad = max(worst_grad, (err, name))
            if err > 1e-4:
                failed.append(f"{name} gradient {i} {err:.3g}")
        if not all(torch.equal(a, b) for a, b in zip(d_grad, d_grad2)):
            differ.append(name)
    n_cases = len(_functional_cases(torch, F))
    log(f"  {n_cases} functions in fp32, card against CPU: worst output "
        f"{worst_out[0]:.3g} of its max ({worst_out[1]}; tol 1e-5), worst "
        f"gradient {worst_grad[0]:.3g} ({worst_grad[1]}; tol 1e-4)")
    log(f"  backward twice from one state on the card: gradients differ for "
        f"{differ or 'none'}")
    check(not failed, f"functional card vs CPU: {failed}")
    dropouts = {}
    for name in ("dropout2d", "dropout3d", "alpha_dropout",
                 "feature_alpha_dropout"):
        x = torch.randn(8, 16, *((2, 4, 4) if name == "dropout3d"
                                 else (4, 4)), device=dev)
        fn = getattr(F, name)
        a = fn(x, p=0.3, generator=torch.Generator(dev).manual_seed(4))
        b = fn(x, p=0.3, generator=torch.Generator(dev).manual_seed(4))
        dropouts[name] = bool(torch.equal(a, b)
                              and torch.equal(fn(x, p=0.0), x)
                              and not torch.equal(a, x))
    log(f"  dropouts on the card, one seed twice equal, p = 0 the identity: "
        f"{dropouts}")
    check(all(dropouts.values()), f"dropouts on the card: {dropouts}")
    return dict(cases=n_cases, worst_out=worst_out[0],
                worst_grad=worst_grad[0], grads_differ=differ)


def phase_functional(torch, dev, report):
    """The ``[functional]`` phase: ``functional_sparse_mask`` (rows 2 and
    4 from ``flash_attention_with_sparse_mask``) and
    ``functional_card_vs_cpu``."""
    run_parts(torch, dev, report, "functional", "functional", (
        ("sparse_mask", functional_sparse_mask),
        ("card_vs_cpu", functional_card_vs_cpu)))


# ---------------------------------------------------------------------------
# [vision]: the vision model zoo trained on the card
# ---------------------------------------------------------------------------
#: timed steps per family (and per mode in ``static_vs_eager``), and the
#: passes of the backward-determinism check
VISION_STEPS, VISION_RUNS = 3, 2
#: the families without batch norm diverge at lr 0.1 (fp32 on the CPU,
#: batch 8 at 224 x 224: AlexNet 8.7, 115, 2.4e7, 1.7e31, NaN; VGG-16,
#: SqueezeNet 1.1 and GoogLeNet NaN by the fourth or fifth step); they
#: take 0.01, their papers' rate
VISION_LR_NO_BN = 0.01

#: (label, constructor, its arguments, batch, image side, channels,
#: learning rate, the fp32 check's smallest configuration: (constructor,
#: arguments, input shape, mode of the gradients, gradient tolerance[,
#: dtype]). ``vgg11`` is checked in fp64 at 64 x 64 (its 7 x 7 pool takes
#: unequal windows from a 2 x 2 map): in fp32 its max pools' near-ties
#: route gradients differently on the card and the CPU (one run:
#: ``features.6.weight`` 0.93% of its max |g| apart at 224 x 224, the
#: logits 1.2e-6).
VISION_FAMILIES = (
    ("LeNet", "LeNet", {}, 256, 28, 1, VISION_LR_NO_BN,
     ("LeNet", {}, (2, 1, 28, 28), "train", 1e-4)),
    ("AlexNet", "alexnet", {}, 128, 224, 3, VISION_LR_NO_BN,
     ("alexnet", dict(dropout=0.0), (1, 3, 224, 224), "train", 1e-4)),
    ("VGG-16", "vgg16", {}, 128, 224, 3, VISION_LR_NO_BN,
     ("vgg11", {}, (1, 3, 64, 64), "train", 1e-4, "float64")),
    ("SqueezeNet 1.1", "squeezenet1_1", {}, 128, 224, 3, VISION_LR_NO_BN,
     ("squeezenet1_1", {}, (2, 3, 64, 64), "train", 1e-4)),
    ("MobileNetV1", "mobilenet_v1", {}, 128, 224, 3, 0.1,
     ("mobilenet_v1", dict(scale=0.25), (2, 3, 64, 64), "eval", 1e-4)),
    ("MobileNetV2", "mobilenet_v2", {}, 128, 224, 3, 0.1,
     ("mobilenet_v2", dict(scale=0.25), (2, 3, 64, 64), "eval", 1e-4)),
    ("MobileNetV3-Large", "mobilenet_v3_large", {}, 128, 224, 3, 0.1,
     ("mobilenet_v3_small", dict(scale=0.5), (2, 3, 64, 64), "eval",
      1e-4)),
    ("ShuffleNetV2 x1.0", "shufflenet_v2_x1_0", {}, 128, 224, 3, 0.1,
     ("shufflenet_v2_x0_25", {}, (2, 3, 64, 64), "eval", 1e-4)),
    ("DenseNet-121", "densenet121", {}, 128, 224, 3, 0.1,
     ("densenet121", {}, (2, 3, 64, 64), "eval", 1e-4)),
    ("GoogLeNet", "googlenet", {}, 128, 224, 3, VISION_LR_NO_BN,
     ("googlenet", {}, (2, 3, 64, 64), "train", 1e-4)),
    ("InceptionV3", "inception_v3", {}, 128, 299, 3, 0.1,
     ("inception_v3", {}, (2, 3, 139, 139), "eval", 1e-4)),
)


def vision_loss(F, out, y):
    """fp32 logits into cross-entropy; GoogLeNet's training tuple as
    ``out + 0.3 * (aux1 + aux2)``."""
    if isinstance(out, tuple):
        main, aux1, aux2 = (F.cross_entropy(o.float(), y) for o in out)
        return main + 0.3 * (aux1 + aux2)
    return F.cross_entropy(out.float(), y)


def conv_linear_flops(torch, model, x):
    """Forward FLOPs of ``model`` on ``x`` counted from its convolutions
    (2 x output entries x (in / groups) x kernel) and ``nn.Linear``s (2 x
    output entries x in), one no-grad training-mode forward through
    hooks (it updates batch norm's running statistics once and draws
    dropout from the model's generator)."""
    total = [0]

    def conv(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()

    def linear(mod, inp, out):
        total[0] += 2 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(
        conv if isinstance(m, torch.nn.Conv2d) else linear)
        for m in model.modules()
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


class VisionTrain(ResnetTrain):
    """One family of the zoo in ``phase_model_train``: its usual
    constructor at full width in bf16, ``(batch, channels, side, side)``
    random images and labels from a seeded generator, fp32 logits into
    cross-entropy, ``Momentum(lr, 0.9, multi_precision=True)``, dropout
    active (the model's ``dropout_generator``). No kernel of the port, as
    ResNet-50 (``ResnetTrain``). MFU from ``conv_linear_flops`` x 3. The
    fp32 check is the family's smallest configuration on the card against
    the same model and weights on the CPU (``fp32_check``)."""

    tag, to_static, steps = "vision", True, VISION_STEPS

    def __init__(self, label, ctor, kw, batch, side, channels, lr, small):
        self.label, self.ctor, self.kw = label, ctor, kw
        self.batch_size, self.side, self.channels = batch, side, channels
        self.lr, self.small_cfg = lr, small

    def model(self, torch, dev, bf16=True, layers=None):
        from paddle_tpu_torch.vision import models

        model = getattr(models, self.ctor)(device=dev, seed=0, **self.kw)
        return model.to(torch.bfloat16) if bf16 else model

    def num_classes(self):
        return 10 if self.ctor == "LeNet" else 1000

    def batch(self, torch, cfg, dev):
        g = torch.Generator(device=dev).manual_seed(9)
        x = torch.rand(self.batch_size, self.channels, self.side, self.side,
                       generator=g, device=dev).to(torch.bfloat16)
        y = torch.randint(0, self.num_classes(), (self.batch_size,),
                          generator=g, device=dev)
        return x, y

    def loss(self, model, x, y):
        from paddle_tpu_torch.nn import functional as F

        return vision_loss(F, model(x), y)

    def opt(self, model):
        from paddle_tpu_torch.optimizer import Momentum

        return Momentum(learning_rate=self.lr, momentum=0.9,
                        parameters=model.parameters(), multi_precision=True)

    def generators(self, model):
        return [model.dropout_generator]

    def rates(self, dt, model, batch):
        import torch

        flops = conv_linear_flops(torch, model, batch[0][:1])
        ips = self.batch_size * self.steps / dt
        return dict(step_ms=dt / self.steps * 1e3, images_per_s=ips,
                    mfu=ips * 3 * flops / PEAK_FLOPS["bfloat16"],
                    fwd_gflop_per_image=flops / 1e9)

    def fp32_check(self, torch, dev, batch):
        """The smallest configuration in fp32 (TF32 off), weights drawn on
        the card and copied to a CPU model: with dropout off, the logits
        (training mode for the families without batch norm, eval mode
        for the others, whose few values a channel make training-mode
        gradients ill-conditioned) within 1e-5 of their max and every
        gradient of the loss within 1e-4 of its own max |g|; ``vgg11`` in
        fp64 (see ``VISION_FAMILIES``)."""
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.vision import models

        ctor, kw, shape, mode, grad_tol, *dt = self.small_cfg
        dtype = getattr(torch, dt[0] if dt else "float32")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = getattr(models, ctor)(num_classes=10, device=dev, seed=1,
                                     dtype=dtype, **kw)
        cpu = getattr(models, ctor)(num_classes=10, device="cpu",
                                    dtype=dtype, **kw)
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        g = torch.Generator().manual_seed(5)
        x = torch.randn(*shape, generator=g).to(dtype)
        y = torch.randint(0, 10, (shape[0],), generator=g)
        res = []
        for m, where in ((card, dev), (cpu, "cpu")):
            for mod in m.modules():
                if type(mod).__name__ == "Dropout":
                    mod.p = 0.0
            m.train(mode == "train")
            out = m(x.to(where))
            vision_loss(F, out, y.to(where)).backward()
            logits = out[0] if isinstance(out, tuple) else out
            res.append((logits.detach().cpu(),
                        {n: p.grad.cpu() for n, p in m.named_parameters()
                         if p.grad is not None}))
        (c_log, c_grads), (p_log, p_grads) = res
        out_err = float((c_log - p_log).abs().max()) / float(
            p_log.abs().max())
        worst = max((float((c_grads[n] - gp).abs().max())
                     / max(float(gp.abs().max()), 1e-30), n)
                    for n, gp in p_grads.items())
        log(f"  {dtype} {ctor} {kw or ''} at {list(shape)} ({mode} mode), card "
            f"against CPU: logits {out_err:.3g} of their max (tol 1e-5), "
            f"worst gradient {worst[1]} {worst[0]:.3g} of its max |g| (tol "
            f"{grad_tol:g}) over {len(p_grads)} gradients")
        check(out_err <= 1e-5, f"fp32 {ctor} logits, card vs CPU")
        check(worst[0] <= grad_tol, f"fp32 {ctor} gradient {worst[1]}")
        del card, cpu, res
        torch.cuda.empty_cache()
        return dict(config=ctor, dtype=str(dtype), logits_share=out_err,
                    worst_grad_share=worst[0])


def phase_vision(torch, dev, report):
    """The ``[vision]`` phase: each family of ``VISION_FAMILIES``, first
    the backward's determinism at its full batch
    (``phase_backward_determinism``, ``VISION_RUNS`` passes each way),
    then its training step (``phase_model_train`` over ``VisionTrain``:
    ``VISION_STEPS`` timed steps, eager and captured)."""
    report["vision"] = {}
    for fam in VISION_FAMILIES:
        spec = VisionTrain(*fam)
        t0 = time.perf_counter()
        report["vision"][spec.label] = dict(
            determinism=phase_backward_determinism(torch, dev, report, spec,
                                                   runs=VISION_RUNS),
            train=phase_model_train(torch, dev, report, spec))
        log(f"  ({spec.label}: {time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# [detection]: the detection ops at published detectors' shapes
# ---------------------------------------------------------------------------
#: PaddleDetection configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.yml and
#: its _base_: images resized to a short side of 800 (long side at most
#: 1333) and padded to a multiple of 32, FPN levels P2-P6 (strides 4-64),
#: 256 channels, 3 anchors a position (ratios 0.5 / 1 / 2, size 32 at P2
#: doubling a level); RPN proposals 2000 before NMS and 1000 after, NMS
#: 0.7, no minimum size; the 1000 best of an image over the levels; 512
#: RoIs an image into RoIAlign (7 x 7, sampling ratio 0, aligned) over
#: P2-P5 (refer level 4, refer scale 224); 81 classes decoded with
#: variances 0.1 / 0.1 / 0.2 / 0.2, per-class NMS 0.5 after a 0.05 score
#: threshold, 100 kept
FRCNN = dict(images=2, hw=(800, 1344), strides=(4, 8, 16, 32, 64),
             channels=256, ratios=(0.5, 1.0, 2.0), size0=32, pre_nms=2000,
             post_nms=1000, nms=0.7, top=1000, rois=512, classes=81,
             score=0.05, class_nms=0.5, keep=100)
#: RoIPool (Fast R-CNN, VGG16's 512 channels) and PSRoIPool (R-FCN on VOC:
#: 7 x 7 x 21 channels) on the stride-16 map of one such image, 300 RoIs
POOLS = dict(channels=512, ps_classes=21, out=7, rois=300, stride=16)
#: configs/yolov3/yolov3_darknet53_270e_coco.yml: batch 8 at 608 x 608, 80
#: classes, heads at strides 32 / 16 / 8 with anchor masks [6, 7, 8],
#: [3, 4, 5], [0, 1, 2]; 50 ground truths an image with a gt_score;
#: YOLOv3Loss(ignore_thresh 0.7, label smoothing off); yolo_box
#: (conf_thresh 0.005, clip_bbox), then per-class NMS 0.45 over the
#: image's 1000 best
YOLO = dict(batch=8, side=608, classes=80, strides=(32, 16, 8),
            masks=((6, 7, 8), (3, 4, 5), (0, 1, 2)), gts=50, ignore=0.7,
            conf=0.005, nms=0.45, top=1000)
YOLO_ANCHORS = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326)
#: configs/ppyolo/ppyolo_r50vd_dcn_1x_coco.yml: DCNv2 in ResNet50-vd's
#: stage 5 at 608 (x [8, 512, 19, 19], a 3 x 3 weight [512, 512]), the
#: YOLOv3 heads decoded with scale_x_y 1.05, MatrixNMS(keep_top_k 100,
#: score_threshold 0.01, post_threshold 0.01, nms_top_k -1,
#: background_label -1)
PPYOLO = dict(batch=8, channels=512, side=19, scale_x_y=1.05, keep=100,
              score=0.01, post=0.01)
#: configs/ssd/ssd_vgg16_300_240e_voc.yml: six maps (38, 19, 10, 5, 3, 1)
#: of a 300 x 300 image with their steps, min / max sizes and ratios
#: (flip, min-max order): 8732 priors, encoded against 50 ground truths
SSD = dict(side=300, maps=(38, 19, 10, 5, 3, 1),
           steps=(8, 16, 32, 64, 100, 300),
           min_sizes=(30.0, 60.0, 111.0, 162.0, 213.0, 264.0),
           max_sizes=(60.0, 111.0, 162.0, 213.0, 264.0, 315.0),
           ratios=((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0,),
                   (2.0,)), gts=50, priors=8732)
#: device-timed calls of each op, and wall-timed runs of each path
DETECTION_ITERS, DETECTION_PATH_RUNS = 5, 3


def host_syncs(torch, fn):
    """How often a call of ``fn`` made the host wait for the card,
    counted by ``torch.cuda.set_sync_debug_mode``'s warnings (a
    device-to-host copy, ``item``, ``tolist``, a copy from pageable
    memory)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in seen)


def wall_ms(torch, fn, runs=DETECTION_PATH_RUNS):
    """The median host-clock ms of ``fn`` (ended by a synchronise) over
    ``runs`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def op_numbers(torch, label, fn, inputs, grad=False, syncs=False):
    """``fn(*inputs)``'s device ms and, with ``grad``, those of the
    backward into ``inputs`` of its (first) output for a fixed random
    gradient (on a kept graph); that backward run twice from one state
    must give the same bits. With ``syncs``, the host waits a call."""
    out = dict(fwd_ms=device_ms(lambda: fn(*inputs), iters=DETECTION_ITERS,
                                warmup=1))
    if grad:
        res = _first(fn(*inputs))
        gen = torch.Generator(device=res.device).manual_seed(1)
        g = torch.randn(res.shape, device=res.device, generator=gen)
        bwd = library_grad(torch, lambda *a: _first(fn(*a)), inputs, g)
        out["bwd_ms"] = device_ms(bwd, iters=DETECTION_ITERS, warmup=1)
        same = all(torch.equal(a, b) for a, b in zip(bwd(), bwd()))
        out["backward_bit_equal"] = same
        check(same, f"{label}: two backward passes from one state differ")
    if syncs:
        out["host_syncs"] = host_syncs(torch, lambda: fn(*inputs))
    log(f"  {label}: forward {out['fwd_ms']:.3f} ms"
        + (f", backward {out['bwd_ms']:.3f} ms (two passes bit-equal)"
           if grad else "")
        + (f", {out['host_syncs']} host syncs a call" if syncs else ""))
    return out


def _anchor_table(np, hw, stride, size, ratios):
    """Anchors [h, w, A, 4] of one FPN level centred on its cells, and
    unit variances: numpy, as the configuration's anchor generator."""
    h, w = hw
    ws = np.array([size / math.sqrt(r) for r in ratios], np.float32)
    hs = np.array([size * math.sqrt(r) for r in ratios], np.float32)
    cy, cx = np.meshgrid((np.arange(h) + 0.5) * stride,
                         (np.arange(w) + 0.5) * stride, indexing="ij")
    cx, cy = cx[:, :, None], cy[:, :, None]
    table = np.stack([cx - ws / 2, cy - hs / 2, cx + ws / 2, cy + hs / 2],
                     -1).astype(np.float32)
    return table, np.ones_like(table)


def _level_hw(stride):
    h, w = FRCNN["hw"]
    return -(-h // stride), -(-w // stride)


def detection_two_stage(torch, dev, report):
    """Faster R-CNN R50-FPN's (``FRCNN``) detection ops on synthetic FPN
    maps and RPN outputs: per level ``generate_proposals``, the 1000 best
    of each image, ``distribute_fpn_proposals`` of 512 an image,
    ``roi_align`` on P2-P5 with its backward, ``box_coder``'s decode of
    1000 x 81 and the per-class ``nms``; then ``roi_pool`` and
    ``psroi_pool`` at the stride-16 map (``POOLS``). Each op's device ms
    (forward, backward), host syncs a call of each selection op, the
    path's wall ms with the backward, peak memory."""
    import numpy as np

    from paddle_tpu_torch.vision import ops as V

    cfg, g = FRCNN, torch.Generator(device=dev).manual_seed(21)
    n, levels = cfg["images"], range(len(cfg["strides"]))
    img = torch.tensor([cfg["hw"]] * n, dtype=torch.float32, device=dev)
    rpn = []
    for lv in levels:
        stride = cfg["strides"][lv]
        hw = _level_hw(stride)
        anc, var = _anchor_table(np, hw, stride, cfg["size0"] << lv,
                                 cfg["ratios"])
        a = len(cfg["ratios"])
        rpn.append((torch.rand(n, a, *hw, generator=g, device=dev),
                    0.3 * torch.randn(n, 4 * a, *hw, generator=g, device=dev),
                    torch.from_numpy(anc).to(dev),
                    torch.from_numpy(var).to(dev)))
    feats = [torch.randn(n, cfg["channels"], *_level_hw(s), generator=g,
                         device=dev, requires_grad=True)
             for s in cfg["strides"][:4]]
    out = {}

    def proposals(lv):
        s, d, anc, var = rpn[lv]
        return V.generate_proposals(
            s, d, img, anc, var, pre_nms_top_n=cfg["pre_nms"],
            post_nms_top_n=cfg["post_nms"], nms_thresh=cfg["nms"],
            min_size=0.0, return_rois_num=True)

    def best_per_image():
        """The ``top`` best proposals of each image over the levels."""
        per = [proposals(lv) for lv in levels]
        counts = torch.stack([p[2] for p in per]).tolist()
        rois, probs = [], []
        for i in range(n):
            r = torch.cat([p[0][sum(c[:i]):sum(c[:i + 1])]
                           for p, c in zip(per, counts)])
            s = torch.cat([p[1][sum(c[:i]):sum(c[:i + 1])]
                           for p, c in zip(per, counts)])
            top = torch.topk(s, min(cfg["top"], s.numel())).indices
            rois.append(r[top])
            probs.append(s[top])
        return rois, probs

    def roi_features(rois):
        """512 RoIs an image through the levels' RoIAlign, restored to
        their order."""
        sel = torch.cat([r[:cfg["rois"]] for r in rois])
        num = torch.tensor([min(cfg["rois"], r.shape[0]) for r in rois],
                           dtype=torch.int32, device=dev)
        outs, restore, nums = V.distribute_fpn_proposals(
            sel, 2, 5, 4, 224, rois_num=num)
        pooled = [V.roi_align(f, b, k, 7, 1.0 / s, sampling_ratio=0,
                              aligned=True)
                  for f, b, k, s in zip(feats, outs, nums, cfg["strides"])]
        return torch.cat(pooled)[restore[:, 0].long()]

    def detections(rois, gk):
        """Decode 81 classes around each image's proposals, then per-class
        NMS after the score threshold."""
        kept = []
        for r in rois:
            deltas = 0.5 * torch.randn(r.shape[0], cfg["classes"], 4,
                                       generator=gk, device=dev)
            logits = torch.randn(r.shape[0], cfg["classes"], generator=gk,
                                 device=dev) * 3.0
            boxes = V.box_coder(r, [0.1, 0.1, 0.2, 0.2], deltas,
                                "decode_center_size", False, axis=1)
            scores = torch.softmax(logits, -1)[:, 1:]
            ri, ci = torch.nonzero(scores > cfg["score"], as_tuple=True)
            kept.append(V.nms(boxes[ri, ci + 1], cfg["class_nms"],
                              scores[ri, ci], ci + 1,
                              list(range(1, cfg["classes"])), cfg["keep"]))
        return kept

    rois, probs = best_per_image()
    check(all(r.shape == (cfg["top"], 4) and bool(torch.isfinite(r).all())
              for r in rois), "two-stage: 1000 finite proposals an image")
    for lv in levels:
        out[f"generate_proposals_P{lv + 2}"] = op_numbers(
            torch, f"generate_proposals P{lv + 2} {list(rpn[lv][0].shape)}",
            lambda lv=lv: proposals(lv), [], syncs=True)
    sel = torch.cat([r[:cfg["rois"]] for r in rois])
    num = torch.tensor([cfg["rois"]] * n, dtype=torch.int32, device=dev)
    out["distribute_fpn_proposals"] = op_numbers(
        torch, f"distribute_fpn_proposals {list(sel.shape)}",
        lambda b: V.distribute_fpn_proposals(b, 2, 5, 4, 224, rois_num=num),
        [sel], syncs=True)
    outs, restore, nums = V.distribute_fpn_proposals(sel, 2, 5, 4, 224,
                                                     rois_num=num)
    log(f"  RoIs a level (P2-P5): {[o.shape[0] for o in outs]}")
    for f, b, k, s in zip(feats, outs, nums, cfg["strides"]):
        out[f"roi_align_stride{s}"] = op_numbers(
            torch, f"roi_align {list(f.shape)} x {b.shape[0]} RoIs",
            lambda f, b=b, k=k, s=s: V.roi_align(f, b, k, 7, 1.0 / s, 0,
                                                 True),
            [f.detach()], grad=True)
    feats_all = roi_features(rois)
    check(feats_all.shape == (n * cfg["rois"], cfg["channels"], 7, 7)
          and bool(torch.isfinite(feats_all).all()),
          "two-stage: RoI features, 512 an image, finite")
    gk = torch.Generator(device=dev).manual_seed(5)
    deltas = 0.5 * torch.randn(cfg["top"], cfg["classes"], 4, generator=gk,
                               device=dev)
    out["box_coder_decode"] = op_numbers(
        torch, f"box_coder decode {list(deltas.shape)}",
        lambda d: V.box_coder(rois[0], [0.1, 0.1, 0.2, 0.2], d,
                              "decode_center_size", False, axis=1), [deltas])
    kept = detections(rois, gk)
    check(all(0 < k.numel() <= cfg["keep"] for k in kept),
          f"two-stage: 1-100 detections an image "
          f"({[k.numel() for k in kept]})")
    boxes = V.box_coder(rois[0], [0.1, 0.1, 0.2, 0.2], deltas,
                        "decode_center_size", False, axis=1)
    scores = torch.softmax(torch.randn(cfg["top"], cfg["classes"],
                                       generator=gk, device=dev) * 3.0, -1)
    ri, ci = torch.nonzero(scores[:, 1:] > cfg["score"], as_tuple=True)
    cand = (boxes[ri, ci + 1], scores[ri, ci + 1], ci + 1)
    out["class_nms"] = op_numbers(
        torch, f"per-class nms over {ri.numel()} candidates",
        lambda b: V.nms(b, cfg["class_nms"], cand[1], cand[2],
                        list(range(1, cfg["classes"])), cfg["keep"]),
        [cand[0]], syncs=True)
    out["class_nms"]["candidates"] = int(ri.numel())

    def path():
        rois, _ = best_per_image()
        roi_features(rois).backward(torch.ones(
            n * cfg["rois"], cfg["channels"], 7, 7, device=dev))
        detections(rois, torch.Generator(device=dev).manual_seed(5))

    torch.cuda.reset_peak_memory_stats(dev)
    out["path_ms"] = wall_ms(torch, path)
    out["path_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["path_host_syncs"] = host_syncs(torch, path)
    log(f"  Faster R-CNN path (proposals on 5 levels, 1000 an image, 512 "
        f"RoIs an image through RoIAlign and back, decode, per-class NMS): "
        f"{out['path_ms']:.1f} ms wall, {out['path_host_syncs']} host syncs, "
        f"peak {out['path_peak_bytes'] / 2**30:.2f} GiB")
    # RoIPool and PSRoIPool on the stride-16 map, 300 of image 0's RoIs
    hw = _level_hw(POOLS["stride"])
    ps_c = POOLS["ps_classes"] * POOLS["out"] ** 2
    x = torch.relu(torch.randn(1, POOLS["channels"], *hw, generator=g,
                               device=dev))
    xp = torch.randn(1, ps_c, *hw, generator=g, device=dev)
    b300 = rois[0][:POOLS["rois"]]
    k300 = torch.tensor([POOLS["rois"]], device=dev)
    scale = 1.0 / POOLS["stride"]
    out["roi_pool"] = op_numbers(
        torch, f"roi_pool {list(x.shape)} x {POOLS['rois']} RoIs",
        lambda x: V.roi_pool(x, b300, k300, POOLS["out"], scale), [x],
        grad=True, syncs=True)
    out["psroi_pool"] = op_numbers(
        torch, f"psroi_pool {list(xp.shape)} x {POOLS['rois']} RoIs",
        lambda x: V.psroi_pool(x, b300, k300, POOLS["out"], scale), [xp],
        grad=True)
    del feats, feats_all, x, xp
    torch.cuda.empty_cache()
    return out


def _yolo_heads(torch, dev, g, cfg, side):
    """Synthetic YOLO heads [batch, 3 * (5 + classes), s, s] a stride:
    objectness logits around -8 (most boxes under the confidence
    threshold, as a trained head's) with 50 confident cells an image,
    class logits around -6 with a hot class on those cells."""
    heads = []
    for stride in cfg["strides"]:
        s = side // stride
        x = torch.randn(cfg["batch"], 3, 5 + cfg["classes"], s, s,
                        generator=g, device=dev)
        x[:, :, 4] = x[:, :, 4] - 8.0
        x[:, :, 5:] = 1.5 * x[:, :, 5:] - 6.0
        cells = torch.randint(0, s * s, (cfg["batch"], 50), generator=g,
                              device=dev)
        hot = torch.randint(0, cfg["classes"], (cfg["batch"], 50),
                            generator=g, device=dev)
        flat = x.view(cfg["batch"], 3, 5 + cfg["classes"], s * s)
        bi = torch.arange(cfg["batch"], device=dev)[:, None]
        flat[bi, 0, 4, cells] = 3.0
        flat[bi, 0, 5 + hot, cells] = 4.0
        heads.append(x.reshape(cfg["batch"], -1, s, s))
    return heads


def _decode_heads(torch, V, heads, img, cfg, **kw):
    """``yolo_box`` of each head, concatenated: boxes [N, M, 4], scores
    [N, M, classes]."""
    boxes, scores = [], []
    for x, stride, mask in zip(heads, cfg["strides"], cfg["masks"]):
        anchors = [YOLO_ANCHORS[2 * m + k] for m in mask for k in (0, 1)]
        b, s = V.yolo_box(x, img, anchors, cfg["classes"], cfg["conf"],
                          stride, True, **kw)
        boxes.append(b)
        scores.append(s)
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def detection_one_stage(torch, dev, report):
    """YOLOv3-608 (``YOLO``): ``yolo_loss`` forward and backward on the
    three heads, ``yolo_box`` and per-class NMS over each image's 1000
    best; then PP-YOLO's (``PPYOLO``) ``deform_conv2d`` forward and
    backward at its DCN shape, ``yolo_box`` with ``scale_x_y`` and
    ``matrix_nms``. Device ms, host syncs, wall ms of the paths."""
    from paddle_tpu_torch.vision import ops as V

    cfg, g = YOLO, torch.Generator(device=dev).manual_seed(31)
    heads = _yolo_heads(torch, dev, g, cfg, cfg["side"])
    nb = cfg["batch"]
    gt = torch.cat([0.1 + 0.8 * torch.rand(nb, cfg["gts"], 2, generator=g,
                                           device=dev),
                    0.02 + 0.4 * torch.rand(nb, cfg["gts"], 2, generator=g,
                                            device=dev)], -1)
    label = torch.randint(0, cfg["classes"], (nb, cfg["gts"]), generator=g,
                          device=dev)
    score = 0.5 + 0.5 * torch.rand(nb, cfg["gts"], generator=g, device=dev)
    img = torch.full((nb, 2), cfg["side"], dtype=torch.int32, device=dev)
    out = {}

    def loss(x, stride, mask):
        return V.yolo_loss(x, gt, label, list(YOLO_ANCHORS), list(mask),
                           cfg["classes"], cfg["ignore"], stride,
                           gt_score=score, use_label_smooth=False)

    for x, stride, mask in zip(heads, cfg["strides"], cfg["masks"]):
        out[f"yolo_loss_stride{stride}"] = op_numbers(
            torch, f"yolo_loss {list(x.shape)}",
            lambda x, stride=stride, mask=mask: loss(x, stride, mask), [x],
            grad=True)
    boxes, scores = _decode_heads(torch, V, heads, img, cfg)
    m = 3 * sum((cfg["side"] // s) ** 2 for s in cfg["strides"])
    check(boxes.shape == (nb, m, 4) and bool(torch.isfinite(scores).all()),
          f"one-stage: yolo_box [{nb}, {m}, 4], finite")
    out["yolo_box"] = op_numbers(
        torch, "yolo_box, three heads",
        lambda: _decode_heads(torch, V, heads, img, cfg), [])

    def best_nms(b, s):
        top = torch.topk(s.reshape(-1), cfg["top"]).indices
        return V.nms(b[top // cfg["classes"]], cfg["nms"],
                     s.reshape(-1)[top], top % cfg["classes"],
                     list(range(cfg["classes"])), 100)

    out["class_nms"] = op_numbers(
        torch, "per-class nms over an image's 1000 best",
        lambda b: best_nms(b, scores[0]), [boxes[0]], syncs=True)

    def yolo_path():
        leaves = [h.detach().requires_grad_() for h in heads]
        sum(loss(x, s, m).sum() for x, s, m in zip(
            leaves, cfg["strides"], cfg["masks"])).backward()

    def decode_path():
        b, s = _decode_heads(torch, V, heads, img, cfg)
        return [best_nms(b[i], s[i]) for i in range(nb)]

    kept = decode_path()
    check(all(k.numel() > 0 for k in kept), "one-stage: detections an image")
    torch.cuda.reset_peak_memory_stats(dev)
    out["loss_path_ms"] = wall_ms(torch, yolo_path)
    out["loss_path_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["decode_path_ms"] = wall_ms(torch, decode_path)
    out["decode_path_host_syncs"] = host_syncs(torch, decode_path)
    log(f"  YOLOv3 loss over three heads with backward: "
        f"{out['loss_path_ms']:.1f} ms wall, peak "
        f"{out['loss_path_peak_bytes'] / 2**30:.2f} GiB; yolo_box + "
        f"per-class NMS of 8 images: {out['decode_path_ms']:.1f} ms wall, "
        f"{out['decode_path_host_syncs']} host syncs")
    # PP-YOLO
    pp = PPYOLO
    x = torch.randn(pp["batch"], pp["channels"], pp["side"], pp["side"],
                    generator=g, device=dev)
    w = torch.randn(pp["channels"], pp["channels"], 3, 3, generator=g,
                    device=dev) * (2.0 / (pp["channels"] * 9)) ** 0.5
    off = torch.randn(pp["batch"], 18, pp["side"], pp["side"], generator=g,
                      device=dev)
    msk = torch.sigmoid(torch.randn(pp["batch"], 9, pp["side"], pp["side"],
                                    generator=g, device=dev))
    bias = torch.zeros(pp["channels"], device=dev)
    out["deform_conv2d"] = op_numbers(
        torch, f"deform_conv2d {list(x.shape)}, weight {list(w.shape)}",
        lambda x, off, w, msk, bias: V.deform_conv2d(
            x, off, w, bias, padding=1, mask=msk),
        [x, off, w, msk, bias], grad=True)
    ppb, pps = _decode_heads(torch, V, heads, img, cfg,
                             scale_x_y=pp["scale_x_y"])
    pps = pps.transpose(1, 2).contiguous()

    def matrix(b):
        return V.matrix_nms(b, pps, pp["score"], pp["post"], -1, pp["keep"],
                            background_label=-1, normalized=False,
                            return_index=True)

    rows, _, per = matrix(ppb)
    check(rows.shape[1] == 6 and 0 < rows.shape[0] <= nb * pp["keep"],
          f"PP-YOLO: matrix_nms rows {list(rows.shape)}")
    out["matrix_nms"] = op_numbers(
        torch, f"matrix_nms {list(ppb.shape)} x {pps.shape[1]} classes",
        matrix, [ppb], syncs=True)
    out["matrix_nms"]["rows_an_image"] = per.tolist()

    def pp_path():
        b, s = _decode_heads(torch, V, heads, img, cfg,
                             scale_x_y=pp["scale_x_y"])
        return V.matrix_nms(b, s.transpose(1, 2), pp["score"], pp["post"],
                            -1, pp["keep"], background_label=-1)

    out["ppyolo_path_ms"] = wall_ms(torch, pp_path)
    log(f"  PP-YOLO yolo_box + matrix_nms of 8 images: "
        f"{out['ppyolo_path_ms']:.1f} ms wall")
    del heads, x, w, off, msk
    torch.cuda.empty_cache()
    return out


def detection_ssd(torch, dev, report):
    """SSD300's (``SSD``) priors over its six maps (8732) and their
    ``box_coder`` encoding against 50 ground truths."""
    from paddle_tpu_torch.vision import ops as V

    cfg = SSD
    image = torch.zeros(1, 3, cfg["side"], cfg["side"], device=dev)

    def priors():
        out = [V.prior_box(torch.zeros(1, 1, m, m, device=dev), image,
                           [mn], [mx], list(r), [0.1, 0.1, 0.2, 0.2],
                           flip=True, clip=True, steps=[st, st],
                           min_max_aspect_ratios_order=True)
               for m, st, mn, mx, r in zip(cfg["maps"], cfg["steps"],
                                           cfg["min_sizes"],
                                           cfg["max_sizes"], cfg["ratios"])]
        return (torch.cat([b.reshape(-1, 4) for b, _ in out]),
                torch.cat([v.reshape(-1, 4) for _, v in out]))

    boxes, var = priors()
    check(boxes.shape == (cfg["priors"], 4), f"SSD: {cfg['priors']} priors, "
          f"got {boxes.shape[0]}")
    g = torch.Generator(device=dev).manual_seed(41)
    xy = torch.rand(cfg["gts"], 2, generator=g, device=dev) * 0.7
    gt = torch.cat([xy, xy + 0.05 + 0.25 * torch.rand(
        cfg["gts"], 2, generator=g, device=dev)], 1)
    out = dict(priors=op_numbers(torch, "prior_box, six maps", priors, []))
    enc = V.box_coder(boxes, var, gt, "encode_center_size")
    check(enc.shape == (cfg["gts"], cfg["priors"], 4)
          and bool(torch.isfinite(enc).all()), "SSD: encoding finite")
    out["box_coder_encode"] = op_numbers(
        torch, f"box_coder encode {cfg['gts']} x {cfg['priors']}",
        lambda t: V.box_coder(boxes, var, t, "encode_center_size"), [gt],
        grad=True)
    return out


def _flat(out):
    """The tensors of an op's output (tuples and lists of tensors, None
    left out), in order."""
    if out is None:
        return []
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _distinct_scores(torch, g, *shape):
    """Scores in (0, 1), all distinct (the reference's selection sorts
    are numpy's; distinct scores fix the order)."""
    n = math.prod(shape)
    return ((torch.randperm(n, generator=g).float() + 0.5) / n).reshape(shape)


def _detection_cases(torch, V):
    """(name, function, make(generator) -> (inputs, indices of the inputs
    that take a gradient), selection?) for every op of ``vision.ops`` at
    a reduced size: a few RoIs, one or two images, narrow channels."""

    def boxes(g, n, size, over=0.2):
        a = (torch.rand(n, 2, generator=g) * (1 + 2 * over) - over) * size
        b = (torch.rand(n, 2, generator=g) * (1 + 2 * over) - over) * size
        return torch.cat([torch.minimum(a, b), torch.maximum(a, b)], 1)

    def ties(g, *shape):
        x = torch.randn(*shape, generator=g)
        return torch.relu(torch.round(x * 2) / 2)

    def rpn(g):
        s = _distinct_scores(torch, g, 1, 3, 8, 10)
        d = 0.3 * torch.randn(1, 12, 8, 10, generator=g)
        cy, cx = torch.meshgrid(torch.arange(8) * 8.0 + 4,
                                torch.arange(10) * 8.0 + 4, indexing="ij")
        size = torch.tensor([8.0, 16.0, 32.0])
        c = torch.stack([cx, cy], -1)[:, :, None, :]
        anc = torch.cat([c - size[:, None] / 2, c + size[:, None] / 2], -1)
        return [s, d, torch.tensor([[64.0, 80.0]]), anc, torch.ones_like(anc)]

    num1 = torch.tensor([6])
    return [
        ("roi_align", lambda x, b: V.roi_align(x, b, num1, 7, 0.25, 0, True),
         lambda g: ([torch.randn(1, 8, 24, 30, generator=g),
                     boxes(g, 6, 110.0)], [0, 1]), False),
        ("roi_align unaligned", lambda x, b: V.roi_align(
            x, b, torch.tensor([2, 4]), 3, 0.5, 2, False),
         lambda g: ([torch.randn(2, 4, 12, 14, generator=g),
                     boxes(g, 6, 26.0)], [0, 1]), False),
        ("roi_pool", lambda x, b: V.roi_pool(x, b, num1, 7, 1 / 16),
         lambda g: ([ties(g, 1, 8, 20, 25), boxes(g, 6, 380.0)], [0]),
         False),
        ("psroi_pool", lambda x, b: V.psroi_pool(x, b, num1, 7, 1 / 16),
         lambda g: ([torch.randn(1, 2 * 49, 20, 25, generator=g),
                     boxes(g, 6, 380.0)], [0]), False),
        ("deform_conv2d", lambda x, o, w, m, b: V.deform_conv2d(
            x, o, w, b, padding=1, mask=m),
         lambda g: ([torch.randn(2, 8, 9, 9, generator=g),
                     2 * torch.randn(2, 18, 9, 9, generator=g),
                     torch.randn(8, 8, 3, 3, generator=g) * 0.2,
                     torch.rand(2, 9, 9, 9, generator=g),
                     torch.randn(8, generator=g)], [0, 1, 2, 3, 4]), False),
        ("yolo_loss", lambda x, gt, lab, sc: V.yolo_loss(
            x, gt, lab, list(YOLO_ANCHORS), [3, 4, 5], 4, 0.7, 16,
            gt_score=sc),
         lambda g: ([torch.randn(2, 27, 8, 8, generator=g),
                     torch.cat([0.1 + 0.8 * torch.rand(2, 6, 2, generator=g),
                                0.05 + 0.4 * torch.rand(2, 6, 2, generator=g)],
                               -1),
                     torch.randint(0, 4, (2, 6), generator=g),
                     torch.rand(2, 6, generator=g)], [0]), False),
        ("yolo_box", lambda x, im: V.yolo_box(
            x, im, [10, 13, 16, 30, 33, 23], 4, 0.3, 16, True, scale_x_y=1.05),
         lambda g: ([2 * torch.randn(2, 27, 8, 8, generator=g),
                     torch.tensor([[128, 128], [100, 120]])], []), False),
        ("box_coder encode", lambda p, t: V.box_coder(
            p, [0.1, 0.1, 0.2, 0.2], t, "encode_center_size"),
         lambda g: ([boxes(g, 30, 1.0, 0.0) + torch.tensor([0, 0, 0.05, 0.05]),
                     boxes(g, 5, 1.0, 0.0) + torch.tensor([0, 0, 0.05, 0.05])],
                    [1]), False),
        ("box_coder decode", lambda p, t: V.box_coder(
            p, [0.1, 0.1, 0.2, 0.2], t, "decode_center_size", False, 1),
         lambda g: ([boxes(g, 30, 80.0, 0.0) + torch.tensor([0, 0, 1, 1]),
                     torch.randn(30, 5, 4, generator=g)], [1]), False),
        ("prior_box", lambda x, im: V.prior_box(
            x, im, [30.0], [60.0], [2.0, 3.0], flip=True, clip=True,
            steps=[16, 16], min_max_aspect_ratios_order=True),
         lambda g: ([torch.zeros(1, 1, 5, 5), torch.zeros(1, 3, 80, 80)],
                    []), False),
        ("nms", lambda b, s, c: V.nms(b, 0.5, s, c, [2, 0, 1], 20),
         lambda g: ([boxes(g, 64, 100.0, 0.0),
                     _distinct_scores(torch, g, 64),
                     torch.randint(0, 3, (64,), generator=g)], []), True),
        ("matrix_nms", lambda b, s: V.matrix_nms(
            b, s, 0.3, 0.2, -1, 30, background_label=0, return_index=True),
         lambda g: ([torch.stack([boxes(g, 40, 1.0, 0.0) for _ in range(2)]),
                     _distinct_scores(torch, g, 2, 4, 40)], []), True),
        ("matrix_nms gaussian", lambda b, s: V.matrix_nms(
            b, s, 0.2, 0.1, 10, -1, True, 0.5, -1, return_index=True),
         lambda g: ([torch.stack([boxes(g, 40, 1.0, 0.0) for _ in range(2)]),
                     _distinct_scores(torch, g, 2, 4, 40)], []), True),
        ("generate_proposals", lambda s, d, im, a, v: V.generate_proposals(
            s, d, im, a, v, 100, 30, 0.7, 0.0, return_rois_num=True),
         lambda g: (rpn(g), []), True),
        ("distribute_fpn_proposals",
         lambda b, n: V.distribute_fpn_proposals(b, 2, 5, 4, 224, rois_num=n),
         lambda g: ([boxes(g, 40, 800.0, 0.0), torch.tensor([25, 15])], []),
         True),
    ]


def detection_card_vs_cpu(torch, dev, report):
    """Every op of ``vision.ops`` (``_detection_cases``) in fp32 (TF32
    off) on the card against the same call on the CPU: selection outputs
    equal (values, dtypes, order), other outputs within 1e-5 of their own
    max |value| (absolute below 1), gradients of ``sum(out * w)`` within
    1e-4 of their own max |g|; the card's backward run twice from one
    state must give the same bits."""
    from paddle_tpu_torch.vision import ops as V

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst_out, worst_grad, failed = (0.0, ""), (0.0, ""), []
    cases = _detection_cases(torch, V)
    for name, fn, make, select in cases:
        g = torch.Generator().manual_seed(sum(map(ord, name)))
        args, grads = make(g)
        weights = []

        def run(device):
            xs = [_moved(a, device, i in grads) for i, a in enumerate(args)]
            outs = _flat(fn(*xs))
            if not weights:
                weights.extend(torch.randn(o.shape, generator=g)
                               for o in outs)
            if grads:
                sum((o * w.to(device)).sum() for o, w in zip(outs, weights)
                    if o.is_floating_point() and o.requires_grad).backward()
            return ([o.detach().cpu() for o in outs],
                    [xs[i].grad.cpu() for i in grads])

        c_out, c_grad = run("cpu")
        d_out, d_grad = run(dev)
        _, d_grad2 = run(dev)
        if len(c_out) != len(d_out):
            failed.append(f"{name}: {len(d_out)} outputs, {len(c_out)} on "
                          f"the CPU")
            continue
        for k, (got, want) in enumerate(zip(d_out, c_out)):
            if select or not want.is_floating_point():
                if got.dtype != want.dtype or not torch.equal(got, want):
                    failed.append(f"{name} output {k}")
                continue
            err = (float((got - want).abs().max()) / max(
                float(want.abs().max()), 1.0)) if want.numel() else 0.0
            worst_out = max(worst_out, (err, name))
            if err > 1e-5:
                failed.append(f"{name} output {k} {err:.3g}")
        for i, got, want in zip(grads, d_grad, c_grad):
            err = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1.0)
            worst_grad = max(worst_grad, (err, name))
            if err > 1e-4:
                failed.append(f"{name} gradient {i} {err:.3g}")
        if not all(torch.equal(a, b) for a, b in zip(d_grad, d_grad2)):
            failed.append(f"{name}: two backward passes differ")
    log(f"  {len(cases)} cases in fp32, card against CPU: selections equal, "
        f"worst output {worst_out[0]:.3g} of its max ({worst_out[1]}; tol "
        f"1e-5), worst gradient {worst_grad[0]:.3g} ({worst_grad[1]}; tol "
        f"1e-4), every backward twice from one state bit-equal")
    check(not failed, f"detection card vs CPU: {failed}")
    return dict(cases=len(cases), worst_out=worst_out[0],
                worst_grad=worst_grad[0])


def phase_detection(torch, dev, report):
    """The ``[detection]`` phase: ``detection_card_vs_cpu``, then the
    detectors' paths (``detection_two_stage``, ``detection_one_stage``,
    ``detection_ssd``). No kernel of the port runs: every launch counter
    stays 0 (kept under ``launches_by_path["detection"]``) and a
    profiled run of each path shows none of the port's kernels by
    name."""
    from torch.autograd import DeviceType

    reset_counts()
    run_parts(torch, dev, report, "detection", "detection", (
        ("card_vs_cpu", detection_card_vs_cpu),
        ("two_stage", detection_two_stage),
        ("one_stage", detection_one_stage),
        ("ssd", detection_ssd)))
    counts = read_counts()
    record_launches(report, "detection", counts)
    check(not any(counts.values()),
          f"detection: kernels of the port launched: {counts}")
    from paddle_tpu_torch.vision import ops as V

    x = torch.randn(2, 256, 50, 84, device=dev, requires_grad=True)
    b = torch.rand(64, 4, device=dev) * 400
    b[:, 2:] += b[:, :2]
    num = torch.tensor([32, 32], device=dev)

    def sample():
        V.roi_align(x, b, num, 7, 1 / 16, 0, True).sum().backward()
        V.roi_pool(x, b, num, 7, 1 / 16).sum().backward()
        V.nms(b, 0.5, torch.rand(64, device=dev))

    names = {e.key for e in profiled(sample, 1)
             if e.device_type == DeviceType.CUDA}
    ran = port_launches({k: 1 for k in names}, ())
    log(f"  detection ops by name: kernels of the port {ran or 'none'} "
        f"({len(names)} kernels)")
    check(not ran, f"detection ran kernels of the port: {ran}")


#: timed steps of each training form, and the profiler's window (steps
#: closed, ready and recorded)
OBS_STEPS = 5
OBS_PROFILE = dict(closed=1, ready=1, record=3)


def llama_step_flops(config, batch, seq, chunk=2048):
    """The analytic FLOPs of one Llama training step under
    ``paddle_tpu_torch/utils/flops.py``'s convention: each decoder linear
    layer 6 * T * in * out (forward, dX, dW); the lm head through the
    fused loss 8 * Tp * H * V (Tp: T rounded up to the loss's 2048-row
    chunks; each chunk's product is recomputed in the backward); the
    flash forward the 4 * B * H * S * S * D that the reference's Pallas
    call declares, each layer; nothing for the flash backward, RMSNorm,
    RoPE, SwiGLU, the embedding or AdamW."""
    h, i = config.hidden_size, config.intermediate_size
    nl, heads = config.num_hidden_layers, config.num_attention_heads
    kvh, d = config.num_key_value_heads, config.hidden_size // heads
    t = batch * seq
    linear = h * heads * d + 2 * h * kvh * d + heads * d * h + 3 * h * i
    tp = -(-t // chunk) * chunk
    return (6 * t * nl * linear + 8 * tp * h * config.vocab_size
            + 4 * batch * heads * seq * seq * d * nl)


def obs_train_forms(torch, dev, model, opt, ids, labels, nl, n_params,
                    res):
    """``phase_observability``'s training part: the step under a
    ``StepTimer`` eagerly and under ``jit.to_static``, each form's gauge
    against its synced wall, its FLOP count against the analytic one, its
    launches against the counters."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.device.memory import compiled_memory_stats

    config = model.config
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def step(ids, labels):
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    t0 = time.perf_counter()
    warm = float(step(ids, labels))
    log(f"  warm-up step {time.perf_counter() - t0:.2f} s, loss {warm:.4f}")
    timer = obs.StepTimer("train", items_per_step=tokens, unit="tokens",
                          sample_memory_every=OBS_STEPS)
    t0 = time.perf_counter()
    flops = timer.measure_flops(step, ids, labels)
    torch.cuda.synchronize()
    want = llama_step_flops(config, TRAIN_BATCH, TRAIN_SEQ)
    bench = tokens * (6 * n_params + 12 * nl * config.hidden_size * TRAIN_SEQ)
    log(f"  measure_flops: {flops:,} FLOPs a step ({time.perf_counter() - t0:.2f}"
        f" s); analytic count {want:,}; bench.py's formula (6 N + 12 L h S "
        f"a token) {bench:,} ({flops / bench:.4f} of it)")
    check(flops == want, f"measured FLOPs {flops} != the analytic {want}")
    peak = obs.default_peak_flops()
    check(peak == 989e12, f"default_peak_flops {peak}, want 989e12")
    static = jit.to_static(step, full_graph=True)

    def capture():
        t0 = time.perf_counter()
        static(ids, labels)             # the warm-up call and the capture
        torch.cuda.synchronize()
        log(f"  to_static: warm-up and capture "
            f"{time.perf_counter() - t0:.2f} s")
        return static

    hist = obs.registry.get("train.step_seconds")
    mfu_g = obs.registry.get("train.mfu")
    forms = {}
    # eager first: the capture empties the allocator's cache, and the
    # eager steps after it would pay cudaMalloc again
    for form, make, name in (("eager", lambda: step, "train"),
                             ("to_static", capture, "train_static")):
        fn = make()
        t = timer if form == "eager" else obs.StepTimer(
            name, items_per_step=tokens, unit="tokens", flops_per_step=flops,
            sample_memory_every=OBS_STEPS)
        torch.cuda.synchronize()
        reset_counts()
        h0 = hist.stats(name=name)
        t0 = time.perf_counter()
        for _ in range(OBS_STEPS):
            with t.region():
                fn(ids, labels)
        t.flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / OBS_STEPS
        counts = read_counts()
        h1 = hist.stats(name=name)
        n = h1["count"] - h0["count"]
        gauge = (h1["sum"] - h0["sum"]) / max(n, 1)
        mfu = mfu_g.value(name=name)
        log(f"  {form}: train.step_seconds mean {gauge * 1e3:.3f} ms over "
            f"{n} steps (device time, CUDA events), synced wall mean "
            f"{wall * 1e3:.3f} ms ({gauge / wall - 1:+.2%}); train.mfu "
            f"{mfu:.4f} (last step; the mean's "
            f"{flops / gauge / peak:.4f}); bench.py's formula gives "
            f"{bench / gauge / peak:.4f}; launches {counts}")
        check(n == OBS_STEPS, f"{form}: {n} steps recorded, want {OBS_STEPS}")
        check(abs(gauge / wall - 1) <= 0.05,
              f"{form}: gauge mean {gauge:.6f} s not within 5% of the "
              f"synced wall {wall:.6f} s")
        for key, per in train_launches(nl).items():
            check(counts[key] == per * OBS_STEPS,
                  f"{form}: {key} launches {counts[key]}, want {per} x "
                  f"{OBS_STEPS}")
        forms[form] = dict(step_seconds_mean=gauge, wall_seconds_mean=wall,
                           mfu_last=mfu, mfu_mean=flops / gauge / peak,
                           bench_mfu=bench / gauge / peak, launches=counts)
    mem = compiled_memory_stats(static)
    log(f"  compiled_memory_stats(to_static step): {mem}")
    check(mem.get("temp_size_in_bytes", 0) > 0,
          f"the captured step's pool reads {mem}")
    res.update(flops=flops, analytic_flops=want, bench_formula_flops=bench,
               peak_flops=peak, forms=forms, graph_memory=mem)
    return step


def obs_memory_and_flight(torch, dev, model, step, ids, labels, res):
    """The device gauges against the allocator, and a step that raises
    inside a ``step_region`` writing a flight dump with them."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import observability as obs

    s = obs.sample_device_memory()
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    wm = obs.registry.get("device.hbm_watermark_bytes").value(device="0")
    lim = obs.registry.get("device.hbm_bytes_limit").value(device="0")
    log(f"  device gauges: in use {s['bytes_in_use'] / 2**30:.2f} GiB, "
        f"watermark {wm / 2**30:.2f} GiB (max_memory_allocated "
        f"{peak / 2**30:.2f} GiB), limit {lim / 2**30:.2f} GiB (card "
        f"{total / 2**30:.2f} GiB)")
    check(wm >= peak, f"watermark {wm} < max_memory_allocated {peak}")
    check(lim == total, f"hbm_bytes_limit {lim} != the card's {total}")
    d = tempfile.mkdtemp()
    prev = os.environ.get(obs.flight.FLIGHT_DIR_ENV)
    os.environ[obs.flight.FLIGHT_DIR_ENV] = d
    try:
        try:
            with obs.step_region("train_fault", step=0):
                step(ids, labels)
                raise RuntimeError("injected fault")
        except RuntimeError as exc:
            check("injected" in str(exc), f"unexpected error {exc!r}")
        dumps = []
        for f in sorted(os.listdir(d)):
            with open(os.path.join(d, f)) as fh:
                dumps.append(json.load(fh))
    finally:
        if prev is None:
            os.environ.pop(obs.flight.FLIGHT_DIR_ENV, None)
        else:
            os.environ[obs.flight.FLIGHT_DIR_ENV] = prev
        shutil.rmtree(d, ignore_errors=True)
    mem = dumps[-1].get("device_memory") if dumps else None
    log(f"  flight dumps after the fault: {[x['reason'] for x in dumps]}, "
        f"device_memory {mem}")
    check(len(dumps) == 1 and dumps[0]["reason"] == "step_exception"
          and mem and mem["bytes_limit"] == total
          and mem["bytes_in_use"] > 0,
          f"the step_exception dump holds no device memory: {mem}")
    res["memory"] = dict(watermark_bytes=wm, max_memory_allocated=peak,
                         bytes_limit=lim, flight_device_memory=mem)


def obs_profiler(torch, dev, step, ids, labels, nl, res):
    """``Profiler`` over ``OBS_PROFILE``'s window of training steps: the
    trace file, the port's kernels by name under the port's class with the
    counters' launches, and the device total against ``profile_kernels``."""
    import os
    import tempfile

    from paddle_tpu_torch import profiler as P
    from paddle_tpu_torch.profiler import statistic as S

    rec = OBS_PROFILE["record"]
    steps = sum(OBS_PROFILE.values())
    per_step = {"flash_fwd_tc_kernel": nl, "flash_bwd_dq_tc_kernel": nl,
                "flash_bwd_dkv_tc_kernel": nl,
                **{k: 2 * nl + 1 for k in RMS_TRAIN_KERNELS}}

    def take():
        with tempfile.TemporaryDirectory() as d:
            p = P.Profiler(targets=[P.ProfilerTarget.CPU,
                                    P.ProfilerTarget.GPU],
                           scheduler=P.make_scheduler(**OBS_PROFILE),
                           on_trace_ready=P.export_chrome_tracing(d))
            reset_counts()
            p.start()
            for _ in range(steps):
                step(ids, labels)
                torch.cuda.synchronize()
                p.step()
            p.stop()
            files = sorted(os.listdir(d))
            sizes = [os.path.getsize(os.path.join(d, f)) for f in files]
        by_op = S.collect_device_statistic(p.device_events, by="op")
        by_class = S.collect_device_statistic(p.device_events, by="class")
        return dict(p=p, files=list(zip(files, sizes)), by_op=by_op,
                    by_class=by_class, counts=read_counts())

    def launches(out):
        return {k: it.calls for k, it in out["by_op"].items()}

    def check_fn(out):
        check(len(out["files"]) == 1 and out["files"][0][1] > 0,
              f"profiler trace files {out['files']}")
        c = out["counts"]
        check(c["flash"] == c["flash_bwd"] == nl * steps
              and c["rms_norm"] == c["rms_norm_bwd"] == (2 * nl + 1) * steps,
              f"counters over {steps} steps: {c}")
        got = {k: out["by_op"][k].calls if k in out["by_op"] else 0
               for k in per_step}
        log(f"  profiler window ({rec} steps): port kernels by name {got}")
        check(got == {k: v * rec for k, v in per_step.items()},
              f"profiler window: port kernels {got}, want "
              f"{ {k: v * rec for k, v in per_step.items()} }")
        wrong = {k: S.op_class(k) for k in per_step
                 if S.op_class(k) != S.PORT_CLASS}
        check(not wrong, f"port kernels outside {S.PORT_CLASS}: {wrong}")
        port = out["by_class"].get(S.PORT_CLASS)
        check(port is not None and port.calls == sum(
            it.calls for k, it in out["by_op"].items()
            if S.op_class(k) == S.PORT_CLASS) >= sum(got.values()),
              f"the class table's {S.PORT_CLASS} row {port and port.calls}")

    out = recorded(take, launches, check_fn, "observability profiler")
    table = out["p"].summary(op_detail=True)
    check(all(k in table for k in per_step) and S.PORT_CLASS in table,
          "summary() lacks the port's kernels or their class")
    dev_ms = sum(it.total_ns for it in out["by_op"].values()) / rec / 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(ids, labels)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy, _ = profile_kernels(torch, lambda: step(ids, labels), 1, wall_ms,
                              "observability step, profile_kernels")
    log(f"  Profiler device total {dev_ms:.3f} ms a step; profile_kernels "
        f"{busy:.3f} ms ({dev_ms / busy - 1:+.2%}); by class " + "; ".join(
            f"{k} {it.total_ns / rec / 1e6:.3f} ms x{it.calls // rec}"
            for k, it in sorted(out["by_class"].items(),
                                key=lambda kv: -kv[1].total_ns)))
    check(abs(dev_ms / busy - 1) <= 0.05,
          f"Profiler device total {dev_ms:.3f} ms not within 5% of "
          f"profile_kernels' {busy:.3f} ms")
    res["profiler"] = dict(
        device_ms_per_step=dev_ms, profile_kernels_ms=busy,
        trace_files=out["files"],
        by_class_ms={k: it.total_ns / rec / 1e6
                     for k, it in out["by_class"].items()})


def obs_serving(torch, dev, res):
    """``default_serving_setup`` under ``run_load`` (24 requests, 30
    req/s, seed 0) without and with a ``HealthMonitor`` of the default
    rules: one recorder sample per engine step, any PTL60x finding
    printed, tokens/s both ways."""
    import dataclasses

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import health
    from paddle_tpu_torch.serve import (ServeEngine, default_serving_setup,
                                        run_load, warm_engine)
    from paddle_tpu_torch.models import LlamaForCausalLM

    config, prm = default_serving_setup(dev)
    model = LlamaForCausalLM(dataclasses.replace(config, dtype="bfloat16"),
                             device=dev, seed=0).eval()
    eng = ServeEngine(model, max_slots=prm["slots"],
                      block_size=prm["block_size"],
                      num_blocks=prm["num_blocks"],
                      max_seq_len=prm["max_seq_len"], name="obs_serve",
                      device=dev)
    warm_engine(eng, max_prompt_len=prm["prompt_len"][1])
    calls = [0]
    real = eng.step

    def counted():
        calls[0] += 1
        return real()

    eng.step = counted
    hook_s = [0.0]
    real_hook = health.maybe_on_step

    def timed_hook(now=None):
        t0 = time.perf_counter()
        real_hook(now)
        hook_s[0] += time.perf_counter() - t0

    out = {}
    for label, mon in (("without", None),
                       ("with", health.HealthMonitor(health.default_rules()))):
        health.install(mon)
        health.maybe_on_step = timed_hook
        calls[0], hook_s[0] = 0, 0.0
        try:
            r = run_load(eng, rate=prm["rate"], n_requests=24,
                         prompt_len=prm["prompt_len"], max_new=prm["max_new"],
                         seed=0)
        finally:
            health.install(None)
            health.maybe_on_step = real_hook
        torch.cuda.synchronize()
        out[label] = dict(tokens_per_s=r.tokens_per_sec, steps=calls[0],
                          ttft_p50=r.ttft_p50, ttft_p99=r.ttft_p99,
                          hook_us_per_step=hook_s[0] / max(calls[0], 1) * 1e6)
        done = sum(q.state == "FINISHED" for q in r.requests)
        check(done == 24, f"serving {label} the monitor: {done}/24 finished")
        if mon is not None:
            findings = [f"{d.code} {d.message}" for d in mon.report]
            log(f"  health monitor: {mon.recorder.samples} samples for "
                f"{calls[0]} engine steps, {mon.recorder.points_total()} "
                f"points in {len(mon.recorder.names())} series; findings "
                f"{findings or 'none'}")
            check(mon.recorder.samples == calls[0] > 0,
                  f"recorder took {mon.recorder.samples} samples for "
                  f"{calls[0]} engine steps")
            out[label].update(samples=mon.recorder.samples,
                              findings=findings,
                              series=mon.recorder.names())
        log(f"  run_load {label} a health monitor: "
            f"{r.tokens_per_sec:.1f} tokens/s, {calls[0]} engine steps, "
            f"TTFT p50 {r.ttft_p50 * 1e3:.2f} ms p99 {r.ttft_p99 * 1e3:.2f} "
            f"ms; the hook {out[label]['hook_us_per_step']:.1f} us a step "
            f"(host)")
    log(f"  the monitor's cost: {out['with']['tokens_per_s'] / out['without']['tokens_per_s'] - 1:+.2%} tokens/s "
        f"(arrival-bound load: 30 req/s)")
    res["serving"] = out
    del eng, model
    torch.cuda.empty_cache()


def phase_observability(torch, dev, report):
    """Step telemetry, device memory, the flight dump, health monitoring
    and the profiler of the port on its main paths (``phase_train``'s
    step: ``bench.py:bench_llama``'s 645M Llama, bf16, 4 x 2048, AdamW;
    then ``default_serving_setup``'s engine): the ``StepTimer`` gauges of
    the eager and captured step against their synced walls (5%), the
    measured FLOPs against ``llama_step_flops`` (exactly) and the
    launches against the counters; the memory gauges against the
    allocator and a faulting step's flight dump; a ``Profiler`` window's
    kernels by name and class and its device total against
    ``profile_kernels`` (5%); serving with and without a health monitor
    (one sample an engine step)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    obs.reset()
    obs.enable()
    res = {}
    try:
        config = LlamaConfig(**TRAIN_CONFIG, dtype="bfloat16")
        nl = config.num_hidden_layers
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = LlamaForCausalLM(config, device=dev, seed=0)
        n_params = model.num_parameters()
        opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                    multi_precision=True)
        ids, labels = train_batch(torch, config, dev)
        step = obs_train_forms(torch, dev, model, opt, ids, labels, nl,
                               n_params, res)
        obs_memory_and_flight(torch, dev, model, step, ids, labels, res)
        obs_profiler(torch, dev, step, ids, labels, nl, res)
        del model, opt, step
        torch.cuda.empty_cache()
        obs_serving(torch, dev, res)
    finally:
        obs.disable()
        obs.reset()
    report["observability"] = res


# ---------------------------------------------------------------------------
# distributed: NCCL at world 1
# ---------------------------------------------------------------------------
#: the launcher's variables ``phase_distributed`` sets for a world of one
#: and puts back after
DIST_ENV = {"PADDLE_TRAINERS_NUM": "1", "PADDLE_TRAINER_ID": "0",
            "WORLD_SIZE": None, "RANK": None, "PADDLE_MASTER": None}
#: each collective's tensors, and the calls timed per collective and dtype
DIST_SHAPE, DIST_CALLS = (1024, 1024), 20
#: steps from one state held bit for bit (wrapped vs unwrapped, captured
#: vs its eager twin)
DIST_COMPARE_STEPS = 3


def _dist_cases(torch, dist, x, y):
    """Each collective at world 1 on ``x`` (and ``y``): name -> (its
    ``comm.collective_calls`` op label, a call returning what it left,
    the world-1 value that must come out)."""
    R = dist.ReduceOp
    t = x.clone()

    def reduced(op):
        def call():
            dist.all_reduce(t, op=op)
            return [t]
        return call

    def task():
        dist.all_reduce(t, op=R.AVG, sync_op=False).wait()
        return [t]

    def listed(fn):
        def call():
            out = []
            fn(out)
            return out
        return call

    o = torch.empty_like(x)

    def into(fn):
        def call():
            fn(o)
            return [o]
        return call

    cases = {f"all_reduce {op}": ("all_reduce", reduced(op), [x])
             for op in (R.SUM, R.MAX, R.MIN, R.PROD, R.AVG)}
    cases.update({
        "all_reduce async": ("all_reduce", task, [x]),
        "reduce": ("reduce", lambda: [dist.reduce(t, dst=0)], [x]),
        "broadcast": ("broadcast", lambda: [dist.broadcast(t, src=0)], [x]),
        "all_gather": ("all_gather",
                       listed(lambda out: dist.all_gather(out, x)), [x]),
        "all_to_all": ("all_to_all",
                       listed(lambda out: dist.all_to_all(out, [x, y])),
                       [x, y]),
        "all_to_all_single": ("all_to_all_single", into(
            lambda out: dist.all_to_all_single(out, x)), [x]),
        "reduce_scatter": ("reduce_scatter", into(
            lambda out: dist.reduce_scatter(out, [x, y])), [x]),
        "scatter": ("scatter", into(
            lambda out: dist.scatter(out, [y], src=0)), [y]),
        "gather": ("gather", listed(
            lambda out: dist.gather(x, out, dst=0)), [x]),
    })
    return cases


def dist_collectives(torch, dev, dist, obs):
    """Every collective on CUDA bf16 and fp32 ``DIST_SHAPE`` tensors at
    world 1 (NCCL): each result equal to its world-1 value (the input,
    dtype and shape too), then ``DIST_CALLS`` calls timed on the host
    (synced at the end); the objects' collectives, ``wait`` and
    ``barrier``; the ``comm.collective_calls`` series must count every
    call by op."""
    g = torch.Generator(device=dev).manual_seed(11)
    out, want_calls = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(DIST_SHAPE, generator=g, device=dev).to(dtype)
        y = torch.randn(DIST_SHAPE, generator=g, device=dev).to(dtype)
        for name, (op, call, want) in _dist_cases(torch, dist, x,
                                                   y).items():
            got = call()
            check(len(got) == len(want) and all(
                a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b) for a, b in zip(got, want)),
                f"{name} {dtype}: not its world-1 value")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DIST_CALLS):
                call()
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / DIST_CALLS * 1e6
            out[f"{name} {str(dtype)[6:]}"] = us
            want_calls[op] = want_calls.get(op, 0) + 1 + DIST_CALLS
    objs = []
    dist.all_gather_object(objs, {"rank": 0, "tag": "x"})
    lst = ["a", {"b": 1}]
    dist.broadcast_object_list(lst, src=0)
    check(objs == [{"rank": 0, "tag": "x"}] and lst == ["a", {"b": 1}],
          f"object collectives: {objs}, {lst}")
    dist.wait(x)
    dist.barrier()
    want_calls.update(all_gather_object=1, broadcast_object_list=1)
    calls = obs.registry.get("comm.collective_calls")
    got_calls = {op: calls.value(op=op, group="world") for op in want_calls}
    log("  host us per call (world 1, each checked first): " + ", ".join(
        f"{k} {v:.1f}" for k, v in out.items()))
    log(f"  comm.collective_calls by op: {got_calls}")
    check(got_calls == want_calls,
          f"comm.collective_calls {got_calls}, want {want_calls}")
    return dict(host_us=out, collective_calls=got_calls)


def _train_state(model, opt):
    """A training state as one list: parameters, fp32 masters, moments."""
    ps = list(model.parameters())
    return ([p.detach() for p in ps]
            + [opt._master_weights[id(p)] for p in ps]
            + [opt._accumulators[n][id(p)] for n in opt._accum_names
               for p in ps])


def _same_state(torch, a, b, la, lb, label):
    """Two runs from one state: losses and every state tensor equal bit
    for bit."""
    apart = sum(int((x != y).sum()) for x, y in zip(a, b))
    log(f"  {label}: losses {[round(v, 5) for v in la]} vs "
        f"{[round(v, 5) for v in lb]}; {apart} of "
        f"{sum(x.numel() for x in a)} state entries apart (want 0)")
    check(la == lb and apart == 0, f"{label}: not equal bit for bit")
    return apart


@contextlib.contextmanager
def gc_pauses():
    """The ms the Python garbage collector ran inside the block, as a
    one-element list (``gc.callbacks``): a host-bound step's wall grows
    by its collections."""
    import gc

    total, start = [0.0], [0.0]

    def timer(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            total[0] += (time.perf_counter() - start[0]) * 1e3

    gc.callbacks.append(timer)
    try:
        yield total
    finally:
        gc.callbacks.remove(timer)


def dist_timed(torch, dev, call, nl, label, want=None, keep_profile=False):
    """One warm-up call, then ``TRAIN_STEPS`` timed steps: their launches
    (flash and RMSNorm forward and backward, each the step's count), the
    step's wall ms and the ms of it in the garbage collector, the busy
    share of one profiled step and the peak memory from the warm-up on
    (the caller leaves only this form's model on the card; a captured
    form's warm-up is a replay); with ``keep_profile``, that profile too
    (``profile_kernels``' pair, for a check of the kernels by name)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    call()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with gc_pauses() as gc_ms:
        for _ in range(TRAIN_STEPS):
            call()
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    counts = read_counts()
    for key, n in (want or train_launches(nl)).items():
        check(counts[key] == n * TRAIN_STEPS,
              f"{label}: {key} launches {counts[key]} != {n} x "
              f"{TRAIN_STEPS} steps")
    peak = torch.cuda.max_memory_allocated(dev)
    profile = profile_kernels(torch, call, 1, step_ms, label)
    busy = profile[0]
    log(f"  {label}: {step_ms:.2f} ms a step ({gc_ms[0] / TRAIN_STEPS:.2f} "
        f"in the garbage collector), peak memory {peak / 2**30:.2f} GiB "
        f"allocated")
    out = dict(step_ms=step_ms, gc_ms=gc_ms[0] / TRAIN_STEPS,
               peak_bytes=peak,
               busy_share=None if busy is None else busy / step_ms,
               launches=counts)
    if keep_profile:
        out["profile"] = profile
    return out


def dist_data_parallel(torch, dev, report, dist):
    """``DataParallel`` around ``phase_train``'s step (``bench_llama``'s
    645M Llama, bf16, 4 x 2048, ``AdamW(multi_precision=True)``) at
    world 1 on NCCL, with the default buckets (25 MB, the first 1 MB):
    ``DIST_COMPARE_STEPS`` wrapped steps equal to as many unwrapped steps
    from one state (seed 0) bit for bit, losses and state; both forms
    timed (``dist_timed``; the wrapped run's launches are the
    ``distributed`` path's); then the wrapped step under
    ``jit.to_static(full_graph=True)``: one capture, and its steps equal
    to its eager twin's (``to_static`` under ``enable_capture(False)``)
    bit for bit, ``jit.fallbacks`` 0; the captured forms timed, wrapped
    and unwrapped. Each form is timed with only its own model on the
    card."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    config = LlamaConfig(**TRAIN_CONFIG, dtype="bfloat16")
    nl = config.num_hidden_layers
    ids, labels = train_batch(torch, config, dev)

    def trainer(wrapped):
        model = LlamaForCausalLM(config, device=dev, seed=0)
        net = dist.DataParallel(model) if wrapped else model
        opt = AdamW(learning_rate=3e-4, parameters=net.parameters(),
                    multi_precision=True)
        opt._ensure_accumulators()

        def step(i, lab):
            loss, _ = net(i, labels=lab)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        return net, model, opt, step

    def steps(fn):
        return [float(fn(ids, labels)) for _ in range(DIST_COMPARE_STEPS)]

    res = {}
    torch.cuda.empty_cache()
    _, um, uo, ustep = trainer(False)
    ul = steps(ustep)
    dp, wm, wo, wstep = trainer(True)
    buckets = dp.buckets
    res["buckets"] = dict(count=len(buckets),
                          bytes=[nb for _, _, nb in buckets],
                          params=[n for _, n, _ in buckets])
    log(f"  reducer: {len(buckets)} buckets, "
        f"{sum(nb for _, _, nb in buckets) / 1e9:.3f} GB of "
        f"{buckets[0][0]} gradients (first {buckets[0][2] / 2**20:.2f} "
        f"MiB, largest {max(nb for _, _, nb in buckets) / 2**20:.2f} MiB)")
    wl = steps(wstep)
    _same_state(torch, _train_state(um, uo), _train_state(wm, wo), ul, wl,
                f"{DIST_COMPARE_STEPS} wrapped vs unwrapped eager steps "
                f"from seed 0")
    del um, uo, ustep
    torch.cuda.empty_cache()
    res["eager"] = {"wrapped": dist_timed(
        torch, dev, lambda: wstep(ids, labels), nl,
        "DataParallel step, eager")}
    record_launches(report, "distributed",
                    res["eager"]["wrapped"]["launches"])
    del dp, wm, wo, wstep
    torch.cuda.empty_cache()
    _, um, uo, ustep = trainer(False)
    res["eager"]["unwrapped"] = dist_timed(
        torch, dev, lambda: ustep(ids, labels), nl, "unwrapped step, eager")
    del um, uo, ustep
    torch.cuda.empty_cache()

    _, cm, co, cstep = trainer(True)
    cfn = jit.to_static(cstep, full_graph=True)
    cl = steps(cfn)
    entries = list(cfn._cache.values())
    check(len(entries) == 1 and entries[0].graphed.captured,
          f"DataParallel to_static made {len(entries)} entries, or did not "
          f"capture")
    _, em, eo, estep = trainer(True)
    efn = jit.to_static(estep, full_graph=True)
    with eager_ticks():
        el = steps(efn)
    _same_state(torch, _train_state(cm, co), _train_state(em, eo), cl, el,
                f"{DIST_COMPARE_STEPS} captured DataParallel steps vs their "
                f"eager twin")
    del em, eo, estep, efn
    torch.cuda.empty_cache()
    fallbacks = obs.registry.get("jit.fallbacks").total()
    check(fallbacks == 0, f"jit.fallbacks {fallbacks}")
    res["captured"] = {"wrapped": dist_timed(
        torch, dev, lambda: cfn(ids, labels), nl,
        "DataParallel step, captured")}
    res["captured"]["wrapped"]["capture_s"] = \
        entries[0].graphed.capture_seconds
    del cm, co, cstep, cfn, entries
    torch.cuda.empty_cache()
    _, um, uo, ustep = trainer(False)
    ufn = jit.to_static(ustep, full_graph=True)
    ufn(ids, labels)                        # the capture
    res["captured"]["unwrapped"] = dist_timed(
        torch, dev, lambda: ufn(ids, labels), nl, "unwrapped step, captured")
    del um, uo, ustep, ufn
    torch.cuda.empty_cache()
    for form, r in res["captured"].items():
        r.pop("launches")
    for form in ("eager", "captured"):
        w, u = res[form]["wrapped"], res[form]["unwrapped"]
        log(f"  {form}: DataParallel {w['step_ms']:.2f} ms vs unwrapped "
            f"{u['step_ms']:.2f} ms a step "
            f"({w['step_ms'] / u['step_ms'] - 1:+.2%})")
    return res


def phase_distributed(torch, dev, report):
    """The port's distributed runtime on the card (``distributed/``):
    ``init_parallel_env`` at world 1 (the launcher's variables for one
    rank) must bring up NCCL; every collective (``dist_collectives``);
    ``DataParallel`` around the training step (``dist_data_parallel``).
    The machine has one card and NCCL refuses two ranks on one card, so
    no multi-rank path runs here (the CPU tests run two gloo ranks
    through the launcher)."""
    import os

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import observability as obs

    saved = {k: os.environ.get(k) for k in DIST_ENV}
    for k, v in DIST_ENV.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    obs.reset()
    obs.enable()
    res = {}
    try:
        t0 = time.perf_counter()
        group = dist.init_parallel_env()
        backend = dist.get_backend()
        res["bring_up"] = dict(backend=backend,
                               seconds=time.perf_counter() - t0)
        log(f"  init_parallel_env: backend {backend}, world "
            f"{dist.get_world_size()}, rank {dist.get_rank()}, "
            f"{res['bring_up']['seconds']:.2f} s")
        check(backend == "nccl", f"backend {backend}, want nccl")
        check((group.nranks, group.rank, dist.get_world_size()) == (1, 0, 1),
              f"world-1 group {group}")
        res["collectives"] = dist_collectives(torch, dev, dist, obs)
        res["data_parallel"] = dist_data_parallel(torch, dev, report, dist)
    finally:
        dist.destroy_process_group()
        obs.disable()
        obs.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    report["distributed"] = res


# ---------------------------------------------------------------------------
# tensor parallelism: the shard plans at mp 1 on NCCL, mp 2 over gloo
# ---------------------------------------------------------------------------
#: the two-rank run (gloo carries the mp-2 step's collectives on CUDA
#: tensors on the card: PERF.md PR 22): bench_llama's width at this
#: depth, 3 AdamW steps
TP_MP2_LAYERS, TP_MP2_STEPS = 2, 3
#: the parameters whose step-1 gradients and values before and after the
#: steps each rank gathers and holds against the unsharded run's: the
#: whole tensor, or of the vocabulary-sharded ones the rows about the
#: boundary of the two shards (16000)
TP_MP2_PARAMS = {
    "llama.embed_tokens.weight": (15872, 16128),
    "llama.layers.0.self_attn.q_proj.weight": None,
    "llama.layers.0.self_attn.o_proj.weight": None,
    "llama.layers.1.mlp.gate_proj.weight": None,
    "llama.layers.1.mlp.down_proj.weight": None,
    "llama.layers.1.input_layernorm.weight": None,
    "lm_head.weight": (15872, 16128),
}
#: the two ranks against the unsharded model, all in bf16 with the
#: row-parallel partial sums rounded to bf16 before their all-reduce,
#: each about 3x the largest gap measured on the H100 (PERF.md PR 22:
#: 3.23e-4, 0.0144, 0.0739): |loss - unsharded loss| at every step; the
#: step-1 gradients, max |g - unsharded g| over max |unsharded g|; the
#: updates of the steps (fp32 masters), ||dw - unsharded dw|| over
#: ||unsharded dw||
TP_MP2_LOSS_TOL = 1e-3
TP_MP2_GRAD_TOL = 0.05
TP_MP2_UPDATE_TOL = 0.25


def _tp_env(world, rank, master=None):
    import os

    env = {"PADDLE_TRAINERS_NUM": str(world), "PADDLE_TRAINER_ID": str(rank),
           "WORLD_SIZE": None, "RANK": None, "PADDLE_MASTER": master}
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return saved


def _restore_env(saved):
    import os

    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def dtensor_dispatches(torch):
    """A dispatch mode counting the ops that reach a ``DTensor`` (each one
    runs torch's sharding propagation on the host) and, to show the mode
    saw the step, every op; ``.count`` is [DTensor ops, all ops]."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.count = [0, 0]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.count[1] += 1
            if any(issubclass(t, DTensor) for t in types):
                self.count[0] += 1
            return func(*args, **(kwargs or {}))
    return Counter()


def interleaved(torch, calls, n=TRAIN_STEPS):
    """Each of ``calls`` (name -> function) ``n`` times, in turns (the
    order flipped every round), the card idle before each: the median
    host µs from the call to its return (``issue_us``: the host's own
    time where a call launches fewer kernels than the launch queue holds,
    as a forward does) and to the card's end (``wall_ms``). Turns put the
    host's drift on every form alike. ``gc_ms``: the mean ms a call in
    the garbage collector."""
    import statistics

    got = {name: ([], [], []) for name in calls}
    for i in range(n):
        order = list(calls) if i % 2 == 0 else list(calls)[::-1]
        for name in order:
            torch.cuda.synchronize()
            with gc_pauses() as gc_ms:
                t0 = time.perf_counter()
                calls[name]()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
            got[name][0].append((t1 - t0) * 1e6)
            got[name][1].append((time.perf_counter() - t0) * 1e3)
            got[name][2].append(gc_ms[0])
    return {name: {"issue_us": statistics.median(a),
                   "wall_ms": statistics.median(b), "gc_ms": sum(c) / n}
            for name, (a, b, c) in got.items()}


def tp_model_forms(torch, dev, report, spec):
    """One model family under its shard plan at mp 1 against the same
    model unsharded (``spec``: label, make(), batch, loss(model, ids,
    labels), make_opt(model), plan, nl, want (launch counts a step),
    check_kernels(per_kernel, label), names (row kernels by name), path):
    ``DIST_COMPARE_STEPS`` eager steps from one state equal bit for bit,
    then the captured forms (``jit.to_static(full_graph=True)``) equal bit
    for bit, and the captured sharded steps equal to their eager twin
    (``eager_ticks``); each form built afresh and timed with only its
    model on the card (``dist_timed``: step ms, busy share, peak memory,
    launches by counter), the eager forms' launches of the row kernels by
    name through ``recorded``, the ops of a step that reach a ``DTensor``
    (each form's step under the counting mode, so both have taken the same
    steps), and, both models on the card after those same steps and timed
    in turns (``interleaved``), the host µs to issue a forward and loss
    and the eager step ms."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import observability as obs

    from paddle_tpu_torch.distributed import fleet

    label, ids, labels = spec["label"], *spec["batch"]
    hcg = fleet.get_hybrid_communicate_group()

    def trainer(sharded):
        model = spec["make"]()
        if sharded:
            spec["plan"](model, hcg.mesh)
        opt = spec["make_opt"](model)
        opt._ensure_accumulators()

        def step(i, lab):
            loss = spec["loss"](model, i, lab)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        return model, opt, step

    def steps(fn):
        return [float(fn(ids, labels)) for _ in range(DIST_COMPARE_STEPS)]

    res = {}
    torch.cuda.empty_cache()
    um, uo, ustep = trainer(False)
    ul = steps(ustep)
    sm, so, sstep = trainer(True)
    kinds = sorted({type(p).__name__ for p in sm.parameters()})
    check(kinds == ["DistParameter"], f"{label}: parameters {kinds}")
    sl = steps(sstep)
    _same_state(torch, _train_state(um, uo), _train_state(sm, so), ul, sl,
                f"{label}: {DIST_COMPARE_STEPS} sharded (mp 1) vs unsharded "
                f"eager steps from seed 0")
    counted = {}
    for form, step in (("sharded", sstep), ("unsharded", ustep)):
        with dtensor_dispatches(torch) as mode:       # the same history
            step(ids, labels)
        counted[form] = mode.count
    n = counted["sharded"]
    check(n[1] > 0, f"{label}: the dispatch mode saw no op")
    check(counted["unsharded"][0] == 0, f"{label}: unsharded DTensor ops")
    res["dtensor_dispatches_a_step"], res["ops_a_step"] = n
    res["unsharded_ops_a_step"] = counted["unsharded"][1]
    fwd = interleaved(torch, {
        "sharded": lambda: spec["loss"](sm, ids, labels),
        "unsharded": lambda: spec["loss"](um, ids, labels)})
    res["forward_issue_us"] = {k: v["issue_us"] for k, v in fwd.items()}
    h = res["forward_issue_us"]
    log(f"  {label}: {n[0]} of {n[1]} ops a sharded step reach a DTensor "
        f"({counted['unsharded'][1]} ops an unsharded step); "
        f"host {h['sharded']:.0f} µs to issue a sharded forward and loss vs "
        f"{h['unsharded']:.0f} µs unsharded "
        f"({h['sharded'] - h['unsharded']:+.0f} µs; medians of turns)")
    steps_in_turn = interleaved(torch, {
        "sharded": lambda: sstep(ids, labels),
        "unsharded": lambda: ustep(ids, labels)})
    res["eager_in_turns_ms"] = {k: v["wall_ms"]
                                for k, v in steps_in_turn.items()}
    res["eager_in_turns_gc_ms"] = {k: v["gc_ms"]
                                   for k, v in steps_in_turn.items()}
    t, gt = res["eager_in_turns_ms"], res["eager_in_turns_gc_ms"]
    log(f"  {label}: eager steps in turns, sharded {t['sharded']:.2f} ms vs "
        f"unsharded {t['unsharded']:.2f} ms "
        f"({t['sharded'] / t['unsharded'] - 1:+.2%}; medians); in the "
        f"garbage collector {gt['sharded']:.2f} vs {gt['unsharded']:.2f} ms "
        f"a step (means)")
    del um, uo, ustep, sm, so, sstep
    torch.cuda.empty_cache()
    names = spec["names"]
    res["eager"] = {}
    for form in ("sharded", "unsharded"):
        model, opt, step = trainer(form == "sharded")
        timed = dist_timed(torch, dev, lambda: step(ids, labels),
                           spec["nl"], f"{label} {form} step, eager",
                           want=spec["want"])
        out = recorded(
            lambda: profile_kernels(torch, lambda: step(ids, labels), 1,
                                    timed["step_ms"], f"{label} {form}"),
            _per_kernel,
            lambda o: spec["check_kernels"](o[1], f"{label} {form}"),
            f"{label} {form}")
        timed["by_name"] = named_launches(out[1], names)
        res["eager"][form] = timed
        del model, opt, step
        torch.cuda.empty_cache()
    record_launches(report, spec["path"],
                    res["eager"]["sharded"].pop("launches"))
    res["eager"]["unsharded"].pop("launches")
    by = {f: res["eager"][f]["by_name"] for f in ("sharded", "unsharded")}
    log(f"  {label}: row kernels by name, sharded {by['sharded']} vs "
        f"unsharded {by['unsharded']}")
    check(by["sharded"] == by["unsharded"],
          f"{label}: row kernels by name differ {by}")

    captured = {}
    for form in ("sharded", "unsharded", "sharded eager twin"):
        model, opt, step = trainer(form != "unsharded")
        fn = jit.to_static(step, full_graph=True)
        if form.endswith("twin"):
            with eager_ticks():
                losses = steps(fn)
        else:
            losses = steps(fn)
            entries = list(fn._cache.values())
            check(len(entries) == 1 and entries[0].graphed.captured,
                  f"{label} {form}: to_static made {len(entries)} entries, "
                  f"or did not capture")
            del entries
        captured[form] = (_train_state(model, opt), losses)
        del model, opt, step, fn
        torch.cuda.empty_cache()
    (a, la), (b, lb), (c, lc) = (captured[k] for k in (
        "sharded", "unsharded", "sharded eager twin"))
    _same_state(torch, a, b, la, lb,
                f"{label}: {DIST_COMPARE_STEPS} captured sharded vs captured "
                f"unsharded steps from seed 0")
    _same_state(torch, a, c, la, lc,
                f"{label}: {DIST_COMPARE_STEPS} captured sharded steps vs "
                f"their eager twin")
    del captured, a, b, c
    torch.cuda.empty_cache()
    fallbacks = obs.registry.get("jit.fallbacks").total() \
        if obs.registry.get("jit.fallbacks") else 0
    check(not fallbacks, f"{label}: jit.fallbacks {fallbacks}")
    res["captured"] = {}
    for form in ("sharded", "unsharded"):
        model, opt, step = trainer(form == "sharded")
        fn = jit.to_static(step, full_graph=True)
        fn(ids, labels)                        # the capture
        timed = dist_timed(torch, dev, lambda: fn(ids, labels), spec["nl"],
                           f"{label} {form} step, captured",
                           want=spec["want"])
        timed.pop("launches")
        res["captured"][form] = timed
        del model, opt, step, fn
        torch.cuda.empty_cache()
    for form in ("eager", "captured"):
        s_, u_ = res[form]["sharded"], res[form]["unsharded"]
        log(f"  {label} {form}: sharded {s_['step_ms']:.2f} ms vs unsharded "
            f"{u_['step_ms']:.2f} ms a step "
            f"({s_['step_ms'] / u_['step_ms'] - 1:+.2%}; in the garbage "
            f"collector {s_['gc_ms']:.2f} vs {u_['gc_ms']:.2f}); peak "
            f"{s_['peak_bytes'] / 2**30:.2f} vs "
            f"{u_['peak_bytes'] / 2**30:.2f} GiB")
    return res


def tp_mp2_steps(torch, dev, mesh=None):
    """``TP_MP2_STEPS`` AdamW steps of ``tp_two_ranks``'s model
    (``bench_llama``'s width at ``TP_MP2_LAYERS`` layers, bf16, seed 0,
    ``phase_train``'s batch), under ``llama_shard_plan`` over ``mesh``
    unless it is None: the losses; ``TP_MP2_PARAMS``' values before the
    steps, their step-1 gradients and their fp32 masters after the steps
    (a bf16 norm weight moves less than its ulp in 3 steps), whole (a
    rank gathers its shards) on the host; the mean ms of the steps
    after the first (the first gathers); the launches of the steps; and
    the shapes, dtypes and keyword arguments of each flash and RMSNorm
    kernel's first call (``first_kernel_calls``)."""
    from paddle_tpu_torch.distributed.auto_parallel.api import DistParameter
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama_shard_plan)
    from paddle_tpu_torch.optimizer import AdamW

    config = LlamaConfig(**{**TRAIN_CONFIG,
                            "num_hidden_layers": TP_MP2_LAYERS},
                         dtype="bfloat16")
    ids, labels = train_batch(torch, config, dev)
    model = LlamaForCausalLM(config, device=dev, seed=0)
    if mesh is not None:
        llama_shard_plan(model, mesh)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                multi_precision=True)
    named = dict(model.named_parameters())

    def whole(name, t):
        if isinstance(named[name], DistParameter):
            t = gather_shards(torch, named[name], t)
        rows = TP_MP2_PARAMS[name]
        t = t if rows is None else t[rows[0]:rows[1]]
        return t.detach().cpu().clone()

    out = dict(init={n: whole(n, named[n]) for n in TP_MP2_PARAMS},
               losses=[], local_heads=named[
                   "llama.layers.0.self_attn.q_proj.weight"].shape[0]
               // (config.hidden_size // config.num_attention_heads))
    reset_counts()
    ms = []
    with first_kernel_calls() as calls:
        for i in range(TP_MP2_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = model(ids, labels=labels)
            loss.backward()
            if i == 0:
                out["grads"] = {n: whole(n, named[n].grad)
                                for n in TP_MP2_PARAMS}
            opt.step()
            opt.clear_grad()
            out["losses"].append(float(loss.detach()))
            ms.append((time.perf_counter() - t0) * 1e3)
    out.update(launches=read_counts(), calls=calls,
               step_ms=sum(ms[1:]) / len(ms[1:]),
               final={n: whole(n, opt._master_weights[id(named[n])])
                      for n in TP_MP2_PARAMS})
    del model, opt, named
    torch.cuda.empty_cache()
    return out


def gather_shards(torch, p, t):
    """The whole tensor of which ``t`` is this rank's shard of the
    ``DistParameter`` ``p``, by ``torch.distributed.all_gather`` over the
    group of each mesh dimension that shards it. Not ``p.gather`` /
    ``full_tensor()``: DTensor's functional all-gather ends the process
    with a segmentation fault in ``wait_tensor`` under gloo on CUDA
    tensors (torch 2.11, PERF.md PR 22); NCCL and gloo on the CPU run
    it."""
    from torch.distributed.tensor import Shard

    dm = p.device_mesh
    t = t.detach().contiguous()
    for m, pl in reversed(list(enumerate(p.torch_placements))):
        if dm.size(m) == 1 or pl.is_replicate():
            continue
        check(type(pl) is Shard, f"gather_shards: placement {pl}")
        parts = [torch.empty_like(t) for _ in range(dm.size(m))]
        torch.distributed.all_gather(parts, t, group=dm.get_group(m))
        t = torch.cat(parts, dim=pl.dim)
    return t


@contextlib.contextmanager
def first_kernel_calls(split=()):
    """The shapes and dtypes of the positional tensor arguments (other
    arguments as given) and the keyword arguments of the first call of
    each flash and RMSNorm kernel in the block, by count key; the kernels
    still launch and count. ``split`` names flash keyword arguments whose
    every value keeps a first call of its own, under ``key/name=value``
    (the ring's causal and full blocks)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    sites = {"flash": (fa, "_flash_fwd_kernel"),
             "flash_bwd": (fa, "_flash_bwd_kernel"),
             "rms_norm": (rn, "rms_norm_fwd"),
             "rms_norm_bwd": (rn, "rms_norm_bwd")}
    calls = {}
    saved = {key: getattr(mod, attr) for key, (mod, attr) in sites.items()}

    def recorder(key, fn):
        def call(*args, **kw):
            name = "/".join([key] + [f"{n}={kw.get(n)}" for n in split]) \
                if key.startswith("flash") else key
            calls.setdefault(name, (
                [(tuple(a.shape), a.dtype) if hasattr(a, "shape") else a
                 for a in args], dict(kw)))
            return fn(*args, **kw)
        return call

    for key, (mod, attr) in sites.items():
        setattr(mod, attr, recorder(key, saved[key]))
    try:
        yield calls
    finally:
        for key, (mod, attr) in sites.items():
            setattr(mod, attr, saved[key])


def kernels_at_calls(torch, dev, calls):
    """Each kernel of ``first_kernel_calls`` again, on seeded random
    inputs of its recorded shapes and dtypes with its recorded keyword
    arguments, against its plain version, at the tolerances of its own
    phase: flash out and dq, dk, dv within ``tolerance(dtype, 1e-4)``,
    lse within 1e-4 (``phase_flash``, ``phase_flash_bwd``); RMSNorm y and
    dx within ``tolerance(dtype, 1e-5)``, dw ``tolerance(w dtype, 1e-3)``
    (``phase_rms_norm``). Returns, by count key, the first argument's
    shape, the worst error and the worst share of the tolerance (lse's
    error over 1e-4)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    g = torch.Generator(device=dev).manual_seed(22)

    def rnd(spec):
        shape, dt = spec
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    def weight(spec):
        shape, dt = spec
        return (1 + 0.1 * torch.randn(*shape, generator=g,
                                      device=dev)).to(dt)

    def worst(pairs, tols):
        errs = [close_err(a, b, *t) for (a, b), t in zip(pairs, tols)]
        return max(e for e, _ in errs), max(sh for _, sh in errs)

    out = {}
    for key in sorted(k for k in calls if k.startswith("flash")):
        args, kw = calls[key]
        check(args[-2:] == [None, None],
              f"{key}: a seed or key bias in the call ({args[-2:]})")
        q, k, v = (rnd(a) for a in args[:3])
        fo, flse = fa._flash_fwd_kernel(q, k, v, None, None, **kw)
        tol = tolerance(q.dtype, 1e-4)
        if key.split("/")[0] == "flash":
            ro, rlse = fa._flash_fwd_reference(q, k, v, None, None, **kw)
            e, sh = worst([(fo, ro)], [tol])
            sh = max(sh, max_err(flse, rlse) / 1e-4)
        else:
            do = rnd(args[5])
            got = fa._flash_bwd_kernel(q, k, v, fo, flse, do, None, None,
                                       **kw)
            ref = fa._flash_bwd_reference(q, k, v, fo, flse, do, None,
                                          None, **kw)
            e, sh = worst(list(zip(got, ref)), [tol] * 3)
        out[key] = dict(shape=list(args[0][0]), max_abs_err=e, share=sh)
    for key in ("rms_norm", "rms_norm_bwd"):
        args, kw = calls[key]
        x, w = rnd(args[0]), weight(args[1])
        tol_x, tol_w = tolerance(x.dtype, 1e-5), tolerance(w.dtype, 1e-3)
        if key == "rms_norm":
            e, sh = worst([(rn.rms_norm_fwd(x, w, **kw),
                            rn.rms_norm_reference(x, w, **kw))], [tol_x])
        else:
            gy = rnd(args[2])
            e, sh = worst(list(zip(rn.rms_norm_bwd(x, w, gy, **kw),
                                   rn.rms_norm_bwd_reference(x, w, gy,
                                                             **kw))),
                          [tol_x, tol_w])
        out[key] = dict(shape=list(args[0][0]), max_abs_err=e, share=sh)
    torch.cuda.synchronize()
    return out


def spawn_two_ranks(torch, flag):
    """``chip_smoke.py FLAG R DIR`` for ranks 0 and 1 over gloo on the
    card, run to their end (their last lines printed): (what each rank
    saved, the wall seconds)."""
    import os
    import socket
    import tempfile

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    with tempfile.TemporaryDirectory() as d:
        env = {**os.environ, "PADDLE_TRAINERS_NUM": "2",
               "PADDLE_MASTER": f"127.0.0.1:{port}"}
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), flag, str(r), d],
            env={**env, "PADDLE_TRAINER_ID": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        wall = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, logs)):
            for line in out.strip().splitlines()[-(8 if p.returncode == 0
                                                   else 60):]:
                log(f"    rank {r}: {line}")
            check(p.returncode == 0, f"{flag} rank {r} exited {p.returncode}")
        return [torch.load(os.path.join(d, f"rank{r}.pt"))
                for r in range(2)], wall


def held_against(torch, ref, got, names, tols, label):
    """One two-rank run (``got``: rank 0's whole tensors, as gathered)
    against the unsharded ``ref``: every step's loss (``got["losses"]``),
    the step-1 gradients by max |g - ref g| / max |ref g| and the updates
    of the steps by ||dw - ref dw|| / ||ref dw||, each within its limit
    of ``tols`` (loss, gradient, update); the initial values equal bit
    for bit. Logs and returns the gaps."""
    def rel_max(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max())

    def rel_update(n):
        dw = got["final"][n].float() - got["init"][n].float()
        want = ref["final"][n].float() - ref["init"][n].float()
        return float((dw - want).norm() / want.norm())

    loss_err = [abs(a - b) for a, b in zip(got["losses"], ref["losses"])]
    grad_err = {n: rel_max(got["grads"][n], ref["grads"][n]) for n in names}
    upd_err = {n: rel_update(n) for n in names}
    log(f"  {label}: losses {[round(v, 5) for v in got['losses']]} vs "
        f"unsharded {[round(v, 5) for v in ref['losses']]}, apart "
        f"{[f'{e:.3g}' for e in loss_err]} (tol {tols[0]})")
    log(f"  {label} step-1 gradients, max |g - unsharded g| / max "
        f"|unsharded g| (tol {tols[1]}): "
        + ", ".join(f"{n} {e:.3g}" for n, e in grad_err.items()))
    log(f"  {label} updates, ||dw - unsharded dw|| / ||unsharded dw|| "
        f"(tol {tols[2]}): "
        + ", ".join(f"{n} {e:.3g}" for n, e in upd_err.items()))
    apart = [n for n in names
             if not torch.equal(got["init"][n], ref["init"][n])]
    check(not apart, f"{label}: initial values of {apart} differ from the "
                     f"unsharded model's")
    check(all(e <= tols[0] for e in loss_err),
          f"{label}: losses {loss_err} from unsharded")
    check(all(e <= tols[1] for e in grad_err.values()),
          f"{label}: step-1 gradients {grad_err}")
    check(all(e <= tols[2] for e in upd_err.values()),
          f"{label}: updates {upd_err}")
    return dict(losses=got["losses"], loss_err=loss_err, grad_err=grad_err,
                update_err=upd_err)


def rank_setup(rank):
    """A rank of a two-rank run: the card, gloo over ``PADDLE_MASTER``."""
    import faulthandler
    import os

    import torch
    import torch.distributed as tdist

    faulthandler.enable()               # a crash prints where it was
    sys.path.insert(0, str(HERE))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    host, port = os.environ["PADDLE_MASTER"].split(":")
    tdist.init_process_group("gloo", init_method=f"tcp://{host}:{port}",
                             rank=rank, world_size=2)
    return torch, tdist, dev


def tp_two_ranks(torch, dev):
    """mp 2 as two processes on the one card over gloo: ``tp_mp2_steps``
    under ``llama_shard_plan`` on dp 1 x mp 2 in each rank
    (``--tp-rank``), against ``tp_mp2_steps`` unsharded in this process.
    Each rank's kernels run at its local shapes (8 of 16 heads, the MLP at
    2816 of 5632). Held: the gathered values before the steps equal the
    unsharded ones bit for bit, and both ranks gather the same bits; every
    step's loss within ``TP_MP2_LOSS_TOL``, the step-1 gradients within
    ``TP_MP2_GRAD_TOL`` and the updates within ``TP_MP2_UPDATE_TOL`` of
    the unsharded run's; each rank's flash and RMSNorm launches the step's
    counts, flash at 8 heads; and each of those kernels against its plain
    version at the shapes of its first call in the rank
    (``kernels_at_calls``)."""
    ref = tp_mp2_steps(torch, dev)
    got, wall = spawn_two_ranks(torch, "--tp-rank")
    return tp_mp2_verdict(torch, ref, got, wall)


def tp_mp2_verdict(torch, ref, got, wall):
    """``tp_two_ranks``' checks of the ranks' ``got`` against the
    unsharded ``ref``; its report."""
    for part in ("init", "grads", "final"):
        apart = [n for n in TP_MP2_PARAMS
                 if not torch.equal(got[0][part][n], got[1][part][n])]
        check(not apart, f"mp-2: the ranks gather different {part} of "
                         f"{apart}")
    out = held_against(torch, ref, got[0], TP_MP2_PARAMS,
                       (TP_MP2_LOSS_TOL, TP_MP2_GRAD_TOL, TP_MP2_UPDATE_TOL),
                       "mp 2 on one card over gloo")
    local = [g["local_kernels"] for g in got]
    log(f"  mp 2: local heads {got[0]['local_heads']}; "
        f"{got[0]['step_ms']:.1f} / {got[1]['step_ms']:.1f} ms a step "
        f"(ranks 0 / 1; unsharded {ref['step_ms']:.1f}), {wall:.1f} s wall")
    for r, lk in enumerate(local):
        log(f"  mp 2 rank {r}, kernels vs plain at its first calls' shapes: "
            + ", ".join(f"{k} {v['shape']} err {v['max_abs_err']:.3g} "
                        f"({v['share']:.3g} of the tolerance)"
                        for k, v in lk.items()))
    heads = TRAIN_CONFIG["num_attention_heads"] // 2
    for r, g in enumerate(got):
        check(g["launches"] == {k: v * TP_MP2_STEPS for k, v in
                                train_launches(TP_MP2_LAYERS).items()},
              f"mp-2 rank {r} launches {g['launches']}")
        check(g["local_kernels"]["flash"]["shape"][1] == heads
              and g["local_heads"] == heads,
              f"mp-2 rank {r}: flash at {g['local_kernels']['flash']}")
        bad = {k: v for k, v in g["local_kernels"].items()
               if not v["share"] <= 1.0}
        check(not bad, f"mp-2 rank {r}: kernels vs plain {bad}")
    out.update(unsharded_losses=ref["losses"],
               step_ms=[g["step_ms"] for g in got],
               unsharded_step_ms=ref["step_ms"], wall_s=wall,
               local_heads=got[0]["local_heads"],
               local_kernels=local, launches=got[0]["launches"])
    return out


def tp_rank_main(rank, out_dir):
    """One rank of ``tp_two_ranks`` (``python chip_smoke.py --tp-rank R
    DIR``): gloo on the card, ``tp_mp2_steps`` under the plan at mp 2,
    then ``kernels_at_calls``; writes ``DIR/rank<R>.pt``."""
    torch, tdist, dev = rank_setup(rank)
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    print(f"rank {rank}: fleet.init done", flush=True)
    out = tp_mp2_steps(torch, dev, hcg.mesh)
    print(f"rank {rank}: steps done", flush=True)
    out["local_kernels"] = kernels_at_calls(torch, dev, out.pop("calls"))
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    print(f"rank {rank}: losses {out['losses']}, {out['step_ms']:.1f} ms a "
          f"step, {out['local_heads']} local heads", flush=True)
    tdist.destroy_process_group()
    return 0


def phase_tensor_parallel(torch, dev, report):
    """Tensor parallelism on the card (``distributed/fleet``,
    ``auto_parallel``, the models' shard plans): ``fleet.init`` at mp 1 on
    NCCL (world 1), then ``phase_train``'s Llama (``bench_llama``: 645M,
    bf16, 4 x 2048, ``AdamW(multi_precision=True)``) under
    ``llama_shard_plan`` and GPT-2 medium (``GptTrain``: 8 x 1024, dropout
    0.1) under ``gpt_shard_plan``, each against itself unsharded
    (``tp_model_forms``), then mp 2 as two gloo ranks on the card
    (``tp_two_ranks``)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (GPTConfig, LlamaConfig,
                                         LlamaForCausalLM, gpt_shard_plan,
                                         llama_shard_plan)
    from paddle_tpu_torch.optimizer import AdamW

    saved = _tp_env(1, 0)
    obs.reset()
    obs.enable()
    res = {}
    try:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}
        hcg = fleet.init(is_collective=True, strategy=strategy)
        check(dist.get_backend() == "nccl", "fleet.init: backend not nccl")
        check(hcg.get_model_parallel_world_size() == 1, "mp degree")
        config = LlamaConfig(**TRAIN_CONFIG, dtype="bfloat16")
        nl = config.num_hidden_layers
        flash_names = [n for pair in FLASH_KERNELS.values() for n in pair]
        res["llama"] = tp_model_forms(torch, dev, report, dict(
            label="Llama", make=lambda: LlamaForCausalLM(config, device=dev,
                                                         seed=0),
            batch=train_batch(torch, config, dev), loss=_llama_loss,
            make_opt=lambda m: AdamW(learning_rate=3e-4,
                                     parameters=m.parameters(),
                                     multi_precision=True),
            plan=llama_shard_plan, nl=nl, want=train_launches(nl),
            check_kernels=lambda pk, lb: check_train_kernels(pk, nl, lb),
            names=flash_names + list(RMS_TRAIN_KERNELS),
            path="tensor_parallel"))
        gpt = GptTrain()
        gcfg = GPTConfig.gpt2_medium()
        gnl = gcfg.num_hidden_layers
        res["gpt"] = tp_model_forms(torch, dev, report, dict(
            label="GPT-2 medium", make=lambda: gpt.model(torch, dev),
            batch=gpt.batch(torch, gcfg, dev), loss=gpt.loss,
            make_opt=gpt.opt, plan=gpt_shard_plan, nl=gnl,
            want={**{k: 0 for k in train_launches(gnl)},
                  "flash": gnl, "flash_bwd": gnl},
            check_kernels=lambda pk, lb: check_flash_route(
                pk, {"fwd": gnl, "dq": gnl, "dkv": gnl}, lb),
            names=flash_names, path="gpt_tensor_parallel"))
        fleet.set_hybrid_communicate_group(None)
    finally:
        dist.destroy_process_group()
        obs.disable()
        obs.reset()
        _restore_env(saved)
    res["mp2"] = tp_two_ranks(torch, dev)
    report["tensor_parallel"] = res


# ---------------------------------------------------------------------------
# expert parallelism: ERNIE-MoE under its plan at ep 1 on NCCL, a
# moe_group's einsum path at world 1, ep 2 as two gloo ranks
# ---------------------------------------------------------------------------
#: the two-rank run: bench_moe's width at 2 layers (layer 0 dense, layer
#: 1 MoE with 4 of the 8 experts a rank, attention tensor parallel over
#: the same axis), random routing off, 3 AdamW steps
EP2_LAYERS, EP2_STEPS = 2, 3
#: the parameters held against the unsharded run (rows of the
#: vocabulary-sharded ones about the shards' boundary, 16000)
EP2_PARAMS = {
    "model.embed_tokens.weight": (15872, 16128),
    "model.layers.0.self_attn.q_proj.weight": None,
    "model.layers.0.mlp.down_proj.weight": None,
    "model.layers.1.mlp.gate.weight": None,
    "model.layers.1.mlp.experts.w0": None,
    "model.layers.1.mlp.experts.w1": None,
    "model.layers.1.post_attention_layernorm.weight": None,
    "lm_head.weight": (15872, 16128),
}
#: ep 2 against the unsharded model (|loss - unsharded loss| at every
#: step; max |g - unsharded g| / max |unsharded g| of the step-1
#: gradients; ||dw - unsharded dw|| / ||unsharded dw|| of the 3-step
#: updates of the fp32 masters), all in bf16 with the experts' partial
#: outputs rounded to bf16 before their all-reduce: about 3x the largest
#: gaps measured on the H100 (PERF.md PR 23: 3.81e-6, 0.0828, 0.159)
EP2_LOSS_TOL = 1.5e-5
EP2_GRAD_TOL = 0.25
EP2_UPDATE_TOL = 0.5
#: [expert_parallel] (ii): ``FusedMoELayer`` at bench_moe's width on its
#: 4 x 2048 tokens, random routing off; the einsum path against its
#: plain dense dispatch within ``tolerance(bf16, 1e-2)`` (bf16 products
#: summed over d = 2048 in another order)
EP_LAYER_TOL = 1e-2


def ep2_steps(torch, dev, mesh=None):
    """``EP2_STEPS`` AdamW steps of ``ep2_two_ranks``' model
    (``MOE_CONFIG`` at ``EP2_LAYERS`` layers, bf16, seed 0, random
    routing off, ``MoeTrain``'s batch), under ``ernie_moe_shard_plan``
    over ``mesh`` (``mp_axis = ep_axis = "ep"``) unless it is None: as
    ``tp_mp2_steps`` returns, for ``EP2_PARAMS``, with the expert bank's
    local shape."""
    from paddle_tpu_torch.distributed.auto_parallel.api import DistParameter
    from paddle_tpu_torch.models import ernie_moe_shard_plan
    from paddle_tpu_torch.optimizer import AdamW

    model = moe_model(torch, dev, layers=EP2_LAYERS)
    for layer in model.model.layers:
        if layer.is_moe:
            layer.mlp.gate._random2 = False
    ids, labels = _ids_and_labels(torch, model.config, dev, MOE_BATCH,
                                  MOE_SEQ)
    if mesh is not None:
        ernie_moe_shard_plan(model, mesh, mp_axis="ep", ep_axis="ep")
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                multi_precision=True)
    named = dict(model.named_parameters())

    def whole(name, t):
        if isinstance(named[name], DistParameter):
            t = gather_shards(torch, named[name], t)
        rows = EP2_PARAMS[name]
        t = t if rows is None else t[rows[0]:rows[1]]
        return t.detach().cpu().clone()

    out = dict(init={n: whole(n, named[n]) for n in EP2_PARAMS},
               losses=[], bank=list(named["model.layers.1.mlp.experts.w0"]
                                    .shape))
    reset_counts()
    ms = []
    with first_kernel_calls() as calls:
        for i in range(EP2_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = model(ids, labels=labels)
            loss.backward()
            if i == 0:
                out["grads"] = {n: whole(n, named[n].grad)
                                for n in EP2_PARAMS}
            opt.step()
            opt.clear_grad()
            out["losses"].append(float(loss.detach()))
            ms.append((time.perf_counter() - t0) * 1e3)
    out.update(launches=read_counts(), calls=calls,
               step_ms=sum(ms[1:]) / len(ms[1:]),
               final={n: whole(n, opt._master_weights[id(named[n])])
                      for n in EP2_PARAMS})
    del model, opt, named
    torch.cuda.empty_cache()
    return out


def ep2_two_ranks(torch, dev):
    """ep 2 as two processes on the one card over gloo (``--ep-rank``):
    ``ep2_steps`` under ``ernie_moe_shard_plan`` on dp 1 x ep 2 in each
    rank (each holds experts [4, 2048, 1408] of the 8 and 8 of the 16
    heads), against ``ep2_steps`` unsharded in this process: the gaps
    within ``EP2_*_TOL`` (``held_against``), both ranks gather the same
    bits, each rank launches the step's flash and RMSNorm counts (flash
    at 8 heads), and each of those kernels against its plain version at
    the shapes of its first call in the rank (``kernels_at_calls``)."""
    ref = ep2_steps(torch, dev)
    got, wall = spawn_two_ranks(torch, "--ep-rank")
    for part in ("init", "grads", "final"):
        apart = [n for n in EP2_PARAMS
                 if not torch.equal(got[0][part][n], got[1][part][n])]
        check(not apart, f"ep 2: the ranks gather different {part} of "
                         f"{apart}")
    out = held_against(torch, ref, got[0], EP2_PARAMS,
                       (EP2_LOSS_TOL, EP2_GRAD_TOL, EP2_UPDATE_TOL),
                       "ep 2 on one card over gloo")
    experts = MOE_CONFIG["num_experts"] // 2
    heads = MOE_CONFIG["num_attention_heads"] // 2
    for r, g in enumerate(got):
        log(f"  ep 2 rank {r}: bank {g['bank']}, {g['step_ms']:.1f} ms a "
            f"step (unsharded {ref['step_ms']:.1f}); kernels vs plain at "
            f"its first calls' shapes: "
            + ", ".join(f"{k} {v['shape']} err {v['max_abs_err']:.3g} "
                        f"({v['share']:.3g} of the tolerance)"
                        for k, v in g["local_kernels"].items()))
        check(g["bank"] == [experts, MOE_CONFIG["hidden_size"],
                            MOE_CONFIG["moe_intermediate_size"]],
              f"ep 2 rank {r}: expert bank {g['bank']}")
        check(g["launches"] == {k: v * EP2_STEPS for k, v in
                                train_launches(EP2_LAYERS).items()},
              f"ep 2 rank {r} launches {g['launches']}")
        check(g["local_kernels"]["flash"]["shape"][1] == heads,
              f"ep 2 rank {r}: flash at {g['local_kernels']['flash']}")
        bad = {k: v for k, v in g["local_kernels"].items()
               if not v["share"] <= 1.0}
        check(not bad, f"ep 2 rank {r}: kernels vs plain {bad}")
    out.update(step_ms=[g["step_ms"] for g in got],
               unsharded_step_ms=ref["step_ms"], wall_s=wall,
               bank=got[0]["bank"],
               local_kernels=[g["local_kernels"] for g in got],
               launches=got[0]["launches"])
    return out


def ep_rank_main(rank, out_dir):
    """One rank of ``ep2_two_ranks`` (``python chip_smoke.py --ep-rank R
    DIR``): ``ep2_steps`` under the plan on dp 1 x ep 2, then
    ``kernels_at_calls``; writes ``DIR/rank<R>.pt``."""
    torch, tdist, dev = rank_setup(rank)
    from paddle_tpu_torch import distributed as dist

    out = ep2_steps(torch, dev, dist.ProcessMesh([[0, 1]], ["dp", "ep"]))
    out["local_kernels"] = kernels_at_calls(torch, dev, out.pop("calls"))
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    print(f"rank {rank}: losses {out['losses']}, {out['step_ms']:.1f} ms a "
          f"step, bank {out['bank']}", flush=True)
    tdist.destroy_process_group()
    return 0


def ep_layer_paths(torch, dev):
    """``FusedMoELayer`` at bench_moe's width (d 2048, experts 8 x 1408,
    top-2 GShard, random routing off, bf16) on its 4 x 2048 tokens: with
    ``moe_group`` over a one-rank ``ep`` axis it takes the einsum path
    (the dense ``[N, E, C]`` dispatch), held against the plain dense
    dispatch computed here expert by expert from the same routing
    (``tolerance(bf16, EP_LAYER_TOL)``); forward and forward + backward
    ms of it and of the same layer on the index path, and each path's
    peak memory above the inputs."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.communication.group import axis_group
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        FusedMoELayer, gate as moe_gate)

    d, h, e = (MOE_CONFIG["hidden_size"], MOE_CONFIG["moe_intermediate_size"],
               MOE_CONFIG["num_experts"])
    n = MOE_BATCH * MOE_SEQ
    group = axis_group(dist.ProcessMesh([0], ["ep"]), "ep")
    make = functools.partial(
        FusedMoELayer, d, h, e, gate={"type": "gshard", "topk": 2,
                                      "random_routing": False},
        device=dev, dtype=torch.bfloat16, seed=0)
    einsum, index = make(moe_group=group), make()
    check(einsum._mesh is not None and index._mesh is None,
          "FusedMoELayer paths")
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        got = einsum(x)
        gate, ex = einsum.gate, einsum.experts
        probs, cap, u = gate.route(x)
        combine, dispatch = moe_gate._dispatch_from_probs(
            probs, u, k=2, capacity=cap, normalize=True, random2=False)
        ys = []
        for i in range(e):
            xe = dispatch[:, i].t() @ x                     # [C, d]
            hid = torch.nn.functional.gelu(xe @ ex.w0[i] + ex.b0[i])
            ys.append(hid @ ex.w1[i] + ex.b1[i])
        want = torch.einsum("nec,ecd->nd", combine, torch.stack(ys))
    err, share = close_err(got, want, *tolerance(torch.bfloat16,
                                                 EP_LAYER_TOL))
    log(f"  FusedMoELayer(moe_group) einsum path at [{n}, {d}], "
        f"capacity {cap}: vs the plain dense dispatch err {err:.3g} "
        f"({share:.3g} of the tolerance)")
    check(share <= 1.0, f"einsum path vs plain: {err} ({share} of tol)")
    out = dict(capacity=cap, max_abs_err=err, share=share)
    w = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    for name, layer in (("einsum", einsum), ("index", index)):
        xg = x.clone().requires_grad_()

        def fwd():
            with torch.no_grad():
                layer(x)

        def step():
            (layer(xg) * w).sum().backward()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        out[name] = dict(forward_ms=time_ms(fwd, iters=5, warmup=1),
                         step_ms=time_ms(step, iters=5, warmup=1),
                         peak_bytes=peak)
        o = out[name]
        log(f"  FusedMoELayer {name} path: forward {o['forward_ms']:.2f} ms, "
            f"forward + backward {o['step_ms']:.2f} ms, peak "
            f"{peak / 2**30:.2f} GiB above the inputs")
    del einsum, index, x, w, combine, dispatch
    torch.cuda.empty_cache()
    return out


def phase_expert_parallel(torch, dev, report):
    """Expert parallelism on the card (``incubate.distributed.models.moe``
    with a mesh axis, ``ernie_moe_shard_plan``): NCCL at world 1, then (i)
    ``bench_moe``'s ERNIE-MoE (``MoeTrain``: bf16, 4 x 2048,
    ``AdamW(multi_precision=True)``) under ``ernie_moe_shard_plan`` on
    dp 1 x ep 1 against the same model unplanned (``tp_model_forms``:
    equal bit for bit over 3 steps, eager and captured; step ms, busy
    share, peak memory, rows 2-5 by name); (ii) ``FusedMoELayer`` with a
    ``moe_group`` (``ep_layer_paths``); (iii) ep 2 as two gloo ranks on
    the card (``ep2_two_ranks``)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ErnieMoeConfig, ernie_moe_shard_plan

    saved = _tp_env(1, 0)
    obs.reset()
    obs.enable()
    res = {}
    try:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}
        fleet.init(is_collective=True, strategy=strategy)
        check(dist.get_backend() == "nccl", "fleet.init: backend not nccl")
        mesh = dist.ProcessMesh([[0]], ["dp", "ep"])
        spec = MoeTrain()
        nl = MOE_CONFIG["num_hidden_layers"]
        flash_names = [n for pair in FLASH_KERNELS.values() for n in pair]
        res["planned"] = tp_model_forms(torch, dev, report, dict(
            label="ERNIE-MoE", make=lambda: moe_model(torch, dev),
            batch=spec.batch(torch, ErnieMoeConfig(**MOE_CONFIG), dev),
            loss=spec.loss, make_opt=spec.opt,
            plan=lambda m, _: ernie_moe_shard_plan(m, mesh, mp_axis="ep",
                                                   ep_axis="ep"),
            nl=nl, want=train_launches(nl),
            check_kernels=lambda pk, lb: check_train_kernels(pk, nl, lb),
            names=flash_names + list(RMS_TRAIN_KERNELS),
            path="expert_parallel"))
        res["layer"] = ep_layer_paths(torch, dev)
        fleet.set_hybrid_communicate_group(None)
    finally:
        dist.destroy_process_group()
        obs.disable()
        obs.reset()
        _restore_env(saved)
    res["ep2"] = ep2_two_ranks(torch, dev)
    report["expert_parallel"] = res


# ---------------------------------------------------------------------------
# ZeRO sharding: group_sharded_parallel at world 1 on NCCL, two gloo ranks
# ---------------------------------------------------------------------------
ZERO_LEVELS = ("os", "os_g", "p_g_os")
#: each level's two ranks against the unsharded model (the gaps as
#: ``held_against`` measures them; each rank on half of the batch in
#: bf16, the unsharded run on all of it): about 3x the largest gaps
#: measured on the H100, the same at every level (PERF.md PR 23:
#: 1.82e-4, 0.00649, 0.0176)
ZERO_LOSS_TOL = 5.5e-4
ZERO_GRAD_TOL = 0.02
ZERO_UPDATE_TOL = 0.055


def zero_forms(torch, dev, report):
    """``phase_train``'s Llama (``bench_llama``: 645M, bf16, 4 x 2048,
    ``AdamW(multi_precision=True)``) through ``group_sharded_parallel``
    at each level at world 1: ``DIST_COMPARE_STEPS`` eager steps equal
    bit for bit to the plain step's from one state, then the captured
    step (``jit.to_static(full_graph=True)``) equal to the captured
    plain step; each level's eager step timed (``dist_timed``: step ms,
    busy share, peak memory) with only its model on the card, the
    ``"p_g_os"`` steps' launches kept as the ``sharding`` path's."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    config = LlamaConfig(**TRAIN_CONFIG, dtype="bfloat16")
    nl = config.num_hidden_layers
    ids, labels = train_batch(torch, config, dev)

    def trainer(level, captured=False):
        model = LlamaForCausalLM(config, device=dev, seed=0)
        opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                    multi_precision=True)
        wrapped = model
        if level is not None:
            wrapped, opt, _ = dist.group_sharded_parallel(model, opt, level)
        opt._ensure_accumulators()

        def step(i, lab):
            loss = _llama_loss(wrapped, i, lab)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        return model, opt, jit.to_static(step, full_graph=True) \
            if captured else step

    res = {}
    for captured in (False, True):
        form = "captured" if captured else "eager"
        torch.cuda.empty_cache()
        pm, po, pstep = trainer(None, captured)
        pl = [float(pstep(ids, labels)) for _ in range(DIST_COMPARE_STEPS)]
        plain = (_train_state(pm, po), pl)
        del pm, po, pstep
        for level in ZERO_LEVELS:
            torch.cuda.empty_cache()
            m, o, step = trainer(level, captured)
            ll = [float(step(ids, labels)) for _ in range(DIST_COMPARE_STEPS)]
            _same_state(torch, plain[0], _train_state(m, o), plain[1], ll,
                        f"Llama {level} ({form}): {DIST_COMPARE_STEPS} "
                        f"steps at world 1 vs the plain step")
            del m, o, step
        del plain
    for level in (None,) + ZERO_LEVELS:
        torch.cuda.empty_cache()
        m, o, step = trainer(level)
        timed = dist_timed(torch, dev, lambda: step(ids, labels), nl,
                           f"Llama {level or 'plain'} step, eager")
        launches = timed.pop("launches")
        if level == "p_g_os":
            record_launches(report, "sharding", launches)
        res[level or "plain"] = timed
        del m, o, step
    torch.cuda.empty_cache()
    return res


def zero_bytes(model, opt):
    """This rank's bytes of parameters and of optimizer states (moments
    and fp32 masters), from the tensors' own sizes."""
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    states = sum(t.numel() * t.element_size()
                 for store in (*opt._accumulators.values(),
                               opt._master_weights)
                 for t in store.values())
    return params, states


def zero_rank_steps(torch, dev, rank):
    """One rank's ``tp_mp2_steps`` model (``bench_llama``'s width at
    ``TP_MP2_LAYERS`` layers, bf16, seed 0) at no sharding and at each
    level, ``TP_MP2_STEPS`` AdamW steps on its half of the batch: per
    level the losses, ``TP_MP2_PARAMS``' values before, the ranks' mean
    step-1 gradients and the fp32 masters after (whole, on the host),
    this rank's bytes of parameters and states after the first step
    (``zero_bytes``) and ``memory_allocated``, and the mean ms of the
    steps after the first."""
    import gc

    import torch.distributed as tdist

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    config = LlamaConfig(**{**TRAIN_CONFIG,
                            "num_hidden_layers": TP_MP2_LAYERS},
                         dtype="bfloat16")
    ids, labels = (t.chunk(2)[rank] for t in train_batch(torch, config, dev))

    def gathered(t, pg=None):
        parts = [torch.empty_like(t) for _ in range(2)]
        tdist.all_gather(parts, t.contiguous(), group=pg)
        return torch.cat(parts)

    out = {}
    for level in (None,) + ZERO_LEVELS:
        gc.collect()            # the last level's model leaves in cycles
        torch.cuda.empty_cache()
        model = LlamaForCausalLM(config, device=dev, seed=0)
        opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                    multi_precision=True)
        named = dict(model.named_parameters())
        init = {n: named[n].detach().cpu().clone() for n in TP_MP2_PARAMS}
        wrapped = model
        if level is not None:
            wrapped, opt, _ = dist.group_sharded_parallel(model, opt, level)
        rows = getattr(opt, "_row_shards", None)

        def whole(n, t, of=None):
            p = named[n]
            if rows is not None and (id(p) in rows.views
                                     or id(p) in rows.sharded):
                t = gathered(t, rows.group)
            span = TP_MP2_PARAMS[n]
            t = t if span is None else t[span[0]:span[1]]
            return t.detach().cpu().clone()

        def mean_grad(n):
            p = named[n]
            if rows is not None and id(p) in rows.sharded:
                return whole(n, p.grad)
            g = p.grad.detach().clone()
            tdist.all_reduce(g)
            g /= 2
            span = TP_MP2_PARAMS[n]
            return (g if span is None else g[span[0]:span[1]]).cpu()

        def master(p):
            key = rows.views[id(p)][1] if rows is not None \
                and id(p) in rows.views else p
            return opt._master_weights[id(key)]

        res = dict(init={n: init[n] if span is None
                         else init[n][span[0]:span[1]]
                         for n, span in TP_MP2_PARAMS.items()},
                   losses=[])
        ms = []
        for i in range(TP_MP2_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = wrapped(ids, labels=labels)
            loss.backward()
            if i == 0:
                res["grads"] = {n: mean_grad(n) for n in TP_MP2_PARAMS}
            opt.step()
            opt.clear_grad()
            lo = loss.detach().float().reshape(1)
            tdist.all_reduce(lo)
            res["losses"].append(float(lo) / 2)
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                torch.cuda.synchronize()
                res["bytes"] = zero_bytes(model, opt)
                res["allocated"] = torch.cuda.memory_allocated(dev)
        res["step_ms"] = sum(ms[1:]) / len(ms[1:])
        res["final"] = {n: whole(n, master(named[n]))
                        for n in TP_MP2_PARAMS}
        out[level or "plain"] = res
        del model, opt, wrapped, named, rows
    torch.cuda.empty_cache()
    return out


def zero_rank_main(rank, out_dir):
    """One rank of ``zero_two_ranks`` (``python chip_smoke.py --zero-rank
    R DIR``): ``zero_rank_steps``; writes ``DIR/rank<R>.pt``."""
    torch, tdist, dev = rank_setup(rank)
    out = zero_rank_steps(torch, dev, rank)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    print(f"rank {rank}: " + ", ".join(
        f"{k} losses {[round(v, 4) for v in r['losses']]}"
        for k, r in out.items()), flush=True)
    tdist.destroy_process_group()
    return 0


def zero_two_ranks(torch, dev):
    """Each level as two processes on the one card over gloo
    (``--zero-rank``), each on half of the batch, against ``tp_mp2_steps``
    unsharded in this process on all of it: the gaps within
    ``ZERO_*_TOL`` (``held_against``), both ranks gather the same
    masters; each rank's bytes of parameters and states after the first
    step over the same rank's at no sharding (the prediction: states
    halved at ``"os"`` and ``"os_g"``, parameters and states at
    ``"p_g_os"``)."""
    ref = tp_mp2_steps(torch, dev)
    ref.pop("calls")
    got, wall = spawn_two_ranks(torch, "--zero-rank")
    out = dict(wall_s=wall, unsharded_step_ms=ref["step_ms"])
    for level in ZERO_LEVELS:
        g0, g1 = (g[level] for g in got)
        apart = [n for n in TP_MP2_PARAMS
                 if not torch.equal(g0["final"][n], g1["final"][n])]
        check(not apart, f"ZeRO {level}: the ranks gather different masters "
                         f"of {apart}")
        res = held_against(torch, ref, g0, TP_MP2_PARAMS,
                           (ZERO_LOSS_TOL, ZERO_GRAD_TOL, ZERO_UPDATE_TOL),
                           f"ZeRO {level}, two ranks over gloo")
        ratios = []
        for r, g in enumerate(got):
            (p, s), (p0, s0) = g[level]["bytes"], g["plain"]["bytes"]
            ratios.append(dict(params=p / p0, states=s / s0,
                               total=(p + s) / (p0 + s0),
                               allocated=g[level]["allocated"]
                               / g["plain"]["allocated"]))
        log(f"  ZeRO {level}: bytes after the first step over no "
            f"sharding, by rank: " + "; ".join(
                f"params {q['params']:.3f}, states {q['states']:.3f}, "
                f"both {q['total']:.3f}, memory_allocated "
                f"{q['allocated']:.3f}" for q in ratios)
            + f"; {g0['step_ms']:.1f} ms a step (plain two ranks "
            f"{got[0]['plain']['step_ms']:.1f}, unsharded one process "
            f"{ref['step_ms']:.1f})")
        want_p = 0.5 if level == "p_g_os" else 1.0
        check(all(q["states"] == 0.5 and q["params"] == want_p
                  for q in ratios),
              f"ZeRO {level}: byte ratios {ratios}")
        res.update(ratios=ratios, step_ms=g0["step_ms"],
                   bytes=[g[level]["bytes"] for g in got])
        out[level] = res
    out["plain"] = dict(step_ms=got[0]["plain"]["step_ms"],
                        bytes=[g["plain"]["bytes"] for g in got],
                        loss_err=[abs(a - b) for a, b in zip(
                            got[0]["plain"]["losses"], ref["losses"])])
    return out


def phase_sharding(torch, dev, report):
    """ZeRO on the card (``distributed.sharding``,
    ``auto_parallel.api``'s stages): NCCL at world 1, (i) ``zero_forms``;
    then (ii) each level as two gloo ranks on the card
    (``zero_two_ranks``)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import observability as obs

    saved = _tp_env(1, 0)
    obs.reset()
    obs.enable()
    res = {}
    try:
        dist.init_parallel_env()
        check(dist.get_backend() == "nccl", "backend not nccl")
        res["world1"] = zero_forms(torch, dev, report)
    finally:
        dist.destroy_process_group()
        obs.disable()
        obs.reset()
        _restore_env(saved)
    res["two_ranks"] = zero_two_ranks(torch, dev)
    report["sharding"] = res


# ---------------------------------------------------------------------------
# context parallelism: ring and Ulysses at sep 1 on NCCL, the ring at sep 2
# as two gloo ranks
# ---------------------------------------------------------------------------
#: the two-rank ring: bench_llama's width at 2 layers, one sequence of
#: 8192 tokens (4096 a rank), 3 AdamW steps
CP2_LAYERS, CP2_SEQ, CP2_STEPS = 2, 8192, 3
#: the parameters held against the unsharded run (rows of the
#: embedding and the head: the first 2048)
CP2_PARAMS = {
    "llama.embed_tokens.weight": (0, 2048),
    "llama.layers.0.self_attn.q_proj.weight": None,
    "llama.layers.0.self_attn.k_proj.weight": None,
    "llama.layers.1.mlp.down_proj.weight": None,
    "llama.layers.1.input_layernorm.weight": None,
    "lm_head.weight": (0, 2048),
}
#: sep 2 against the unsharded model on the whole sequence, in bf16
#: (|loss - unsharded loss| at every step; the step-1 gradients, max |g -
#: unsharded g| over max |unsharded g|; the 3-step updates of the fp32
#: masters, ||dw - unsharded dw|| over ||unsharded dw||): about 3x the
#: largest gaps measured on the H100 (PERF.md PR 24: 7.33e-4, 0.0118,
#: 0.0552)
CP2_LOSS_TOL = 2.2e-3
CP2_GRAD_TOL = 0.036
CP2_UPDATE_TOL = 0.17


def timed_by_name(torch, dev, step, nl, label, want, check_kernels):
    """``dist_timed`` of ``step``, whose profile is also the first
    recording of ``recorded``'s check of the kernels by name (a failed one
    is retaken); the flash kernels' launches by name go under
    ``by_name``."""
    timed = dist_timed(torch, dev, step, nl, label, want=want,
                       keep_profile=True)
    first = [timed.pop("profile")]
    out = recorded(
        lambda: first.pop() if first else profile_kernels(
            torch, step, 1, timed["step_ms"], label),
        _per_kernel, lambda o: check_kernels(o[1], label), label)
    timed["by_name"] = named_launches(
        out[1], [n for pair in FLASH_KERNELS.values() for n in pair])
    return timed


def busy(timed):
    """``dist_timed``'s busy share as words."""
    share = timed["busy_share"]
    return "busy not measured" if share is None else f"{share:.1%} busy"


def cp_forms(torch, dev, report):
    """``bench_llama``'s model (``TRAIN_CONFIG``: 10 layers, 16 heads of
    128, bf16, 4 x 2048, ``AdamW(multi_precision=True)``) with
    ``context_parallel="ring"`` and ``"ulysses"`` at sep 1 (NCCL, world
    1) against the same model without: ``DIST_COMPARE_STEPS`` eager steps
    from seed 0 equal bit for bit (the ring at one rank is one causal
    flash call whose merge weights are exactly 0 and 1; Ulysses' two
    all-to-alls are the identity), each form's flash and RMSNorm
    launches the step's (10 + 10, 21 + 21), and the captured steps
    (``jit.to_static``) equal bit for bit; the three eager steps timed in
    turns (``interleaved``); then the ring's alone (``timed_by_name``:
    step ms, busy share, peak memory, the tensor-core kernels by name;
    Ulysses runs the flash entry points as the model without does)."""
    import gc

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    nl = TRAIN_CONFIG["num_hidden_layers"]
    ids, labels = train_batch(torch, LlamaConfig(**TRAIN_CONFIG), dev)
    modes = (None, "ring", "ulysses")

    def trainer(mode):
        config = LlamaConfig(**TRAIN_CONFIG, dtype="bfloat16",
                             context_parallel=mode)
        model = LlamaForCausalLM(config, device=dev, seed=0)
        opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                    multi_precision=True)
        opt._ensure_accumulators()

        def step(i=ids, lab=labels):
            loss = _llama_loss(model, i, lab)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        return model, opt, step

    res = {}
    for form in ("eager", "captured"):
        base, kept = None, {}
        for mode in modes:
            model, opt, step = trainer(mode)
            fn = jit.to_static(step, full_graph=True) \
                if form == "captured" else step
            reset_counts()
            losses = [float(fn(ids, labels))
                      for _ in range(DIST_COMPARE_STEPS)]
            if form == "eager":
                want = {k: v * DIST_COMPARE_STEPS
                        for k, v in train_launches(nl).items()}
                check(read_counts() == want,
                      f"context_parallel={mode}: launches {read_counts()}, "
                      f"want {want}")
                if mode is not None:
                    record_launches(report, f"context_parallel_{mode}_sep1",
                                    read_counts())
            if form == "captured":
                entries = list(fn._cache.values())
                check(len(entries) == 1 and entries[0].graphed.captured,
                      f"context_parallel={mode}: to_static made "
                      f"{len(entries)} entries, or did not capture")
                del entries
            else:
                kept[str(mode)] = step
            state = (_train_state(model, opt), losses)
            if base is None:
                base = state
            else:
                _same_state(torch, base[0], state[0], base[1], state[1],
                            f"{form} context_parallel={mode} (sep 1) vs "
                            f"without, {DIST_COMPARE_STEPS} steps from "
                            f"seed 0")
            del model, opt, step, fn, state
        del base
        if kept:
            turns = interleaved(torch, kept)
            res["in_turns_ms"] = {k: v["wall_ms"] for k, v in turns.items()}
            log("  context parallelism at sep 1, eager steps in turns "
                "(medians): " + ", ".join(
                    f"{k} {v['wall_ms']:.2f} ms" for k, v in turns.items()))
        del kept
        gc.collect()
        torch.cuda.empty_cache()
    label = "context_parallel=ring (sep 1) eager step"
    model, opt, step = trainer("ring")
    timed = timed_by_name(torch, dev, step, nl, label, train_launches(nl),
                          lambda pk, lb: check_train_kernels(pk, nl, lb))
    timed.pop("launches")
    res["ring"] = timed
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  the ring at sep 1, eager step alone: {timed['step_ms']:.2f} ms "
        f"({busy(timed)}, peak {timed['peak_bytes'] / 2**30:.2f} GiB)")
    return res


def cp_steps(torch, dev, hcg=None):
    """``CP2_STEPS`` AdamW steps of ``cp_two_ranks``' model
    (``bench_llama``'s width at ``CP2_LAYERS`` layers, bf16, seed 0) on
    one sequence of ``CP2_SEQ`` tokens (ids from a seeded generator,
    labels rolled by one): under ``hcg`` (sep 2) with
    ``context_parallel="ring"`` through ``fleet.distributed_model``
    (``SegmentParallel``: each rank its half of the sequence), else
    unsharded. Returns ``tp_mp2_steps``' record for ``CP2_PARAMS``, the
    peak memory, and the bytes ``_rotate`` moved a step (k, v and the
    fp32 dk, dv through the permute)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import context_parallel as cp
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    config = LlamaConfig(**{**TRAIN_CONFIG, "num_hidden_layers": CP2_LAYERS,
                            "max_position_embeddings": CP2_SEQ},
                         dtype="bfloat16",
                         context_parallel=None if hcg is None else "ring")
    g = torch.Generator(device=dev).manual_seed(9)
    ids = torch.randint(0, config.vocab_size, (1, CP2_SEQ), generator=g,
                        device=dev)
    labels = torch.roll(ids, -1, dims=1)
    model = LlamaForCausalLM(config, device=dev, seed=0)
    wrapped = model if hcg is None else fleet.distributed_model(model)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                multi_precision=True)
    named = dict(model.named_parameters())

    def whole(name, t):
        rows = CP2_PARAMS[name]
        t = t if rows is None else t[rows[0]:rows[1]]
        return t.detach().cpu().clone()

    out = dict(init={n: whole(n, named[n]) for n in CP2_PARAMS}, losses=[],
               wrapper=type(wrapped).__name__)
    rotated = [0]
    rotate = cp._rotate

    def counted(x, group, n):
        rotated[0] += x.numel() * x.element_size()
        return rotate(x, group, n)

    cp._rotate = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    ms = []
    try:
        with first_kernel_calls(split=("causal",)) as calls:
            for i in range(CP2_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _ = wrapped(ids, labels=labels)
                loss.backward()
                if i == 0:
                    out["grads"] = {n: whole(n, named[n].grad)
                                    for n in CP2_PARAMS}
                opt.step()
                opt.clear_grad()
                out["losses"].append(float(loss.detach()))
                ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        cp._rotate = rotate
    out.update(launches=read_counts(), calls=calls,
               step_ms=sum(ms[1:]) / len(ms[1:]),
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               rotated_bytes=rotated[0] // CP2_STEPS,
               final={n: whole(n, opt._master_weights[id(named[n])])
                      for n in CP2_PARAMS})
    del model, wrapped, opt, named
    torch.cuda.empty_cache()
    return out


def cp_rotated_bytes(layers):
    """The bytes the ring at sep 2 rotates a step on a rank, from the
    shapes: a layer's forward rotates k and v once, its backward k, v and
    the fp32 dk, dv once and dk, dv once more home."""
    heads = TRAIN_CONFIG["num_attention_heads"]
    d = TRAIN_CONFIG["hidden_size"] // heads
    block = CP2_SEQ // 2 * heads * d                  # elements of k
    bf16, fp32 = 2 * block, 4 * block
    return layers * (2 * bf16 + (2 * bf16 + 2 * fp32) + 2 * fp32)


def cp_two_ranks(torch, dev):
    """The ring at sep 2 as two processes on the one card over gloo
    (``--cp-rank``): ``cp_steps`` under ``fleet.init(sep_degree=2)`` in
    each rank, against ``cp_steps`` unsharded on the whole sequence in
    this process. Held: the values before the steps equal bit for bit and
    both ranks hold the same bits after (the gradients are summed over
    the sep group); every loss, the step-1 gradients and the updates
    within ``CP2_*_TOL`` (``held_against``); each rank's launches a step
    (flash forward and backward ``r + 1`` a layer on rank ``r``: the
    causal ring skips future keys; RMSNorm as the step's); the bytes
    rotated a step as the shapes say (``cp_rotated_bytes``); and each
    flash block (causal and full) and RMSNorm kernel against its plain
    version at the shapes of its first call in the rank
    (``kernels_at_calls``)."""
    ref = cp_steps(torch, dev)
    got, wall = spawn_two_ranks(torch, "--cp-rank")
    for part in ("init", "grads", "final"):
        apart = [n for n in CP2_PARAMS
                 if not torch.equal(got[0][part][n], got[1][part][n])]
        check(not apart, f"sep 2: the ranks hold different {part} of {apart}")
    out = held_against(torch, ref, got[0], CP2_PARAMS,
                       (CP2_LOSS_TOL, CP2_GRAD_TOL, CP2_UPDATE_TOL),
                       "ring at sep 2 on one card over gloo")
    want_bytes = cp_rotated_bytes(CP2_LAYERS)
    base = train_launches(CP2_LAYERS)
    for r, g in enumerate(got):
        lk = g["local_kernels"]
        log(f"  sep 2 rank {r}: {g['step_ms']:.1f} ms a step (unsharded "
            f"{ref['step_ms']:.1f}), peak {g['peak_bytes'] / 2**30:.2f} GiB "
            f"(unsharded {ref['peak_bytes'] / 2**30:.2f}), "
            f"{g['rotated_bytes'] / 2**20:.1f} MiB rotated a step, "
            f"launches {g['launches']}; kernels vs plain at its first "
            f"calls' shapes: " + ", ".join(
                f"{k} {v['shape']} err {v['max_abs_err']:.3g} "
                f"({v['share']:.3g} of the tolerance)" for k, v in lk.items()))
        check(g["wrapper"] == "SegmentParallel", f"rank {r}: {g['wrapper']}")
        want = {**base, "flash": (r + 1) * CP2_LAYERS,
                "flash_bwd": (r + 1) * CP2_LAYERS}
        check(g["launches"] == {k: v * CP2_STEPS for k, v in want.items()},
              f"sep 2 rank {r} launches {g['launches']}, want {want} a step")
        check(g["rotated_bytes"] == want_bytes,
              f"sep 2 rank {r}: {g['rotated_bytes']} bytes rotated a step, "
              f"want {want_bytes}")
        blocks = {"flash/causal=True", "flash_bwd/causal=True"} | (
            {"flash/causal=False", "flash_bwd/causal=False"} if r else set())
        check(blocks <= set(lk) and all(lk[k]["shape"][2] == CP2_SEQ // 2
                                        for k in blocks),
              f"sep 2 rank {r}: flash blocks {sorted(lk)}")
        bad = {k: v for k, v in lk.items() if not v["share"] <= 1.0}
        check(not bad, f"sep 2 rank {r}: kernels vs plain {bad}")
    log(f"  sep 2: Ulysses on gloo: {got[0]['all_to_all']}")
    out.update(unsharded_losses=ref["losses"],
               step_ms=[g["step_ms"] for g in got],
               unsharded_step_ms=ref["step_ms"],
               peak_bytes=[g["peak_bytes"] for g in got],
               unsharded_peak_bytes=ref["peak_bytes"],
               rotated_bytes=[g["rotated_bytes"] for g in got],
               launches=[g["launches"] for g in got],
               local_kernels=[g["local_kernels"] for g in got],
               all_to_all=got[0]["all_to_all"], wall_s=wall)
    return out


def all_to_all_probe(torch, tdist, dev):
    """Whether gloo carries ``all_to_all`` of CUDA tensors (Ulysses' two
    exchanges): a plain sentence either way."""
    ins = list(torch.arange(4.0, device=dev).chunk(2))
    outs = [torch.empty(2, device=dev) for _ in range(2)]
    try:
        tdist.all_to_all(outs, ins)
    except RuntimeError as exc:
        return (f"gloo refused all_to_all on CUDA tensors "
                f"({str(exc).splitlines()[0][:120]}), so Ulysses at sep 2 "
                f"runs only in the CPU tests "
                f"(tests/test_torch_context_parallel.py); on the card it "
                f"runs at sep 1 on NCCL")
    return ("gloo ran all_to_all on CUDA tensors; Ulysses at sep 2 is not "
            "driven here: it runs in the CPU tests "
            "(tests/test_torch_context_parallel.py), and at sep 1 on NCCL")


def cp_rank_main(rank, out_dir):
    """One rank of ``cp_two_ranks`` (``python chip_smoke.py --cp-rank R
    DIR``): gloo on the card, ``fleet.init(sep_degree=2)``, ``cp_steps``,
    ``kernels_at_calls`` and the all-to-all probe; writes
    ``DIR/rank<R>.pt``."""
    torch, tdist, dev = rank_setup(rank)
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "sep_degree": 2}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    print(f"rank {rank}: fleet.init done", flush=True)
    out = cp_steps(torch, dev, hcg)
    print(f"rank {rank}: steps done", flush=True)
    out["local_kernels"] = kernels_at_calls(torch, dev, out.pop("calls"))
    out["all_to_all"] = all_to_all_probe(torch, tdist, dev)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    print(f"rank {rank}: losses {out['losses']}, {out['step_ms']:.1f} ms a "
          f"step", flush=True)
    tdist.destroy_process_group()
    return 0


def phase_context_parallel(torch, dev, report):
    """Context parallelism on the card (``fleet.context_parallel``,
    ``SegmentParallel``, Llama's ``context_parallel``): (i) ring and
    Ulysses at sep 1 on NCCL (``cp_forms``); (ii) the ring at sep 2 as
    two gloo ranks (``cp_two_ranks``)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import fleet

    import gc

    gc.collect()           # an earlier phase's models left in cycles
    torch.cuda.empty_cache()
    log(f"  allocated on the card at the start: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    saved = _tp_env(1, 0)
    obs.reset()
    obs.enable()
    res = {}
    try:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "sep_degree": 1}
        hcg = fleet.init(is_collective=True, strategy=strategy)
        check(dist.get_backend() == "nccl", "fleet.init: backend not nccl")
        check(hcg.get_sep_parallel_world_size() == 1, "sep degree")
        res["sep1"] = cp_forms(torch, dev, report)
        fleet.set_hybrid_communicate_group(None)
    finally:
        dist.destroy_process_group()
        obs.disable()
        obs.reset()
        _restore_env(saved)
    res["sep2"] = cp_two_ranks(torch, dev)
    for r, counts in enumerate(res["sep2"]["launches"]):
        record_launches(report, f"context_parallel_ring_sep2_rank{r}",
                        counts)
    report["context_parallel"] = res


# ---------------------------------------------------------------------------
# the pipeline: a PipelineLayer at pp 1 on NCCL, pp 2 as two gloo ranks
# ---------------------------------------------------------------------------
#: micro-batches a step (bench_llama's 4 x 2048 batch as 4 of 1 x 2048)
PIPE_MICRO = 4
#: q's [B, H, S, D] at a flash call of a micro-batch
PIPE_FLASH_SHAPE = [TRAIN_BATCH // PIPE_MICRO,
                    TRAIN_CONFIG["num_attention_heads"], TRAIN_SEQ,
                    TRAIN_CONFIG["hidden_size"]
                    // TRAIN_CONFIG["num_attention_heads"]]
#: the two-rank pipeline: bench_llama's width at 4 decoder layers (2 a
#: stage), 3 AdamW steps under each schedule
PP2_LAYERS, PP2_STEPS = 4, 3
PP2_SCHEDULES = ("1F1B", "FThenB")
#: the parameters held against the unsharded run, by the pipeline's
#: names (layer index first: 0 the embedding, 1-4 the decoder layers, 5
#: the norm and head; rows of the embedding and the head: the first 2048)
PP2_PARAMS = {
    0: {"0.weight": (0, 2048), "1.self_attn.q_proj.weight": None,
        "2.mlp.down_proj.weight": None},
    1: {"3.self_attn.q_proj.weight": None,
        "4.post_attention_layernorm.weight": None,
        "5.lm_head.weight": (0, 2048)},
}
#: pp 2 and the pipeline at pp 1 against the unsharded model: the same
#: kernels on the same micro-batches in the same order, the activations
#: and gradients moved whole, so equal bit for bit (0: losses, gradients
#: and updates)
PP_LOSS_TOL = PP_GRAD_TOL = PP_UPDATE_TOL = 0.0


def pipeline_llama(torch, dev, nl, num_stages=1):
    """``bench_llama``'s model as a ``PipelineLayer`` over ``num_stages``
    stages: the embedding, ``nl`` decoder layers as ``LayerDesc``s, then
    the final norm and the head, whose fused lm-head cross-entropy is the
    ``loss_fn``; the weights of ``LlamaForCausalLM`` at seed 0 (the layers
    this rank holds). Returns (pipeline, plain model)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                               LlamaRMSNorm)
    from paddle_tpu_torch.nn.functional.common import Embedding

    config = LlamaConfig(**{**TRAIN_CONFIG, "num_hidden_layers": nl},
                         dtype="bfloat16")
    factory = dict(device=dev, dtype=torch.bfloat16)
    h, v = config.hidden_size, config.vocab_size

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = LlamaRMSNorm(config, **factory)
            self.lm_head = torch.nn.Linear(h, v, bias=False, **factory)

        def forward(self, x):
            return self.norm(x)

    held = {}

    def loss_fn(x, labels):
        return fused_linear_cross_entropy(
            x.reshape(-1, h), held["pipe"].run_function[-1].lm_head.weight,
            labels.reshape(-1), ignore_index=-100)

    pipe = PipelineLayer(
        [LayerDesc(Embedding, v, h, **factory)]
        + [LayerDesc(LlamaDecoderLayer, config, **factory)
           for _ in range(nl)] + [LayerDesc(Head)],
        num_stages=num_stages, loss_fn=loss_fn)
    held["pipe"] = pipe
    plain = LlamaForCausalLM(config, device=dev, seed=0)

    def plain_name(name):
        i, rest = name.split(".", 1)
        i = int(i)
        if i == 0:
            return "llama.embed_tokens.weight"
        if i == nl + 1:
            return "lm_head.weight" if rest.startswith("lm_head") \
                else "llama.norm.weight"
        return f"llama.layers.{i - 1}.{rest}"

    src = dict(plain.named_parameters())
    with torch.no_grad():
        for name, p in pipe.named_parameters():
            p.copy_(src[plain_name(name)])
    return pipe, plain


def _pipe_strategy(schedule):
    return type("Strategy", (), {"pipeline_configs": {
        "accumulate_steps": PIPE_MICRO, "schedule_mode": schedule}})()


def pipe_launches(nl, micro=PIPE_MICRO):
    return {k: v * micro for k, v in train_launches(nl).items()}


def pipeline_forms(torch, dev, report):
    """``bench_llama``'s model as a ``PipelineLayer`` at pp 1 (NCCL,
    world 1), ``accumulate_steps`` 4 (micro-batches of 1 x 2048): under
    FThenB and 1F1B, ``DIST_COMPARE_STEPS`` ``train_batch`` steps against
    the plain model's step of the same 4 micro-batches with the gradients
    accumulated (losses and the whole state within ``PP_*_TOL``), each
    form's launches the step's (flash 40 + 40) and each flash and
    RMSNorm kernel against its plain version at the shapes of its first
    call in the form (``kernels_at_calls``: flash at [1, 16, 2048, 128],
    a micro-batch); the three forms' steps
    timed in turns (``interleaved``, all three on the card: the eager
    step is host-bound, so walls compare only in turns); then each form
    alone: the peak memory above the training state of a forward and
    backward (the activations: 1F1B at one stage keeps one micro-batch's,
    FThenB four) and of a whole step; and FThenB's step through
    ``timed_by_name`` (step ms, busy share, the kernels by name; 1F1B
    launches the same kernels)."""
    import gc

    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineParallel
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.optimizer import AdamW

    nl = TRAIN_CONFIG["num_hidden_layers"]
    ids, labels = train_batch(torch, LlamaConfig(**TRAIN_CONFIG), dev)
    forms = (None, "FThenB", "1F1B")

    def trainer(schedule):
        """(model, optimizer, the step, its forward and backward alone)."""
        pipe, plain = pipeline_llama(torch, dev, nl)
        model = plain if schedule is None else pipe
        del pipe, plain
        gc.collect()               # the unused pipeline's loss_fn cycle
        opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                    multi_precision=True)
        opt._ensure_accumulators()
        if schedule is None:
            def fb():
                losses = []
                for m in range(PIPE_MICRO):
                    rows = slice(m, m + 1)
                    loss = _llama_loss(model, ids[rows], labels[rows])
                    (loss * (1.0 / PIPE_MICRO)).backward()
                    losses.append(loss.detach())
                # the mean as PipelineParallel reports it
                return torch.stack(losses).sum() * (1.0 / PIPE_MICRO)
        else:
            pp = PipelineParallel(model, strategy=_pipe_strategy(schedule))

            def fb():
                return pp.forward_backward_pipeline([ids, labels])

        def step():
            loss = fb()
            opt.step()
            opt.clear_grad()
            return loss
        return model, opt, step, fb

    res = {"vs_plain": {}}
    trainers, base = {}, None
    want = pipe_launches(nl)
    for schedule in forms:
        model, opt, step, fb = trainers[str(schedule)] = trainer(schedule)
        reset_counts()
        with first_kernel_calls() as calls:
            losses = [float(step()) for _ in range(DIST_COMPARE_STEPS)]
        counts = read_counts()
        check(counts == {k: v * DIST_COMPARE_STEPS for k, v in want.items()},
              f"pipeline {schedule}: launches {counts}, want {want} a step")
        if schedule is not None:
            record_launches(report, f"pipeline_{schedule.lower()}_pp1",
                            counts)
            lk = kernels_at_calls(torch, dev, calls)
            log(f"  pipeline {schedule} at pp 1: kernels vs plain at their "
                f"first calls' shapes: " + ", ".join(
                    f"{k} {v['shape']} err {v['max_abs_err']:.3g} "
                    f"({v['share']:.3g} of the tolerance)"
                    for k, v in lk.items()))
            check(all(lk[k]["shape"] == PIPE_FLASH_SHAPE
                      for k in ("flash", "flash_bwd")),
                  f"pipeline {schedule}: flash at {lk}")
            bad = {k: v for k, v in lk.items() if not v["share"] <= 1.0}
            check(not bad, f"pipeline {schedule}: kernels vs plain {bad}")
            res.setdefault("local_kernels", {})[schedule] = lk
        state = (_train_state(model, opt), losses)
        if base is None:
            base = state
            continue
        gap = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(base[0], state[0]))
        apart = sum(int((a != b).sum()) for a, b in zip(base[0], state[0]))
        loss_gap = max(abs(a - b) for a, b in zip(base[1], state[1]))
        log(f"  PipelineLayer at pp 1 under {schedule} vs the plain model's "
            f"accumulated step, {DIST_COMPARE_STEPS} steps: losses "
            f"{[round(x, 5) for x in state[1]]} vs "
            f"{[round(x, 5) for x in base[1]]} (apart {loss_gap:.3g}); "
            f"{apart} state entries apart, at most {gap:.3g} (tol "
            f"{PP_UPDATE_TOL})")
        check(loss_gap <= PP_LOSS_TOL and gap <= PP_UPDATE_TOL,
              f"pipeline {schedule} vs plain: losses {loss_gap}, state "
              f"{gap}")
        res["vs_plain"][schedule] = dict(loss_gap=loss_gap, state_gap=gap,
                                         entries_apart=apart)
        del state
    del base
    turns = interleaved(torch, {k: t[2] for k, t in trainers.items()})
    res["in_turns_ms"] = {k: v["wall_ms"] for k, v in turns.items()}
    log("  the pipeline at pp 1, steps in turns (medians): " + ", ".join(
        f"{k} {v['wall_ms']:.2f} ms" for k, v in turns.items()))
    del trainers, model, opt, step, fb
    gc.collect()
    torch.cuda.empty_cache()
    res["peak_above_state_bytes"] = {}
    for schedule in forms:
        model, opt, step, fb = trainer(schedule)
        peaks = []
        for call in (fb, step):          # forward and backward; a step
            opt.clear_grad()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            call()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated(dev) - held)
        res["peak_above_state_bytes"][str(schedule)] = peaks
        if schedule == "FThenB":
            label = f"pipeline {schedule} step"
            timed = timed_by_name(
                torch, dev, step, nl, label, want,
                lambda pk, lb: check_flash_route(pk, {
                    k: PIPE_MICRO * nl for k in ("fwd", "dq", "dkv")}, lb))
            timed.pop("launches")
            res[schedule] = timed
        del model, opt, step, fb
        gc.collect()
        torch.cuda.empty_cache()
    log("  the pipeline at pp 1, peak above the training state (forward "
        "and backward; a step): " + ", ".join(
            f"{k} {a / 2**30:.2f} / {b / 2**30:.2f} GiB"
            for k, (a, b) in res["peak_above_state_bytes"].items())
        + f"; FThenB alone {res['FThenB']['step_ms']:.2f} ms a step "
        f"({busy(res['FThenB'])})")
    return res


def pp2_steps(torch, dev, schedule, strategy=None):
    """``PP2_STEPS`` steps of the ``PP2_LAYERS``-layer pipeline under
    ``schedule``: over the hybrid group's two pipeline ranks after
    ``fleet.init(strategy)`` (this rank's stage,
    ``PP2_PARAMS[stage]``) or in one process (every stage, all of
    ``PP2_PARAMS``): losses, the step-1 gradients and the fp32 masters
    before and after, the mean ms of the steps after the first, the peak
    memory, the activation and gradient bytes this rank sent a step, the
    launches, and the shapes, dtypes and keyword arguments of each flash
    and RMSNorm kernel's first call (``first_kernel_calls``)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.optimizer import AdamW

    num_stages = 1 if strategy is None else 2
    pipe, plain = pipeline_llama(torch, dev, PP2_LAYERS, num_stages)
    del plain
    torch.cuda.empty_cache()
    stage = pipe.stage
    names = {**PP2_PARAMS[0], **PP2_PARAMS[1]} if stage is None \
        else PP2_PARAMS[stage]
    if strategy is None:
        from paddle_tpu_torch.distributed.fleet.meta_parallel import \
            PipelineParallel

        pp = PipelineParallel(pipe, strategy=_pipe_strategy(schedule))
    else:
        strategy.pipeline_configs = _pipe_strategy(schedule).pipeline_configs
        pp = fleet.distributed_model(pipe)
    opt = AdamW(learning_rate=3e-4, parameters=pipe.parameters(),
                multi_precision=True)
    named = dict(pipe.named_parameters())
    ids, labels = train_batch(torch, LlamaConfig(**TRAIN_CONFIG), dev)

    def whole(name, t):
        rows = names[name]
        t = t if rows is None else t[rows[0]:rows[1]]
        return t.detach().cpu().clone()

    out = dict(init={n: whole(n, named[n]) for n in names}, losses=[],
               wrapper=type(pp).__name__, stage=stage)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    ms = []
    with first_kernel_calls() as calls:
        for i in range(PP2_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = pp.forward_backward_pipeline([ids, labels])
            if i == 0:
                out["grads"] = {n: whole(n, named[n].grad) for n in names}
            opt.step()
            opt.clear_grad()
            out["losses"].append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
    sent = 0 if pp._exchange is None else pp._exchange.bytes_sent
    out.update(launches=read_counts(), calls=calls,
               step_ms=sum(ms[1:]) / len(ms[1:]),
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               sent_bytes=sent // PP2_STEPS,
               final={n: whole(n, opt._master_weights[id(named[n])])
                      for n in names})
    del pipe, pp, opt, named
    torch.cuda.empty_cache()
    return out


def pp2_two_ranks(torch, dev):
    """pp 2 as two processes on the one card over gloo (``--pp-rank``):
    ``pp2_steps`` under each of ``PP2_SCHEDULES`` over
    ``fleet.init(pp_degree=2)`` (``fleet.distributed_model`` wraps the
    ``PipelineLayer`` in ``PipelineParallel``; each rank builds and runs
    its stage: the embedding and layers 0-1, or layers 2-3 and the head),
    against ``pp2_steps`` in one process. Held: every loss (on both
    ranks), each rank's step-1 gradients and updates within ``PP_*_TOL``
    (``held_against``); each rank's launches (flash and RMSNorm per
    micro-batch and layer it holds, the final norm on the last stage);
    the activation bytes a rank sends a step (each micro-batch's [1, 2048,
    2048] bf16 activation down, or its gradient up); and each flash
    and RMSNorm kernel against its plain version at the shapes of its
    first call in the rank (``kernels_at_calls``: flash at [1, 16, 2048,
    128], a micro-batch)."""
    ref = {s: pp2_steps(torch, dev, s) for s in PP2_SCHEDULES}
    for r in ref.values():
        r.pop("calls")
    got, wall = spawn_two_ranks(torch, "--pp-rank")
    act = TRAIN_SEQ * TRAIN_CONFIG["hidden_size"] * 2
    out = {"wall_s": wall}
    for s in PP2_SCHEDULES:
        res = {}
        for r in range(2):
            g = got[r][s]
            names = PP2_PARAMS[r]
            sub = {k: {n: ref[s][k][n] for n in names}
                   for k in ("init", "grads", "final")}
            sub["losses"] = ref[s]["losses"]
            res[f"rank{r}"] = held_against(
                torch, sub, g, names, (PP_LOSS_TOL, PP_GRAD_TOL,
                                       PP_UPDATE_TOL),
                f"pp 2 {s}, rank {r} on one card over gloo")
            nl = PP2_LAYERS // 2
            want = {k: 0 for k in train_launches(0)}
            want.update(flash=nl, flash_bwd=nl, rms_norm=2 * nl + r,
                        rms_norm_bwd=2 * nl + r)
            want = {k: v * PIPE_MICRO * PP2_STEPS for k, v in want.items()}
            check(g["launches"] == want,
                  f"pp 2 {s} rank {r} launches {g['launches']}, want {want}")
            check(g["wrapper"] == "PipelineParallel" and g["stage"] == r,
                  f"pp 2 rank {r}: {g['wrapper']}, stage {g['stage']}")
            check(g["sent_bytes"] == PIPE_MICRO * act,
                  f"pp 2 {s} rank {r}: sent {g['sent_bytes']} bytes a step, "
                  f"want {PIPE_MICRO * act}")
            lk = g["local_kernels"]
            check(set(lk) == {"flash", "flash_bwd", "rms_norm",
                              "rms_norm_bwd"}
                  and all(lk[k]["shape"] == PIPE_FLASH_SHAPE
                          for k in ("flash", "flash_bwd")),
                  f"pp 2 {s} rank {r}: kernels at {lk}")
            bad = {k: v for k, v in lk.items() if not v["share"] <= 1.0}
            check(not bad, f"pp 2 {s} rank {r}: kernels vs plain {bad}")
            log(f"  pp 2 {s} rank {r}: {g['step_ms']:.1f} ms a step "
                f"(one process: {ref[s]['step_ms']:.1f}), peak "
                f"{g['peak_bytes'] / 2**30:.2f} GiB (one process: "
                f"{ref[s]['peak_bytes'] / 2**30:.2f}), sent "
                f"{g['sent_bytes'] / 2**20:.1f} MiB a step; kernels vs "
                f"plain at its first calls' shapes: " + ", ".join(
                    f"{k} {v['shape']} err {v['max_abs_err']:.3g} "
                    f"({v['share']:.3g} of the tolerance)"
                    for k, v in lk.items()))
            res[f"rank{r}"].update(step_ms=g["step_ms"],
                                   peak_bytes=g["peak_bytes"],
                                   sent_bytes=g["sent_bytes"],
                                   launches=g["launches"],
                                   local_kernels=lk)
        res.update(one_process_step_ms=ref[s]["step_ms"],
                   one_process_peak_bytes=ref[s]["peak_bytes"])
        out[s] = res
    return out


def pp_rank_main(rank, out_dir):
    """One rank of ``pp2_two_ranks`` (``python chip_smoke.py --pp-rank R
    DIR``): gloo on the card, ``fleet.init(pp_degree=2)``, ``pp2_steps``
    under each schedule and ``kernels_at_calls`` at each one's first
    calls; writes ``DIR/rank<R>.pt``."""
    torch, tdist, dev = rank_setup(rank)
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "pp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    print(f"rank {rank}: fleet.init done", flush=True)
    out = {s: pp2_steps(torch, dev, s, strategy) for s in PP2_SCHEDULES}
    print(f"rank {rank}: steps done", flush=True)
    for o in out.values():
        o["local_kernels"] = kernels_at_calls(torch, dev, o.pop("calls"))
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    print(f"rank {rank}: " + ", ".join(
        f"{s} losses {o['losses']} {o['step_ms']:.1f} ms a step"
        for s, o in out.items()), flush=True)
    tdist.destroy_process_group()
    return 0


def phase_pipeline(torch, dev, report):
    """The pipeline on the card (``fleet.meta_parallel``'s
    ``PipelineLayer`` and ``PipelineParallel``): (i) at pp 1 on NCCL
    (``pipeline_forms``); (ii) pp 2 as two gloo ranks
    (``pp2_two_ranks``)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import fleet

    import gc

    gc.collect()           # an earlier phase's models left in cycles
    torch.cuda.empty_cache()
    log(f"  allocated on the card at the start: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    saved = _tp_env(1, 0)
    obs.reset()
    obs.enable()
    res = {}
    try:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "pp_degree": 1}
        hcg = fleet.init(is_collective=True, strategy=strategy)
        check(dist.get_backend() == "nccl", "fleet.init: backend not nccl")
        check(hcg.get_pipe_parallel_world_size() == 1, "pp degree")
        res["pp1"] = pipeline_forms(torch, dev, report)
        fleet.set_hybrid_communicate_group(None)
    finally:
        dist.destroy_process_group()
        obs.disable()
        obs.reset()
        _restore_env(saved)
    res["pp2"] = pp2_two_ranks(torch, dev)
    for s in PP2_SCHEDULES:
        for r in range(2):
            record_launches(report, f"pipeline_{s.lower()}_pp2_rank{r}",
                            res["pp2"][s][f"rank{r}"]["launches"])
    report["pipeline"] = res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (HERE / "paddle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: paddle_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    dev = torch.device("cuda", 0)
    report = {}
    t_all = time.perf_counter()
    marks = []

    def mark(name=None):
        """Print the seconds of the phase that ends here; start ``name``."""
        now = time.perf_counter()
        if marks:
            log(f"  ([{marks[-1][0]}]: {now - marks[-1][1]:.1f} s)")
        if name:
            marks.append((name, now))
            log(f"[{name}]")

    try:
        mark("device")
        smi = smi_line()
        log(f"  {smi}")
        log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        mark("build")
        from paddle_tpu_torch.ops.cuda import _build
        t0 = time.perf_counter()
        per = _build.build()
        log(f"  built {sorted(per)} in {time.perf_counter() - t0:.1f} s "
            f"(per library: {', '.join(f'{k} {v:.1f}s' for k, v in per.items())})")
        for lg in sorted(_build.build_dir().glob("*.log")):
            regs = sorted({line.split(":", 1)[1].strip()
                           for line in lg.read_text().splitlines()
                           if "Used" in line and "registers" in line})
            log(f"  {lg.stem.split('-')[0]}: {' | '.join(regs)}")
        # the RMSNorm kernels by dtypes and accesses per thread, the
        # varlen kernels by dtype and head dim (the wide ones by dtype and
        # column ranges), the paged kernel by dtype, vectors a lane and q
        # heads a block
        for lib in ("rms_norm", "flash_attention_varlen", "paged_attention"):
            for row in ptxas_table(_build._target(lib).with_suffix(".log")
                                   .read_text()):
                log(f"    {row}")
        mark("kernels")
        phase_rms_norm(torch, dev, report)
        phase_paged(torch, dev, report)
        phase_flash(torch, dev, report)
        phase_flash_bwd(torch, dev, report)
        phase_varlen(torch, dev, report)
        phase_tiled_mm(torch, dev, report)
        mark("forward")
        phase_forward(torch, dev, report)
        llama = llama_family(torch, dev)
        mark("serve")
        out = phase_serve(torch, dev, report, llama)
        report["paged"].update(serve_decode_step=out["decode_step"],
                               serve_peak_bytes=out["peak_bytes"],
                               serve_prefill=out["prefill"]["by_bucket"])
        mark("generate")
        out = phase_generate(torch, dev, report, llama)
        report["paged"].update(generate_ticks=out["ticks"],
                               generate_capture_ms=out["capture_ms"])
        llama_generate = {k: out[k] for k in ("tokens_per_s", "beam",
                                              "speculative")}
        for key in ("paged", "vflash"):
            report[key]["generate_max_abs_err"] = out[f"{key}_max_abs_err"]
        mark("train")
        phase_train(torch, dev, report)
        train = report.pop("train")
        mark("train-recipe")
        phase_train_recipe(torch, dev, report)
        recipe = report.pop("train_recipe")
        mark("varlen")
        phase_varlen_path(torch, dev, report)
        mark("calibrate")
        phase_calibrate(torch, dev, report)
        models = {}
        for name, phase in (("gpt", phase_gpt), ("bert", phase_bert),
                            ("moe", phase_moe), ("resnet", phase_resnet),
                            ("sdxl", phase_sdxl),
                            ("incubate", phase_incubate),
                            ("functional", phase_functional),
                            ("vision", phase_vision),
                            ("detection", phase_detection),
                            ("observability", phase_observability),
                            ("distributed", phase_distributed),
                            ("tensor_parallel", phase_tensor_parallel),
                            ("expert_parallel", phase_expert_parallel),
                            ("sharding", phase_sharding),
                            ("context_parallel", phase_context_parallel),
                            ("pipeline", phase_pipeline)):
            mark(name)
            phase(torch, dev, report)
            models[name] = report.pop(name)
        mark()
        # launches: each kernel's count on its own main path
        for key, r in report.items():
            r["main_path"] = MAIN_PATH[key]
            r["launches"] = r["launches_by_path"][MAIN_PATH[key]]
        idle = [r["name"] for r in report.values() if not r["launches"]]
        if not report["vflash_bwd"]["dkv_launches_by_path"]["varlen"]:
            idle.append("vflash_bwd_dkv_kernel")
        check(not idle, f"no main-path launch for {idle}")
    except Exception as exc:  # every phase is fatal: report and fail
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"train": train}))
    log(json.dumps({"train_recipe": recipe}))
    log(json.dumps({"generate": llama_generate}))
    for name, out in models.items():
        log(json.dumps({name: out}))
    log(json.dumps({"kernels": list(report.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    RANK_MAINS = {"--tp-rank": tp_rank_main, "--ep-rank": ep_rank_main,
                  "--zero-rank": zero_rank_main, "--cp-rank": cp_rank_main,
                  "--pp-rank": pp_rank_main}
    if sys.argv[1:2] and sys.argv[1] in RANK_MAINS:
        sys.exit(RANK_MAINS[sys.argv[1]](int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
