#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

Phases, each fatal on failure:

1. device  — the card's name and power limit, torch and CUDA versions;
2. build   — compile every kernel from ``paddle_tpu_torch/csrc`` (nvcc,
             one process per source, all at once);
3. kernels — each hand-written kernel against its plain PyTorch version
             on the card, at the serving and prefill shapes, with its
             time beside the plain version's, a PyTorch library call's
             where one computes the same function, and its bound;
4. forward — ``LlamaForCausalLM`` at the serving width (bf16), counting
             kernel launches, then fp32 logits of kernels vs plain;
5. serve   — the continuous-batching ``ServeEngine`` under Poisson load
             through the paged kernel, then fp32 greedy streams of the
             kernel engine vs the reference engine.

The last lines are the ``kernels`` JSON, the ``nvidia-smi`` name/power
line, and ``{"ok": true, "device": {...}}``.

Run: ``python3 chip_smoke.py`` from the repository root on a machine with
one CUDA card. Without a card, or without the package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: the summed duration of every GPU
    kernel and copy it ran, from ``torch.profiler`` over ``iters`` calls.
    Host launch gaps are excluded, so a kernel shorter than its Python
    launch is still timed as the card runs it. Falls back to
    :func:`time_ms` (and says so) if the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_dev_us(e) for e in prof.key_averages()
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


def bound_ms(n_bytes: float, flops: float, dtype_name: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------
def phase_rms_norm(torch, dev, report):
    """RMSNorm kernel vs ``rms_norm_reference`` at the decode (8 rows)
    and prefill (4 x 512 rows) row counts of the serving model, hidden
    2048. Both compute in fp32 and round once: tolerance
    ``tolerance(dtype, 1e-5)``, i.e. 1e-5 (fp32) plus two output ulps of
    |y| (bf16, fp16)."""
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    g = torch.Generator(device=dev).manual_seed(1)
    main = None
    for rows in (8, 2048):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = torch.randn(rows, 2048, generator=g, device=dev).to(dt)
            w = (1 + 0.1 * torch.randn(2048, generator=g, device=dev)).to(dt)
            y = rn.rms_norm_fwd(x, w, eps=1e-6)
            ref = rn.rms_norm_reference(x, w, eps=1e-6)
            torch.cuda.synchronize()
            atol, rtol = tolerance(dt, 1e-5)
            err, share = close_err(y, ref, atol, rtol)
            name = str(dt).replace("torch.", "")
            log(f"  rms_norm rows={rows} {name}: max_abs_err={err:.3g}, "
                f"{share:.3g} of the tolerance ({atol} + {rtol:.3g}|ref|)")
            check(share <= 1.0, f"rms_norm rows={rows} {name} err {err}")
            if rows == 2048 and dt == torch.bfloat16:
                main = (x, w, err)
    x, w, err = main
    ms = device_ms(lambda: rn.rms_norm_fwd(x, w, eps=1e-6))
    plain = device_ms(lambda: rn.rms_norm_reference(x, w, eps=1e-6))
    lib = device_ms(lambda: torch.nn.functional.rms_norm(
        x, (x.shape[-1],), w, 1e-6))
    n = x.numel()
    b_ms, by = bound_ms(2 * n * x.element_size() + w.numel() * w.element_size(),
                        4 * n, "float32")
    log(f"  rms_norm [2048, 2048] bf16: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, torch rms_norm {lib:.4f} ms, bound {b_ms:.4f} ms "
        f"({by})")
    report["rms_norm"] = dict(
        name="rms_norm_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/rms_norm.cu",
        replaces="paddle_tpu/ops/pallas/rms_norm.py:53",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
        library_ms=lib)


def _pages_case(torch, dev, g, b, nh, kvh, dh, page, pps, num_pages, lens,
                dtype):
    q = torch.randn(b, nh, dh, generator=g, device=dev).to(dtype)
    kp = torch.randn(kvh, num_pages, page, dh, generator=g, device=dev).to(dtype)
    vp = torch.randn(kvh, num_pages, page, dh, generator=g, device=dev).to(dtype)
    perm = torch.randperm(num_pages, generator=g, device=dev)
    tables = perm[:b * pps].reshape(b, pps).to(torch.int32) \
        if b * pps <= num_pages else \
        torch.randint(0, num_pages, (b, pps), generator=g, device=dev,
                      dtype=torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, lengths, tables


def phase_paged(torch, dev, report):
    """Paged decode kernel vs ``paged_attention_decode_reference`` at the
    serving shape (8 slots, 16 heads, DH 128, page 128, 8 pages per
    sequence, a 96-page pool) with ragged lengths including 0 and exact
    page edges, and at the llama3-8b GQA layout (32 q heads over 8 kv
    heads). Both accumulate in fp32 (the kernel online, the reference in
    one softmax) and round once: tolerance ``tolerance(dtype, 1e-5)``,
    i.e. 1e-5 (fp32) plus two output ulps of |out| (bf16, fp16)."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(2)
    lens = [0, 1, 127, 128, 129, 256, 700, 1024]
    main = None
    for nh, kvh in ((16, 16), (32, 8)):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            args = _pages_case(torch, dev, g, 8, nh, kvh, 128, 128, 8, 96,
                               lens, dt)
            out = pa.paged_attention_decode(*args, backend="kernel")
            ref = pa.paged_attention_decode(*args, backend="reference")
            torch.cuda.synchronize()
            atol, rtol = tolerance(dt, 1e-5)
            err, share = close_err(out, ref, atol, rtol)
            name = str(dt).replace("torch.", "")
            log(f"  paged_decode nh={nh} kvh={kvh} {name}: "
                f"max_abs_err={err:.3g}, {share:.3g} of the tolerance "
                f"({atol} + {rtol:.3g}|ref|)")
            check(share <= 1.0, f"paged nh={nh} kvh={kvh} {name} {err}")
            check(bool((out[0] == 0).all()), "paged: length-0 row is not 0")
            if nh == 16 and dt == torch.bfloat16:
                main = (args, err)
    args, err = main
    ms = device_ms(lambda: pa.paged_attention_decode(*args, backend="kernel"))
    plain = device_ms(lambda: pa.paged_attention_decode(
        *args, backend="reference"))
    q, kp = args[0], args[1]
    kvh, dh = kp.shape[0], kp.shape[3]
    n_bytes = (2 * kvh * sum(lens) * dh * kp.element_size()
               + 2 * q.numel() * q.element_size()
               + args[3].numel() * 4 + args[4].numel() * 4)
    flops = 4 * q.shape[1] * sum(lens) * dh
    b_ms, by = bound_ms(n_bytes, flops, "bfloat16")
    log(f"  paged_decode serving shape bf16: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms ({by})")
    report["paged"] = dict(
        name="paged_attention_decode", route="cuda",
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:163",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
        library_ms=None)


def phase_flash(torch, dev, report):
    """Flash-forward kernel vs ``_flash_fwd_reference``: causal and not,
    Sq != Sk, GQA, [1, Sk] and [B, Sk] key biases, fully masked rows
    (lse -inf), and dropout 0.1 at a fixed seed, whose keep mask must be
    identical (read back through one-hot values). Both accumulate in
    fp32 (the kernel tile by tile) and round once: tolerance
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
    # the keep mask itself: q = 0 gives every visible key p = 1, and
    # one-hot values make out[row, d] = keep[row, d] / (1 - rate) / l
    b, h, s, d = 2, 4, 96, 128
    q = torch.zeros(b, h, s, d, device=dev)
    v = torch.eye(d, device=dev)[:s].expand(b, h, s, d).contiguous()
    k = rnd(b, h, s, d, dt=f32)
    (out, _), (rout, _) = run(q, k, v, seed=seed, causal=True, rate=0.1)
    kept, rkept = out > 0, rout > 0
    n_kept, rn_kept = int(kept.sum()), int(rkept.sum())
    log(f"  flash dropout keep mask: kernel keeps {n_kept}, plain keeps "
        f"{rn_kept}, identical={bool(torch.equal(kept, rkept))}")
    check(torch.equal(kept, rkept), "flash dropout keep mask differs")

    q, k, v = main
    sc = q.shape[-1] ** -0.5
    ms = device_ms(lambda: fa._flash_fwd_kernel(
        q, k, v, None, None, causal=True, scale=sc, dropout_rate=0.0))
    plain = device_ms(lambda: fa._flash_fwd_reference(
        q, k, v, causal=True, scale=sc), iters=5)
    lib = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    flops = 4 * b * h * sq * sk * d / 2
    n_bytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size() \
        + b * h * sq * 4
    b_ms, by = bound_ms(n_bytes, flops, "bfloat16")
    log(f"  flash causal [4,16,512,128] bf16: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, torch sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
        f"({by})")
    report["flash"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:190",
        max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=by, library_ms=lib)


# ---------------------------------------------------------------------------
# main-path phases
# ---------------------------------------------------------------------------
def _kernel_modules():
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    return {"flash": fa, "rms_norm": rn, "paged": pa}


def reset_counts():
    for mod in _kernel_modules().values():
        mod.launches = 0


def read_counts():
    return {k: mod.launches for k, mod in _kernel_modules().items()}


def phase_forward(torch, dev, report):
    """``LlamaForCausalLM`` at ``default_serving_setup``'s width (10
    layers, hidden 2048, 16 heads of 128, vocab 32000), batch 4 x 512.
    bf16: the flash kernel must launch once per layer and the RMSNorm
    kernel twice per layer plus the final norm. fp32 (TF32 off): logits
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
        report["flash"]["launches"] = counts["flash"]
        report["rms_norm"]["launches"] = counts["rms_norm"]
        fwd_ms = time_ms(lambda: model(ids), iters=5, warmup=1)
        with flags_scope(use_cuda_flash_attention=False,
                         use_cuda_rms_norm=False):
            fwd_plain = time_ms(lambda: model(ids), iters=5, warmup=1)
        log(f"  bf16 forward [4, 512]: kernels {fwd_ms:.3f} ms, plain "
            f"compositions {fwd_plain:.3f} ms "
            f"({4 * 512 / fwd_ms * 1e3:.0f} tokens/s with kernels)")
        # device time too: the wall times above include host launch gaps,
        # which vary between calls on a shared host
        profile_kernels(torch, lambda: model(ids), 3, fwd_ms,
                        "bf16 forward [4, 512], kernels")
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


def profile_decode(torch, eng, vocab, steps=16):
    """Where a full-batch decode step's time goes: 8 streams past their
    prefill, ``steps`` decode steps timed on the host clock, then the
    same number under ``torch.profiler`` for the device kernel time by
    name. Busy share = kernel time per step / unprofiled step time."""
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
    profile_kernels(torch, eng.step, steps, wall_ms,
                    f"decode step ({eng.max_slots} streams)")
    eng.run()


def profile_kernels(torch, fn, n, wall_ms, label):
    """Run ``fn`` ``n`` times under ``torch.profiler`` and print the
    device kernel time per call by kernel name, and the busy share
    against ``wall_ms`` (the unprofiled time of one call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_dev_us(e) for e in kernels) / n / 1e3
    if busy_ms <= 0:
        log(f"  {label}: {wall_ms:.3f} ms; device time not measured (the "
            f"profiler saw no kernels)")
        return
    log(f"  {label}: {wall_ms:.3f} ms wall, {busy_ms:.3f} ms of kernels "
        f"({busy_ms / wall_ms:.1%} busy, "
        f"{sum(e.count for e in kernels) / n:.0f} kernels per call)")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:6]:
        log(f"    {_dev_us(e) / n / 1e3:8.4f} ms/call  x{e.count // n:<4d}"
            f" {e.key[:90]}")


def phase_serve(torch, dev, report):
    """The ``default_serving_setup`` engine (8 slots, 96 x 128-token
    blocks, max_seq_len 1024) in bf16 under Poisson load: every request
    finishes and every decode tick ran the paged kernel once per layer.
    Then fp32 greedy streams of the engine on the kernel vs on the
    reference attention must be equal token for token, cold and with the
    prefix cache and 4-tick decode bursts on (the suffix prefill runs the
    paged kernel over many rows)."""
    import dataclasses

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serve import (ServeEngine, default_serving_setup,
                                        run_load, warm_engine)

    config, prm = default_serving_setup(dev)
    nl = config.num_hidden_layers

    def engine(model, name, backend="auto", **kw):
        return ServeEngine(
            model, max_slots=prm["slots"], block_size=prm["block_size"],
            num_blocks=prm["num_blocks"], max_seq_len=prm["max_seq_len"],
            name=name, attention_backend=backend, device=dev, **kw)

    model = LlamaForCausalLM(dataclasses.replace(config, dtype="bfloat16"),
                             device=dev, seed=0).eval()
    eng = engine(model, "smoke")
    log(f"  KV pool: {2 * nl * eng._caches[0][0].numel() * 2 / 2**30:.2f} "
        f"GiB bf16")
    t0 = time.perf_counter()
    warm_engine(eng, max_prompt_len=prm["prompt_len"][1])
    log(f"  warm_engine: {time.perf_counter() - t0:.2f} s")
    n_req = 24
    reset_counts()
    res = run_load(eng, rate=prm["rate"], n_requests=n_req,
                   prompt_len=prm["prompt_len"], max_new=prm["max_new"],
                   seed=0)
    torch.cuda.synchronize()
    counts = read_counts()
    done = sum(r.state == "FINISHED" for r in res.requests)
    dstep = obs.registry.get("serve.decode_step_seconds").stats(
        engine="smoke")
    log(f"  run_load: {done}/{n_req} finished, {res.total_tokens} tokens in "
        f"{res.wall_seconds:.3f} s = {res.tokens_per_sec:.1f} tokens/s, "
        f"TTFT p50 {res.ttft_p50 * 1e3:.2f} ms p99 {res.ttft_p99 * 1e3:.2f} "
        f"ms, {res.engine_steps} decode steps, decode step mean "
        f"{dstep['avg'] * 1e3:.3f} ms (min {dstep['min'] * 1e3:.3f}), "
        f"preemptions {res.preemptions}, launches {counts}")
    check(done == n_req and res.rejected == 0,
          f"only {done} of {n_req} requests finished")
    check(counts["paged"] > 0, "the paged kernel never launched")
    check(counts["paged"] == nl * res.engine_steps,
          f"paged launches {counts['paged']} != layers x decode steps "
          f"{nl * res.engine_steps}")
    report["paged"]["launches"] = counts["paged"]
    profile_decode(torch, eng, config.vocab_size)
    del eng, model
    torch.cuda.empty_cache()

    model = LlamaForCausalLM(config, device=dev, seed=0).eval()
    rng = torch.Generator().manual_seed(5)
    lo, hi = prm["prompt_len"]

    def rand_ids(n):
        return torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()

    # half the prompts share a two-block prefix, so the prefix-cache run
    # prefills their suffixes through the paged kernel
    shared = rand_ids(2 * prm["block_size"])
    plans = [((shared if i % 2 else []) + rand_ids(
        int(torch.randint(lo, hi + 1, (1,), generator=rng))), 16)
        for i in range(12)]
    streams = {}
    for mode, kw in (("cold", {}),
                     ("prefix+burst4", dict(prefix_cache=True,
                                            decode_burst=4))):
        for backend in ("kernel", "reference"):
            name = f"smoke_{mode}_{backend}"
            eng = engine(model, name, backend, **kw)
            reqs = [eng.submit(p, max_new_tokens=k) for p, k in plans]
            eng.run()
            streams[mode, backend] = [r.output_ids for r in reqs]
            hits = obs.registry.get("serve.prefix_hits").value(engine=name)
            del eng
        same = sum(a == b for a, b in zip(streams[mode, "kernel"],
                                          streams[mode, "reference"]))
        label = f"{mode}, {hits} prefix hits" if kw else mode
        log(f"  fp32 greedy streams ({label}), kernel vs reference "
            f"attention: {same}/{len(plans)} identical")
        check(same == len(plans), f"fp32 {mode} kernel and reference "
                                  f"streams differ")
        if kw:
            check(hits > 0, "the prefix-cache run never hit the cache")
    same = sum(a == b for a, b in zip(streams["cold", "kernel"],
                                      streams["prefix+burst4", "kernel"]))
    log(f"  fp32 greedy streams, cold vs prefix+burst4 (kernel): {same}/"
        f"{len(plans)} identical (not required: a shared prefix changes the "
        f"order of the sums)")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
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
    try:
        log("[device]")
        smi = smi_line()
        log(f"  {smi}")
        log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        log("[build]")
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
        log("[kernels]")
        phase_rms_norm(torch, dev, report)
        phase_paged(torch, dev, report)
        phase_flash(torch, dev, report)
        log("[forward]")
        phase_forward(torch, dev, report)
        log("[serve]")
        phase_serve(torch, dev, report)
        missing = [r["name"] for r in report.values() if "launches" not in r]
        check(not missing, f"no main-path launch count for {missing}")
    except Exception as exc:  # every phase is fatal: report and fail
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": list(report.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
