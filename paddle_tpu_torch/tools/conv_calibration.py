"""ResNet-50 conv calibration on the card.

Counterpart of ``tools/conv_calibration.py``. For each ResNet-50 conv
shape it times three ways of doing the same arithmetic, in bf16:

  t_conv   — the convolution itself (``F.conv2d``, NCHW, padding k // 2);
  t_gemm   — its implicit-GEMM matmul ``[M = N*Ho*Wo, K = C_in*kh*kw] x
             [K, C_out]`` through ``torch.matmul``, an upper bound for any
             matmul-based conv kernel (which does this matmul plus patch
             assembly and halos);
  t_pallas — the same matmul through the hand-written tiled kernel
             (``ops/cuda/tiled_mm.py``, the counterpart of the reference's
             naively tiled Pallas probe), with K and C_out padded to 128 as
             the reference pads them. The key keeps the reference's name.

Times are seconds per call on the card's clock: CUDA events around
``iters`` back-to-back calls after warm-up. The reference skips its probe
(``t_pallas = None``) where M is not a multiple of its 512-row tile or the
tiles exceed 14 MB of TPU memory: at batch 64 that is shapes 11-19 (M of
12544 and 3136; shapes 16 and 17 are also too large). The port's kernel
takes any M, so it times every shape.

Run: ``python -m paddle_tpu_torch.tools.conv_calibration [--iters 30]
[--batch 64] [--shape i]``. Prints a per-shape table and the FLOP-weighted
ResNet-50 forward MFU against the H100's 989 TFLOP/s bf16 dense peak, or
with ``--shape i`` one JSON line for ``RESNET50_CONVS[i]``. It needs a
CUDA card: there is nothing to time on the CPU.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..core.place import resolve_device
from ..ops.cuda.tiled_mm import tiled_mm

__all__ = ["RESNET50_CONVS", "conv_dims", "measure_shape", "shape_record",
           "main"]

#: H100 SXM bf16 dense tensor-core peak (NVIDIA data sheet, 700 W)
PEAK_FLOPS = 989e12

# (C_in, H, W, C_out, kernel, stride, count_in_resnet50)
RESNET50_CONVS = [
    (3, 224, 224, 64, 7, 2, 1),      # stem
    (64, 56, 56, 64, 1, 1, 1),       # conv2 reduce (first block)
    (64, 56, 56, 64, 3, 1, 3),       # conv2 3x3
    (64, 56, 56, 256, 1, 1, 4),      # conv2 expand (+projection)
    (256, 56, 56, 64, 1, 1, 2),
    (256, 56, 56, 128, 1, 1, 1),
    (128, 56, 56, 128, 3, 2, 1),     # conv3 entry stride
    (128, 28, 28, 128, 3, 1, 3),
    (128, 28, 28, 512, 1, 1, 5),
    (512, 28, 28, 128, 1, 1, 3),
    (512, 28, 28, 256, 1, 1, 1),
    (256, 28, 28, 256, 3, 2, 1),
    (256, 14, 14, 256, 3, 1, 5),
    (256, 14, 14, 1024, 1, 1, 7),
    (1024, 14, 14, 256, 1, 1, 5),
    (1024, 14, 14, 512, 1, 1, 1),
    (512, 14, 14, 512, 3, 2, 1),
    (512, 7, 7, 512, 3, 1, 2),
    (512, 7, 7, 2048, 1, 1, 4),
    (2048, 7, 7, 512, 1, 1, 2),
]


def _pad128(n: int) -> int:
    return (n + 127) // 128 * 128


def conv_dims(cin, h, w, cout, kk, stride, batch):
    """The conv's FLOPs and its implicit-GEMM shape: a dict of ``flops``,
    ``m``, ``k``, ``n`` and the probe's padded ``kp`` and ``np``."""
    ho, wo = h // stride, w // stride
    k = cin * kk * kk
    return dict(flops=2.0 * batch * ho * wo * cout * cin * kk * kk,
                m=batch * ho * wo, k=k, n=cout, kp=_pad128(k),
                np=_pad128(cout))


def _card(device):
    """The CUDA device to time on: ``None`` is the card; without one, or
    for a CPU device, this raises (the CPU has no device clock)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure_shape times on a CUDA card; the CPU has "
                         "no device clock to time")
    return dev


def _timed(fn, iters, warmup=3):
    """Seconds per call of ``fn`` on the card's clock."""
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
    return start.elapsed_time(end) / iters / 1e3


def measure_shape(cin, h, w, cout, kk, stride, batch, iters, device=None):
    """(flops, t_conv, t_gemm, t_pallas) of one conv shape, times in
    seconds per call of ``_timed``; inputs are random from seed 0, made on
    the card (see :func:`_card`)."""
    dev = _card(device)
    d = conv_dims(cin, h, w, cout, kk, stride, batch)
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    x = rand(batch, cin, h, w)
    wgt = rand(cout, cin, kk, kk, scale=0.05)
    t_conv = _timed(lambda: F.conv2d(x, wgt, stride=stride, padding=kk // 2),
                    iters)
    del x, wgt
    a = rand(d["m"], d["k"])
    b = rand(d["k"], cout, scale=0.05)
    t_gemm = _timed(lambda: torch.matmul(a, b), iters)
    ap = torch.zeros(d["m"], d["kp"], dtype=bf16, device=dev)
    ap[:, :d["k"]] = a
    bp = torch.zeros(d["kp"], d["np"], dtype=bf16, device=dev)
    bp[:d["k"], :cout] = b
    del a, b
    t_pallas = _timed(lambda: tiled_mm(ap, bp), iters)
    return d["flops"], t_conv, t_gemm, t_pallas


def shape_record(i, batch, iters, device=None):
    """``measure_shape`` of ``RESNET50_CONVS[i]`` as the reference's
    ``--shape`` line: a dict of desc, flops, count, t_conv, t_gemm and
    t_pallas."""
    cin, h, w, cout, kk, stride, cnt = RESNET50_CONVS[i]
    flops, t_conv, t_gemm, t_pal = measure_shape(cin, h, w, cout, kk, stride,
                                                 batch, iters, device)
    return {"desc": f"{cin}x{h}x{w}->{cout} k{kk}s{stride}", "flops": flops,
            "count": cnt, "t_conv": t_conv, "t_gemm": t_gemm,
            "t_pallas": t_pal}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--shape", type=int, default=None,
                    help="measure only RESNET50_CONVS[i] and print one JSON "
                         "line")
    args = ap.parse_args(argv)

    if args.shape is not None:
        print(json.dumps(shape_record(args.shape, args.batch, args.iters)),
              flush=True)
        return

    tot = dict(flops=0.0, t_conv=0.0, t_gemm=0.0, t_pallas=0.0)
    print(f"{'shape':>34} | {'conv TF/s':>9} | {'gemm TF/s':>9} | "
          f"{'tiled':>7} | count")
    for i in range(len(RESNET50_CONVS)):
        r = shape_record(i, args.batch, args.iters)
        tf = {k: r["flops"] / r[k] / 1e12 for k in ("t_conv", "t_gemm",
                                                     "t_pallas")}
        print(f"{r['desc']:>34} | {tf['t_conv']:9.1f} | {tf['t_gemm']:9.1f} "
              f"| {tf['t_pallas']:7.1f} | x{r['count']}", flush=True)
        for k in tot:
            tot[k] += r[k] * r["count"]
    mfu = {k: tot["flops"] / tot[k] / PEAK_FLOPS
           for k in ("t_conv", "t_gemm", "t_pallas")}
    print(f"\nFLOP-weighted ResNet-50 fwd against {PEAK_FLOPS / 1e12:.0f} "
          f"TFLOP/s: conv MFU {mfu['t_conv']:.3f}; implicit-GEMM matmul "
          f"(upper bound for a matmul-based conv) MFU {mfu['t_gemm']:.3f}; "
          f"tiled kernel MFU {mfu['t_pallas']:.3f}")


if __name__ == "__main__":
    main()
