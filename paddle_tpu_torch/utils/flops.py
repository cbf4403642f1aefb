"""FLOPs accounting.

Counterpart of ``paddle_tpu/utils/flops.py``: the per-op registry keyed
by op type (:func:`flops`, :func:`register_flops`) and the layer-walking
``paddle.flops(net, input_size)`` summary (:func:`dynamic_flops`), as in
the reference. Where the reference reads XLA's cost analysis of a
compiled call (``xla_flops``), the port counts one call's operations as
they run: :func:`count_flops` runs ``fn`` under
``torch.utils.flop_counter.FlopCounterMode``.

The count's convention (what ``observability.measure_step_flops``, and
so ``train.mfu``, reads):

- torch's matrix products as ``FlopCounterMode`` counts them (``mm``,
  ``addmm``, ``bmm``, convolutions, SDPA: 2 per multiply-add; a linear
  layer's backward is two products), forward and backward, and any
  recomputation run again (a checkpointed chunk of the fused lm-head
  loss counts its product twice);
- the port's hand-written kernels count what the reference's Pallas call
  declares to XLA (``pl.CostEstimate``): the flash forward
  ``4 * B * H * Sq * Sk * D`` (``paddle_tpu/ops/pallas/flash_attention
  .py:252-256``, causal or not) and every other kernel 0, since none of
  the others declares a cost. ``FlopCounterMode`` sees no work inside a
  kernel (a ctypes call), and on the CPU the wrappers run plain versions
  whose own products must not count either: the flash, varlen, paged and
  tiled-matmul wrappers open :class:`kernel_work`, which replaces
  whatever was counted inside it by the declared figure, so a step
  counts the same on the CPU and the card (RMSNorm's plain version holds
  no product, so it counts its declared 0 as it is);
- elementwise work, reductions and the optimizer's update count 0 (as
  ``FlopCounterMode``, and as XLA's count leaves them out of MFU's
  dense terms).
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["flops", "register_flops", "dynamic_flops", "count_flops"]

_FLOPS_COMPUTE_FUNC_MAP: dict[str, Callable] = {}


def _prod(s):
    out = 1
    for v in s:
        out *= v
    return out


def flops(op_type: str, input_shapes: dict, attrs: dict) -> int:
    """Count FLOPs for one op invocation; unknown op types count 0."""
    func = _FLOPS_COMPUTE_FUNC_MAP.get(op_type)
    if func is None:
        return 0
    try:
        return func(input_shapes, attrs)
    except Exception:
        return 0


def register_flops(op_type: str):
    def register(func):
        _FLOPS_COMPUTE_FUNC_MAP[op_type] = func
        return func

    return register


@register_flops("matmul")
@register_flops("matmul_v2")
def _matmul_flops(input_shapes, attrs):
    x = list(input_shapes.get("X", input_shapes.get("x"))[0])
    y = list(input_shapes.get("Y", input_shapes.get("y"))[0])
    if attrs.get("transpose_X") or attrs.get("transpose_x") or attrs.get("trans_x"):
        x[-1], x[-2] = x[-2], x[-1]
    if attrs.get("transpose_Y") or attrs.get("transpose_y") or attrs.get("trans_y"):
        y[-1], y[-2] = y[-2], y[-1]
    batch = _prod(x[:-2]) if len(x) > 2 else (_prod(y[:-2]) if len(y) > 2 else 1)
    return 2 * batch * x[-2] * x[-1] * y[-1]


@register_flops("conv2d")
def _conv2d_flops(input_shapes, attrs):
    inp = input_shapes.get("Input", input_shapes.get("x"))[0]
    filt = input_shapes.get("Filter", input_shapes.get("weight"))[0]
    strides = attrs.get("strides", [1, 1])
    paddings = attrs.get("paddings", [0, 0])
    dilations = attrs.get("dilations", [1, 1])
    n, _, h, w = inp
    c_out, c_in_g, kh, kw = filt
    ho = (h + 2 * paddings[0] - dilations[0] * (kh - 1) - 1) // strides[0] + 1
    wo = (w + 2 * paddings[1] - dilations[1] * (kw - 1) - 1) // strides[1] + 1
    return 2 * n * c_out * ho * wo * c_in_g * kh * kw


@register_flops("relu")
@register_flops("gelu")
@register_flops("silu")
@register_flops("dropout")
@register_flops("softmax")
@register_flops("elementwise_add")
@register_flops("elementwise_mul")
@register_flops("elementwise_div")
def _elementwise_flops(input_shapes, attrs):
    key = next(iter(input_shapes))
    return _prod(input_shapes[key][0])


@register_flops("layer_norm")
@register_flops("rms_norm")
def _norm_flops(input_shapes, attrs):
    key = next(iter(input_shapes))
    return 5 * _prod(input_shapes[key][0])


@register_flops("c_embedding")
@register_flops("embedding")
def _embedding_flops(input_shapes, attrs):
    return 0


class _Count:
    """One :func:`count_flops` call: its counter mode, the kernels'
    corrections, and how deep the open :class:`kernel_work` blocks are."""

    __slots__ = ("mode", "adjust", "depth", "before")

    def __init__(self, mode):
        self.mode = mode
        self.adjust = 0
        self.depth = 0
        self.before = 0


_active = None


class kernel_work:
    """``with kernel_work(n): ...`` around a kernel wrapper's dispatch (the
    kernel, or its plain version on the CPU): inside a :func:`count_flops`
    call, whatever ``FlopCounterMode`` counts in the block is replaced by
    ``n``, the work the reference's Pallas call declares (module
    docstring). Outside one it costs a global read. Nested blocks count
    the outermost's figure only."""

    __slots__ = ("flops", "_s")

    def __init__(self, flops: int = 0):
        self.flops = flops

    def __enter__(self):
        s = self._s = _active
        if s is not None:
            if s.depth == 0:
                s.before = s.mode.get_total_flops()
            s.depth += 1
        return self

    def __exit__(self, *exc):
        s = self._s
        if s is not None:
            s.depth -= 1
            if s.depth == 0:
                s.adjust += int(self.flops) - (s.mode.get_total_flops()
                                               - s.before)
        return False


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one ``fn(*args, **kwargs)`` call, counted as it runs
    (the call runs: a training step steps its optimizer) under the
    convention of the module docstring. The counterpart of the
    reference's ``xla_flops``."""
    global _active
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    s = _Count(mode)
    prev, _active = _active, s
    try:
        with mode:
            fn(*args, **kwargs)
    finally:
        _active = prev
    return int(mode.get_total_flops() + s.adjust)


def _handlers():
    """Layer class -> FLOPs of one call, the reference's table with the
    port's layers (``torch.nn`` and the vision zoo's own)."""
    from torch import nn

    from ..nn.functional.norm import BatchNorm
    from ..vision.models import _layers as zoo

    def count_linear(layer, inp, out):
        return _prod(out.shape) * layer.weight.shape[1] * 2

    def count_conv(layer, inp, out):
        return 2 * _prod(out.shape) * _prod(layer.weight.shape[1:])

    def count_norm(layer, inp, out):
        return 5 * _prod(out.shape)

    def count_one(layer, inp, out):
        return _prod(out.shape)

    table = {nn.Linear: count_linear, nn.Conv2d: count_conv,
             nn.BatchNorm2d: count_norm, nn.BatchNorm1d: count_norm,
             BatchNorm: count_norm, nn.LayerNorm: count_norm}
    for cls in (nn.ReLU, nn.GELU, nn.Sigmoid, nn.Softmax, zoo.ReLU,
                nn.MaxPool2d, nn.AvgPool2d, nn.AdaptiveAvgPool2d,
                zoo.MaxPool2D, zoo.AvgPool2D, zoo.AdaptiveAvgPool2D):
        table[cls] = count_one
    return table


def dynamic_flops(net, input_size, custom_ops=None, print_detail=False) -> int:
    """``paddle.flops(net, input_size)``: a hook-based per-layer FLOPs
    table over one forward of zeros of ``input_size`` (on the net's
    device). A layer counts by the first class of its type's MRO that the
    table (or ``custom_ops``) holds, so the port's ``Conv2d`` counts as
    ``torch.nn.Conv2d``."""
    handlers = _handlers()
    handlers.update(custom_ops or {})
    counts: dict[int, dict] = {}
    handles = []

    def make_hook(handler):
        def hook(layer, inp, out):
            o = out[0] if isinstance(out, (tuple, list)) else out
            i = inp[0] if isinstance(inp, (tuple, list)) else inp
            entry = counts.get(id(layer))
            if entry is None:
                n_params = sum(_prod(p.shape)
                               for p in layer.parameters(recurse=False))
                counts[id(layer)] = {
                    "layer": layer,
                    "flops": handler(layer, i, o),
                    "params": n_params,
                    "output_shape": list(o.shape),
                }
            else:
                # shared module applied more than once: accumulate flops
                entry["flops"] += handler(layer, i, o)
                entry["output_shape"] = list(o.shape)

        return hook

    for sub in net.modules():
        handler = next((handlers[c] for c in type(sub).__mro__
                        if c in handlers), None)
        if handler is not None:
            handles.append(sub.register_forward_hook(make_hook(handler)))

    was_training = net.training
    net.eval()
    param = next(net.parameters(), None)
    x = torch.zeros(list(input_size), dtype=torch.float32,
                    device=param.device if param is not None else "cpu")
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()

    total_flops = sum(v["flops"] for v in counts.values())
    total_params = sum(v["params"] for v in counts.values())
    if print_detail:
        print(f"{'Layer':<30}{'Output Shape':<24}{'Params':>12}{'FLOPs':>16}")
        for v in counts.values():
            print(f"{type(v['layer']).__name__:<30}"
                  f"{str(v['output_shape']):<24}{v['params']:>12}{v['flops']:>16}")
    print(f"Total Flops: {total_flops}     Total Params: {total_params}")
    return int(total_flops)
