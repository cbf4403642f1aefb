"""Paged decode attention: the hand-written CUDA kernel and its plain
version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py`` (kernel
source ``csrc/paged_attention.cu``), with the same public
``paged_attention_decode`` and the same ``_check_shapes``. Layouts match:
q ``[B, NH, DH]``, pools ``[KVH, pages, page, DH]``, ``lengths [B]`` and
``block_tables [B, pages_per_seq]``.

Routing: ``backend="auto"`` sends a CPU tensor to
:func:`paged_attention_decode_reference` and a CUDA tensor to the
kernel; ``"kernel"`` insists on the kernel (and raises for a CPU
tensor); ``"reference"`` runs the plain version on any device (the
serving engine's reference mode). The Pallas ``"interpret"`` backend has
no counterpart.

The kernel splits each row's context into splits of ``split_tokens``
tokens; a work item is one split that holds rows, for one block of q
heads of one kv head, and a row's splits merge in split order inside the
same launch. The launch comes from the shapes alone (:func:`_split_plan`;
the grid is as many blocks as fit the SMs, and the kernel reads the
lengths itself), so a call never waits on the host. The fp32 partials
of the splits and the per-(row, head block) arrival counters live in a
workspace kept per device and stream (:func:`_workspace`): the counters
are 0 between calls, and the addresses stay fixed while the shapes do.
A graph captured on a stream (``jit/_capture.py``) warms up on that
stream first, so its workspace exists before the capture, and keeps a
reference to it (:func:`_workspace_of`); every replay leaves the
counters 0 as a launch does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, refuse_dtensors
from ...utils.flops import kernel_work

__all__ = [
    "paged_attention_decode",
    "paged_attention_decode_reference",
    "paged_attention_decode_kernel",
    "launches",
]

#: kernel launches since the count was last reset
launches = 0

#: bytes of K and V rows a block's ring of shared memory holds (its 4
#: stages): 32 KB, 16-row stages at D 128 bf16
RING_BYTES = 32 * 1024
#: the kernel's ring stages and warps per block (csrc/paged_attention.cu
#: ``kPdStages``, ``kPdWarps``)
STAGES, WARPS = 4, 4
#: fp32 values of q (and as many of acc) a lane may hold in registers
LANE_VALUES = 64

_fns = {}


def _lib():
    if not _fns:
        fn = _build.load("paged_attention").paged_decode
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["run"] = fn
    return _fns["run"]


class SplitPlan(NamedTuple):
    """A paged decode launch: ``split_tokens`` per split, ``splits`` =
    ceil(pps * page / split_tokens) per row, ``heads`` q heads per block,
    ``grid`` = (splits, rows, kv heads x head blocks per kv head), one work
    item each (the kernel runs them on as many blocks as fit the SMs);
    ``stage_rows`` rows a ring stage, ``smem`` bytes of shared memory a
    block; and how a row is read: ``lanes`` lanes a row, ``vectors``
    16-byte vectors a lane (csrc/paged_attention.cu ``row_lanes`` /
    ``row_vpl``)."""
    split_tokens: int
    splits: int
    heads: int
    grid: tuple
    stage_rows: int
    smem: int
    lanes: int
    vectors: int


def _pow2_at_least(n):
    return 1 << max(0, int(n) - 1).bit_length()


def _split_plan(pps, page, b, kvh, dh, itemsize, sms, *, group=1,
                split_tokens=None):
    """The launch of one call, from shapes only (the lengths stay on the
    device). A row of ``dh`` elements is read 16 bytes a lane by
    ``lanes`` lanes (its vectors rounded up to a power of two, at most
    32), ``vectors`` times each; a block takes ``heads`` q heads of one
    kv head, the group rounded up to a power of two and cut so that a
    lane holds at most ``LANE_VALUES`` fp32 values of q. The split is a
    page, or half a page where a page would give fewer than 2 work items
    per SM on ``sms`` SMs; ``split_tokens`` overrides the rule. A ring
    stage holds the rows that fit ``RING_BYTES`` over ``STAGES`` stages.
    Raises ``ValueError`` where a lane would need more than 8 vectors (DH
    above 2048 in bf16/fp16, 1024 in fp32)."""
    vec = 16 // itemsize
    nv = dh // vec
    lanes = min(32, _pow2_at_least(nv))
    vectors = _pow2_at_least(-(-nv // lanes))
    if vectors > 8:
        raise ValueError(
            f"paged_attention kernel: DH {dh} needs {vectors} 16-byte "
            f"vectors a lane; the kernel takes at most 8 (DH <= "
            f"{8 * 32 * vec} for this dtype)")
    heads = min(_pow2_at_least(group),
                max(1, min(8, LANE_VALUES // (vectors * vec))))
    head_blocks = kvh * -(-group // heads)
    if split_tokens is None:
        split_tokens = page
        if page > 1 and pps * b * head_blocks < 2 * sms:
            split_tokens = -(-page // 2)
    if split_tokens < 1:
        raise ValueError(f"paged_attention kernel: split_tokens "
                         f"{split_tokens} < 1")
    splits = -(-pps * page // split_tokens)
    stage_rows = max(1, RING_BYTES // (STAGES * 2 * dh * itemsize))
    # the ring, or the warps' (m, l, acc) aliased over it; then page ids
    # and each sequence's first split
    region = max(STAGES * 2 * stage_rows * dh * itemsize,
                 4 * WARPS * heads * (dh + 2))
    smem = -(-region // 16) * 16 + 4 * (split_tokens // page + 2 + b + 1)
    return SplitPlan(split_tokens, splits, heads, (splits, b, head_blocks),
                     stage_rows, smem, lanes, vectors)


_scratch = {}


def _workspace(dev, n_partials, n_counters):
    """(fp32 partials, int32 counters) of at least the given sizes for the
    current stream on ``dev``, kept between calls. Counters start at 0 and
    every launch leaves them 0; a larger shape replaces both buffers (the
    old ones stay alive until the stream's earlier launches are done, as
    the caching allocator orders frees on their stream)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    ws, cnt = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < n_partials:
        ws = torch.empty(max(1, n_partials), dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(max(1, n_counters), dtype=torch.int32, device=dev)
    _scratch[key] = (ws, cnt)
    return ws, cnt


def _workspace_of(dev, stream):
    """The buffers :func:`_workspace` keeps for ``stream`` on ``dev``, or
    None. A CUDA graph captured on that stream holds them: its launches
    write them on every replay, so a larger shape that replaces them in
    the cache must not free them (``jit/_capture.py``)."""
    return _scratch.get((dev.index, stream.cuda_stream))


def _check_shapes(q, k_pages, v_pages, lengths, block_tables):
    refuse_dtensors("paged attention", q, k_pages, v_pages, lengths,
                    block_tables)
    if q.ndim != 3:
        raise ValueError(f"q must be [B, NH, DH], got {tuple(q.shape)}")
    if k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"k_pages/v_pages must both be [KVH, pages, page_size, DH], "
            f"got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    b, nh, dh = q.shape
    kvh = k_pages.shape[0]
    if k_pages.shape[-1] != dh:
        raise ValueError(
            f"head_dim mismatch: q has {dh}, k_pages has "
            f"{k_pages.shape[-1]}")
    if nh % kvh:
        raise ValueError(
            f"num q heads ({nh}) must be a multiple of kv heads ({kvh})")
    if tuple(lengths.shape) != (b,):
        raise ValueError(
            f"lengths must be [B]={b}, got {tuple(lengths.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"block_tables must be [B, pages_per_seq], got "
            f"{tuple(block_tables.shape)}")


def paged_attention_decode_reference(q, k_pages, v_pages, lengths,
                                     block_tables, *, sm_scale=None):
    """Gather reference: the masked softmax the kernel must match (one q
    token per row, GQA by repeat, -inf beyond ``lengths``, fp32 softmax,
    output in q's dtype, 0 for a zero-length row)."""
    _check_shapes(q, k_pages, v_pages, lengths, block_tables)
    b, nh, dh = q.shape
    kvh, _, page, _ = k_pages.shape
    pps = block_tables.shape[1]
    s_pad = pps * page
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    tables = block_tables.long()
    # [KVH, B, PPS, PAGE, DH] -> [B, S_pad, KVH, DH]
    k_rows = k_pages[:, tables].permute(1, 2, 3, 0, 4).reshape(
        b, s_pad, kvh, dh)
    v_rows = v_pages[:, tables].permute(1, 2, 3, 0, 4).reshape(
        b, s_pad, kvh, dh)
    if kvh != nh:
        k_rows = torch.repeat_interleave(k_rows, nh // kvh, dim=2)
        v_rows = torch.repeat_interleave(v_rows, nh // kvh, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k_rows.float()) * scale
    valid = (torch.arange(s_pad, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # a zero-length row is fully masked -> NaN; serving carries such rows
    # for idle slots, so return 0 instead (as the kernel does)
    probs = torch.where(valid[:, None, :], probs, 0.0)
    return torch.einsum("bhs,bshd->bhd", probs, v_rows.float()).to(q.dtype)


def paged_attention_decode_kernel(q, k_pages, v_pages, lengths,
                                  block_tables, *, sm_scale=None):
    """Launch the CUDA kernel (CUDA tensors only)."""
    global launches
    _check_shapes(q, k_pages, v_pages, lengths, block_tables)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(
            f"paged_attention_decode_kernel needs CUDA tensors, got {dev}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"paged_attention kernel: unsupported dtype {q.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} must be "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention kernel: {name} must be "
                             f"16-byte aligned")
    b, nh, dh = q.shape
    kvh, num_pages, page, _ = k_pages.shape
    if (dh * q.element_size()) % 16:
        raise ValueError(
            f"paged_attention kernel: a K/V row must be a multiple of 16 "
            f"bytes (DH={dh}, {q.dtype})")
    pps, sms = block_tables.shape[1], _build.sm_count(dev)
    plan = _split_plan(pps, page, b, kvh, dh, q.element_size(), sms,
                       group=nh // kvh)
    limit = _build.smem_limit(dev)
    if plan.smem > limit:
        raise ValueError(
            f"paged_attention kernel: {b} rows of DH {dh} need {plan.smem} "
            f"bytes of shared memory (the ring and a split count a row), "
            f"the card allows {limit}")
    # the kernel reads int32 lengths / tables (jax's x64 ids were cast the
    # same way at paged_attention.py:173-174)
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    block_tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    out = torch.empty_like(q)
    rows = b * plan.grid[2]        # (row, head block) pairs
    ws, cnt = _workspace(dev, 0 if plan.splits == 1 else
                         rows * plan.splits * plan.heads * (dh + 2), rows)
    status = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    lengths.data_ptr(), block_tables.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), b, nh, kvh,
                    dh, num_pages, page, pps, plan.split_tokens,
                    plan.stage_rows, plan.heads, sms, float(scale),
                    _build.DTYPE_CODES[q.dtype], _build.stream_ptr(dev))
    _build.check_status(status, "paged_decode")
    launches += 1
    return out


def paged_attention_decode(q, k_pages, v_pages, lengths, block_tables, *,
                           sm_scale=None, backend="auto"):
    """Paged attention for ONE decode step.

    Args:
      q: ``[B, NH, DH]`` — one query token per sequence; head ``h`` reads
        kv head ``h // (NH // KVH)``.
      k_pages / v_pages: ``[KVH, total_pages, page_size, DH]`` pool.
      lengths: ``[B]`` valid context length per sequence (including the
        just-written token). Length-0 rows return zeros.
      block_tables: ``[B, pages_per_seq]`` physical page ids.
      backend: ``"auto"`` (kernel for CUDA tensors, plain version for
        CPU tensors), ``"kernel"`` or ``"reference"``.

    Returns ``[B, NH, DH]`` in q's dtype.
    """
    if backend == "auto":
        backend = "kernel" if q.device.type == "cuda" else "reference"
    with kernel_work(0):        # the reference's call declares no cost
        if backend == "reference":
            return paged_attention_decode_reference(
                q, k_pages, v_pages, lengths, block_tables, sm_scale=sm_scale)
        if backend == "kernel":
            return paged_attention_decode_kernel(
                q, k_pages, v_pages, lengths, block_tables, sm_scale=sm_scale)
    raise ValueError(
        f"paged_attention_decode: unknown backend {backend!r} "
        f"(use 'auto', 'kernel' or 'reference')")
