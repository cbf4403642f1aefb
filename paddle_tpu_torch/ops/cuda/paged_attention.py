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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "paged_attention_decode",
    "paged_attention_decode_reference",
    "paged_attention_decode_kernel",
    "launches",
]

#: kernel launches since the count was last reset
launches = 0

_fns = {}


def _lib():
    if not _fns:
        lib = _build.load("paged_attention")
        fn = lib.paged_decode
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.paged_decode_smem_bytes
        smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_longlong
        _fns.update(run=fn, smem=smem)
    return _fns


def _check_shapes(q, k_pages, v_pages, lengths, block_tables):
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
    fns = _lib()
    smem = fns["smem"](nh // kvh, dh, q.element_size())
    limit = _build.smem_limit(dev)
    if smem > limit:
        raise ValueError(
            f"paged_attention kernel: group {nh // kvh} x DH {dh} needs "
            f"{smem} bytes of shared memory, the card allows {limit}")
    # the kernel reads int32 lengths / tables (jax's x64 ids were cast the
    # same way at paged_attention.py:173-174)
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    block_tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    out = torch.empty_like(q)
    status = fns["run"](q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                        lengths.data_ptr(), block_tables.data_ptr(),
                        out.data_ptr(), b, nh, kvh, dh, num_pages, page,
                        block_tables.shape[1], float(scale),
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
    if backend == "reference":
        return paged_attention_decode_reference(
            q, k_pages, v_pages, lengths, block_tables, sm_scale=sm_scale)
    if backend == "kernel":
        return paged_attention_decode_kernel(
            q, k_pages, v_pages, lengths, block_tables, sm_scale=sm_scale)
    raise ValueError(
        f"paged_attention_decode: unknown backend {backend!r} "
        f"(use 'auto', 'kernel' or 'reference')")
