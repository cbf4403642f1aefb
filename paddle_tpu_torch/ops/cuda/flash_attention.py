"""Flash attention: the hand-written CUDA kernels and their plain
versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py`` (kernel
source ``csrc/flash_attention.cu``): ``_flash_fwd_bhsd``,
``_flash_bwd_bhsd``, ``flash_attention_bshd``, ``flash_attention_fused``
and the ``_dropout_keep`` counter hash, reproduced bit for bit. The
backward reuses the seed the forward drew, so it regenerates the same
keep mask.

Routing: a CPU tensor takes :func:`_flash_fwd_reference` /
:func:`_flash_bwd_reference`; a CUDA tensor launches the kernel or
raises. There is no fallback between the two. On the card the dtype
picks the kernels (in the C entry points): fp32 runs the CUDA-core
kernels (``flash_fwd_kernel``, ``flash_bwd_dq_kernel``,
``flash_bwd_dkv_kernel``), bf16 and fp16 the tensor-core kernels
(``flash_fwd_tc_kernel``, ``flash_bwd_dq_tc_kernel``,
``flash_bwd_dkv_tc_kernel``), which copy rows in 16-byte chunks and so
take tensors that start on a 16-byte boundary (:func:`_aligned`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ...core.autocast import autocast_off
from ...core.generator import draw_seed
from ...utils.flops import kernel_work

__all__ = ["flash_attention_bshd", "flash_attention_fused",
           "launches", "bwd_launches", "KERNEL_HEAD_DIMS"]

NEG_INF = float("-inf")
#: head dims the kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128)
_U32 = 0xFFFFFFFF

#: forward kernel launches since the count was last reset
launches = 0
#: backward launches (one dq and one dk/dv kernel each) since the reset
bwd_launches = 0

_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("flash_attention").flash_bwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _mul32(x, c):
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return ((((hi * c) & 0xFFFF) << 16) + lo * c) & _U32


def _keep_mask(seed, bh, rows, cols, rate):
    """The counter hash of ``_dropout_keep`` on broadcastable int64 index
    tensors: uint32 wrapping multiplies and logical shifts, carried in
    int64 masked to 32 bits. Returns a bool keep mask."""
    x = _mul32(rows & _U32, 0x9E3779B1) ^ _mul32(cols & _U32, 0x85EBCA77)
    x = x ^ _mul32(bh & _U32, 0xC2B2AE3D) ^ (seed & _U32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    thresh = int(min(float(rate), 1.0) * 2147483647.0)
    return (x & 0x7FFFFFFF) >= thresh


def _as_int64(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.tensor(int(v), dtype=torch.int64, device=device)


def _dropout_keep(seed, bh, i, j, block_q, block_k, rate):
    """Attention-dropout keep mask for the (i, j) tile of head ``bh`` —
    the same signature and the same bits as the jnp function
    (``flash_attention.py:43``). P(keep) = 1 - rate; float32 0/1."""
    seed = _as_int64(seed, None).reshape(-1)[:1].reshape(())
    dev = seed.device
    rows = (_as_int64(i, dev) * block_q
            + torch.arange(block_q, dtype=torch.int64, device=dev)[:, None])
    cols = (_as_int64(j, dev) * block_k
            + torch.arange(block_k, dtype=torch.int64, device=dev)[None, :])
    return _keep_mask(seed, _as_int64(bh, dev), rows, cols,
                      rate).to(torch.float32)


def _check(q, k, v, seed, key_bias, dropout_rate):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash attention wants q [B,H,Sq,D] and k/v [B,Hkv,Sk,D], got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(
            f"flash attention: k/v {tuple(k.shape)} do not fit q "
            f"{tuple(q.shape)} (batch, head dim, GQA group)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if key_bias is not None and (
            key_bias.ndim != 2 or key_bias.shape[0] not in (1, b)
            or key_bias.shape[1] != k.shape[2]):
        raise ValueError(
            f"flash attention: key_bias must be [B|1, Sk], got "
            f"{tuple(key_bias.shape)}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"flash attention: dropout_rate must be in [0, 1), "
                         f"got {dropout_rate}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("flash attention: dropout_rate > 0 needs a seed")


def _scores(q, k, key_bias, *, causal, scale):
    """fp32 logits [B,H,Sq,Sk] under the kernels' bias and causal mask,
    with k/v repeated to q's heads: (s, repeat)."""
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv

    def repeat(t):
        return t.float().repeat_interleave(g, dim=1) if g > 1 else t.float()

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), repeat(k)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows + (sk - sq) >= cols, s, NEG_INF)
    return s, repeat


def _keep_scale(q, sk, seed, dropout_rate):
    """The dropout keep mask times 1 / (1 - rate), [B,H,Sq,Sk] fp32."""
    b, h, sq, _ = q.shape
    dev = q.device
    bh = (torch.arange(b, dtype=torch.int64, device=dev)[:, None] * h
          + torch.arange(h, dtype=torch.int64, device=dev)[None, :])
    rows = torch.arange(sq, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(sk, dtype=torch.int64, device=dev)[None, :]
    keep = _keep_mask(_as_int64(seed, dev).reshape(-1)[0],
                      bh[:, :, None, None], rows, cols, dropout_rate)
    return keep.to(torch.float32) * (1.0 / (1.0 - dropout_rate))


def _flash_fwd_reference(q, k, v, seed=None, key_bias=None, *, causal,
                         scale, dropout_rate=0.0):
    """The forward kernel's arithmetic in plain PyTorch, untiled:
    (out [B,H,Sq,D] in q's dtype, lse [B,H,Sq] fp32)."""
    _check(q, k, v, seed, key_bias, dropout_rate)
    s, repeat = _scores(q, k, key_bias, causal=causal, scale=scale)
    m = s.amax(dim=-1, keepdim=True)
    m_eff = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(s - m_eff)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        p = p * _keep_scale(q, k.shape[2], seed, dropout_rate)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, repeat(v))
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return out, lse


def _flash_bwd_reference(q, k, v, out, lse, do, seed=None, key_bias=None, *,
                         causal, scale, dropout_rate=0.0):
    """The backward kernels' arithmetic in plain PyTorch, untiled:
    (dq in q's dtype, dk, dv in k's dtype). P comes from the saved lse
    (0 where lse is -inf, so a fully masked row has zero gradients), and
    the GQA group's per-q-head dk/dv are summed in fp32."""
    _check(q, k, v, seed, key_bias, dropout_rate)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    s, repeat = _scores(q, k, key_bias, causal=causal, scale=scale)
    lse_safe = torch.where(lse == NEG_INF, 0.0, lse.float())[..., None]
    p = torch.exp(s - lse_safe)
    dof = do.float()
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, repeat(v))
    p_drop = p
    if dropout_rate > 0.0:
        keep = _keep_scale(q, sk, seed, dropout_rate)
        p_drop, dp = p * keep, dp * keep
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, repeat(k))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p_drop, dof)
    if h != hkv:
        dk = dk.reshape(b, hkv, h // hkv, sk, d).sum(dim=2)
        dv = dv.reshape(b, hkv, h // hkv, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _aligned(t):
    """``t`` itself if it starts on a 16-byte boundary, else a copy that
    does (a contiguous view into a larger tensor may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_args(q, k, v, seed, key_bias, dropout_rate):
    """Check what the kernels take and return the launch arguments they
    share: (bias pointer, bias batch stride, seed pointer, dropout
    threshold, keep scale, the seed tensor kept alive)."""
    dev = q.device
    b, _, _, d = q.shape
    sk = k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash kernel: unsupported dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash kernel: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel: {name} must be contiguous")
    bias_ptr, bias_stride = None, 0
    if key_bias is not None:
        if (key_bias.device != dev or key_bias.dtype != torch.float32
                or not key_bias.is_contiguous()):
            raise ValueError("flash kernel: key_bias must be a contiguous "
                             "float32 tensor on q's device")
        bias_ptr = key_bias.data_ptr()
        bias_stride = sk if key_bias.shape[0] == b and b > 1 else 0
    seed_ptr, thresh, inv_keep = None, 0, 1.0
    if dropout_rate > 0.0:
        if not isinstance(seed, torch.Tensor):
            seed = torch.tensor([int(seed)], dtype=torch.int32)
        seed = seed.to(device=dev, dtype=torch.int32).reshape(-1)[:1]
        seed_ptr = seed.data_ptr()
        thresh = int(min(float(dropout_rate), 1.0) * 2147483647.0)
        inv_keep = 1.0 / (1.0 - dropout_rate)
    return bias_ptr, bias_stride, seed_ptr, thresh, inv_keep, seed


def _flash_fwd_kernel(q, k, v, seed, key_bias, *, causal, scale,
                      dropout_rate):
    global launches
    dev = q.device
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bias_ptr, bias_stride, seed_ptr, thresh, inv_keep, _seed = _kernel_args(
        q, k, v, seed, key_bias, dropout_rate)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    status = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                       bias_stride, seed_ptr, out.data_ptr(), lse.data_ptr(),
                       b, h, hkv, sq, sk, d, float(scale), int(bool(causal)),
                       int(dropout_rate > 0.0), thresh, float(inv_keep),
                       _build.DTYPE_CODES[q.dtype], _build.stream_ptr(dev))
    _build.check_status(status, "flash_fwd")
    launches += 1
    return out, lse


def _flash_bwd_kernel(q, k, v, out, lse, do, seed, key_bias, *, causal,
                      scale, dropout_rate):
    global bwd_launches
    dev = q.device
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bias_ptr, bias_stride, seed_ptr, thresh, inv_keep, _seed = _kernel_args(
        q, k, v, seed, key_bias, dropout_rate)
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"flash bwd kernel: {name} must match q "
                             f"({tuple(q.shape)}, {q.dtype}, {dev})")
    if lse.shape != (b, h, sq):
        raise ValueError(f"flash bwd kernel: lse must be [B,H,Sq], got "
                         f"{tuple(lse.shape)}")
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(
        do.contiguous())
    lse = lse.to(torch.float32).contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    status = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), bias_ptr, bias_stride, seed_ptr,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, sk, d,
        float(scale), int(bool(causal)), int(dropout_rate > 0.0), thresh,
        float(inv_keep), _build.DTYPE_CODES[q.dtype], _build.stream_ptr(dev))
    _build.check_status(status, "flash_bwd")
    bwd_launches += 1
    return dq, dk, dv


def _flash_fwd_bhsd(q, k, v, seed=None, key_bias=None, *, causal, scale,
                    dropout_rate=0.0):
    """q: [B,H,Sq,D]; k,v: [B,Hkv,Sk,D] -> (out [B,H,Sq,D], lse [B,H,Sq]).
    seed: int32 (a tensor of one element or an int), required when
    dropout_rate > 0. key_bias: [B|1, Sk] additive logit bias broadcast
    over heads and rows, added BEFORE the causal mask. CPU tensors run
    the plain version, CUDA tensors the kernel."""
    _check(q, k, v, seed, key_bias, dropout_rate)
    b, h, sq, d = q.shape
    # the work the reference's pallas_call declares (utils/flops.py)
    with kernel_work(4 * b * h * sq * k.shape[2] * d):
        if q.device.type == "cpu":
            return _flash_fwd_reference(q, k, v, seed, key_bias,
                                        causal=causal, scale=scale,
                                        dropout_rate=dropout_rate)
        if q.device.type != "cuda":
            raise ValueError(
                f"flash attention: unsupported device {q.device}")
        return _flash_fwd_kernel(q, k, v, seed, key_bias, causal=causal,
                                 scale=scale, dropout_rate=dropout_rate)


def _flash_bwd_bhsd(q, k, v, out, lse, do, seed=None, key_bias=None, *,
                    causal, scale, dropout_rate=0.0):
    """Gradients of :func:`_flash_fwd_bhsd`: q, out, do [B,H,Sq,D], k, v
    [B,Hkv,Sk,D], lse [B,H,Sq] from the forward -> (dq, dk, dv). ``seed``
    and ``key_bias`` must be the forward's. CPU tensors run the plain
    version, CUDA tensors the kernels."""
    _check(q, k, v, seed, key_bias, dropout_rate)
    kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate)
    with kernel_work(0):        # the reference's call declares no cost
        if q.device.type == "cpu":
            return _flash_bwd_reference(q, k, v, out, lse, do, seed,
                                        key_bias, **kw)
        if q.device.type != "cuda":
            raise ValueError(
                f"flash attention: unsupported device {q.device}")
        return _flash_bwd_kernel(q, k, v, out, lse, do, seed, key_bias, **kw)


def flash_attention_bshd(q, k, v, *extras, causal=False, scale=None,
                         dropout_rate=0.0, has_bias=False):
    """Flash attention in paddle's [B, S, H, D] layout. Returns (out, lse).
    ``extras`` holds the optional inputs in order: ``key_bias`` ([B|1, Sk],
    present when ``has_bias``) then ``seed`` (present when
    ``dropout_rate > 0``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    extras = list(extras)
    key_bias = extras.pop(0) if has_bias else None
    seed = extras.pop(0) if dropout_rate > 0.0 else None
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out, lse = _flash_fwd_bhsd(qt, kt, vt, seed, key_bias, causal=causal,
                               scale=float(scale),
                               dropout_rate=float(dropout_rate))
    return out.transpose(1, 2), lse


class _FlashAttention(torch.autograd.Function):
    """Flash attention in paddle's [B, S, H, D] layout through the forward
    and backward kernels. Saves q, k, v, out and lse in [B, H, S, D] and
    the seed the forward drew: the backward regenerates the same dropout
    bits from it and never draws a new one. Autocast is off inside: the
    caller casts (``core/autocast.py``)."""

    @staticmethod
    @autocast_off
    def forward(ctx, q, k, v, key_bias, seed, causal, scale, dropout_rate):
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        out, lse = _flash_fwd_bhsd(qt, kt, vt, seed, key_bias,
                                   causal=causal, scale=scale,
                                   dropout_rate=dropout_rate)
        ctx.save_for_backward(qt, kt, vt, out, lse, key_bias, seed)
        ctx.statics = dict(causal=causal, scale=scale,
                           dropout_rate=dropout_rate)
        return out.transpose(1, 2)

    @staticmethod
    @autocast_off
    def backward(ctx, grad_out):
        qt, kt, vt, out, lse, key_bias, seed = ctx.saved_tensors
        do = grad_out.contiguous().transpose(1, 2).contiguous()
        dq, dk, dv = _flash_bwd_bhsd(qt, kt, vt, out, lse, do, seed,
                                     key_bias, **ctx.statics)
        # key_bias is a mask and the seed an integer: neither takes a grad
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None, None, None)


def flash_attention_fused(q, k, v, *, causal=False, scale=None,
                          dropout_p=0.0, generator=None, key_bias=None):
    """Tensor-level entry used by ``scaled_dot_product_attention`` (paddle
    layout [B, S, H, D]); returns the attention output. ``dropout_p`` > 0
    requires ``generator`` (a ``torch.Generator`` on q's device), from
    which one int32 seed for the in-kernel counter hash is drawn.
    ``key_bias`` is a [B|1, Sk] additive logit bias (a padding mask)."""
    scale = (float(scale) if scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    if key_bias is not None:
        if key_bias.requires_grad:
            raise ValueError(
                "flash_attention_fused: key_bias is a mask input and "
                "receives no gradient; a trainable additive bias must use "
                "the plain attention path (sdpa with attn_mask).")
        key_bias = key_bias.to(torch.float32).contiguous()
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(
            f"flash_attention_fused: dropout_p must be in [0, 1), got "
            f"{dropout_p} (the 1/(1-p) keep-scale diverges at 1)")
    seed = None
    if dropout_p > 0.0:
        if generator is None:
            raise ValueError(
                "flash_attention_fused: dropout_p > 0 requires a "
                "torch.Generator for the in-kernel counter hash's seed")
        seed = draw_seed(generator, q.device)
    return _FlashAttention.apply(q, k, v, key_bias, seed, bool(causal),
                                 scale, float(dropout_p))
