"""Varlen (packed-sequence) flash attention: the hand-written CUDA kernels
and their plain versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention_varlen.py`` (kernel
source ``csrc/flash_attention_varlen.cu``): several sequences packed into
one token axis, q ``[Tq, H, D]`` and k/v ``[Tk, Hkv, D]``, with
``cu_seqlens`` (int32 or int64, ``[n_seqs + 1]``) giving each segment's
start. A q row sees the keys of its own segment only and, when causal,
none past its bound, bottom-right aligned per segment (:func:`_seg_vectors`).
Dropout uses the dense kernels' counter hash on (q head, packed row,
packed col), so the bits equal the reference's.

The reference transposes to ``[H, T, D]`` and pads T to 128 for the
TPU's layout; the port reads the packed tensors in place and returns
lse unpadded, ``[H, Tq]``. ``cu_seqlens`` stay on the device: nothing
here reads them back to the host.

Routing: a CPU tensor takes :func:`_vflash_fwd_reference` /
:func:`_vflash_bwd_reference`; a CUDA tensor launches the kernels or
raises. There is no fallback between the two. The kernels' route is the
dtype's: fp32 on the CUDA cores, bf16 and fp16 on the tensor cores.

Head dims (:func:`_kernel_head_dim`): up to 256 the kernels compiled for
every multiple of 32 from 32 to 256 (``KERNEL_HEAD_DIMS``) run, by the
dtype's route; above 256 every dtype takes the wide kernels
(``vflash_*_wide_kernel``, fp32 math on the CUDA cores), which take the
head dim at run time, any multiple of 32. Their fp32 accumulator holds at
most ``WIDE_RANGE_COLS`` (1536) columns, so above that the columns are cut
into ranges, one block per range (:func:`_wide_column_ranges`). The C
entry points route by the same rule. Any other head dim runs at the next
multiple of 32, with q, k, v (and out, dO) zero-padded and the results
sliced back; that is exact, because zero columns add nothing to Q K^T and
give only output columns that are sliced off. Every head dim from 1 up
runs on the card, as the plain version takes any.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ...core.autocast import autocast_off
from ...utils.flops import kernel_work
from .flash_attention import NEG_INF, _as_int64, _keep_mask

__all__ = ["flash_attn_varlen_thd", "flash_attn_varlen", "launches",
           "dq_launches", "dkv_launches", "KERNEL_HEAD_DIMS",
           "WIDE_RANGE_COLS"]

#: head dims the kernels are compiled for (csrc/flash_attention_varlen.cu
#: ``with_head_dim``); other head dims up to 256 are padded to the next one
KERNEL_HEAD_DIMS = tuple(range(32, 257, 32))
#: the widest column range of the wide kernels' fp32 accumulator
#: (csrc/flash_attention_varlen.cu ``kWideMaxD``): [32, 1536] fp32 and the
#: staging tiles, 128 x 1536 + 20.8 KB, fill the 227 KB of shared memory a
#: block may use
WIDE_RANGE_COLS = 1536

#: forward kernel launches since the count was last reset
launches = 0
#: backward dq kernel launches
dq_launches = 0
#: backward dk/dv kernel launches
dkv_launches = 0

_fns = {}
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_TAIL = [ctypes.c_float, _INT, _INT, ctypes.c_uint, ctypes.c_float, _INT, _PTR]
# argument types of the C entry points (csrc/flash_attention_varlen.cu)
_ARGTYPES = {
    "vflash_fwd": [_PTR] * 3 + [_I64] * 3 + [_PTR] * 7 + [_INT] * 6 + _TAIL,
    "vflash_bwd_dq": [_PTR] * 3 + [_I64] * 3 + [_PTR] * 9 + [_INT] * 6 + _TAIL,
    "vflash_bwd_dkv": [_PTR] * 3 + [_I64] * 3 + [_PTR] * 11 + [_INT] * 6
    + _TAIL,
}


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_attention_varlen"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _seg_vectors(cu_q, cu_k, n_q, n_k):
    """Per-token segment ids and causal column bounds from cu_seqlens, on
    their device: (seg_q [n_q], seg_k [n_k], bound [n_q]) int32. The rule
    of the reference's ``_seg_vectors``: a token's segment is
    ``searchsorted(cu[1:], pos, right=True)``, so zero-length segments are
    skipped; tokens past ``cu[-1]`` get the sentinels n_seqs (q) and
    n_seqs + 1 (k), which never match, and bound -1. A q row of segment s
    may see keys up to ``cu_k[s] + (row - cu_q[s]) + (len_k - len_q)``."""
    n_seqs = cu_q.shape[0] - 1
    cu_q = cu_q.to(torch.int32)
    cu_k = cu_k.to(torch.int32)
    dev = cu_q.device
    pos_q = torch.arange(n_q, dtype=torch.int32, device=dev)
    pos_k = torch.arange(n_k, dtype=torch.int32, device=dev)
    seg_q = torch.searchsorted(cu_q[1:], pos_q, right=True, out_int32=True)
    seg_k = torch.searchsorted(cu_k[1:], pos_k, right=True, out_int32=True)
    in_q = pos_q < cu_q[-1]
    seg_q = torch.where(in_q, seg_q, n_seqs)
    seg_k = torch.where(pos_k < cu_k[-1], seg_k, n_seqs + 1)
    sq = seg_q.clamp(0, n_seqs - 1).long()
    len_q = cu_q[sq + 1] - cu_q[sq]
    len_k = cu_k[sq + 1] - cu_k[sq]
    bound = cu_k[sq] + (pos_q - cu_q[sq]) + (len_k - len_q)
    bound = torch.where(in_q, bound, -1).to(torch.int32)
    return seg_q.to(torch.int32), seg_k.to(torch.int32), bound


def _check(q, k, v, cu_q, cu_k, seed, dropout_rate):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(
            f"varlen flash attention wants q [Tq,H,D] and k/v [Tk,Hkv,D], got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    if k.shape[2] != q.shape[2] or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"varlen flash attention: k/v {tuple(k.shape)} do not fit q "
            f"{tuple(q.shape)} (head dim, GQA group)")
    if q.shape[0] == 0 or k.shape[0] == 0:
        raise ValueError("varlen flash attention: empty token axis")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"varlen flash attention: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if (cu_q.ndim != 1 or cu_q.shape != cu_k.shape or cu_q.shape[0] < 2
            or cu_q.dtype.is_floating_point or cu_k.dtype.is_floating_point):
        raise ValueError(
            f"varlen flash attention: cu_seqlens_q/k must be integer "
            f"[n_seqs + 1] vectors of one length >= 2, got "
            f"{tuple(cu_q.shape)} / {tuple(cu_k.shape)}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"varlen flash attention: dropout_rate must be in "
                         f"[0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("varlen flash attention: dropout_rate > 0 needs a "
                         "seed")


def _mask(cu_q, cu_k, n_q, n_k, causal):
    """[Tq, Tk] bool: which keys each q row may see."""
    seg_q, seg_k, bound = _seg_vectors(cu_q, cu_k, n_q, n_k)
    valid = seg_q[:, None] == seg_k[None, :]
    if causal:
        cols = torch.arange(n_k, dtype=torch.int32, device=seg_q.device)
        valid = valid & (cols[None, :] <= bound[:, None])
    return valid


def _varlen_keep(seed, h, n_q, n_k, rate, device):
    """The dropout keep mask times 1 / (1 - rate), [H, Tq, Tk] fp32: the
    counter hash on (q head, packed row, packed col)."""
    heads = torch.arange(h, dtype=torch.int64, device=device)[:, None, None]
    rows = torch.arange(n_q, dtype=torch.int64, device=device)[None, :, None]
    cols = torch.arange(n_k, dtype=torch.int64, device=device)[None, None, :]
    keep = _keep_mask(_as_int64(seed, device).reshape(-1)[0], heads, rows,
                      cols, rate)
    return keep.to(torch.float32) * (1.0 / (1.0 - rate))


def _scores(q, k, cu_q, cu_k, causal, scale):
    """fp32 logits [H, Tq, Tk] under the segment mask, with k/v repeated
    to q's heads: (s, repeat)."""
    g = q.shape[1] // k.shape[1]

    def repeat(t):      # [T, Hkv, D] -> [H, T, D] fp32
        t = t.float().transpose(0, 1)
        return t.repeat_interleave(g, dim=0) if g > 1 else t

    s = torch.einsum("hqd,hkd->hqk", q.float().transpose(0, 1),
                     repeat(k)) * scale
    valid = _mask(cu_q, cu_k, q.shape[0], k.shape[0], causal)
    return torch.where(valid[None], s, NEG_INF), repeat


def _vflash_fwd_reference(q, k, v, cu_q, cu_k, seed=None, *, causal, scale,
                          dropout_rate=0.0):
    """The forward kernel's arithmetic in plain PyTorch, untiled:
    (out [Tq, H, D] in q's dtype, lse [H, Tq] fp32)."""
    _check(q, k, v, cu_q, cu_k, seed, dropout_rate)
    s, repeat = _scores(q, k, cu_q, cu_k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    m_eff = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(s - m_eff)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        p = p * _varlen_keep(seed, q.shape[1], q.shape[0], k.shape[0],
                             dropout_rate, q.device)
    acc = torch.einsum("hqk,hkd->hqd", p, repeat(v))
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).transpose(0, 1).contiguous().to(q.dtype)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return out, lse


def _vflash_bwd_reference(q, k, v, cu_q, cu_k, out, lse, do, seed=None, *,
                          causal, scale, dropout_rate=0.0):
    """The backward kernels' arithmetic in plain PyTorch, untiled:
    (dq in q's dtype, dk, dv in k's dtype). P comes from the saved lse (0
    where lse is -inf, so a row that saw no key has zero gradients), and
    the GQA group's per-q-head dk/dv are summed in fp32."""
    _check(q, k, v, cu_q, cu_k, seed, dropout_rate)
    tq, h, d = q.shape
    tk, hkv = k.shape[0], k.shape[1]
    s, repeat = _scores(q, k, cu_q, cu_k, causal, scale)
    lse_safe = torch.where(lse == NEG_INF, 0.0, lse.float())[..., None]
    p = torch.exp(s - lse_safe)
    dof = do.float().transpose(0, 1)
    delta = (dof * out.float().transpose(0, 1)).sum(dim=-1, keepdim=True)
    dp = torch.einsum("hqd,hkd->hqk", dof, repeat(v))
    p_drop = p
    if dropout_rate > 0.0:
        keep = _varlen_keep(seed, h, tq, tk, dropout_rate, q.device)
        p_drop, dp = p * keep, dp * keep
    ds = p * (dp - delta) * scale
    dq = torch.einsum("hqk,hkd->qhd", ds, repeat(k))
    dk = torch.einsum("hqk,qhd->khd", ds, q.float())
    dv = torch.einsum("hqk,hqd->khd", p_drop, dof)
    if h != hkv:
        dk = dk.reshape(tk, hkv, h // hkv, d).sum(dim=2)
        dv = dv.reshape(tk, hkv, h // hkv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _packed(t):
    """``t`` itself where its heads and head dims are contiguous (a packed
    [T, H, D] tensor, or one of q, k, v unbound from a packed qkv), which
    the kernels read in place at its token stride; else a contiguous
    copy. bf16 and fp16 go to the tensor-core kernels, which copy each
    token's head in 16-byte pieces: read in place, such a tensor must also
    start on a 16-byte boundary with a token stride that is a multiple of
    8 elements (a head's offset, h * D * 2 bytes, is then one too)."""
    _, h, d = t.shape
    in_place = t.stride(2) == 1 and (h == 1 or t.stride(1) == d)
    if in_place and t.dtype != torch.float32:
        in_place = t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
    if in_place:
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _kernel_args(q, k, v, cu_q, cu_k, seed, dropout_rate):
    """Check what the kernels take (q, k, v from :func:`_packed`) and
    return what their launches share: token strides, the int32 segment
    vectors and cu_seqlens, the seed, dropout threshold and keep scale."""
    dev = q.device
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"varlen flash kernel: unsupported dtype {q.dtype}")
    for name, t in (("k", k), ("v", v), ("cu_seqlens_q", cu_q),
                    ("cu_seqlens_k", cu_k)):
        if t.device != dev:
            raise ValueError(f"varlen flash kernel: {name} on {t.device}, q "
                             f"on {dev}")
    strides = [t.stride(0) for t in (q, k, v)]
    cu_q32 = cu_q.to(torch.int32).contiguous()
    cu_k32 = cu_k.to(torch.int32).contiguous()
    seg = _seg_vectors(cu_q32, cu_k32, q.shape[0], k.shape[0])
    thresh, inv_keep = 0, 1.0
    if dropout_rate > 0.0:
        if not isinstance(seed, torch.Tensor):
            seed = torch.tensor([int(seed)], dtype=torch.int32)
        seed = seed.to(device=dev, dtype=torch.int32).reshape(-1)[:1]
        thresh = int(min(float(dropout_rate), 1.0) * 2147483647.0)
        inv_keep = 1.0 / (1.0 - dropout_rate)
    else:
        seed = None
    return dict(strides=strides, seg=seg, cu_q=cu_q32, cu_k=cu_k32,
                seed=seed, thresh=thresh, inv_keep=inv_keep)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _shape_args(q, k, a):
    tq, h, d = q.shape
    tk, hkv = k.shape[0], k.shape[1]
    return [tq, tk, h, hkv, d, a["cu_q"].shape[0] - 1]


def _tail_args(q, a, causal, scale, dropout_rate):
    return [float(scale), int(bool(causal)), int(dropout_rate > 0.0),
            a["thresh"], float(a["inv_keep"]), _build.DTYPE_CODES[q.dtype],
            _build.stream_ptr(q.device)]


def _kernel_head_dim(d):
    """(head dim the kernels run at, route) for a call with head dim
    ``d``: the next multiple of 32 (``d`` itself if it is one), and
    "compiled" up to 256 (the kernels compiled for that head dim) or
    "wide" above (the wide kernels, head dim at run time). Raises
    ``ValueError`` for ``d`` < 1."""
    d = int(d)
    if d < 1:
        raise ValueError(f"varlen flash kernel: head dim {d} < 1")
    d_run = -(-d // 32) * 32
    return d_run, "compiled" if d_run <= KERNEL_HEAD_DIMS[-1] else "wide"


def _wide_column_ranges(d):
    """(ranges, columns a range) of the wide kernels' accumulator for a
    call with head dim ``d`` (csrc/flash_attention_varlen.cu
    ``wide_range_cols``): the kernels' head dim cut into n =
    ceil(D / ``WIDE_RANGE_COLS``) ranges of ceil(D / n) columns rounded up
    to 32, the last one narrower where they do not divide D; one block
    per range, each taking the products over the full D and accumulating
    its own columns. One range up to 1536."""
    d_run, _ = _kernel_head_dim(d)
    n = -(-d_run // WIDE_RANGE_COLS)
    cols = -(-(-(-d_run // n)) // 32) * 32
    return -(-d_run // cols), cols


def _pad_head_dim(t, d):
    """``t`` [T, H, D0] zero-padded on its last axis to ``d``, or ``t``
    itself where D0 == d."""
    if t.shape[-1] == d:
        return t
    return torch.nn.functional.pad(t, (0, d - t.shape[-1]))


def _cut_head_dim(t, d):
    """The first ``d`` columns of ``t``'s last axis, contiguous."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _vflash_fwd_kernel(q, k, v, cu_q, cu_k, seed, *, causal, scale,
                       dropout_rate):
    """The forward kernel at the kernels' head dim: q, k, v padded to
    :func:`_kernel_head_dim` (``scale`` is the caller's, from the unpadded
    D), out sliced back."""
    d = q.shape[2]
    d_run, _ = _kernel_head_dim(d)
    out, lse = _vflash_fwd_launch(
        *(_pad_head_dim(t, d_run) for t in (q, k, v)), cu_q, cu_k, seed,
        causal=causal, scale=scale, dropout_rate=dropout_rate)
    return _cut_head_dim(out, d), lse


def _vflash_fwd_launch(q, k, v, cu_q, cu_k, seed, *, causal, scale,
                       dropout_rate):
    global launches
    q, k, v = (_packed(t) for t in (q, k, v))
    a = _kernel_args(q, k, v, cu_q, cu_k, seed, dropout_rate)
    seg_q, seg_k, bound = a["seg"]
    tq, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((h, tq), dtype=torch.float32, device=q.device)
    status = _kernel("vflash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *a["strides"],
        seg_q.data_ptr(), seg_k.data_ptr(), bound.data_ptr(),
        a["cu_k"].data_ptr(), _ptr(a["seed"]), out.data_ptr(), lse.data_ptr(),
        *_shape_args(q, k, a), *_tail_args(q, a, causal, scale, dropout_rate))
    _build.check_status(status, "vflash_fwd")
    launches += 1
    return out, lse


def _vflash_bwd_kernel(q, k, v, cu_q, cu_k, out, lse, do, seed, *, causal,
                       scale, dropout_rate):
    """The dq and dk/dv kernels at the kernels' head dim: q, k, v, out and
    do padded as in :func:`_vflash_fwd_kernel`, the gradients sliced
    back."""
    tq, h, d = q.shape
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"varlen flash bwd kernel: {name} must match q "
                             f"({tuple(q.shape)}, {q.dtype}, {q.device})")
    if lse.shape != (h, tq):
        raise ValueError(f"varlen flash bwd kernel: lse must be [H, Tq], got "
                         f"{tuple(lse.shape)}")
    d_run, _ = _kernel_head_dim(d)
    q, k, v, out, do = (_pad_head_dim(t, d_run) for t in (q, k, v, out, do))
    grads = _vflash_bwd_launch(q, k, v, cu_q, cu_k, out, lse, do, seed,
                               causal=causal, scale=scale,
                               dropout_rate=dropout_rate)
    return tuple(_cut_head_dim(g, d) for g in grads)


def _vflash_bwd_launch(q, k, v, cu_q, cu_k, out, lse, do, seed, *, causal,
                       scale, dropout_rate):
    global dq_launches, dkv_launches
    q, k, v = (_packed(t) for t in (q, k, v))
    a = _kernel_args(q, k, v, cu_q, cu_k, seed, dropout_rate)
    seg_q, seg_k, bound = a["seg"]
    do = do.contiguous()
    if do.data_ptr() % 16:     # the tensor-core kernels copy 16-byte pieces
        do = do.clone()
    lse = lse.to(torch.float32).contiguous()
    delta = (do.float() * out.float()).sum(dim=-1).t().contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    common = [q.data_ptr(), k.data_ptr(), v.data_ptr(), *a["strides"],
              do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              seg_q.data_ptr(), seg_k.data_ptr(), bound.data_ptr()]
    shape = _shape_args(q, k, a)
    tail = _tail_args(q, a, causal, scale, dropout_rate)
    status = _kernel("vflash_bwd_dq")(
        *common, a["cu_k"].data_ptr(), _ptr(a["seed"]), dq.data_ptr(),
        *shape, *tail)
    _build.check_status(status, "vflash_bwd_dq")
    dq_launches += 1
    status = _kernel("vflash_bwd_dkv")(
        *common, a["cu_q"].data_ptr(), a["cu_k"].data_ptr(), _ptr(a["seed"]),
        dk.data_ptr(), dv.data_ptr(), *shape, *tail)
    _build.check_status(status, "vflash_bwd_dkv")
    dkv_launches += 1
    return dq, dk, dv


def _route(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type == "cpu"


def _vflash_fwd(q, k, v, cu_q, cu_k, seed=None, *, causal, scale,
                dropout_rate=0.0):
    """q: [Tq, H, D]; k, v: [Tk, Hkv, D] (packed, read in place); cu_q,
    cu_k: [n_seqs + 1] int -> (out [Tq, H, D], lse [H, Tq] fp32). seed:
    int32 (a tensor of one element or an int), required when
    dropout_rate > 0. CPU tensors run the plain version, CUDA tensors the
    kernel."""
    _check(q, k, v, cu_q, cu_k, seed, dropout_rate)
    kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate)
    with kernel_work(0):        # the reference's call declares no cost
        if _route(q, "varlen flash attention"):
            return _vflash_fwd_reference(q, k, v, cu_q, cu_k, seed, **kw)
        return _vflash_fwd_kernel(q, k, v, cu_q, cu_k, seed, **kw)


def _vflash_bwd(q, k, v, cu_q, cu_k, out, lse, do, seed=None, *, causal,
                scale, dropout_rate=0.0):
    """Gradients of :func:`_vflash_fwd`: out, do [Tq, H, D] and lse
    [H, Tq] from the forward -> (dq, dk, dv). ``seed`` must be the
    forward's. CPU tensors run the plain version, CUDA tensors the dq and
    the dk/dv kernels."""
    _check(q, k, v, cu_q, cu_k, seed, dropout_rate)
    kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate)
    with kernel_work(0):        # the reference's call declares no cost
        if _route(q, "varlen flash attention"):
            return _vflash_bwd_reference(q, k, v, cu_q, cu_k, out, lse, do,
                                         seed, **kw)
        return _vflash_bwd_kernel(q, k, v, cu_q, cu_k, out, lse, do, seed,
                                  **kw)


def flash_attn_varlen_thd(q, k, v, cu_q, cu_k, seed=None, *, causal=False,
                          scale=None, dropout_rate=0.0):
    """Varlen attention over packed [T, H, D] tensors, no autograd.
    ``seed`` (int32 [1]) enables in-kernel attention dropout at
    ``dropout_rate``. Returns (out [Tq, H, D], lse [H, Tq])."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _vflash_fwd(q, k, v, cu_q, cu_k, seed, causal=bool(causal),
                       scale=float(scale), dropout_rate=float(dropout_rate))


class _FlashAttnVarlen(torch.autograd.Function):
    """Varlen flash attention through the forward and backward kernels.
    Saves q, k, v, the cu_seqlens, out, lse and the seed the caller drew:
    the backward regenerates the same dropout bits from it. Autocast is
    off inside: the caller casts (``core/autocast.py``)."""

    @staticmethod
    @autocast_off
    def forward(ctx, q, k, v, cu_q, cu_k, seed, causal, scale, dropout_rate):
        out, lse = _vflash_fwd(q, k, v, cu_q, cu_k, seed, causal=causal,
                               scale=scale, dropout_rate=dropout_rate)
        ctx.save_for_backward(q, k, v, cu_q, cu_k, out, lse, seed)
        ctx.statics = dict(causal=causal, scale=scale,
                           dropout_rate=dropout_rate)
        return out

    @staticmethod
    @autocast_off
    def backward(ctx, grad_out):
        q, k, v, cu_q, cu_k, out, lse, seed = ctx.saved_tensors
        dq, dk, dv = _vflash_bwd(q, k, v, cu_q, cu_k, out, lse, grad_out,
                                 seed, **ctx.statics)
        # cu_seqlens and the seed are integers: they take no gradient
        return dq, dk, dv, None, None, None, None, None, None


def flash_attn_varlen(q, k, v, cu_q, cu_k, seed=None, *, causal=False,
                      scale=None, dropout_rate=0.0):
    """Tensor-level entry used by ``flash_attn_unpadded``: the output
    [Tq, H, D] with autograd through the kernels. ``seed`` is required
    when ``dropout_rate`` > 0."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttnVarlen.apply(q, k, v, cu_q, cu_k, seed, bool(causal),
                                  float(scale), float(dropout_rate))
