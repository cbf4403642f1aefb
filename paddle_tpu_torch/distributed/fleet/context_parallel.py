"""Context parallelism: ring attention and Ulysses (all-to-all) attention
over a sequence sharded on a mesh axis (``sep`` by default).

Counterpart of ``paddle_tpu/distributed/fleet/context_parallel.py``. The
reference runs one program over a device mesh: its q, k, v are the whole
sequence, which ``shard_map`` cuts on the axis. Here each rank is a
process holding its contiguous chunk: q, k, v are ``[B, S_local, H, D]``,
rank ``r`` of the axis holds tokens ``[r * S_local, (r + 1) * S_local)``,
and the result is this rank's chunk of the attention over the whole
sequence. Every rank of the axis must hold a chunk of the same length,
as the reference's sequence must divide by the axis degree: the first
call over a group checks it (one small all-gather, which every rank
makes at that call) and raises ``ValueError`` otherwise.
``fleet.meta_parallel.SegmentParallel``, which cuts the whole sequence
into the chunks, raises for a length that does not divide.

- ``ring_attention``: q stays; k and v rotate around the axis's ranks
  (``communication.functional``'s permute), and each rotation is one
  call of the flash forward kernel (``ops/cuda/flash_attention.py``
  ``_flash_fwd_bhsd``, queue B row 2), merged in lse form. The backward
  (``_RingFlash``, the reference's ``custom_vjp``) runs the flash
  backward kernel (row 4, ``_flash_bwd_bhsd``) on every block against
  the global lse and output, with dk and dv rotating beside k and v and
  one last hop taking them home. Under ``causal`` rotation 0 is the
  diagonal block, and a rank holds future keys at rotations
  ``i > r``: those blocks add nothing, so no kernel is launched for them
  (rank ``r`` launches ``r + 1`` forward and ``r + 1`` backward blocks a
  call; the rotations still run, as every rank takes part in each).
  ``_ring_attn_local``, the reference's einsum ring, is the plain
  PyTorch version the tests hold the flash ring against.
- ``ulysses_attention``: two all-to-alls trade the sequence shard for a
  head shard, so each rank attends over the whole sequence with ``H / n``
  heads through the flash entry point (rows 2 and 4; a dense
  ``[B, H / n, S, S]`` score matrix is what context parallelism exists
  to avoid). The heads must divide by the axis degree.

A CPU tensor runs the flash kernels' plain versions, a CUDA tensor the
kernels (or raises: a head dim or dtype they do not take). Without a
``mesh`` the hybrid group's (``fleet.init`` with a ``sep_degree``) is
used, and its ``sep`` axis.
"""
from __future__ import annotations

import math

import torch

from ...core.autocast import autocast_off
from ...ops.cuda.flash_attention import (_flash_bwd_bhsd, _flash_fwd_bhsd,
                                         flash_attention_fused)
from ..communication import functional as cf
from ..communication.group import axis_group

__all__ = ["ring_attention", "ulysses_attention", "seq_chunk"]

_NEG_INF = -1e30


def _resolve_mesh_axis(mesh, axis):
    if mesh is None:
        from .topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        if hcg is None:
            raise ValueError("context parallelism needs a mesh: pass one or "
                             "init fleet with a sep/cp degree > 1")
        mesh = hcg.mesh
        if axis is None:
            axis = "sep"
    return mesh, axis or "sep"


def _axis(mesh, axis):
    """(group, degree, this rank's index, the axis's name) of ``axis`` of
    ``mesh`` (by default the hybrid group's ``sep``)."""
    mesh, axis = _resolve_mesh_axis(mesh, axis)
    group = axis_group(mesh, axis)
    return group, group.nranks, max(group.rank, 0), axis


def seq_chunk(s_local, mesh=None, axis=None):
    """(the degree of ``axis``, the global position of this rank's first
    token) when each rank holds ``s_local`` tokens in rank order."""
    _, n, rank, _ = _axis(mesh, axis)
    return n, rank * int(s_local)


_checked = set()


def _check_chunks(name, group, axis, s_local, device):
    """Every rank of ``group`` holds ``s_local`` tokens: checked at the
    first call over the group (an all-gather of the lengths), else
    ``ValueError`` on every rank."""
    n = group.nranks
    key = group.id
    if n == 1 or key in _checked:
        return
    mine = torch.tensor([int(s_local)], device=device)
    lens = [int(x) for x in cf.all_gather(mine, group).tolist()]
    if len(set(lens)) != 1:
        raise ValueError(
            f"{name}: seq len {sum(lens)} must be divisible by the "
            f"'{axis}' axis degree {n} into equal chunks; its ranks hold "
            f"{lens} tokens")
    _checked.add(key)


def _rotate(x, group, n):
    """Rank ``j``'s ``x`` to rank ``j + 1`` (mod ``n``)."""
    return cf._permute(x, group.process_group,
                       [(j, (j + 1) % n) for j in range(n)])


def _ring_flash_forward(qt, kt, vt, group, n, rank, causal, scale):
    """The flash ring's forward on [B, H, S, D] blocks: (out fp32, lse)."""
    o = lse = None
    for i in range(n):
        if i:
            kt, vt = _rotate(kt, group, n), _rotate(vt, group, n)
        if causal and i > rank:
            continue                  # future keys: the block adds nothing
        o2, lse2 = _flash_fwd_bhsd(qt, kt, vt, causal=causal and i == 0,
                                   scale=scale)
        if o is None:
            o, lse = o2.float(), lse2
            continue
        new = torch.logaddexp(lse, lse2)
        o = (o * torch.exp(lse - new)[..., None]
             + o2.float() * torch.exp(lse2 - new)[..., None])
        lse = new
    return o, lse


class _RingFlash(torch.autograd.Function):
    """The flash ring over [B, S, H, D] chunks (module docstring)."""

    @staticmethod
    @autocast_off
    def forward(ctx, q, k, v, group, n, rank, causal, scale):
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        o, lse = _ring_flash_forward(qt, kt, vt, group, n, rank, causal,
                                     scale)
        out = o.to(q.dtype)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.statics = (group, n, rank, causal, scale)
        return out.transpose(1, 2)

    @staticmethod
    @autocast_off
    def backward(ctx, grad):
        qt, kt, vt, out, lse = ctx.saved_tensors
        group, n, rank, causal, scale = ctx.statics
        do = grad.transpose(1, 2).contiguous()
        dq = None
        dk = torch.zeros(kt.shape, dtype=torch.float32, device=kt.device)
        dv = torch.zeros_like(dk)
        for i in range(n):
            if i:
                kt, vt, dk, dv = (_rotate(x, group, n)
                                  for x in (kt, vt, dk, dv))
            if causal and i > rank:
                continue
            dqi, dki, dvi = _flash_bwd_bhsd(qt, kt, vt, out, lse, do,
                                            causal=causal and i == 0,
                                            scale=scale)
            dq = dqi.float() if dq is None else dq + dqi.float()
            dk = dk + dki.float()
            dv = dv + dvi.float()
        if n > 1:
            # the blocks held last came from rank + 1: one hop takes
            # every accumulated dk, dv home
            dk, dv = _rotate(dk, group, n), _rotate(dv, group, n)
        return (dq.to(qt.dtype).transpose(1, 2),
                dk.to(kt.dtype).transpose(1, 2),
                dv.to(vt.dtype).transpose(1, 2), None, None, None, None,
                None)


def _block_attn(q, k, v, mask, scale):
    """One einsum block in fp32: (numerator [B, s, H, D], row max m, row
    sum l)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    live = (m > _NEG_INF / 2)[..., None]
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, torch.where(m > _NEG_INF / 2, m, torch.full_like(m, _NEG_INF)), l


def _merge(o, m, l, o2, m2, l2):
    """Online-softmax merge of two partial blocks."""
    m_new = torch.maximum(m, m2)
    a = torch.exp(m - m_new)
    b = torch.exp(m2 - m_new)
    o_new = (o * a[..., None].transpose(1, 2)
             + o2 * b[..., None].transpose(1, 2))
    return o_new, m_new, l * a + l2 * b


def _ring_attn_local(q, k, v, *, group, n, rank, causal, scale):
    """The reference's einsum ring on this rank's chunk: the plain version
    of ``ring_attention`` (differentiable through torch autograd and the
    permute's transpose)."""
    b, sq, h, d = q.shape
    qf = q.float()
    q_pos = rank * sq + torch.arange(sq, device=q.device)
    o = torch.zeros(b, sq, h, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(b, h, sq, dtype=torch.float32, device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    for i in range(n):
        src = (rank - i) % n
        mask = None
        if causal:
            k_pos = src * k.shape[1] + torch.arange(k.shape[1],
                                                    device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        o, m, l = _merge(o, m, l, *_block_attn(qf, k.float(), v.float(),
                                               mask, scale))
        if i != n - 1:
            k, v = cf.permute(k, group, perm), cf.permute(v, group, perm)
    out = o / l.clamp_min(1e-30)[..., None].transpose(1, 2)
    return out.to(q.dtype)


def _prepare(name, q, k, v, mesh, axis):
    group, n, rank, axis = _axis(mesh, axis)
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"{name}: q, k, v must be [B, S_local, H, D] with one sequence "
            f"chunk, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    _check_chunks(name, group, axis, q.shape[1], q.device)
    return group, n, rank, axis


def ring_attention(q, k, v, mesh=None, axis: str = None, causal: bool = False,
                   scale=None):
    """Exact attention over a sequence sharded on ``axis`` (module
    docstring): q, k, v are this rank's ``[B, S_local, H, D]`` chunk (k
    and v may have fewer heads that divide q's); returns this rank's
    chunk of the output."""
    group, n, rank, _ = _prepare("ring_attention", q, k, v, mesh, axis)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])     # the flash entry points'
    return _RingFlash.apply(q, k, v, group, n, rank, bool(causal),
                            float(scale))


def ulysses_attention(q, k, v, mesh=None, axis: str = None,
                      causal: bool = False, scale=None):
    """DeepSpeed-Ulysses sequence parallelism (module docstring): an
    all-to-all to shard the heads, full-sequence flash attention, an
    all-to-all back."""
    group, n, _, axis = _prepare("ulysses_attention", q, k, v, mesh, axis)
    for what, heads in (("num_heads", q.shape[2]),
                        ("num_key_value_heads", k.shape[2])):
        if heads % n:
            raise ValueError(
                f"ulysses_attention: {what} {heads} must be divisible by "
                f"the '{axis}' axis degree {n}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])     # the flash entry points'
    qh, kh, vh = (cf.all_to_all(x, group, 2, 1) for x in (q, k, v))
    out = flash_attention_fused(qh, kh, vh, causal=bool(causal),
                                scale=float(scale))
    return cf.all_to_all(out, group, 1, 2)
