"""Inference-serving fused attention ops.

Counterpart of ``paddle_tpu/incubate/nn/functional/inference_attention.py``
(reference surface: paddle's incubate/nn/functional/
masked_multihead_attention.py:19, block_multihead_attention.py:19,
blha_get_max_len.py:26, variable_length_memory_efficient_attention.py and
fused_dot_product_attention.py).

``block_multihead_attention`` (paged KV cache, prefill and decode in one
call) is one jnp gather program with two branches in the reference. Each
branch computes what a kernel of the port computes, so here each branch
is that kernel:

- prefill rows (``seq_lens_encoder > 0``): q/k rotated at positions
  ``0..enc-1``, k/v written into the pool, then causal attention within
  each row's tokens through the varlen flash forward
  (``ops/cuda/flash_attention_varlen.flash_attn_varlen_thd``, cu_seqlens
  from ``enc``) — :func:`_paged_prefill`;
- decode rows (``enc == 0, seq_lens_decoder > 0``): the one token
  rotated at and written to position ``dec``, then one query per row over
  its cached window through the paged decode kernel
  (``ops/cuda/paged_attention.paged_attention_decode``, lengths
  ``dec + 1``) — :func:`_paged_decode`.

A mixed batch takes both, each on its rows; rows with neither write
nothing and return zeros. CPU tensors take the kernels' plain versions,
CUDA tensors the kernels, with no fallback between them.

Layouts: the public wrapper keeps the reference's cache layout
``[num_blocks, kv_H, block_size, D]`` and returns new caches, leaving its
arguments as they were. The core (:func:`_bmha_fwd` and the two branches)
works on the paged kernel's layout ``[kv_H, num_blocks, block_size, D]``
and writes the pool in place. ``_bmha_fwd`` reads the per-row lengths to
the host once a call to split the rows between the branches (the
reference selects with ``lax.cond`` on the device);
``models/generation.py``'s paged decode knows its phase and calls the
branches itself, so its decode ticks read nothing back.

RoPE rotates q and k in fp32 and casts back (the reference rotates in
qkv's dtype; the two agree in fp32). ``masked_multihead_attention``,
``variable_length_memory_efficient_attention`` and
``fused_dot_product_attention`` are plain PyTorch, as the reference's are
jnp. Quantized-cache arguments raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....ops.cuda.flash_attention_varlen import flash_attn_varlen_thd
from ....ops.cuda.paged_attention import paged_attention_decode
from ._rope_common import rotate_half

__all__ = [
    "masked_multihead_attention", "blha_get_max_len",
    "block_multihead_attention", "variable_length_memory_efficient_attention",
    "fused_dot_product_attention",
]

_NEG_INF = -1e9


def _mmha_fwd(x, cache_kv, src_mask, seq_lens, *, num_heads, use_mask,
              use_seq_lens):
    # x: [B, 3*H*D] single decode step; cache_kv: [2, B, H, S_max, D]
    b = x.shape[0]
    h = num_heads
    s_max, d = cache_kv.shape[3], cache_kv.shape[4]
    qkv = x.reshape(b, 3, h, d)
    q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # [B, H, D]
    if use_seq_lens:
        pos = seq_lens.reshape(b).long()             # write position per row
    else:
        # reference decode convention: src_mask is [B, 1, 1, t+1] at step t
        pos = torch.full((b,), src_mask.shape[-1] - 1, dtype=torch.long,
                         device=x.device)
    bi = torch.arange(b, device=x.device)
    k_cache, v_cache = cache_kv[0].clone(), cache_kv[1].clone()
    k_cache[bi, :, pos, :] = k_new.to(k_cache.dtype)
    v_cache[bi, :, pos, :] = v_new.to(v_cache.dtype)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(),
                          k_cache.float()) * (1.0 / math.sqrt(d))
    valid = (torch.arange(s_max, device=x.device)[None, :]
             <= pos[:, None])                        # [B, S]
    scores = torch.where(valid[:, None, :], scores, _NEG_INF)
    if use_mask:
        m = src_mask.reshape(b, 1, -1).float()
        if m.shape[-1] < s_max:
            # decode masks are [B,1,1,t+1]; positions beyond t are already
            # dropped by `valid`, pad neutrally
            m = torch.nn.functional.pad(m, (0, s_max - m.shape[-1]))
        scores = scores + m[:, :, :s_max]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", probs, v_cache.float())
    return (out.to(x.dtype).reshape(b, h * d),
            torch.stack([k_cache, v_cache], dim=0))


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """Single-token decode attention over a dense KV cache.

    x ``[B, 3*H*D]``, cache_kv ``[2, B, H, S_max, D]``, sequence_lengths
    ``[B, 1]`` gives each sequence's current length (the write position).
    Returns (out ``[B, H*D]``, the updated cache) like the reference's
    inplace variant; ``cache_kv`` itself is left as it was.
    """
    if qkv_out_scale is not None or out_scale != -1:
        raise NotImplementedError(
            "quantized masked_multihead_attention is not part of the port")
    if beam_cache_offset is not None or cum_offsets is not None:
        raise NotImplementedError(
            "beam-search cache reordering (beam_cache_offset/cum_offsets) is "
            "not implemented in the port")
    num_heads, head_dim = cache_kv.shape[2], cache_kv.shape[4]
    if bias is not None:
        x = x + bias.reshape(3 * num_heads * head_dim)
    use_mask = src_mask is not None
    use_seq = sequence_lengths is not None
    if not use_mask and not use_seq:
        # without a step signal every decode step would silently overwrite
        # cache slot 0 (and use RoPE position 0)
        raise ValueError(
            "masked_multihead_attention needs a decode-step signal: pass "
            "src_mask ([B,1,1,t+1] at step t) or sequence_lengths ([B,1])")
    if rotary_emb_dims > 0 and rotary_tensor is not None:
        # when only src_mask is given, its trailing dim carries the step
        mask_pos = (src_mask.shape[-1] - 1) if not use_seq else 0
        x = _apply_decode_rope(x, rotary_tensor, sequence_lengths, num_heads,
                               head_dim, use_neox_rotary_style,
                               fallback_pos=mask_pos)
    return _mmha_fwd(x, cache_kv, src_mask, sequence_lengths,
                     num_heads=int(num_heads), use_mask=use_mask,
                     use_seq_lens=use_seq)


def _apply_decode_rope(x, rotary_tensor, sequence_lengths, h, d, neox,
                       fallback_pos=0):
    """RoPE on the q/k slices of a packed decode qkv row, from the
    reference table layout ``[2, B, S, 1, D]`` (cos at [0], sin at [1])
    at each row's position (``fallback_pos`` without
    ``sequence_lengths``). Products in the promoted dtype, as the
    reference's."""
    b = x.shape[0]
    qkv = x.reshape(b, 3, h, d)
    pos = (sequence_lengths.reshape(b).long() if sequence_lengths is not None
           else torch.full((b,), fallback_pos, dtype=torch.long,
                           device=x.device))
    bi = torch.arange(b, device=x.device)
    cos = rotary_tensor[0].reshape(b, -1, d)[bi, pos][:, None, :]
    sin = rotary_tensor[1].reshape(b, -1, d)[bi, pos][:, None, :]
    q = qkv[:, 0] * cos + rotate_half(qkv[:, 0], neox) * sin
    k = qkv[:, 1] * cos + rotate_half(qkv[:, 1], neox) * sin
    v = qkv[:, 2].to(q.dtype)
    return torch.stack([q, k, v], dim=1).reshape(b, 3 * h * d)


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size):
    """Max encoder/decoder lengths for block attention scheduling, as 0-d
    tensors (reference: blha_get_max_len.py:26)."""
    return (torch.as_tensor(seq_lens_encoder).max(),
            torch.as_tensor(seq_lens_decoder).max())


# ---------------------------------------------------------------------------
# paged attention core: pools [KVH, num_blocks, block_size, D], in place
# ---------------------------------------------------------------------------
def _rope_qk(q, k, cos, sin, neox=True):
    """q ``[N, H, D]`` and k ``[N, KVH, D]`` rotated by per-token fp32
    tables ``cos``/``sin`` (broadcast to ``[N, 1, D]``), in fp32, cast
    back."""
    q32, k32 = q.float(), k.float()
    return ((q32 * cos + rotate_half(q32, neox) * sin).to(q.dtype),
            (k32 * cos + rotate_half(k32, neox) * sin).to(k.dtype))


def _pool_slots(tables, rows, pos, block_size):
    """Flat pool slot ids ``[N]`` of tokens at logical positions ``pos``
    of block-table rows ``rows``."""
    return (tables[rows, pos // block_size].long() * block_size
            + pos % block_size)


def _packed_tokens(rows, counts, first_pos, starts, tables, block_size,
                   dev):
    """Index tensors of ``counts[i]`` tokens of each table row
    ``rows[i]``, packed one row after another (host arrays in, device
    tensors out): (ids into a flat source in which row ``i``'s tokens
    start at ``starts[i]``, table rows, logical positions from
    ``first_pos[i]``, flat pool slots, int32 ``cu_seqlens``
    ``[len(rows) + 1]``)."""
    tok = np.concatenate([s + np.arange(c) for s, c in zip(starts, counts)])
    pos = np.concatenate([p + np.arange(c)
                          for p, c in zip(first_pos, counts)])
    tok, row, pos = (torch.as_tensor(a, device=dev)
                     for a in (tok, np.repeat(rows, counts), pos))
    cu = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                         dtype=torch.int32, device=dev)
    return tok, row, pos, _pool_slots(tables, row, pos, block_size), cu


def _write_kv(kc, vc, k, v, slot):
    """k, v ``[N, KVH, D]`` into the pools at flat slot ids, in place."""
    kvh, nb, bs, d = kc.shape
    kc.view(kvh, nb * bs, d)[:, slot] = k.transpose(0, 1).to(kc.dtype)
    vc.view(kvh, nb * bs, d)[:, slot] = v.transpose(0, 1).to(vc.dtype)


def _paged_prefill(q, k, v, kc, vc, slot, cu_seqlens):
    """The prefill branch: rows packed one after another (row ``s`` owns
    tokens ``cu_seqlens[s]:cu_seqlens[s+1]``, at positions from 0), q/k
    already rotated. Writes k/v into the pools at ``slot`` and returns
    each row's causal attention over its own tokens, ``[N, H, D]``,
    through the varlen flash forward (the pools hold the same k/v, so
    nothing is read back)."""
    _write_kv(kc, vc, k, v, slot)
    out, _ = flash_attn_varlen_thd(q, k, v, cu_seqlens, cu_seqlens,
                                   causal=True)
    return out


def _paged_decode(q, k, v, kc, vc, slot, lengths, tables):
    """The decode branch: one token per row (q ``[B, H, D]``, already
    rotated). Writes its k/v at ``slot`` and attends over each row's
    first ``lengths`` cached tokens (the new one included) through the
    paged decode kernel; ``[B, H, D]``."""
    _write_kv(kc, vc, k, v, slot)
    return paged_attention_decode(q, kc, vc, lengths, tables)


def _bmha_fwd(qkv, key_cache, value_cache, seq_lens_encoder,
              seq_lens_decoder, cu_seqlens_q, block_tables, rope_emb, *,
              num_heads, kv_num_heads, block_size, max_seq_len, use_neox,
              use_rope):
    """Paged-KV attention, prefill and decode in one call.

    qkv ``[T, (H + 2*kv_H) * D]`` packed varlen (row ``b`` from
    ``cu_seqlens_q[b]``); pools ``[kv_H, num_blocks, block_size, D]``,
    written in place; ``block_tables [B, blocks/seq]``; ``rope_emb``
    ``[2, B, S, 1, D]`` (cos, sin) when ``use_rope``. Returns (out
    ``[T, H*D]``, qkv, key_cache, value_cache)."""
    t = qkv.shape[0]
    d = key_cache.shape[-1]
    h, kvh = num_heads, kv_num_heads
    b = block_tables.shape[0]
    dev = qkv.device
    q_all = qkv[:, :h * d].reshape(t, h, d)
    k_all = qkv[:, h * d:(h + kvh) * d].reshape(t, kvh, d)
    v_all = qkv[:, (h + kvh) * d:].reshape(t, kvh, d)
    # the one host read of the call: which rows take which branch
    enc = seq_lens_encoder.reshape(b).cpu().numpy().astype(np.int64)
    dec = seq_lens_decoder.reshape(b).cpu().numpy().astype(np.int64)
    starts = cu_seqlens_q.reshape(-1)[:b].cpu().numpy().astype(np.int64)

    def take(tok, row, pos):
        q, k, v = q_all[tok], k_all[tok], v_all[tok]
        if use_rope:
            cos = rope_emb[0].reshape(b, -1, rope_emb.shape[-1])[row, pos]
            sin = rope_emb[1].reshape(b, -1, rope_emb.shape[-1])[row, pos]
            q, k = _rope_qk(q, k, cos.float()[:, None], sin.float()[:, None],
                            use_neox)
        return q, k, v

    out = torch.zeros(t, h, d, dtype=qkv.dtype, device=dev)
    pre = np.flatnonzero(enc > 0)
    if pre.size:
        tok, row, pos, slot, cu = _packed_tokens(
            pre, enc[pre], np.zeros_like(pre), starts[pre], block_tables,
            block_size, dev)
        out[tok] = _paged_prefill(*take(tok, row, pos), key_cache,
                                  value_cache, slot, cu)
    rows = np.flatnonzero((enc == 0) & (dec > 0))
    if rows.size:
        tok, row, pos, slot, _ = _packed_tokens(
            rows, np.ones_like(rows), dec[rows], starts[rows], block_tables,
            block_size, dev)
        out[tok] = _paged_decode(*take(tok, row, pos), key_cache,
                                 value_cache, slot, (pos + 1).to(torch.int32),
                                 block_tables[row])
    return out.reshape(t, h * d), qkv, key_cache, value_cache


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets, cum_offsets, cu_seqlens_q,
                              cu_seqlens_k, block_tables, pre_key_cache=None,
                              pre_value_cache=None, cache_k_quant_scales=None,
                              cache_v_quant_scales=None,
                              cache_k_dequant_scales=None,
                              cache_v_dequant_scales=None, qkv_out_scale=None,
                              qkv_bias=None, out_shift=None, out_smooth=None,
                              max_enc_len_this_time=None,
                              max_dec_len_this_time=None, rope_emb=None,
                              mask=None, tgt_mask=None, max_seq_len=-1,
                              block_size=64, use_neox_style=False,
                              use_dynamic_cachekv_quant=False,
                              quant_round_type=1, quant_max_bound=127.0,
                              quant_min_bound=-127.0, out_scale=-1.0,
                              compute_dtype="default"):
    """Paged-KV-cache attention (prefill and decode in one call).

    Packed varlen qkv ``[T, (H+2*kv_H)*D]``, block caches ``[num_blocks,
    kv_H, block_size, D]``, per-sequence ``block_tables``. Returns (out,
    qkv, key_cache, value_cache); the caches passed in are left as they
    were.
    """
    if cache_k_quant_scales is not None or use_dynamic_cachekv_quant:
        raise NotImplementedError(
            "int8/quantized KV cache is not part of the port")
    kvh, d = key_cache.shape[1], key_cache.shape[3]
    h = qkv.shape[-1] // d - 2 * kvh
    if qkv_bias is not None:
        qkv = qkv + qkv_bias
    # the kernel layout, in new tensors (clone: a transpose over a size-1
    # axis is already contiguous and .contiguous() would alias the input)
    kc = key_cache.transpose(0, 1).clone(memory_format=torch.contiguous_format)
    vc = value_cache.transpose(0, 1).clone(
        memory_format=torch.contiguous_format)
    out, qkv_out, kc, vc = _bmha_fwd(
        qkv, kc, vc, seq_lens_encoder, seq_lens_decoder, cu_seqlens_q,
        block_tables, rope_emb, num_heads=int(h), kv_num_heads=int(kvh),
        block_size=int(block_size), max_seq_len=int(max_seq_len),
        use_neox=bool(use_neox_style), use_rope=rope_emb is not None)
    return (out, qkv_out, kc.transpose(0, 1).contiguous(),
            vc.transpose(0, 1).contiguous())


def _vl_attn_fwd(q, k, v, kv_lens, mask, *, scale):
    # q: [B, H, Sq, D]; k/v: [B, kvH, Sk, D]; kv_lens: [B]
    b, h = q.shape[:2]
    kvh, sk = k.shape[1], k.shape[2]
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=1)
        v = torch.repeat_interleave(v, h // kvh, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = (torch.arange(sk, device=q.device)[None, :]
             < kv_lens.reshape(b, 1).to(q.device))
    scores = torch.where(valid[:, None, None, :], scores, _NEG_INF)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0):
    """Attention over ``[B, H, S, D]`` tensors with per-sequence KV lengths
    (reference: variable_length_memory_efficient_attention.py)."""
    scale = (float(scale) if scale is not None
             else 1.0 / float(np.sqrt(query.shape[-1])))
    mask_v = mask.float() if mask is not None else None
    if causal:
        # causal composes with an explicit padding mask (additive)
        sq, sk = query.shape[2], key.shape[2]
        rows = torch.arange(sq, device=query.device)[:, None]
        cols = torch.arange(sk, device=query.device)[None, :]
        tri = torch.where(rows >= cols - (sk - sq), 0.0, _NEG_INF)[None, None]
        mask_v = tri if mask_v is None else mask_v + tri
    return _vl_attn_fwd(query, key, value, kv_seq_lens, mask_v, scale=scale)


def fused_dot_product_attention(q, k, v, bias=None, cu_seqlen_q=None,
                                cu_seqlen_kv=None, scaling_factor=None,
                                dropout_prob=0.0, training=True,
                                is_causal_masking=False, mask_type=None,
                                bias_type=None, name=None, generator=None):
    """cuDNN-fused SDPA analog (``[B, S, H, D]`` layout; bias is an
    additive ``[B, H, Sq, Sk]`` mask) through the port's
    ``scaled_dot_product_attention``; ``generator`` feeds its dropout."""
    from ....nn.functional.attention import scaled_dot_product_attention

    if scaling_factor is not None:
        # sdpa applies 1/sqrt(d) itself; fold the custom scale into q
        default = 1.0 / float(np.sqrt(q.shape[-1]))
        q = q * (float(scaling_factor) / default)
    return scaled_dot_product_attention(
        q, k, v, attn_mask=bias, dropout_p=dropout_prob,
        is_causal=is_causal_masking, training=training, generator=generator)
