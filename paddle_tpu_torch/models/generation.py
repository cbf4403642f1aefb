"""Incremental decoding (KV-cache generation) for the Llama, GPT and
ERNIE-MoE families.

Counterpart of ``paddle_tpu/models/generation.py``: ``generate`` (greedy,
temperature / top-k / top-p sampling, ``repetition_penalty``,
``min_length``, eos with the post-eos fill, left-padded prompts, beam
search with GNMT ``length_penalty``, and a paged KV cache with
``paged=True``) and ``generate_speculative`` (draft-and-verify greedy
decoding), with the reference's names, arguments, checks and return
shape ``[B, prompt_len + max_new_tokens]``. The serving engine shares the
parameter views, the decoder stacks, the head and the sampler
(``_decode_family``, ``_decoder_stack``, ``_head_logits``,
``_sample_slot_tokens``). Each family is a dict of parameter views
(``_llama_decode_params``: rope, RMSNorm, SwiGLU, and for ERNIE-MoE a
routed expert bank as the FFN of each MoE layer, ``_moe_mlp``;
``_gpt_decode_params``: learned positions added by each token's logical
position, LayerNorm in fp32, the fused qkv, exact GELU in fp32, biases,
a tied or untied head) and one stack that the dense, paged and serving
paths all run.

What differs from the reference, and why:

- The reference jits each decode loop as one ``lax.scan``. Here the
  greedy/sampling tick of the dense and the paged path is one CUDA graph
  per call (``jit/_capture.py``): the prefill and the first tick run
  eagerly, the first tick is then captured, and every later tick is one
  replay. The tick keeps its state on the device (the carried token,
  the eos latch, the position and the tick count, the token matrix) and
  advances it itself, so a replay needs no input from the host; the
  position in the cache and rope and ``min_length``'s eos mask are read
  from the device counters. The sampler's generator is registered with
  the graph, so a captured sampled stream equals the eager one. On the
  CPU the same tick runs eagerly. Beam search and speculative decoding
  stay eager Python loops (``ROADMAP.md`` queue A). The reference's
  per-model jit cache (``_generation_jit_cache``) has no counterpart: a
  graph lives for one call.
- ``generate`` runs on the model's own device (the ids are moved there)
  under ``torch.no_grad()``. The KV caches are written in place:
  ``[B, S_max, kvh, dh]`` per layer on the dense path, the paged
  kernel's ``[kvh, blocks, block_size, dh]`` pools with ``paged=True``.
- Sampling draws Gumbel noise from a ``torch.Generator`` made from
  ``seed`` on the model's device: one draw for the first token, then one
  per tick, where the reference splits its key. Sampled streams are
  reproducible within the port, and the dense and paged paths give the
  same stream for one seed; they are not ``jax.random``'s.
- Ids are accepted as a tensor, numpy array or nested list and come back
  as an int64 tensor (the reference's are int32).
- The Llama, GPT and ERNIE-MoE families; other models raise
  ``TypeError``. ERNIE-MoE decodes on the dense cache only (greedy,
  sampled, beam search), with the reference's refusals: ragged prompts,
  ``paged=True`` and ``generate_speculative`` raise for it. Its MoE
  layers route each decode call in the gate's current mode without
  random routing, the capacity computed over the call's tokens, through
  the same index path as the training forward
  (``moe_layer._moe_idx_ffn_fwd``).

``paged=True`` runs the two branches of
``incubate/nn/functional/inference_attention``: the prefill through the
varlen flash forward (one launch per layer) and each tick through the
paged decode kernel (one launch per layer), on a CUDA model the
hand-written kernels, with no fallback. The dense path is plain PyTorch,
as the reference leaves it to XLA.

Weights are torch's ``[out, in]``, so ``h @ w`` of the reference is
``F.linear(h, w)`` here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.generator import make_generator, use_generator
from ..core.place import device_of
from ..incubate.nn.functional import _rope_tables
from ..incubate.nn.functional.inference_attention import (_packed_tokens,
                                                          _paged_decode,
                                                          _paged_prefill,
                                                          _pool_slots,
                                                          _rope_qk)
from ..jit._capture import Graphed
from ..nn.functional.norm import layer_norm
from ..ops.cuda.rms_norm import rms_norm_reference

__all__ = ["generate", "generate_speculative"]


def _llama_decode_params(model):
    """Detached views of a Llama or ERNIE-MoE model's parameter tensors
    plus its shape statics. An ERNIE-MoE layer's FFN is the dense SwiGLU
    or, on an MoE layer, ``moe`` (:func:`_moe_views`); the family is
    marked ``moe``."""
    cfg = model.config
    moe = not hasattr(model, "llama")
    inner = model.model if moe else model.llama
    layers = []
    for layer in inner.layers:
        a, m = layer.self_attn, layer.mlp
        entry = dict(
            ln1=layer.input_layernorm.weight.detach(),
            wq=a.q_proj.weight.detach(), wk=a.k_proj.weight.detach(),
            wv=a.v_proj.weight.detach(), wo=a.o_proj.weight.detach(),
            ln2=layer.post_attention_layernorm.weight.detach(),
        )
        if getattr(layer, "is_moe", False):
            entry["moe"] = _moe_views(m)
        else:
            entry.update(wg=m.gate_proj.weight.detach(),
                         wu=m.up_proj.weight.detach(),
                         wd=m.down_proj.weight.detach())
        layers.append(entry)
    return dict(
        embed=inner.embed_tokens.weight.detach(),
        norm=inner.norm.weight.detach(),
        head=model.lm_head.weight.detach(),
        layers=layers, family="llama", moe=moe,
        nh=cfg.num_attention_heads, nkv=cfg.num_key_value_heads,
        dh=cfg.hidden_size // cfg.num_attention_heads,
        eps=cfg.rms_norm_eps, theta=cfg.rope_theta,
    )


def _gpt_decode_params(model):
    """GPT-family views: learned positions, pre-LN, fused qkv, GELU, and
    the tied head (``tied_head``: logits are ``hidden @ embed.T``) or the
    untied one (``head``)."""
    cfg = model.config
    layers = []
    for layer in model.gpt.layers:
        a = layer.attn
        layers.append(dict(
            ln1_w=layer.norm1.weight.detach(),
            ln1_b=layer.norm1.bias.detach(),
            wqkv=a.qkv_proj.weight.detach(), bqkv=a.qkv_proj.bias.detach(),
            wo=a.out_proj.weight.detach(), bo=a.out_proj.bias.detach(),
            ln2_w=layer.norm2.weight.detach(),
            ln2_b=layer.norm2.bias.detach(),
            w1=layer.linear1.weight.detach(), b1=layer.linear1.bias.detach(),
            w2=layer.linear2.weight.detach(), b2=layer.linear2.bias.detach(),
        ))
    out = dict(
        embed=model.gpt.wte.weight.detach(),
        wpe=model.gpt.wpe.weight.detach(),
        normf_w=model.gpt.norm_f.weight.detach(),
        normf_b=model.gpt.norm_f.bias.detach(),
        layers=layers, family="gpt",
        nh=cfg.num_attention_heads, nkv=cfg.num_attention_heads,
        dh=cfg.hidden_size // cfg.num_attention_heads,
        eps=cfg.layer_norm_eps,
        tied_head=bool(cfg.tie_word_embeddings),
        max_positions=int(cfg.max_position_embeddings),
    )
    if not cfg.tie_word_embeddings:
        out["head"] = model.lm_head.weight.detach()
    return out


def _moe_views(mlp):
    """An MoE layer's decode views: the gate's raw ``[d, E]`` weight and
    bias, the expert bank, and the routing statics (top-k, the gate's
    capacity factor in its current mode, the activation,
    normalization)."""
    gate, ex = mlp.gate, mlp.experts
    return dict(
        gw=gate.weight.detach(), gb=gate.bias.detach(),
        w0=ex.w0.detach(), b0=ex.b0.detach(),
        w1=ex.w1.detach(), b1=ex.b1.detach(),
        topk=int(gate.topk), factor=float(gate._train_factor()),
        activation=ex.activation, normalize=bool(gate._normalize))


def _moe_mlp(h, m, dtype):
    """A routed expert FFN for the decode paths: the gate's softmax in
    fp32, top-k without random routing, the capacity over this call's
    tokens (``gate._capacity``), through the training forward's index
    path, so decode and the full-prefix forward route alike wherever no
    expert overflows. When one does, this call's tokens drop, as the
    reference's per-call capacity does."""
    from ..incubate.distributed.models.moe.gate import _capacity
    from ..incubate.distributed.models.moe.moe_layer import _moe_idx_ffn_fwd

    shape = h.shape
    x = h.reshape(-1, shape[-1])
    n, e = x.shape[0], m["gw"].shape[1]
    probs = torch.softmax((torch.matmul(x, m["gw"]) + m["gb"]).float(),
                          dim=-1)
    out = _moe_idx_ffn_fwd(
        probs, x, m["w0"], m["b0"], m["w1"], m["b1"], None, k=m["topk"],
        capacity=_capacity(n, e, m["topk"], m["factor"]),
        activation=m["activation"], normalize=m["normalize"], random2=False)
    return out.to(dtype).reshape(shape)


def _rms(h, g, eps, dtype):
    """RMSNorm in fp32, output in ``dtype`` (the plain composition, as in
    the reference's decode paths; ``h`` is in ``dtype`` or fp32, so the
    plain kernel version's one rounding to h's dtype changes nothing)."""
    return rms_norm_reference(h, g, eps=eps).to(dtype)


def _ln(h, g, bb, eps, dtype):
    """LayerNorm in fp32 (statistics and affine), output in ``dtype``."""
    return layer_norm(h, h.shape[-1], g, bb, eps).to(dtype)


def _llama_ffn(h, lp, dtype):
    """SwiGLU MLP: silu in fp32, products in ``dtype``."""
    gate = F.silu(F.linear(h, lp["wg"]).float()).to(dtype)
    return F.linear(gate * F.linear(h, lp["wu"]), lp["wd"])


def _gpt_ffn(h, lp, dtype):
    """GELU MLP with biases: exact GELU in fp32, products in ``dtype``."""
    act = F.gelu(F.linear(h, lp["w1"], lp["b1"]).float()).to(dtype)
    return F.linear(act, lp["w2"], lp["b2"])


def _decode_family(model):
    """Decode parameters for a supported causal-LM family (Llama, GPT,
    ERNIE-MoE)."""
    from .ernie_moe import ErnieMoeForCausalLM

    if hasattr(model, "llama") or isinstance(model, ErnieMoeForCausalLM):
        return _llama_decode_params(model)
    if hasattr(model, "gpt"):
        return _gpt_decode_params(model)
    raise TypeError(
        f"generate() supports the Llama, GPT and ERNIE-MoE families; got "
        f"{type(model).__name__}")


def _head_logits(p, hidden):
    """LM-head logits; a tied head reuses the embedding."""
    return F.linear(hidden, p["embed"] if p.get("tied_head") else p["head"])


def _rope_full(p, s_max, device):
    """fp32 rope tables ``[s_max, dh]`` (cos, sin), made once per decode
    call and kept in ``p``."""
    key = ("rope", s_max)
    if key not in p:
        p[key] = _rope_tables(s_max, p["dh"], p["theta"], True,
                              torch.float32, device)
    return p[key]


def _llama_stack(p, x, cos, sin, attn):
    """The Llama decoder stack over hidden states ``x`` (``[B, T, H]`` on
    the dense path, ``[N, H]`` on the paged one and in the engine): per
    layer the norm, the q/k/v projections, rope in fp32 by ``cos``/``sin``
    (broadcast against ``[..., heads, dh]``), ``attn(layer, q, k, v)``
    (the only thing the paths differ in), the residual and the FFN (an
    MoE layer's routed bank, :func:`_moe_mlp`); then the final norm. One
    stack for every path, so their math cannot drift."""
    nh, nkv, dh, eps = p["nh"], p["nkv"], p["dh"], p["eps"]
    dtype = x.dtype
    lead = x.shape[:-1]
    for li, lp in enumerate(p["layers"]):
        h = _rms(x, lp["ln1"], eps, dtype)
        q = F.linear(h, lp["wq"]).view(*lead, nh, dh)
        k = F.linear(h, lp["wk"]).view(*lead, nkv, dh)
        v = F.linear(h, lp["wv"]).view(*lead, nkv, dh)
        q, k = _rope_qk(q, k, cos, sin)
        ctx = attn(li, q, k, v)
        x = x + F.linear(ctx.reshape(*lead, nh * dh).to(dtype), lp["wo"])
        h2 = _rms(x, lp["ln2"], eps, dtype)
        x = x + (_moe_mlp(h2, lp["moe"], dtype) if "moe" in lp
                 else _llama_ffn(h2, lp, dtype))
    return _rms(x, p["norm"], eps, dtype)


def _gpt_stack(p, x, attn):
    """The GPT decoder stack over hidden states ``x`` (positions already
    added), with :func:`_llama_stack`'s contract: per layer the fp32
    LayerNorm, the fused q|k|v projection, ``attn(layer, q, k, v)``, the
    output projection and the GELU MLP with their biases; then the final
    LayerNorm."""
    nh, dh, eps = p["nh"], p["dh"], p["eps"]
    dtype = x.dtype
    lead = x.shape[:-1]
    for li, lp in enumerate(p["layers"]):
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], eps, dtype)
        q, k, v = F.linear(h, lp["wqkv"], lp["bqkv"]).view(
            *lead, 3, nh, dh).unbind(-3)
        # q contiguous: the paged kernel reads it as [rows, heads, dh];
        # k and v are written and read through their strides
        ctx = attn(li, q.contiguous(), k, v)
        x = x + F.linear(ctx.reshape(*lead, nh * dh).to(dtype), lp["wo"],
                         lp["bo"])
        x = x + _gpt_ffn(_ln(x, lp["ln2_w"], lp["ln2_b"], eps, dtype), lp,
                         dtype)
    return _ln(x, p["normf_w"], p["normf_b"], eps, dtype)


def _decoder_stack(p, tokens, pos, attn, s_max):
    """Embed ``tokens`` at the logical positions ``pos`` (an index tensor
    that broadcasts against ``tokens``; below ``s_max``) and run the
    family's stack: GPT adds its learned position rows to the embeddings,
    Llama rotates q and k by the rope rows (fp32 tables of ``s_max``
    positions, made once per ``p``)."""
    x = p["embed"][tokens]
    if p["family"] == "gpt":
        return _gpt_stack(p, x + p["wpe"][pos], attn)
    cos_full, sin_full = _rope_full(p, s_max, x.device)
    return _llama_stack(p, x, cos_full[pos][..., None, :],
                        sin_full[pos][..., None, :], attn)


def _cached_forward(p, tokens, caches, pos, s_max, pads=None,
                    return_all=False):
    """Forward ``tokens`` [B, T] through the stack at absolute positions
    ``pos..pos+T-1``, writing their k/v into the per-layer caches
    ``[(k, v)]`` of ``[B, S_max, kvh, dh]`` in place. ``pos`` is an int,
    or a one-element int64 device tensor (a captured tick's counter).
    Returns the last position's hidden [B, H], or every position's [B, T,
    H] with ``return_all`` (the speculative verify pass). Causal within
    the new tokens; full attention to everything cached before ``pos``.
    ``pads`` [B] (left-pad counts) offsets each row's positions (rope, or
    the learned position rows) and blanks its pad slots out of the
    visibility mask."""
    b, t = tokens.shape
    dev = tokens.device
    positions = pos + torch.arange(t, device=dev)       # absolute [T]
    slot = torch.arange(s_max, device=dev)
    if pads is None:
        logical = positions[None, :]                         # [1, T]
        # query i (absolute pos+i) may see cache slot j iff j <= pos+i
        visible = (slot[None, :] <= positions[:, None])[None]   # [1, T, S]
    else:
        # per-row logical positions: absolute minus this row's pad run
        logical = (positions[None, :] - pads[:, None]).clamp(min=0)
        visible = ((slot[None, None, :] <= positions[None, :, None])
                   & (slot[None, None, :] >= pads[:, None, None]))
    n_rep = p["nh"] // p["nkv"]
    out = _decoder_stack(
        p, tokens, logical,
        lambda li, q, k, v: _cached_attention(q, k, v, caches[li],
                                              positions, visible, n_rep),
        s_max)
    return out if return_all else out[:, -1, :]


def _cached_attention(q, k, v, cache, positions, visible, n_rep):
    """Writes k/v [B, T, kvh, dh] at slots ``positions`` [T] (device) of
    ``cache`` in place and returns the masked-softmax context [B, T, nh,
    dh]: fp32 logits from the ``q.dtype`` operands, ``-1e30`` where not
    ``visible`` ([1 or B, T, S_max]), the fp32 softmax cast to q's dtype
    before the product with V; q head ``h`` reads kv head ``h //
    n_rep``."""
    b, t, nh, dh = q.shape
    ck, cv = cache
    ck.index_copy_(1, positions, k)
    cv.index_copy_(1, positions, v)
    qg = q.reshape(b, t, nh // n_rep, n_rep, dh)
    # bf16 products are exact in fp32, so this is the fp32 accumulation of
    # the dtype operands
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                          ck.float()) * (dh ** -0.5)
    logits = logits.masked_fill(~visible[:, None, None], -1e30)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskd->btkgd", attn, cv).reshape(b, t, nh, dh)


def _filter_logits(logits, temperature, top_k, top_p):
    """The sampling filter of the reference's ``_sample_token``
    (``generation.py:407-420``) on logits [B, V]: fp32 logits over
    ``temperature``; top-k keeps the logits at or above the k-th largest;
    top-p keeps the smallest prefix of the sorted logits whose mass
    exceeds ``top_p`` (always the best; ``top_p=0.0`` keeps only the
    best). Dropped entries become ``-1e30``."""
    logits = logits.float() / max(temperature, 1e-6)
    v = logits.shape[-1]
    if top_k and 0 < top_k < v:
        kth = torch.sort(logits, dim=-1).values[:, v - top_k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # a cut past the last entry (every prefix short of top_p) keeps
        # everything, as the reference's out-of-range gather does
        cutoff = (cum < top_p).sum(dim=-1).clamp(max=v - 1)
        kth = sorted_l.gather(1, cutoff[:, None])
        logits = torch.where(logits < kth, -1e30, logits)
    return logits


def _gumbel_argmax(logits, generator):
    """One categorical draw per row of fp32 ``logits`` [B, V]: the
    Gumbel-max rule, ``argmax(logits - log E)`` with ``E ~ Exp(1)`` drawn
    from ``generator`` for every entry. int64 ids [B]."""
    noise = torch.empty_like(logits).exponential_(
        generator=use_generator(generator))
    return torch.argmax(logits - torch.log(noise), dim=-1)


def _sample_token(logits, generator, *, do_sample, temperature, top_k,
                  top_p):
    """logits [B, V] -> token ids [B] (int64): the argmax, or one draw
    from the filtered distribution (:func:`_filter_logits`)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    return _gumbel_argmax(_filter_logits(logits, temperature, top_k, top_p),
                          generator)


def _sample_slot_tokens(logits, temps, generator):
    """Per-row mixed greedy/sampled decode: logits [B, V] and per-slot
    temperatures [B] (0.0 = greedy for that row) -> token ids [B] int32.
    Every row draws from ``generator`` each call (:func:`_gumbel_argmax`),
    so a row's draw depends only on how many calls came before it (which
    keeps decode bursts equal to single steps)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sampled = _gumbel_argmax(scaled, generator).to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)


def _prep_decode(p, t0, max_new_tokens):
    """Shared decode-path check (one copy for the greedy, beam, paged and
    speculative paths): a learned-position table (GPT's
    ``max_positions``; Llama has none) must hold the target length."""
    max_pos = p.get("max_positions")
    if max_pos is not None and t0 + max_new_tokens > max_pos:
        raise ValueError(
            f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) = "
            f"{t0 + max_new_tokens} exceeds the learned position table "
            f"(max_position_embeddings={max_pos})")


def _check_left_padded(ids_np, pad: int):
    """Leading-pad counts [B]; reject pads anywhere but a left run. Pads
    are told from real tokens by id alone, as in the reference, so a real
    leading token equal to ``pad`` counts as a pad."""
    b, t0 = ids_np.shape
    is_pad = ids_np == pad
    pads = np.argmax(~is_pad, axis=1).astype(np.int32)
    pads = np.where(is_pad.all(axis=1), t0, pads)
    if (pads >= t0).any():
        raise ValueError("generate: a prompt row is entirely padding")
    for r in range(b):
        if is_pad[r, pads[r]:].any():
            raise ValueError(
                "generate(pad_token_id=...) expects LEFT-padded prompts; "
                f"row {r} has pad tokens after its first real token")
    return pads


def _as_ids(input_ids, device):
    """Prompt ids as an int64 tensor on ``device``, from a tensor, a numpy
    array or nested lists."""
    if isinstance(input_ids, torch.Tensor):
        return input_ids.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(input_ids), device=device).long()


def _new_caches(p, b, s_max, device):
    """Zeroed dense caches ``[(k, v)]`` of ``[b, s_max, kvh, dh]`` per
    layer, in the model's dtype."""
    shape = (b, s_max, p["nkv"], p["dh"])
    dtype = p["embed"].dtype
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in p["layers"]]


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None, seed: int = 0,
             pad_token_id: Optional[int] = None, paged: bool = False,
             block_size: int = 64, num_blocks: Optional[int] = None,
             num_beams: int = 1,
             length_penalty: float = 0.0, repetition_penalty: float = 1.0,
             min_length: int = 0):
    """Decode ``max_new_tokens`` from a Llama-, GPT- or ERNIE-MoE causal LM
    with a KV cache, on the model's device. Returns ``[B, prompt_len +
    max_new_tokens]`` int64 (prompt included); positions after an emitted
    ``eos_token_id`` are filled with eos.

    ``pad_token_id``: enables LEFT-padded mixed-length prompts (each row
    decodes at its own logical positions). ``paged=True`` decodes over a
    paged KV pool through the varlen flash forward (prefill) and the
    paged decode kernel (each tick); ``num_blocks`` caps the pool, and the
    call raises ``ValueError`` (blocks required vs available) when the
    batch cannot fit, instead of reading another row's cache (``None``
    sizes the pool to the batch). ``num_beams > 1``: beam search, ranked
    by sum logprob / len**``length_penalty`` (0.0 = no length
    normalization). ``repetition_penalty`` (CTRL: seen tokens' logits
    divided by the factor when positive, multiplied when negative; prompt
    tokens count as seen) and ``min_length`` (eos masked out for the
    first ``min_length`` new tokens) apply to the greedy/sampling paths.
    """
    ids = _as_ids(input_ids, device_of(model))
    if ids.ndim != 2:
        raise ValueError("generate expects [batch, prompt_len] input_ids")
    b, t0 = ids.shape
    if max_new_tokens <= 0:
        return ids
    pads_np = None
    if pad_token_id is not None:
        pads_np = _check_left_padded(ids.cpu().numpy(), int(pad_token_id))
        if not pads_np.any():
            pads_np = None                    # no row is actually padded
    if repetition_penalty <= 0.0:
        raise ValueError(
            f"repetition_penalty must be > 0, got {repetition_penalty}")
    if length_penalty != 0.0 and num_beams <= 1:
        raise ValueError(
            "generate: length_penalty ranks beam-search hypotheses; it "
            "has no effect with num_beams=1 — refusing to silently "
            "ignore it")
    if num_blocks is not None and not paged:
        # checked BEFORE the beam branch so num_beams>1 cannot silently
        # swallow a num_blocks the caller thought was in force
        raise ValueError(
            "generate: num_blocks sizes the paged KV pool; it has no "
            "effect without paged=True — refusing to silently ignore it")
    if num_beams > 1:
        if do_sample:
            raise ValueError(
                "generate: num_beams > 1 is deterministic beam search; "
                "it does not compose with do_sample")
        if paged or pads_np is not None:
            raise NotImplementedError(
                "generate: beam search runs on the dense same-length "
                "cache path (no paged=True / ragged prompts)")
        if repetition_penalty != 1.0 or min_length:
            raise NotImplementedError(
                "generate: repetition_penalty/min_length apply to the "
                "greedy/sampling paths, not beam search")
        return _generate_beam(model, ids, max_new_tokens=max_new_tokens,
                              num_beams=num_beams,
                              eos_token_id=eos_token_id,
                              length_penalty=length_penalty)
    if paged:
        if repetition_penalty != 1.0 or min_length:
            raise NotImplementedError(
                "generate: repetition_penalty/min_length run on the "
                "dense cache path (no paged=True)")
        return _generate_paged(model, ids, pads_np,
                               max_new_tokens=max_new_tokens,
                               do_sample=do_sample, temperature=temperature,
                               top_k=top_k, top_p=top_p,
                               eos_token_id=eos_token_id, seed=seed,
                               block_size=block_size,
                               num_blocks=num_blocks)
    if min_length > 0 and eos_token_id is None:
        # min_length works by masking eos, so with no eos it would be a
        # silent no-op
        raise ValueError(
            "generate: min_length works by masking the eos token for the "
            "first min_length new tokens; it has no effect with "
            "eos_token_id=None — refusing to silently ignore it")
    p = _decode_family(model)
    if pads_np is not None and any("moe" in lp for lp in p["layers"]):
        raise NotImplementedError(
            "generate: ragged (left-padded) prompts are not supported "
            "for MoE models — pad rows would consume expert capacity, "
            "so a padded row could not reproduce its solo decode")
    s_max = t0 + max_new_tokens
    _prep_decode(p, t0, max_new_tokens)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    rep, min_new = float(repetition_penalty), int(min_length)
    dev = ids.device
    gen = make_generator(seed, dev)
    vocab = p["embed"].shape[0]
    rows = torch.arange(b, device=dev)
    pads = None if pads_np is None else torch.as_tensor(
        pads_np, dtype=torch.long, device=dev)
    presence = None
    if rep != 1.0:
        # tokens already in the prompt count as seen (pad runs don't)
        seen = ids if pads is None else torch.where(
            torch.arange(t0, device=dev)[None, :] >= pads[:, None], ids,
            vocab)
        presence = torch.zeros(b, vocab + 1, dtype=torch.bool,
                               device=dev).scatter_(1, seen, True)[:, :vocab]

    def pick(hidden, i):
        """The CTRL penalty over seen tokens, the min-length eos mask (at
        the new-token index ``i``, a device scalar), then the token."""
        logits = _head_logits(p, hidden).float()
        if presence is not None:
            scaled = torch.where(logits > 0, logits / rep, logits * rep)
            logits = torch.where(presence, scaled, logits)
        if min_new > 0 and eos >= 0:
            logits[:, eos] = torch.where(i < min_new, -torch.inf,
                                         logits[:, eos])
        return _sample_token(logits, gen, do_sample=do_sample,
                             temperature=temperature, top_k=top_k,
                             top_p=top_p)

    caches = _new_caches(p, b, s_max, dev)
    step = torch.zeros(1, dtype=torch.long, device=dev)    # new-token index
    tok = pick(_cached_forward(p, ids, caches, 0, s_max, pads=pads), step)
    done = tok == eos
    toks = torch.empty(b, max_new_tokens, dtype=torch.long, device=dev)
    toks[:, 0] = tok

    def tick():
        """One decode tick on the device state: the carried token is the
        sequence element at absolute position ``t0 + step - 1``, its
        cache slot and its rope position (one slot later leaves the
        all-zeros slot t0 visible and shifts every rope angle)."""
        step.add_(1)
        if presence is not None:
            presence[rows, tok] = True
        hidden = _cached_forward(p, tok[:, None], caches, step + (t0 - 1),
                                 s_max, pads=pads)
        tok.copy_(torch.where(done, eos, pick(hidden, step)))
        done.logical_or_(tok == eos)
        toks.index_copy_(1, step, tok[:, None])

    _decode_ticks(tick, max_new_tokens - 1, dev, gen, "generate.dense")
    return torch.cat([ids, toks], dim=1)


def _decode_ticks(tick, n, device, generator, name):
    """Run ``tick`` ``n`` times: one tick eagerly, more as one captured
    graph (the first tick eager, then replays; eagerly on the CPU)."""
    graph = (Graphed(tick, device, name=name, generators=[generator])
             if n > 1 else tick)
    for _ in range(n):
        graph()


def _topk(x, k):
    """(values, indices) of the ``k`` largest entries of each row of fp32
    ``x``, in ``lax.top_k``'s order: IEEE total order (so -0.0 below
    +0.0), ties to the lower index. ``torch.topk`` documents no tie order,
    so this sorts the values' total-order integer keys, stably."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    indices = torch.sort(key, dim=-1, descending=True, stable=True).indices
    indices = indices[:, :k]
    return x.gather(1, indices), indices


def _generate_beam(model, ids, *, max_new_tokens, num_beams,
                   eos_token_id, length_penalty=0.0):
    """Beam search over the dense cache: the batch axis carries B*K beam
    rows, each tick forwards every beam one token, expands to K*V
    candidates, keeps the top K per batch row (:func:`_topk`) and reorders
    the KV caches in place by each survivor's parent beam. Finished beams
    (emitted eos) are frozen: their only continuation is eos at zero
    added logprob. Returns each row's best beam; ``length_penalty`` != 0
    ranks them by sum_logprob / len(generated)**length_penalty (GNMT)."""
    p = _decode_family(model)
    b, t0 = ids.shape
    K = int(num_beams)
    s_max = t0 + max_new_tokens
    vocab = p["embed"].shape[0]
    if K > vocab:
        raise ValueError(f"num_beams ({K}) > vocab size ({vocab})")
    _prep_decode(p, t0, max_new_tokens)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    dev = ids.device
    # eos-continuation row for finished beams: only eos, at +0
    frozen = torch.full((vocab,), -torch.inf, device=dev)
    if eos >= 0:
        frozen[eos] = 0.0

    # prefill on the B prompt rows, then expand to K beams
    caches = _new_caches(p, b, s_max, dev)
    hidden = _cached_forward(p, ids, caches, 0, s_max)
    scores, tok = _topk(
        torch.log_softmax(_head_logits(p, hidden).float(), dim=-1), K)
    done = tok == eos
    gen_len = torch.ones(b, K, dtype=torch.long, device=dev)  # incl. eos
    caches = [(ck.repeat_interleave(K, dim=0), cv.repeat_interleave(K, dim=0))
              for ck, cv in caches]                     # [B*K, S, kvh, dh]
    tok_buf = torch.full((b, K, max_new_tokens), eos, dtype=torch.long,
                         device=dev)
    tok_buf[:, :, 0] = tok
    base = torch.arange(b, device=dev)[:, None] * K
    for i in range(1, max_new_tokens):
        hidden = _cached_forward(p, tok.reshape(b * K, 1), caches,
                                 t0 + i - 1, s_max)
        lp = torch.log_softmax(_head_logits(p, hidden).float(),
                               dim=-1).reshape(b, K, vocab)
        lp = torch.where(done[:, :, None], frozen, lp)
        scores, idx = _topk((scores[:, :, None] + lp).reshape(b, K * vocab),
                            K)
        parent, tok = idx // vocab, idx % vocab
        order = (base + parent).reshape(-1)
        for ck, cv in caches:
            ck.copy_(ck.index_select(0, order))
            cv.copy_(cv.index_select(0, order))
        parent_done = done.gather(1, parent)
        done = parent_done | (tok == eos)
        gen_len = gen_len.gather(1, parent) + (~parent_done).long()
        tok_buf = tok_buf.gather(
            1, parent[:, :, None].expand(-1, -1, max_new_tokens))
        tok_buf[:, :, i] = tok
    if length_penalty != 0.0:
        scores = scores / gen_len.float() ** float(length_penalty)
    best = torch.argmax(scores, dim=1)                  # [B]
    return torch.cat([ids, tok_buf[torch.arange(b, device=dev), best]],
                     dim=1)


@torch.no_grad()
def generate_speculative(model, draft_model, input_ids,
                         max_new_tokens: int = 32, gamma: int = 4,
                         eos_token_id: Optional[int] = None):
    """Speculative GREEDY decoding: ``draft_model`` proposes ``gamma``
    tokens per round from its own cache, the target verifies all of them
    in ONE cached forward, and the longest matching prefix plus the
    target's own next token are accepted, so the output is EXACTLY
    ``model``'s greedy decode while each accepted draft token saves a
    target forward.

    A Python loop over rounds: cache "rollback" after a rejection is free
    because the dense caches are addressed by position (stale slots are
    overwritten before they become visible). Each round reads the
    accepted count back to the host once, to advance the loop. Batch 1,
    the latency-bound regime speculative decoding is for. Returns ``[1,
    prompt_len + max_new_tokens]`` int64.
    """
    ids = _as_ids(input_ids, device_of(model))
    if ids.ndim != 2 or ids.shape[0] != 1:
        raise ValueError(
            "generate_speculative expects [1, prompt_len] input_ids "
            "(batch 1 — the latency-bound regime)")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    t0 = ids.shape[1]
    if max_new_tokens <= 0:
        return ids
    pt, pd = _decode_family(model), _decode_family(draft_model)
    if pt.get("moe") or pd.get("moe"):
        raise NotImplementedError(
            "generate_speculative supports dense families only: a MoE "
            "model's expert capacity is computed per call, so the "
            "multi-token verify window could drop tokens that the "
            "one-token-per-step greedy decode keeps, breaking the "
            "exact-equality guarantee")
    if pt["embed"].shape[0] != pd["embed"].shape[0]:
        raise ValueError(
            f"target and draft vocabularies differ "
            f"({pt['embed'].shape[0]} vs {pd['embed'].shape[0]})")
    # buffer leaves room for one full overshoot round past max_new
    cap = max_new_tokens + gamma + 1
    s_max = t0 + cap
    eos = -1 if eos_token_id is None else int(eos_token_id)
    _prep_decode(pt, t0, cap)
    _prep_decode(pd, t0, cap)
    dev = ids.device

    def greedy(p, hidden):
        return torch.argmax(_head_logits(p, hidden), dim=-1)

    # prefill BOTH models; the target's argmax is the first pending token
    ct, cd = _new_caches(pt, 1, s_max, dev), _new_caches(pd, 1, s_max, dev)
    pending = greedy(pt, _cached_forward(pt, ids, ct, 0, s_max))    # [1]
    _cached_forward(pd, ids, cd, 0, s_max)
    out = torch.full((1, cap), eos if eos >= 0 else 0, dtype=torch.long,
                     device=dev)
    n_gen = 0
    while n_gen < max_new_tokens:
        P = t0 + n_gen                        # the pending token's position
        drafts, tok = [], pending
        for i in range(gamma):
            tok = greedy(pd, _cached_forward(pd, tok[:, None], cd, P + i,
                                             s_max))
            drafts.append(tok)
        # forward d_gamma too (logits discarded): a fully accepted round
        # advances past slot P+gamma, which would otherwise stay an
        # unwritten-but-visible hole in the draft's cache
        _cached_forward(pd, tok[:, None], cd, P + gamma, s_max)
        # verify: ONE target forward over pending + drafts
        window = torch.cat([pending] + drafts)[None, :]     # [1, gamma+1]
        t_preds = greedy(pt, _cached_forward(pt, window, ct, P, s_max,
                                             return_all=True)[0])
        matches = (t_preds[:gamma] == window[0, 1:]).long()
        a = int(torch.cumprod(matches, dim=0).sum())   # the round's host read
        # this round emits [pending, d_1..d_a], all the target's own greedy
        # choices; slots past a+1 hold rejected drafts the next round
        # overwrites, and the target's token at a is the next pending
        out[0, n_gen:n_gen + gamma + 1] = window[0]
        n_gen += a + 1
        pending = t_preds[a:a + 1]
    out = out[:, :max_new_tokens]
    if eos >= 0:
        # greedy-equivalent eos semantics: everything after the first eos
        # is eos
        hit = (out == eos).long()
        out = torch.where(torch.cumsum(hit, dim=1) - hit > 0, eos, out)
    return torch.cat([ids, out], dim=1)


def _paged_block_tables(b, s_max, block_size, num_blocks=None):
    """Disjoint row-major block allocation for a ``generate`` batch: row
    ``r`` owns blocks ``[r*blocks_per_seq, (r+1)*blocks_per_seq)``.
    Raises ``ValueError`` when a caller-capped pool (``num_blocks``)
    cannot hold the batch's KV working set, instead of reading another
    row's cache through an out-of-range block id. Returns (tables int32
    [b, blocks_per_seq], pool blocks)."""
    blocks_per_seq = -(-s_max // block_size)
    needed = b * blocks_per_seq
    if num_blocks is not None and int(num_blocks) < needed:
        raise ValueError(
            f"generate(paged=True): KV block pool exhausted before "
            f"decode could start — the batch needs {needed} blocks "
            f"({b} rows x {blocks_per_seq} blocks of {block_size} "
            f"tokens for prompt+max_new_tokens={s_max}) but "
            f"num_blocks={int(num_blocks)}. Grow the pool, shrink the "
            f"batch/max_new_tokens, or serve the requests through "
            f"paddle_tpu_torch.serve.ServeEngine, which queues and "
            f"preempts instead of failing")
    total = needed if num_blocks is None else int(num_blocks)
    tables = (np.arange(needed, dtype=np.int32)
              .reshape(b, blocks_per_seq))
    return tables, total


def _generate_paged(model, ids, pads_np, *, max_new_tokens, do_sample,
                    temperature, top_k, top_p, eos_token_id, seed,
                    block_size, num_blocks=None):
    """Paged-KV-cache decode (Llama and GPT): the prefill packs each row's
    REAL tokens (left pads dropped) one row after another and runs the prefill
    branch of ``block_multihead_attention`` per layer (k/v into the pool,
    causal attention within each row through the varlen flash forward);
    each tick appends one token per row through the decode branch (the
    paged decode kernel over the block tables). Pads never enter the
    pool. The prefill attends over the packed prompt tokens themselves,
    so it needs no block-table view. On a CUDA model: one varlen launch
    per layer for the prefill, one paged launch per layer per tick.
    Positions are logical: slot j of a packed row is position j, and a
    tick's token sits at its row's length less one (Llama rotates by it,
    GPT adds that row of its learned table)."""
    if not hasattr(model, "llama") and not hasattr(model, "gpt"):
        raise NotImplementedError(
            "paged=True decode supports the Llama and GPT families; "
            "MoE models use the dense cache path")
    p = _decode_family(model)
    b, t0 = ids.shape
    nkv, dh = p["nkv"], p["dh"]
    eos = -1 if eos_token_id is None else int(eos_token_id)
    s_max = t0 + max_new_tokens
    _prep_decode(p, t0, max_new_tokens)
    tables_np, nb = _paged_block_tables(b, s_max, block_size, num_blocks)
    dev = ids.device
    gen = make_generator(seed, dev)
    tables = torch.as_tensor(tables_np, device=dev)
    caches = [tuple(torch.zeros(nkv, nb, block_size, dh,
                                dtype=p["embed"].dtype, device=dev)
                    for _ in range(2)) for _ in p["layers"]]

    def forward(tokens, pos, attend):
        """The stack on one token per entry of ``tokens`` [N] at logical
        positions ``pos`` [N]."""
        return _decoder_stack(p, tokens, pos, attend, s_max)

    def pick(hidden):
        return _sample_token(_head_logits(p, hidden).float(), gen,
                             do_sample=do_sample, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    # prefill: row r's real tokens are ids[r, pads[r]:] at positions 0..
    pads = np.zeros(b, np.int64) if pads_np is None else pads_np.astype(
        np.int64)
    enc = t0 - pads
    src, _, pos_t, slot, cu = _packed_tokens(
        np.arange(b), enc, np.zeros(b, np.int64), np.arange(b) * t0 + pads,
        tables, block_size, dev)
    hidden = forward(ids.reshape(-1)[src], pos_t,
                     lambda li, q, k, v: _paged_prefill(q, k, v, *caches[li],
                                                        slot, cu))
    last_t = cu[1:].long() - 1
    tok = pick(hidden[last_t])
    done = tok == eos
    toks = torch.empty(b, max_new_tokens, dtype=torch.long, device=dev)
    toks[:, 0] = tok
    rows = torch.arange(b, device=dev)
    # the carried token is each row's element at logical position enc +
    # step - 1: its append slot and its rope angle
    pos_t = torch.as_tensor(enc, device=dev) - 1
    step = torch.zeros(1, dtype=torch.long, device=dev)

    def tick():
        step.add_(1)
        pos_t.add_(1)
        slot = _pool_slots(tables, rows, pos_t, block_size)
        lengths = (pos_t + 1).to(torch.int32)
        hidden = forward(tok, pos_t,
                         lambda li, q, k, v: _paged_decode(
                             q, k, v, *caches[li], slot, lengths, tables))
        tok.copy_(torch.where(done, eos, pick(hidden)))
        done.logical_or_(tok == eos)
        toks.index_copy_(1, step, tok[:, None])

    _decode_ticks(tick, max_new_tokens - 1, dev, gen, "generate.paged")
    return torch.cat([ids, toks], dim=1)
