"""GPT model family (GPT-2 style decoder) — forward, training loss and
``generate``.

Counterpart of ``paddle_tpu/models/gpt.py``: the pre-LN causal decoder
with learned positions, a fused ``qkv_proj`` and exact GELU, with the
reference's parameter names (``gpt.layers.0.attn.qkv_proj.weight`` and
friends). Modules are ``torch.nn``: Linear weights are torch's ``[out,
in]`` where the reference keeps paddle's ``[in, out]``
(``convert.load_paddle_tpu_state`` transposes).

Attention goes through ``nn.functional.scaled_dot_product_attention``
with ``is_causal=True`` and the attention dropout, so at a kernel head
dim (64 for GPT-2's heads) it runs the flash kernels, the dropout inside
them. LayerNorm computes as the reference does (fp32 statistics and
affine, one rounding). Every dropout draw (the flash kernels' seed, the
embedding and hidden masks) comes from the model's one explicit
generator, ``dropout_generator``, through ``use_generator``, so
``recompute`` replays the same draws. With ``tie_word_embeddings`` the
head is ``hidden @ wte.weight.T`` and there is no ``lm_head``.

The reference has no ``dtype`` field: bf16 comes from
``model.to(torch.bfloat16)`` or ``amp``. ``gpt_shard_plan`` is the
reference's Megatron plan (see there for the fused ``qkv_proj``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.generator import make_generator
from ..core.place import resolve_device
from ..distributed.auto_parallel.api import DistParameter
from ..distributed.communication.functional import reduce_bwd
from ..distributed.communication.group import axis_group
from ..distributed.fleet.mp_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding,
                                           check_divides, global_numel,
                                           lm_cross_entropy, mp_shard_)
from ..distributed.fleet.utils import recompute
from ..nn import functional as F
from ..nn.functional.common import Embedding

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "GPTDecoderLayer",
           "GPTAttention", "gpt_shard_plan"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    # GPT-2's attn_pdrop; runs inside the flash kernels at their head dims
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    recompute: bool = False

    @staticmethod
    def gpt2() -> "GPTConfig":
        return GPTConfig()

    @staticmethod
    def gpt2_medium() -> "GPTConfig":
        return GPTConfig(hidden_size=1024, num_hidden_layers=24,
                         num_attention_heads=16, intermediate_size=4096)

    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=64)
        base.update(kw)
        return GPTConfig(**base)


class _LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing as the reference: fp32 statistics and
    affine, one rounding to the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.eps)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, generator, **factory):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        self.qkv_proj = nn.Linear(h, 3 * h, **factory)
        self.out_proj = nn.Linear(h, h, **factory)
        self.generator = generator

    def forward(self, x):
        b, s, h = x.shape
        # -1: a tensor-parallel rank holds its share of the heads
        qkv = self.qkv_proj(x).reshape(b, s, 3, -1, self.head_dim)
        q, k, v = qkv.unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.config.attention_probs_dropout_prob,
            is_causal=True, training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, -1))


class GPTDecoderLayer(nn.Module):
    """Pre-LN block: x + attn(ln(x)); x + dropout(mlp(ln(x)))."""

    def __init__(self, config: GPTConfig, generator, **factory):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.norm1 = _LayerNorm(h, eps=eps, **factory)
        self.attn = GPTAttention(config, generator, **factory)
        self.norm2 = _LayerNorm(h, eps=eps, **factory)
        self.linear1 = nn.Linear(h, config.intermediate_size, **factory)
        self.linear2 = nn.Linear(config.intermediate_size, h, **factory)
        self.dropout_p = config.hidden_dropout_prob
        self.generator = generator

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        y = self.linear2(F.gelu(self.linear1(self.norm2(x))))
        return x + F.dropout(y, self.dropout_p, training=self.training,
                             generator=self.generator)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, generator, **factory):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.wte = Embedding(config.vocab_size, h, **factory)
        self.wpe = Embedding(config.max_position_embeddings, h, **factory)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, generator, **factory)
             for _ in range(config.num_hidden_layers)])
        self.norm_f = _LayerNorm(h, eps=config.layer_norm_eps, **factory)
        self.generator = generator

    def forward(self, input_ids, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        x = F.dropout(self.wte(input_ids) + self.wpe(position_ids),
                      self.config.hidden_dropout_prob,
                      training=self.training, generator=self.generator)
        for layer in self.layers:
            x = recompute(layer, x) if self.config.recompute else layer(x)
        return self.norm_f(x)

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())


class GPTForCausalLM(nn.Module):
    """GPT causal LM. ``device=None`` builds on the card (and raises
    without one); pass ``device="cpu"`` for the CPU. Parameters are fp32,
    made from ``seed`` with an explicit generator: normal(0, 0.02) for
    the projections and embeddings, zeros for biases, ones and zeros for
    the LayerNorms. ``dropout_generator`` (seeded with ``seed``, on the
    model's device) feeds every dropout draw."""

    def __init__(self, config: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=torch.float32)
        self.config = config
        self.dropout_generator = make_generator(seed, dev)
        self.gpt = GPTModel(config, self.dropout_generator, **factory)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False, **factory)
        self._init_weights(seed, dev)

    @torch.no_grad()
    def _init_weights(self, seed: int, device):
        gen = make_generator(seed, device)
        for name, p in self.named_parameters():
            if ".norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)

    def forward(self, input_ids, position_ids=None, labels=None):
        """Logits [B, S, V]; with ``labels`` (``-100`` ignored) ``(loss,
        logits)``, the mean token cross-entropy."""
        hidden = self.gpt(input_ids, position_ids)
        if self.config.tie_word_embeddings:
            group = getattr(self.gpt.wte, "mp_group", None)
            logits = torch.nn.functional.linear(reduce_bwd(hidden, group),
                                                self.gpt.wte.weight)
        else:
            group = getattr(self.lm_head, "mp_group", None)
            logits = self.lm_head(hidden)
        if labels is not None:
            return lm_cross_entropy(logits, labels, group), logits
        return logits

    def num_parameters(self) -> int:
        return sum(global_numel(p) for p in self.parameters())

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id=None, seed: int = 0, pad_token_id=None,
                 paged: bool = False, block_size: int = 64,
                 num_blocks=None,
                 num_beams: int = 1, length_penalty: float = 0.0,
                 repetition_penalty: float = 1.0, min_length: int = 0):
        """KV-cache incremental decoding on the model's device, the same
        decode loop as the Llama family's (``models/generation.py``): learned
        positions by each token's logical position, so left-padded and
        packed rows decode as they would alone. Returns [B, prompt +
        max_new_tokens] int64, the prompt included."""
        from .generation import generate as _generate

        return _generate(self, input_ids, max_new_tokens=max_new_tokens,
                         do_sample=do_sample, temperature=temperature,
                         top_k=top_k, top_p=top_p,
                         eos_token_id=eos_token_id, seed=seed,
                         pad_token_id=pad_token_id, paged=paged,
                         block_size=block_size, num_blocks=num_blocks,
                         num_beams=num_beams,
                         length_penalty=length_penalty,
                         repetition_penalty=repetition_penalty,
                         min_length=min_length)


def gpt_shard_plan(model: GPTForCausalLM, mesh, dp_axis="dp", mp_axis="mp"):
    """Megatron tensor parallelism over ``mesh``'s ``mp_axis``, the
    reference's plan (``paddle_tpu/models/gpt.py`` ``gpt_shard_plan``) in
    torch's ``[out, in]`` layout: ``qkv_proj`` and ``linear1`` column
    parallel (weight and bias ``Shard(0)``), ``out_proj`` and ``linear2``
    row parallel (weight ``Shard(1)``, bias replicated), ``wte`` vocab
    parallel (and with it the tied head, whose logits stay sharded into a
    vocab-parallel cross-entropy; an untied ``lm_head`` is column
    parallel), the rest replicated. Sharded in place, computed on local
    tensors, as ``llama_shard_plan``.

    The fused ``qkv_proj`` ``[3h, h]`` is laid out as ``_StridedShard(0,
    split_factor=3)``: the rows are viewed as the three blocks q, k, v and
    each block is sharded, so a rank holds the rows of its heads of q,
    then of k, then of v (a contiguous ``Shard(0)`` would give rank 0 all
    of q and half of k). ``full_tensor()`` is the whole ``[3h, h]``
    weight, the reference's transposed. With dropout above 0, a rank
    draws the attention dropout of its heads from the model's generator,
    so at mp above 1 the draws differ from the unsharded model's.
    """
    cfg = model.config
    check_divides("gpt_shard_plan", {
        "vocab_size": cfg.vocab_size,
        "num_attention_heads": cfg.num_attention_heads,
        "intermediate_size": cfg.intermediate_size},
        mesh.get_dim_size(mp_axis))
    group = axis_group(mesh, mp_axis)
    gpt = model.gpt
    gpt.wte = VocabParallelEmbedding.from_embedding(gpt.wte, group)
    for layer in gpt.layers:
        attn = layer.attn
        attn.qkv_proj = ColumnParallelLinear.from_linear(
            attn.qkv_proj, group, split_factor=3)
        attn.out_proj = RowParallelLinear.from_linear(attn.out_proj, group)
        layer.linear1 = ColumnParallelLinear.from_linear(layer.linear1, group)
        layer.linear2 = RowParallelLinear.from_linear(layer.linear2, group)
    if not cfg.tie_word_embeddings:
        model.lm_head = ColumnParallelLinear.from_linear(model.lm_head, group)
    for p in model.parameters():
        if not isinstance(p, DistParameter):
            mp_shard_(p, group, None)
    return model
