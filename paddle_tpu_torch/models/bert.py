"""BERT model family — the encoder, the pretraining (MLM + NSP) and
sequence-classification heads.

Counterpart of ``paddle_tpu/models/bert.py``: word, position and
token-type embeddings, LayerNorm, dropout; post-LN encoder layers
(self-attention, exact GELU FFN); a tanh pooler over the first token.
Parameter names are the reference's (``bert.encoder.0.self_attn.q_proj.
weight`` and friends). Modules are ``torch.nn``: Linear weights are
torch's ``[out, in]`` where the reference keeps paddle's ``[in, out]``
(``convert.load_paddle_tpu_state`` transposes them; the embeddings and
LayerNorms are copied as they are).

Attention goes through ``nn.functional.scaled_dot_product_attention``,
not causal, with the attention dropout: at a kernel head dim (BERT-base's
64) it runs the flash kernels, forward and backward, the dropout inside
them. A 2-D ``attention_mask`` [B, S] (1 keep, 0 pad) becomes the
additive ``-1e4 * (1 - mask)`` of shape [B, 1, 1, S] in fp32, whatever
the model's dtype (the reference's ``astype("float32")``), and reaches
the kernels as a key bias. LayerNorm computes as the reference does
(fp32 statistics and affine, one rounding). Every dropout draw comes
from the model's one explicit generator, ``dropout_generator``, through
``use_generator``, so ``recompute`` replays the same draws.

The reference has no ``dtype`` field: bf16 comes from
``model.to(torch.bfloat16)``. ``bert_shard_plan`` waits for the
distributed slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.generator import make_generator
from ..core.place import resolve_device
from ..distributed.fleet.utils import recompute
from ..nn import functional as F
from ..nn.functional.common import Embedding
from .gpt import _LayerNorm
from .llama import fused_qkv_linear

__all__ = [
    "BertConfig", "BertModel", "BertForPretraining",
    "BertForSequenceClassification", "BertEmbeddings", "BertEncoderLayer",
    "bert_shard_plan",
]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    recompute: bool = False
    # compute-time q|k|v weight concat (one [3h, h] product); the
    # parameters stay separate
    fused_qkv: bool = False

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def large() -> "BertConfig":
        return BertConfig(hidden_size=1024, num_hidden_layers=24,
                          num_attention_heads=16, intermediate_size=4096)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=64)
        base.update(kw)
        return BertConfig(**base)


class _Dropout(nn.Module):
    """``F.dropout`` at a fixed rate from the model's generator, active in
    training mode."""

    def __init__(self, p, generator):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)


class BertEmbeddings(nn.Module):
    """word + position + token_type embeddings -> LayerNorm -> dropout."""

    def __init__(self, config: BertConfig, generator, **factory):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, **factory)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, h, **factory)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               **factory)
        self.layer_norm = _LayerNorm(h, eps=config.layer_norm_eps, **factory)
        self.dropout = _Dropout(config.hidden_dropout_prob, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, generator, **factory):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        self.q_proj = nn.Linear(h, h, **factory)
        self.k_proj = nn.Linear(h, h, **factory)
        self.v_proj = nn.Linear(h, h, **factory)
        self.out_proj = nn.Linear(h, h, **factory)
        self.dropout = _Dropout(config.hidden_dropout_prob, generator)
        self.generator = generator

    def forward(self, x, attention_mask=None):
        b, s, h = x.shape
        projs = (self.q_proj, self.k_proj, self.v_proj)
        if self.config.fused_qkv:
            q, k, v = fused_qkv_linear(x, projs)
        else:
            q, k, v = (p(x) for p in projs)
        shape = (b, s, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            q.reshape(shape), k.reshape(shape), v.reshape(shape),
            attn_mask=attention_mask,
            dropout_p=self.config.attention_probs_dropout_prob,
            is_causal=False, training=self.training,
            generator=self.generator)
        return self.dropout(self.out_proj(out.reshape(b, s, h)))


class BertEncoderLayer(nn.Module):
    """Post-LN encoder block: norm1(x + attn(x)), then norm2(x +
    dropout(linear2(gelu(linear1(x)))))."""

    def __init__(self, config: BertConfig, generator, **factory):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.self_attn = BertSelfAttention(config, generator, **factory)
        self.norm1 = _LayerNorm(h, eps=eps, **factory)
        self.linear1 = nn.Linear(h, config.intermediate_size, **factory)
        self.linear2 = nn.Linear(config.intermediate_size, h, **factory)
        self.norm2 = _LayerNorm(h, eps=eps, **factory)
        self.dropout = _Dropout(config.hidden_dropout_prob, generator)

    def forward(self, x, attention_mask=None):
        x = self.norm1(x + self.self_attn(x, attention_mask))
        ff = self.linear2(F.gelu(self.linear1(x)))
        return self.norm2(x + self.dropout(ff))


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, generator, **factory):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, generator, **factory)
        self.encoder = nn.ModuleList(
            [BertEncoderLayer(config, generator, **factory)
             for _ in range(config.num_hidden_layers)])
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size,
                                **factory)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """(sequence output [B, S, H], pooled [B, H])."""
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None and attention_mask.ndim == 2:
            # [B, S] padding mask -> additive [B, 1, 1, S] in fp32
            neg = (1.0 - attention_mask.float()) * -1e4
            attention_mask = neg[:, None, None, :]
        for layer in self.encoder:
            x = (recompute(layer, x, attention_mask) if self.config.recompute
                 else layer(x, attention_mask))
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())


class _BertRoot(nn.Module):
    """Device, the dropout generator and the initialisation shared by the
    two heads: ``device=None`` builds on the card (and raises without
    one), ``device="cpu"`` on the CPU; parameters fp32 from ``seed``:
    normal(0, 0.02) for the projections and embeddings, zeros for
    biases, ones and zeros for the LayerNorms. ``dropout_generator``
    (seeded with ``seed``, on the model's device) feeds every dropout
    draw."""

    def _setup(self, config, device, seed):
        dev = resolve_device(device)
        self.config = config
        self.dropout_generator = make_generator(seed, dev)
        factory = dict(device=dev, dtype=torch.float32)
        self.bert = BertModel(config, self.dropout_generator, **factory)
        return factory

    @torch.no_grad()
    def _init_weights(self, seed: int):
        gen = make_generator(seed, self.dropout_generator.device)
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())


class BertForPretraining(_BertRoot):
    """MLM + NSP heads. With ``masked_lm_labels`` (``-100`` ignored) the
    forward returns ``(loss, mlm logits, nsp logits)``, the loss the MLM
    cross-entropy plus, with ``next_sentence_labels``, the NSP one;
    without, ``(mlm logits, nsp logits)``."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0):
        super().__init__()
        factory = self._setup(config, device, seed)
        h = config.hidden_size
        self.mlm_transform = nn.Linear(h, h, **factory)
        self.mlm_norm = _LayerNorm(h, eps=config.layer_norm_eps, **factory)
        self.mlm_head = nn.Linear(h, config.vocab_size, **factory)
        self.nsp_head = nn.Linear(h, 2, **factory)
        self._init_weights(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_labels=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        mlm = self.mlm_head(self.mlm_norm(F.gelu(self.mlm_transform(seq))))
        nsp = self.nsp_head(pooled)
        if masked_lm_labels is not None:
            loss = F.cross_entropy(
                mlm.reshape(-1, self.config.vocab_size),
                masked_lm_labels.reshape(-1), ignore_index=-100)
            if next_sentence_labels is not None:
                loss = loss + F.cross_entropy(
                    nsp, next_sentence_labels.reshape(-1))
            return loss, mlm, nsp
        return mlm, nsp


class BertForSequenceClassification(_BertRoot):
    """The pooled output through dropout and a classifier; with
    ``labels`` ``(loss, logits)``."""

    def __init__(self, config: BertConfig, num_classes: int = 2,
                 device=None, seed: int = 0):
        super().__init__()
        factory = self._setup(config, device, seed)
        self.dropout = _Dropout(config.hidden_dropout_prob,
                                self.dropout_generator)
        self.classifier = nn.Linear(config.hidden_size, num_classes,
                                    **factory)
        self._init_weights(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels.reshape(-1)), logits
        return logits


def bert_shard_plan(model, mesh, dp_axis="dp", mp_axis="mp"):
    """The reference's Megatron tensor-parallel layout; it waits for the
    distributed slice."""
    raise NotImplementedError(
        "bert_shard_plan waits for ROADMAP.md queue A item 4 (distributed "
        "training) of the port")
