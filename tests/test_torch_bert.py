"""The port's BERT family (paddle_tpu_torch/models/bert.py) against the
reference's (paddle_tpu/models/bert.py) on the CPU, from the same weights
(bridged by ``load_paddle_tpu_state``) and the same numpy batches.

- Forward: the sequence output, the pooled output and the MLM and NSP
  logits, and the pretraining loss (MLM at ``ignore_index=-100`` plus
  NSP), with and without a 2-D padding mask, at head dim 16 (the plain
  attention) and 64 (the port's flash route with the mask as a key bias,
  through the kernels' plain version on the CPU).
- Training, dropout 0: three AdamW steps, the losses, the step-1
  gradients and the weights after three steps; with the padding mask,
  with ``recompute`` and with ``fused_qkv``.
- ``BertForSequenceClassification``: logits, loss and gradients.
- Dropout 0.1 within the port: recompute on and off equal bit for bit,
  one seed twice equal, another seed another loss.
- The additive mask stays fp32 under ``model.to(torch.bfloat16)``.
- The weight bridge: every reference key, Linear weights transposed,
  embeddings and LayerNorms as they are; ``bert_shard_plan`` raises.

fp32 throughout. Tolerances (as ``test_torch_gpt.py``): logits and
hidden states 1e-5 of their max |value|; losses 2e-5 absolute; step-1
gradients 1e-4 of each gradient's max |g| (the key bias's, 0 in exact
arithmetic, below 1e-6 in both); weights after three steps 1e-5
absolute where every step's gradient is at least 1e-3 of the
parameter's max |g| in both packages, or 0 in both, covering 70% of the
weights (``G_FLOOR``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import BertConfig as JConfig
from paddle_tpu.models import BertForPretraining as JBert
from paddle_tpu.models import BertForSequenceClassification as JCls

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertForSequenceClassification,
                                     bert_shard_plan)

LOSS_TOL = 2e-5
REL = 1e-5
GRAD_REL = 1e-4
PARAM_TOL = 1e-5
#: the weights after three steps are compared where every step's gradient
#: is at least this share of the parameter's largest |g| in both packages:
#: Adam divides by |g|, so the fp32 gradients' rounding differences (about
#: 1e-6 of max |g|) move an entry by about 3 * lr * 1e-6 * max|g| / |g|
#: over three steps, 3e-6 at this floor; BERT's LayerNorms give many
#: entries gradients far below the largest
G_FLOOR = 1e-3
COVERED = 0.7
#: a gradient that is 0 in exact arithmetic (the key projection's bias)
ZERO_GRAD = 1e-6
LR = 1e-3
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
#: head dim 64: the port's flash gate passes (its plain version on the CPU)
D64 = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256)


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def numpy_init(jm, seed):
    """Weights drawn with numpy, set on the reference model: matrices and
    embeddings normal(0, 0.1), LayerNorm weights 1 + normal(0, 0.1),
    biases normal(0, 0.02). Returns the state."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in _state(jm).items():
        if k.endswith("bias"):
            a = 0.02 * rng.standard_normal(v.shape)
        elif "norm" in k:
            a = 1.0 + 0.1 * rng.standard_normal(v.shape)
        else:
            a = 0.1 * rng.standard_normal(v.shape)
        state[k] = a.astype(np.float32)
    jm.set_state_dict(state)
    return state


def _pair(jcls=JBert, tcls=BertForPretraining, seed=7, **kw):
    paddle.seed(seed)
    jm = jcls(JConfig.tiny(**kw))
    tm = tcls(BertConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, numpy_init(jm, seed))
    return jm, tm


def _batch(seq=16, vocab=256, seed=0, b=2, masked=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, seq))
    tt = (np.arange(seq)[None, :] >= seq // 2).astype("int64") * np.ones(
        (b, 1), "int64")
    mlm = np.where(rng.random((b, seq)) < 0.3, ids, -100)
    mlm[0, 1] = ids[0, 1]
    nsp = rng.integers(0, 2, (b, 1))
    mask = None
    if masked:
        mask = np.ones((b, seq), "int64")
        mask[1, seq - 5:] = 0
    return ids, tt, mlm, nsp, mask


def _j(a):
    return None if a is None else paddle.to_tensor(a)


def _tt(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max(), err_msg=err_msg)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("kw", [{}, D64], ids=["head_dim_16", "head_dim_64"])
def test_forward_and_loss_match_reference(kw, masked):
    jm, tm = _pair(**kw, **NO_DROPOUT)
    jm.eval()
    tm.eval()
    ids, tt, mlm, nsp, mask = _batch(masked=masked)
    jseq, jpool = jm.bert(_j(ids), _j(tt), attention_mask=_j(mask))
    with torch.no_grad():
        tseq, tpool = tm.bert(_tt(ids), _tt(tt), attention_mask=_tt(mask))
        tmlm, tnsp = tm(_tt(ids), _tt(tt), attention_mask=_tt(mask))
    jmlm, jnsp = jm(_j(ids), _j(tt), attention_mask=_j(mask))
    for name, got, want in (("seq", tseq, jseq), ("pooled", tpool, jpool),
                            ("mlm", tmlm, jmlm), ("nsp", tnsp, jnsp)):
        _close(got.numpy(), want.numpy(), name)
    jl, _, _ = jm(_j(ids), _j(tt), attention_mask=_j(mask),
                  masked_lm_labels=_j(mlm), next_sentence_labels=_j(nsp))
    tl, _, _ = tm(_tt(ids), _tt(tt), attention_mask=_tt(mask),
                  masked_lm_labels=_tt(mlm), next_sentence_labels=_tt(nsp))
    assert abs(tl.item() - float(jl)) <= LOSS_TOL
    jl, _, _ = jm(_j(ids), _j(tt), masked_lm_labels=_j(mlm))
    tl, _, _ = tm(_tt(ids), _tt(tt), masked_lm_labels=_tt(mlm))
    assert abs(tl.item() - float(jl)) <= LOSS_TOL


def _t_np(tm):
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}

    def conv(name, t):
        a = t.detach().numpy()
        return a.T if name.rsplit(".", 1)[0] in linear else a
    return conv


def _train(kw, masked=False, steps=3):
    jm, tm = _pair(**kw, **NO_DROPOUT)
    conv = _t_np(tm)
    jparams = dict(jm.named_parameters())
    tparams = dict(tm.named_parameters())
    jo = jopt.AdamW(learning_rate=LR, parameters=list(jparams.values()))
    to = topt.AdamW(learning_rate=LR, parameters=list(tparams.values()))
    ids, tt, mlm, nsp, mask = _batch(masked=masked)
    out = dict(jl=[], tl=[], jg=[], tg=[])
    for _ in range(steps):
        jloss, _, _ = jm(_j(ids), _j(tt), attention_mask=_j(mask),
                         masked_lm_labels=_j(mlm),
                         next_sentence_labels=_j(nsp))
        jloss.backward()
        tloss, _, _ = tm(_tt(ids), _tt(tt), attention_mask=_tt(mask),
                         masked_lm_labels=_tt(mlm),
                         next_sentence_labels=_tt(nsp))
        tloss.backward()
        out["jl"].append(float(jloss))
        out["tl"].append(tloss.item())
        out["jg"].append({n: np.asarray(p.grad._value)
                          for n, p in jparams.items()})
        out["tg"].append({n: conv(n, p.grad) for n, p in tparams.items()})
        jo.step()
        jo.clear_grad()
        to.step()
        to.clear_grad()
    out["jp"] = {n: np.asarray(p._value) for n, p in jparams.items()}
    out["tp"] = {n: conv(n, p) for n, p in tparams.items()}
    return out


@pytest.mark.parametrize("kw,masked", [
    ({}, False), (D64, True), (dict(recompute=True), True),
    (dict(fused_qkv=True), False)],
    ids=["plain", "head_dim_64_mask", "recompute_mask", "fused_qkv"])
def test_trains_like_reference(kw, masked):
    r = _train(kw, masked)
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=0, atol=LOSS_TOL)
    assert r["tl"][-1] < r["tl"][0]
    for name, jg in r["jg"][0].items():
        if name.endswith("k_proj.bias"):
            # q . b_k shifts a row's logits by one constant: the softmax
            # drops it, so this gradient is 0 but for rounding
            assert max(np.abs(jg).max(),
                       np.abs(r["tg"][0][name]).max()) < ZERO_GRAD, name
            continue
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(r["tg"][0][name], jg, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)
    covered = total = 0
    for name, jp in r["jp"].items():
        if name.endswith("k_proj.bias"):
            continue             # Adam's steps on a rounding-noise gradient
        gj = np.stack([g[name] for g in r["jg"]])
        gt = np.stack([g[name] for g in r["tg"]])
        floor = G_FLOOR * float(np.abs(gj).max())
        stable = (np.abs(gj).min(0) > floor) & (np.abs(gt).min(0) > floor)
        keep = stable | ((gj == 0).all(0) & (gt == 0).all(0))
        np.testing.assert_allclose(r["tp"][name][keep], jp[keep], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
        covered += int(keep.sum())
        total += keep.size
    assert covered >= COVERED * total, (covered, total)


def test_sequence_classification_matches_reference():
    jm, tm = _pair(JCls, BertForSequenceClassification, seed=3,
                   **NO_DROPOUT)
    ids, tt, _, nsp, mask = _batch(masked=True, seed=2)
    jlogits = jm(_j(ids), _j(tt), attention_mask=_j(mask))
    tlogits = tm(_tt(ids), _tt(tt), attention_mask=_tt(mask))
    _close(tlogits.detach().numpy(), jlogits.numpy())
    jl, _ = jm(_j(ids), _j(tt), attention_mask=_j(mask), labels=_j(nsp))
    tl, _ = tm(_tt(ids), _tt(tt), attention_mask=_tt(mask), labels=_tt(nsp))
    assert abs(tl.item() - float(jl)) <= LOSS_TOL
    jl.backward()
    tl.backward()
    conv = _t_np(tm)
    jp = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        jg = np.asarray(jp[name].grad._value)
        if name.endswith("k_proj.bias"):
            assert max(np.abs(jg).max(),
                       np.abs(conv(name, p.grad)).max()) < ZERO_GRAD, name
            continue
        np.testing.assert_allclose(
            conv(name, p.grad), jg, rtol=0,
            atol=GRAD_REL * max(float(np.abs(jg).max()), 1e-12),
            err_msg=name)


def _loss_and_grads(cfg, seed, batch):
    ids, tt, mlm, nsp, mask = (_tt(a) for a in batch)
    model = BertForPretraining(cfg, device="cpu", seed=seed).train()
    loss, _, _ = model(ids, tt, attention_mask=mask, masked_lm_labels=mlm,
                       next_sentence_labels=nsp)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("kw", [{}, D64], ids=["head_dim_16", "head_dim_64"])
def test_dropout_recompute_and_seed_within_the_port(kw):
    """Dropout 0.1 (embeddings, attention inside the flash route at head
    dim 64, outputs, FFN) with a padding mask: recompute's replay draws
    the same masks from the model's generator, one seed twice is bit for
    bit, another seed gives another loss."""
    batch = _batch(masked=True, seed=5)
    cfg = BertConfig.tiny(**kw)
    assert cfg.hidden_dropout_prob == cfg.attention_probs_dropout_prob == 0.1
    loss, grads = _loss_and_grads(cfg, 3, batch)
    loss_rc, grads_rc = _loss_and_grads(BertConfig.tiny(recompute=True, **kw),
                                        3, batch)
    loss2, grads2 = _loss_and_grads(cfg, 3, batch)
    other, _ = _loss_and_grads(cfg, 4, batch)
    nodrop, _ = _loss_and_grads(BertConfig.tiny(**NO_DROPOUT, **kw), 3, batch)
    assert torch.equal(loss, loss_rc) and torch.equal(loss, loss2)
    assert not torch.equal(loss, other) and not torch.equal(loss, nodrop)
    for n, g in grads.items():
        assert torch.equal(g, grads_rc[n]), n
        assert torch.equal(g, grads2[n]), n


def test_padding_mask_stays_fp32_under_bf16():
    """The 2-D mask becomes ``-1e4 * (1 - mask)`` [B, 1, 1, S] in fp32 on
    a bf16 model (the reference's ``astype("float32")``), and padded keys
    change no unpadded row."""
    model = BertForPretraining(BertConfig.tiny(**D64, **NO_DROPOUT),
                               device="cpu").to(torch.bfloat16).eval()
    seen = []
    model.bert.encoder[0].register_forward_pre_hook(
        lambda mod, args: seen.append(args[1]))
    ids, tt, _, _, mask = _batch(masked=True)
    with torch.no_grad():
        mlm, _ = model(_tt(ids), _tt(tt), attention_mask=_tt(mask))
        ids2 = ids.copy()
        ids2[1, -5:] = (ids2[1, -5:] + 1) % 256
        mlm2, _ = model(_tt(ids2), _tt(tt), attention_mask=_tt(mask))
    assert seen[0].dtype == torch.float32
    assert tuple(seen[0].shape) == (2, 1, 1, 16)
    assert float(seen[0][1, 0, 0, -1]) == -1e4 and float(seen[0][0].sum()) == 0
    assert mlm.dtype == torch.bfloat16
    torch.testing.assert_close(mlm2[1, :-5], mlm[1, :-5], rtol=0, atol=0)


def test_state_round_trip_and_shard_plan():
    """Every reference key reaches the port: Linear weights transposed,
    the three embeddings and the LayerNorms as they are; the port's
    state dict has the reference's key set."""
    for jcls, tcls in ((JBert, BertForPretraining),
                       (JCls, BertForSequenceClassification)):
        jm, tm = _pair(jcls, tcls, seed=1)
        state = _state(jm)
        assert set(tm.state_dict()) == set(state)
        conv = _t_np(tm)
        for name, p in tm.named_parameters():
            np.testing.assert_array_equal(conv(name, p), state[name],
                                          err_msg=name)
        emb = tm.bert.embeddings
        np.testing.assert_array_equal(
            emb.token_type_embeddings.weight.detach().numpy(),
            state["bert.embeddings.token_type_embeddings.weight"])
        np.testing.assert_array_equal(
            tm.bert.encoder[0].linear1.weight.detach().numpy().T,
            state["bert.encoder.0.linear1.weight"])
    with pytest.raises(NotImplementedError, match="item 4"):
        bert_shard_plan(tm, None)
