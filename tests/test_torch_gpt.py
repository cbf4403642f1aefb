"""The port's GPT family (paddle_tpu_torch/models/gpt.py) against the
reference's (paddle_tpu/models/gpt.py) on the CPU, from the same weights
(bridged by ``load_paddle_tpu_state``) and the same numpy batches.

- Forward logits and the ``labels=`` loss, tied and untied heads.
- Training, dropout 0: three AdamW steps, the losses, the step-1
  gradients and the weights after three steps, tied, untied, with
  ``recompute`` and at head dim 64 (the port's flash route, through the
  kernels' plain versions on the CPU).
- With dropout 0.1 (attention and hidden), within the port: recompute on
  and off give equal losses and gradients, one seed twice is bit for
  bit, another seed differs (head dim 16: the plain attention; head dim
  64: the flash kernels' plain version with its counter-hash mask).
- The reference's ``tests/test_text_models.py::TestGPT`` cases through
  the port (forward and tied embeddings, causality, a ``to_static``
  training run whose loss falls, the untied head), and
  ``gpt_shard_plan`` raising until the distributed slice.
- Weights drawn with numpy (``numpy_init``).
  The weight bridge: the fused ``qkv_proj`` transposed, LayerNorm and
  embeddings as they are, no ``lm_head`` key in a tied model.
- A CPU model never reaches a kernel (forward, backward, ``generate``
  dense and paged, serving).

fp32 throughout. Tolerances (as ``test_torch_train.py``): logits 1e-5 of
their max |value|; loss 2e-5 absolute; step-1 gradients 1e-4 of each
gradient's max |g|; weights after three steps 1e-5 absolute where every
step's gradient is above 1e-5 in both packages or 0 in both (Adam's
update near a zero gradient is ±lr whichever side rounding put it), and
that must cover 95% of the weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT

import paddle_tpu_torch
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, gpt_shard_plan
from _torch_zoo import one_torch_thread  # noqa: F401

LOSS_TOL = 2e-5
LOGIT_REL = 1e-5
GRAD_REL = 1e-4
PARAM_TOL = 1e-5
G_FLOOR = 1e-5
LR = 1e-3
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
#: head dim 64: the port's flash gate passes (its plain version on the CPU)
D64 = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256)


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def numpy_init(jm, seed, scale=0.1):
    """Weights drawn with numpy and set on the reference model: matrices,
    embeddings and biases normal(0, ``scale``), LayerNorm weights 1 +
    normal(0, 0.1) and biases normal(0, 0.02). (The reference's own init
    saturates the tied head's softmax, and GPT-2's 0.02 leaves attention
    nearly flat, so much of the gradients compared would be rounding
    noise.) Returns the state."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in _state(jm).items():
        if ".norm" in k:
            base = 1.0 if k.endswith("weight") else 0.0
            sd = 0.1 if k.endswith("weight") else 0.02
            state[k] = (base + sd * rng.standard_normal(v.shape))
        else:
            state[k] = scale * rng.standard_normal(v.shape)
        state[k] = state[k].astype(np.float32)
    jm.set_state_dict(state)
    return state


def _pair(seed=7, **kw):
    paddle.seed(seed)
    jm = JGPT(JConfig.tiny(**kw))
    tm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, numpy_init(jm, seed))
    return jm, tm


def _batch(seq, vocab=256, seed=0, b=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, seq))
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    labels[1, :3] = -100
    return ids, labels


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_forward_and_loss_match_reference(tie):
    jm, tm = _pair(tie_word_embeddings=tie, **NO_DROPOUT)
    jm.eval()
    tm.eval()
    ids, labels = _batch(12)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_REL * np.abs(want).max())
    jl, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    tl, tlogits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert abs(tl.item() - float(jl)) <= LOSS_TOL
    assert tlogits.shape == tuple(jlogits.shape)


def _train(kw, seq=16, steps=3):
    jm, tm = _pair(**kw, **NO_DROPOUT)
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    jparams = dict(jm.named_parameters())
    tparams = dict(tm.named_parameters())

    def t_np(name, t):
        a = t.detach().numpy()
        return a.T if name.rsplit(".", 1)[0] in linear else a

    jo = jopt.AdamW(learning_rate=LR, parameters=list(jparams.values()))
    to = topt.AdamW(learning_rate=LR, parameters=list(tparams.values()))
    ids, labels = _batch(seq)
    out = dict(jl=[], tl=[], jg=[], tg=[])
    for _ in range(steps):
        jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jloss.backward()
        tloss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        tloss.backward()
        out["jl"].append(float(jloss))
        out["tl"].append(tloss.item())
        out["jg"].append({n: np.asarray(p.grad._value)
                          for n, p in jparams.items()})
        out["tg"].append({n: t_np(n, p.grad) for n, p in tparams.items()})
        jo.step()
        jo.clear_grad()
        to.step()
        to.clear_grad()
    out["jp"] = {n: np.asarray(p._value) for n, p in jparams.items()}
    out["tp"] = {n: t_np(n, p) for n, p in tparams.items()}
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(tie_word_embeddings=False), dict(recompute=True), D64],
    ids=["tied", "untied", "recompute", "head_dim_64"])
def test_trains_like_reference(kw):
    r = _train(kw)
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=0, atol=LOSS_TOL)
    assert r["tl"][-1] < r["tl"][0]
    for name, jg in r["jg"][0].items():
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(r["tg"][0][name], jg, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)
    covered = total = 0
    for name, jp in r["jp"].items():
        gj = np.stack([g[name] for g in r["jg"]])
        gt = np.stack([g[name] for g in r["tg"]])
        stable = (np.abs(gj).min(0) > G_FLOOR) & (np.abs(gt).min(0) > G_FLOOR)
        keep = stable | ((gj == 0).all(0) & (gt == 0).all(0))
        np.testing.assert_allclose(r["tp"][name][keep], jp[keep], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
        covered += int(keep.sum())
        total += keep.size
    assert covered >= 0.95 * total, (covered, total)


def _loss_and_grads(cfg, seed, ids, labels):
    model = GPTForCausalLM(cfg, device="cpu", seed=seed).train()
    loss, _ = model(ids, labels=labels)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("kw", [{}, D64], ids=["head_dim_16", "head_dim_64"])
def test_dropout_recompute_and_seed_within_the_port(kw):
    """Dropout 0.1 in attention and hidden states: the recompute replay
    draws the same flash seed and masks from the model's generator, so
    its loss and gradients equal the plain run's bit for bit; one seed
    twice is bit for bit, another seed gives another loss."""
    ids, labels = (torch.from_numpy(a) for a in _batch(32))
    cfg = GPTConfig.tiny(**kw)
    assert cfg.hidden_dropout_prob == cfg.attention_probs_dropout_prob == 0.1
    loss, grads = _loss_and_grads(cfg, 3, ids, labels)
    loss_rc, grads_rc = _loss_and_grads(GPTConfig.tiny(recompute=True, **kw),
                                        3, ids, labels)
    loss2, grads2 = _loss_and_grads(cfg, 3, ids, labels)
    other, _ = _loss_and_grads(cfg, 4, ids, labels)
    nodrop, _ = _loss_and_grads(GPTConfig.tiny(**NO_DROPOUT, **kw), 3, ids,
                                labels)
    assert torch.equal(loss, loss_rc) and torch.equal(loss, loss2)
    assert not torch.equal(loss, other) and not torch.equal(loss, nodrop)
    for n, g in grads.items():
        assert torch.equal(g, grads_rc[n]), n
        assert torch.equal(g, grads2[n]), n


# --- the reference's tests/test_text_models.py::TestGPT, through the port --
def test_forward_and_tied_embeddings():
    config = GPTConfig.tiny()
    model = GPTForCausalLM(config, device="cpu", seed=4)
    assert config.tie_word_embeddings
    assert not hasattr(model, "lm_head")
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, config.vocab_size, (2, 12)))
    logits = model(ids)
    assert list(logits.shape) == [2, 12, config.vocab_size]


def test_causality():
    """Changing a future token must not affect earlier logits."""
    config = GPTConfig.tiny(hidden_dropout_prob=0.0)
    model = GPTForCausalLM(config, device="cpu", seed=5).eval()
    ids = np.random.default_rng(6).integers(0, config.vocab_size, (1, 8))
    ids2 = ids.copy()
    ids2[0, -1] = (ids2[0, -1] + 1) % config.vocab_size
    with torch.no_grad():
        a = model(torch.from_numpy(ids))
        b = model(torch.from_numpy(ids2))
    torch.testing.assert_close(a[0, :-1], b[0, :-1], rtol=0, atol=1e-5)
    assert not torch.allclose(a[0, -1], b[0, -1])


def _static_losses(model, n, ids, labels):
    opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters())

    @tjit.to_static
    def step(ids, labels):
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return [float(step(ids, labels)) for _ in range(n)]


def test_training_loss_decreases():
    config = GPTConfig.tiny(hidden_dropout_prob=0.0)
    model = GPTForCausalLM(config, device="cpu", seed=6)
    ids = np.random.default_rng(7).integers(0, config.vocab_size, (4, 16))
    losses = _static_losses(model, 5, torch.from_numpy(ids),
                            torch.from_numpy(np.roll(ids, -1, axis=1)))
    assert losses[-1] < losses[0]


def test_untied_head_and_tp_plan():
    config = GPTConfig.tiny(hidden_size=32, intermediate_size=64,
                            vocab_size=256, tie_word_embeddings=False,
                            hidden_dropout_prob=0.0)
    model = GPTForCausalLM(config, device="cpu", seed=7)
    assert hasattr(model, "lm_head")
    # the plan checks mp against the model before it touches the mesh's
    # process group: 3 divides neither the heads nor the vocabulary
    from paddle_tpu_torch.distributed import ProcessMesh
    with pytest.raises(ValueError, match="does not divide over mp = 3"):
        gpt_shard_plan(model, mesh=ProcessMesh([[0, 1, 2]], ["dp", "mp"]))
    ids = np.random.default_rng(8).integers(0, config.vocab_size, (4, 8))
    l1, l2 = _static_losses(model, 2, torch.from_numpy(ids),
                            torch.from_numpy(np.roll(ids, -1, 1)))
    assert np.isfinite(l1) and l2 < l1


def test_weight_bridge_layouts():
    """The fused qkv weight arrives transposed ([h, 3h] -> [3h, h]), the
    LayerNorm and embedding tables as they are; a tied model has no
    ``lm_head`` key, and a tied state does not load into an untied
    model."""
    jm, tm = _pair(tie_word_embeddings=True)
    state = _state(jm)
    assert not any(k.startswith("lm_head") for k in state)
    q = "gpt.layers.0.attn.qkv_proj.weight"
    assert state[q].shape == (64, 192)
    np.testing.assert_array_equal(
        dict(tm.named_parameters())[q].detach().numpy(), state[q].T)
    for k in ("gpt.layers.1.norm2.weight", "gpt.layers.1.norm2.bias",
              "gpt.wpe.weight", "gpt.wte.weight"):
        np.testing.assert_array_equal(
            dict(tm.named_parameters())[k].detach().numpy(), state[k])
    untied = GPTForCausalLM(GPTConfig.tiny(tie_word_embeddings=False),
                            device="cpu")
    with pytest.raises(KeyError, match="lm_head"):
        load_paddle_tpu_state(untied, state)


def test_bf16_forward_tracks_fp32():
    """``model.to(torch.bfloat16)`` (the reference has no dtype field):
    bf16 logits, within 0.05 of the fp32 model's (logits of ~0.3)."""
    ids = torch.from_numpy(_batch(16)[0])
    model = GPTForCausalLM(GPTConfig.tiny(**D64), device="cpu", seed=2).eval()
    with torch.no_grad():
        want = model(ids)
        got = model.to(torch.bfloat16)(ids)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) < 0.05


def test_cpu_gpt_never_reaches_a_kernel(monkeypatch):
    """Head dim 64, dropout 0.1: the flash gate passes, so the training
    step's attention goes through the kernel wrappers, which send CPU
    tensors to their plain versions; ``generate`` (dense and paged) and
    the serving engine likewise. No launch is counted and no kernel is
    built."""
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.ops.cuda import flash_attention_varlen as tvf
    from paddle_tpu_torch.ops.cuda import paged_attention as tpa

    def no_build(name):
        raise AssertionError(f"a CPU run tried to load the {name} kernel")

    monkeypatch.setattr(_build, "load", no_build)

    def launches():
        return (tfa.launches, tfa.bwd_launches, tpa.launches, tvf.launches)

    counts = launches()
    model = GPTForCausalLM(GPTConfig.tiny(**D64), device="cpu")
    ids, labels = (torch.from_numpy(a) for a in _batch(16))
    loss, _ = model(ids, labels=labels)
    loss.backward()
    assert torch.isfinite(loss)
    model.eval()
    for kw in ({}, dict(paged=True, block_size=8)):
        out = model.generate(ids[:, :6], max_new_tokens=4, **kw)
        assert out.shape == (2, 10)
    eng = paddle_tpu_torch.ServeEngine(model, max_slots=2, block_size=8,
                                       num_blocks=8, max_seq_len=32,
                                       name="t_gpt_pkg", device="cpu")
    eng.submit(np.arange(1, 12), max_new_tokens=4)
    eng.run()
    assert launches() == counts
