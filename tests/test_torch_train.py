"""The port's Llama training step (paddle_tpu_torch: ``labels=`` loss,
``loss.backward()``, ``AdamW``) against the reference package's, on the
CPU: the tiny config from the same weights (bridged by
``load_paddle_tpu_state``) and the same batch, three steps, with the fused
lm-head cross-entropy on and off and with ``recompute=True``. One config
passes both packages' kernel gates (head_dim 64, seq 128) and runs with
``pallas_force_interpret`` (test_torch_train_kernels.py), so the
reference takes its flash and RMSNorm Pallas kernels forward and backward
under the interpreter while the port takes its kernels' plain versions
(a CPU tensor never launches).

fp32 throughout. Tolerances:
- loss, each step: 2e-5 absolute on losses of ~5.5 (fp32 sums over the
  vocabulary and two layers in another order);
- step-1 gradients: 1e-4 of each gradient's own max |g| (rounding in
  another order through two layers and the softmax backward; measured
  below 1e-5);
- parameters after three steps: 1e-5 absolute. Adam divides by
  sqrt(v) + 1e-8, so a gradient near 0 moves a weight by about ±lr
  whichever side of 0 rounding put it on: weights are compared where
  every step's gradient is above 1e-5 in magnitude (there the update is
  ~lr * sign(m) / sqrt(v) and insensitive to rounding) or exactly 0 in
  both packages (embedding rows of tokens not in the batch), and those
  must cover at least 95% of the weights.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.core.flags import flags_scope
from paddle_tpu_torch.core.generator import make_generator
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF

LOSS_TOL = 2e-5
GRAD_REL = 1e-4
PARAM_TOL = 1e-5
G_FLOOR = 1e-5
LR = 1e-3


def _batch(seq, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (2, seq))
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100                   # no next token: ignored
    labels[1, :3] = -100
    return ids, labels


def _train(kw, seq, steps=3):
    """Both packages from the same weights, ``steps`` AdamW steps on one
    batch: (losses j, losses t, grads j, grads t per step, params j, t),
    gradients and parameters as numpy in the reference's layout."""
    paddle.seed(7)
    jm = JLlama(JConfig.tiny(**kw))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v._value)
                               for k, v in jm.state_dict().items()})
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


def _check(r):
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=0, atol=LOSS_TOL)
    assert r["tl"][-1] < r["tl"][0]
    for name, jg in r["jg"][0].items():
        tg = r["tg"][0][name]
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(tg, jg, rtol=0, atol=GRAD_REL * scale,
                                   err_msg=name)
    covered = total = 0
    for name, jp in r["jp"].items():
        gj = np.stack([g[name] for g in r["jg"]])
        gt = np.stack([g[name] for g in r["tg"]])
        stable = (np.abs(gj).min(0) > G_FLOOR) & (np.abs(gt).min(0) > G_FLOOR)
        zero = (gj == 0).all(0) & (gt == 0).all(0)
        keep = stable | zero
        np.testing.assert_allclose(r["tp"][name][keep], jp[keep], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
        covered += int(keep.sum())
        total += keep.size
    assert covered >= 0.95 * total, (covered, total)


@pytest.mark.parametrize("kw", [
    dict(),                               # fused lm-head CE (the default)
    dict(fused_lm_head_ce=False),         # cross_entropy on full logits
    dict(recompute=True),                 # every decoder layer checkpointed
], ids=["fused_ce", "unfused_ce", "recompute"])
def test_tiny_llama_trains_like_reference(kw):
    _check(_train(kw, seq=16))


def test_labels_return_shapes():
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    ids = torch.zeros(2, 5, dtype=torch.long)
    loss, logits = tm(ids, labels=ids)
    assert loss.shape == () and logits is None
    tm.config.fused_lm_head_ce = False
    loss2, logits = tm(ids, labels=ids)
    assert logits.shape == (2, 5, 256)
    torch.testing.assert_close(loss2, loss, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flash", [True, False])
def test_recompute_replays_the_same_dropout(flash):
    # attention dropout from an explicit generator under recompute: the
    # replay in the backward must draw what the first run drew (the flash
    # route's seed, the plain route's mask), and the generator must come
    # out where it would without recompute
    rng = np.random.default_rng(3)
    arrays = [rng.normal(size=(2, 16, 2, 64)).astype(np.float32)
              for _ in range(3)]

    def run(use_recompute):
        gen = make_generator(9, "cpu")
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]

        def attn(q, k, v):
            return TF.scaled_dot_product_attention(
                q, k, v, dropout_p=0.3, is_causal=True, generator=gen)

        with flags_scope(use_cuda_flash_attention=flash):
            out = recompute(attn, *ts) if use_recompute else attn(*ts)
            (out * out).sum().backward()
        after = torch.randint(0, 2 ** 30, (4,), generator=gen)
        return out.detach(), [t.grad for t in ts], after

    (o1, g1, a1), (o2, g2, a2) = run(False), run(True)
    torch.testing.assert_close(o2, o1, rtol=0, atol=0)
    for x, y in zip(g2, g1):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    torch.testing.assert_close(a2, a1, rtol=0, atol=0)
