"""The port's training step with the usual LLM recipe against the
reference package's, on the CPU: the tiny Llama from the same weights
and batch, ``AdamW`` over a warm-up then cosine schedule
(``LinearWarmup(CosineAnnealingDecay)``, stepped by the caller), a
global-norm clip that binds every step (``ClipGradByGlobalNorm``), and
no decay on the RMSNorm weights (``apply_decay_param_fun`` on the
parameters' names: ``p.name`` in the reference, ``named_parameters()``
pairs in the port). One case also runs the kernel-gated configuration of
test_torch_train_kernels.py with the reference's Pallas kernels
interpreted. Tolerances and the coverage rule are test_torch_train.py's.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

from test_torch_train import _batch, _check
from test_torch_train_kernels import GATED

CLIP = 0.5
PEAK_LR = 1e-3


def _recipe(opt_mod, lr_mod, nn_mod, params, steps):
    sched = lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(PEAK_LR, T_max=steps), warmup_steps=2,
        start_lr=1e-4, end_lr=PEAK_LR)
    return opt_mod.AdamW(
        learning_rate=sched, parameters=params, weight_decay=0.1,
        grad_clip=nn_mod.ClipGradByGlobalNorm(CLIP),
        apply_decay_param_fun=lambda n: not n.endswith("norm.weight"))


def _train_recipe(kw, seq, steps):
    """Both packages, ``steps`` recipe steps on one batch, recorded as
    test_torch_train._train records them (gradients before the clip), and
    each parameter's gradient again after ``step()``."""
    paddle.seed(7)
    jm = JLlama(JConfig.tiny(**kw))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v._value)
                               for k, v in jm.state_dict().items()})
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    jparams = dict(jm.named_parameters())
    tparams = dict(tm.named_parameters())
    for n, p in jparams.items():
        p.name = n

    def t_np(name, t):
        a = t.detach().numpy().copy()
        return a.T if name.rsplit(".", 1)[0] in linear else a

    jo = _recipe(jopt, jopt.lr, jnn, list(jparams.values()), steps)
    to = _recipe(topt, topt.lr, tnn, list(tparams.items()), steps)
    ids, labels = _batch(seq)
    out = dict(jl=[], tl=[], jg=[], tg=[], lr=[], jg_after=[], tg_after=[])
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
        out["lr"].append((jo.get_lr(), to.get_lr()))
        for o in (jo, to):
            o.step()
        # the clip scaled copies: after the step p.grad is still unclipped
        out["jg_after"].append({n: np.asarray(p.grad._value)
                                for n, p in jparams.items()})
        out["tg_after"].append({n: t_np(n, p.grad)
                                for n, p in tparams.items()})
        for o in (jo, to):
            o.clear_grad()
            o._learning_rate.step()
    out["jp"] = {n: np.asarray(p._value) for n, p in jparams.items()}
    out["tp"] = {n: t_np(n, p) for n, p in tparams.items()}
    return out


def _check_recipe(r):
    _check(r)
    assert all(j == t for j, t in r["lr"])
    assert len({j for j, _ in r["lr"]}) == len(r["lr"])    # the rate moved
    for pkg in "jt":           # both leave the parameters' gradients alone
        for after, before in zip(r[pkg + "g_after"], r[pkg + "g"]):
            assert all(np.array_equal(after[n], before[n]) for n in before)
    for grads in r["tg"]:      # the clip binds every step
        total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                            for g in grads.values()))
        assert total > 2 * CLIP, total


@pytest.mark.parametrize("kw", [dict(), dict(fused_lm_head_ce=False)],
                         ids=["fused_ce", "unfused_ce"])
def test_tiny_llama_recipe_trains_like_reference(kw):
    _check_recipe(_train_recipe(kw, seq=16, steps=4))


def test_kernel_gated_recipe_matches_interpreted_pallas():
    prev = jflags.get_flag("pallas_force_interpret")
    jflags.set_flags({"pallas_force_interpret": True})
    try:
        r = _train_recipe(GATED, seq=128, steps=2)
    finally:
        jflags.set_flags({"pallas_force_interpret": prev})
    _check_recipe(r)
