"""The port's ERNIE-MoE family (paddle_tpu_torch/models/ernie_moe.py and
the MoE branch of models/generation.py) against the reference's
(paddle_tpu/models/ernie_moe.py, paddle_tpu/models/generation.py) on the
CPU, from the same weights (``load_paddle_tpu_state``) and the same
numpy batches.

- The layer alternation (``is_moe_layer``) and the parameter names.
- Forward logits, the ``labels=`` loss (cross-entropy plus
  ``aux_loss_weight`` times the gates' balance losses) in training and
  eval mode; the aux losses read and cleared by the loss.
- Training, random routing off in both packages: three AdamW steps, the
  losses, the step-1 gradients and the weights; every MoE layer (gelu),
  every second layer with swiglu experts, and ``recompute`` (the MoE
  layers outside the checkpoint, so the router keeps its gradient).
- Random routing within the port: one seed twice bit for bit, another
  seed another loss (the draws are not ``jax.random``'s).
- ``generate``: greedy and beam search token for token, the dense path
  with its captured-tick function; the reference's three refusals
  (ragged prompts, ``paged=True``, ``generate_speculative``) with its
  exception types and messages; sampled streams within the port (one
  seed twice, ``top_k=1`` = greedy).
- The weight bridge (the expert banks and the gate's ``[d, E]`` weight
  copied as they are), and a ``moe_group`` without a mesh keeping the
  index path (``ernie_moe_shard_plan`` and the meshes of two ranks are
  ``test_torch_expert_parallel.py``'s).

fp32 throughout. Tolerances: logits 1e-5 of their max |value|; losses
2e-5 absolute; step-1 gradients 1e-4 of each gradient's max |g|; weights
after three steps 1e-5 absolute where every step's gradient is at least
1e-3 of the parameter's max |g| in both packages, or 0 in both (Adam
divides by |g|; see ``test_torch_bert.py``), covering 70% of the weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import ErnieMoeConfig as JConfig
from paddle_tpu.models import ErnieMoeForCausalLM as JMoe
from paddle_tpu.models.generation import generate as jgenerate
from paddle_tpu.models.generation import generate_speculative as jspec

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.models import (ErnieMoeConfig, ErnieMoeForCausalLM,
                                     ernie_moe_shard_plan)
from paddle_tpu_torch.models import generation as tgen
from _torch_zoo import one_torch_thread  # noqa: F401

LOSS_TOL = 2e-5
REL = 1e-5
GRAD_REL = 1e-4
PARAM_TOL = 1e-5
G_FLOOR = 1e-3
COVERED = 0.7
LR = 1e-3


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _no_random_routing(*models):
    for m in models:
        for layer in m.model.layers:
            if layer.is_moe:
                layer.mlp.gate._random2 = False


def _pair(seed=7, **kw):
    paddle.seed(seed)
    jm = JMoe(JConfig.tiny(**kw))
    tm = ErnieMoeForCausalLM(ErnieMoeConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, _state(jm))
    _no_random_routing(jm, tm)
    return jm, tm


def _batch(seq=16, vocab=256, seed=0, b=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, seq))
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return ids, labels


def test_layer_alternation_and_names():
    cfg = ErnieMoeConfig.tiny(num_hidden_layers=4, moe_layer_interval=2)
    model = ErnieMoeForCausalLM(cfg, device="cpu")
    assert [l.is_moe for l in model.model.layers] == [False, True, False,
                                                     True]
    paddle.seed(0)
    jm = JMoe(JConfig.tiny(num_hidden_layers=4, moe_layer_interval=2))
    assert set(model.state_dict()) == set(_state(jm))
    assert tuple(model.model.layers[1].mlp.gate.weight.shape) == (64, 4)
    assert tuple(model.model.layers[1].mlp.experts.w0.shape) == (4, 64, 128)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_and_aux_loss_match_reference(mode):
    jm, tm = _pair()
    getattr(jm, mode)()
    getattr(tm, mode)()
    ids, labels = _batch()
    want = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())
    jaux, taux = jm.moe_aux_loss(), tm.moe_aux_loss()
    assert abs(taux.item() - float(jaux)) <= LOSS_TOL
    assert tm.moe_aux_loss() is None          # read and cleared
    jl, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    tl, tlogits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert abs(tl.item() - float(jl)) <= LOSS_TOL
    assert tm.moe_aux_loss() is None          # the loss consumed them
    assert tuple(tlogits.shape) == (2, 16, 256)


def _train(kw, steps=3):
    jm, tm = _pair(**kw)
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    jparams = dict(jm.named_parameters())
    tparams = dict(tm.named_parameters())

    def t_np(name, t):
        a = t.detach().numpy()
        return a.T if name.rsplit(".", 1)[0] in linear else a

    jo = jopt.AdamW(learning_rate=LR, parameters=list(jparams.values()))
    to = topt.AdamW(learning_rate=LR, parameters=list(tparams.values()))
    ids, labels = _batch(seq=24, seed=1)
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
    {}, dict(moe_layer_interval=2, moe_activation="swiglu"),
    dict(recompute=True, moe_layer_interval=2)],
    ids=["every_layer_gelu", "swiglu_interval_2", "recompute"])
def test_trains_like_reference(kw):
    r = _train(kw)
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=0, atol=LOSS_TOL)
    assert r["tl"][-1] < r["tl"][0]
    for name, jg in r["jg"][0].items():
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(r["tg"][0][name], jg, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)
        if name.endswith("mlp.gate.weight"):
            assert scale > 0, name            # the router trains
    covered = total = 0
    for name, jp in r["jp"].items():
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


def _loss_and_grads(seed, ids, labels, **kw):
    model = ErnieMoeForCausalLM(ErnieMoeConfig.tiny(**kw), device="cpu",
                                seed=seed)
    loss, _ = model(ids, labels=labels)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_random_routing_and_recompute_within_the_port():
    """GShard's random second expert draws from ``routing_generator``:
    one seed twice is bit for bit, another seed another loss; recompute
    (the dense layers checkpointed, MoE layers outside) gives the same
    loss and gradients, the router's among them."""
    ids, labels = (torch.from_numpy(a) for a in _batch(seq=24, seed=2))
    kw = dict(moe_layer_interval=2, num_hidden_layers=4)
    loss, grads = _loss_and_grads(3, ids, labels, **kw)
    loss2, grads2 = _loss_and_grads(3, ids, labels, **kw)
    loss_rc, grads_rc = _loss_and_grads(3, ids, labels, recompute=True, **kw)
    model = ErnieMoeForCausalLM(ErnieMoeConfig.tiny(**kw), device="cpu",
                                seed=3)
    model.routing_generator.manual_seed(4)
    other, _ = model(ids, labels=labels)
    assert torch.equal(loss, loss2) and torch.equal(loss, loss_rc)
    assert not torch.equal(loss, other.detach())
    for n, g in grads.items():
        assert torch.equal(g, grads2[n]), n
        assert torch.equal(g, grads_rc[n]), n
    assert float(grads_rc["model.layers.1.mlp.gate.weight"].abs().sum()) > 0


@pytest.fixture(scope="module")
def pair():
    jm, tm = _pair(seed=11)
    jm.eval()
    tm.eval()
    return jm, tm


def _ids(seed, b, t0):
    return np.random.default_rng(seed).integers(1, 256, (b, t0))


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=8), dict(max_new_tokens=6, num_beams=3),
    dict(max_new_tokens=6, num_beams=2, length_penalty=1.0,
         eos_token_id=7)],
    ids=["greedy", "beam", "beam_length_penalty"])
def test_generate_matches_reference(pair, kw):
    jm, tm = pair
    ids = _ids(3, 3, 5)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())
    got = tm.generate(ids, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 5 + kw["max_new_tokens"])


def test_generate_ticks_run_through_one_graph_per_call(pair, monkeypatch):
    """The dense tick of an MoE model runs through ``Graphed`` (eagerly on
    the CPU), one per call, and gives the reference's tokens."""
    jm, tm = pair
    made = []
    real = tgen.Graphed

    def counting(*a, **k):
        made.append(k.get("name"))
        return real(*a, **k)

    monkeypatch.setattr(tgen, "Graphed", counting)
    ids = _ids(5, 2, 4)
    got = tm.generate(ids, max_new_tokens=5).numpy()
    assert made == ["generate.dense"]
    np.testing.assert_array_equal(
        got, np.asarray(jm.generate(paddle.to_tensor(ids),
                                    max_new_tokens=5).numpy()))


@pytest.mark.parametrize("case", ["ragged", "paged", "speculative"])
def test_refusals_match_reference(pair, case):
    """The reference's MoE-only refusals, same type, same message."""
    jm, tm = pair
    ids = _ids(6, 2, 5)
    ids[0, :2] = 0                                 # a left-padded row
    x = ids if case == "ragged" else ids[1:]
    kw = dict(max_new_tokens=3)
    if case == "speculative":
        calls = (lambda: jspec(jm, jm, paddle.to_tensor(x), **kw),
                 lambda: tgen.generate_speculative(tm, tm, x, **kw))
    else:
        kw.update(pad_token_id=0) if case == "ragged" else kw.update(
            paged=True)
        calls = (lambda: jgenerate(jm, paddle.to_tensor(x), **kw),
                 lambda: tgen.generate(tm, x, **kw))
    msgs = []
    for call in calls:
        with pytest.raises(NotImplementedError) as err:
            call()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "MoE" in msgs[1]


def test_sampled_streams_within_the_port(pair):
    _, tm = pair
    ids = _ids(8, 2, 5)
    a = tm.generate(ids, max_new_tokens=8, do_sample=True, top_k=20, seed=1)
    b = tm.generate(ids, max_new_tokens=8, do_sample=True, top_k=20, seed=1)
    c = tm.generate(ids, max_new_tokens=8, do_sample=True, top_k=20, seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = tm.generate(ids, max_new_tokens=8)
    assert torch.equal(tm.generate(ids, max_new_tokens=8, do_sample=True,
                                   top_k=1, seed=5), greedy)


def test_state_round_trip_and_shard_plan():
    """Every reference key reaches the port: Linear weights transposed,
    the expert banks ``w0``/``w1`` [E, d, h], their [E, 1, h] biases and
    the gate's raw [d, E] weight as they are."""
    paddle.seed(2)
    cfg = dict(num_hidden_layers=2, moe_layer_interval=2,
               moe_activation="swiglu")
    jm = JMoe(JConfig.tiny(**cfg))
    tm = ErnieMoeForCausalLM(ErnieMoeConfig.tiny(**cfg), device="cpu")
    state = _state(jm)
    load_paddle_tpu_state(tm, state)
    assert set(tm.state_dict()) == set(state)
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in tm.named_parameters():
        a = p.detach().numpy()
        if name.rsplit(".", 1)[0] in linear:
            a = a.T
        np.testing.assert_array_equal(a, state[name], err_msg=name)
    moe = tm.model.layers[1].mlp
    np.testing.assert_array_equal(moe.experts.w0.detach().numpy(),
                                  state["model.layers.1.mlp.experts.w0"])
    np.testing.assert_array_equal(moe.gate.weight.detach().numpy(),
                                  state["model.layers.1.mlp.gate.weight"])
    assert tuple(moe.experts.b0.shape) == (4, 1, 256)
    # a moe_group without a mesh axis and no hybrid group keeps the index
    # path in both packages: the same logits as the reference built with
    # it (the plan and the meshes of two ranks are
    # test_torch_expert_parallel.py's)
    paddle.seed(2)
    jg = JMoe(JConfig.tiny(**cfg), moe_group=object())
    tg = ErnieMoeForCausalLM(ErnieMoeConfig.tiny(**cfg), moe_group=object(),
                             device="cpu")
    load_paddle_tpu_state(tg, _state(jg))
    _no_random_routing(jg, tg)
    assert tg.model.layers[1].mlp._mesh is None
    assert callable(ernie_moe_shard_plan)
    ids, _ = _batch()
    want = jg(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tg(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())
