"""Beam search and speculative decoding as captured device steps, on the
CPU in fp32.

A beam tick and a speculative round must read nothing from the host, or
a CUDA graph could not replay them. ``host_read_guard`` is a
``TorchFunctionMode`` that raises on ``Tensor.item``, ``__bool__``,
``__int__``, ``__index__``, ``tolist`` and ``numpy`` while
``jit.is_capturing()``: on the CPU a ``Graphed`` call's first run is
under ``is_capturing``, so the whole tick (or round) body runs under the
guard once. Under it:

- beam search (``num_beams`` 2 and 3, with eos and ``length_penalty``,
  Llama and ERNIE-MoE) equals the reference token for token, every tick
  after the prefill going through one ``Graphed`` of site
  ``generate.beam``;
- ``generate_speculative`` (``gamma`` 1, 2 and 4; a weak and a perfect
  draft; with eos) equals the reference's and the port's greedy decode,
  every round going through one ``Graphed`` of site
  ``generate.speculative``; the counters ``generate.speculative_rounds``
  and ``generate.speculative_accepted`` equal what an eager Python loop
  over rounds counts (``_eager_rounds``, the loop the port ran before
  its rounds were captured, with its host read a round).
"""
import contextlib

import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401
from torch.overrides import TorchFunctionMode

import paddle_tpu as paddle
from paddle_tpu.models import ErnieMoeConfig as JMoeConfig
from paddle_tpu.models import ErnieMoeForCausalLM as JMoe
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models.generation import generate_speculative as jspec

from paddle_tpu_torch import jit, load_paddle_tpu_state
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import (ErnieMoeConfig, ErnieMoeForCausalLM,
                                     LlamaConfig, LlamaForCausalLM)
from paddle_tpu_torch.models import generation as tgen

_TINY = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)
_DRAFT = dict(vocab_size=97, hidden_size=16, intermediate_size=32,
              num_hidden_layers=1, num_attention_heads=2,
              num_key_value_heads=2, max_position_embeddings=64)

_HOST_READS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__int__,
               torch.Tensor.__index__, torch.Tensor.tolist,
               torch.Tensor.numpy}


class _HostReadGuard(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if jit.is_capturing() and func in _HOST_READS:
            raise AssertionError(
                f"{func.__name__} read a device value on the host inside a "
                f"captured step")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def host_read_guard(monkeypatch):
    """The guard above, and the ``Graphed`` objects made inside it (each
    with its site name and call count)."""
    made = []
    real = tgen.Graphed

    def recording(fn, device, **kw):
        g = real(fn, device, **kw)
        made.append(g)
        return g

    monkeypatch.setattr(tgen, "Graphed", recording)
    with _HostReadGuard():
        yield made
    monkeypatch.setattr(tgen, "Graphed", real)


def _llama_pair(cfg, seed):
    paddle.seed(seed)
    jm = JLlama(JConfig.tiny(**cfg))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu").eval()
    load_paddle_tpu_state(
        tm, {k: np.array(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def target():
    return _llama_pair(_TINY, 3)


@pytest.fixture(scope="module")
def draft():
    return _llama_pair(_DRAFT, 77)


def _ids(seed, b, t):
    return np.random.RandomState(seed).randint(1, 97, (b, t)).astype("int64")


def test_guard_catches_a_host_read(monkeypatch):
    t = torch.ones(1)
    with host_read_guard(monkeypatch):
        g = jit._capture.Graphed(lambda: int(t), "cpu")
        with pytest.raises(AssertionError, match="__int__"):
            g()
        int(t)                               # outside a capture: allowed


@pytest.mark.parametrize("kw", [dict(num_beams=2), dict(num_beams=3),
                                dict(num_beams=3, eos="first",
                                     length_penalty=1.0),
                                dict(num_beams=2, eos="third",
                                     length_penalty=0.6)],
                         ids=["K2", "K3", "K3-eos-lp1.0", "K2-eos-lp0.6"])
def test_beam_tick_reads_nothing_from_the_host(target, monkeypatch, kw):
    jm, tm = target
    ids = _ids(13, 2, 5)
    kw = dict(kw)
    where = kw.pop("eos", None)
    if where is not None:
        greedy = tm.generate(ids, max_new_tokens=3).numpy()
        kw["eos_token_id"] = int(greedy[0, 5 if where == "first" else 7])
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=7, **kw).numpy()
    with host_read_guard(monkeypatch) as made:
        got = tm.generate(ids, max_new_tokens=7, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert [(g.name, g.calls) for g in made] == [("generate.beam", 6)]


def test_moe_beam_tick_reads_nothing_from_the_host(monkeypatch):
    paddle.seed(11)
    jm = JMoe(JMoeConfig.tiny())
    tm = ErnieMoeForCausalLM(ErnieMoeConfig.tiny(), device="cpu")
    load_paddle_tpu_state(
        tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    for m in (jm, tm):
        m.eval()
        for layer in m.model.layers:
            if layer.is_moe:
                layer.mlp.gate._random2 = False
    ids = np.random.default_rng(3).integers(1, 256, (2, 5))
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=6,
                                  num_beams=3).numpy())
    with host_read_guard(monkeypatch) as made:
        got = tm.generate(ids, max_new_tokens=6, num_beams=3).numpy()
    np.testing.assert_array_equal(got, want)
    assert [(g.name, g.calls) for g in made] == [("generate.beam", 5)]


def _eager_rounds(model, draft_model, ids, max_new_tokens, gamma):
    """Speculative decoding as an eager Python loop over rounds, reading
    the accepted count to the host each round: (new tokens, rounds,
    accepted drafts)."""
    pt, pd = tgen._decode_family(model), tgen._decode_family(draft_model)
    ids = torch.as_tensor(ids)
    t0 = ids.shape[1]
    cap = max_new_tokens + gamma + 1
    s_max = t0 + cap

    def greedy(p, hidden):
        return torch.argmax(tgen._head_logits(p, hidden), dim=-1)

    ct, cd = tgen._new_caches(pt, 1, s_max, "cpu"), tgen._new_caches(
        pd, 1, s_max, "cpu")
    pending = greedy(pt, tgen._cached_forward(pt, ids, ct, 0, s_max))
    tgen._cached_forward(pd, ids, cd, 0, s_max)
    out, rounds, accepted = [], 0, 0
    while len(out) < max_new_tokens:
        pos = t0 + len(out)
        drafts, tok = [], pending
        for i in range(gamma):
            tok = greedy(pd, tgen._cached_forward(pd, tok[:, None], cd,
                                                  pos + i, s_max))
            drafts.append(tok)
        tgen._cached_forward(pd, tok[:, None], cd, pos + gamma, s_max)
        window = torch.cat([pending] + drafts)[None, :]
        preds = greedy(pt, tgen._cached_forward(pt, window, ct, pos, s_max,
                                                return_all=True)[0])
        a = 0
        while a < gamma and int(preds[a]) == int(window[0, a + 1]):
            a += 1
        out += window[0, :a + 1].tolist()
        pending = preds[a:a + 1]
        rounds, accepted = rounds + 1, accepted + a
    return out[:max_new_tokens], rounds, accepted


@pytest.mark.parametrize("gamma", [1, 2, 4])
@pytest.mark.parametrize("which", ["weak", "perfect"])
def test_speculative_round_reads_nothing_from_the_host(target, draft,
                                                       monkeypatch, gamma,
                                                       which):
    jm, tm = target
    jd, td = draft if which == "weak" else target
    ids = _ids(50, 1, 6)
    n = 11
    want = jspec(jm, jd, paddle.to_tensor(ids), max_new_tokens=n,
                 gamma=gamma).numpy()
    rounds = obs.registry.get("generate.speculative_rounds")
    accepted = obs.registry.get("generate.speculative_accepted")
    r0, a0 = rounds.total(), accepted.total()
    with host_read_guard(monkeypatch) as made:
        got = tgen.generate_speculative(tm, td, ids, max_new_tokens=n,
                                        gamma=gamma).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tm.generate(ids, max_new_tokens=n).numpy())
    toks, n_rounds, n_accepted = _eager_rounds(tm, td, ids, n, gamma)
    np.testing.assert_array_equal(got[0, 6:], toks)
    assert rounds.total() - r0 == n_rounds
    assert accepted.total() - a0 == n_accepted
    assert [(g.name, g.calls) for g in made] == [
        ("generate.speculative", n_rounds)]
    if which == "perfect":
        assert n_accepted == gamma * n_rounds
    else:
        assert n_accepted < gamma * n_rounds


def test_speculative_with_eos_under_the_guard(target, draft, monkeypatch):
    jm, tm = target
    jd, td = draft
    ids = _ids(51, 1, 5)
    greedy = tm.generate(ids, max_new_tokens=8).numpy()
    eos = int(greedy[0, 8])
    want = jspec(jm, jd, paddle.to_tensor(ids), max_new_tokens=8, gamma=2,
                 eos_token_id=eos).numpy()
    with host_read_guard(monkeypatch):
        got = tgen.generate_speculative(tm, td, ids, max_new_tokens=8,
                                        gamma=2, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 9:] == eos).all()
