"""Beam search and speculative decoding in the port's ``generate`` against
the reference's, on the CPU in fp32, token for token.

- Beam search (``num_beams`` 2 and 3, eos with its frozen continuation,
  GNMT ``length_penalty``) equals the reference's; one beam equals greedy.
- Ties: ``lax.top_k`` puts the lower index first and ``torch.topk``
  documents no order, so the port selects with a stable descending sort
  (``_topk``, IEEE total order, so -0.0 below +0.0 as in ``lax.top_k``).
  It is held against ``lax.top_k`` on rows of ties, signed zeros and
  ``-inf``, and end to end on a model whose head gives two tokens equal
  logits at every step.
- ``generate_speculative`` equals the reference's and the port's own
  greedy decode at ``gamma`` 1, 2 and 4, with a weak and a perfect draft,
  with eos and past a short horizon; its argument errors are the
  reference's; and the draft's extra forward of ``d_gamma`` leaves no
  hole in the draft's cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models.generation import generate_speculative as jspec

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import generation as tgen

_TINY = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)
#: tests/test_generation.py's draft: other weights, low acceptance
_DRAFT = dict(vocab_size=97, hidden_size=16, intermediate_size=32,
              num_hidden_layers=1, num_attention_heads=2,
              num_key_value_heads=2, max_position_embeddings=64)


def _pair(cfg, seed, edit=None):
    """A reference Llama from ``seed`` (its state passed through ``edit``)
    and the port's on the same weights."""
    paddle.seed(seed)
    jm = JLlama(JConfig.tiny(**cfg))
    jm.eval()
    state = {k: np.array(v._value) for k, v in jm.state_dict().items()}
    if edit is not None:
        edit(state)
        for k, v in jm.state_dict().items():
            v.set_value(state[k])
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu").eval()
    load_paddle_tpu_state(tm, state)
    return jm, tm


@pytest.fixture(scope="module")
def target():
    return _pair(_TINY, 3)


@pytest.fixture(scope="module")
def draft():
    return _pair(_DRAFT, 77)


def _ids(seed, b, t):
    return np.random.RandomState(seed).randint(1, 97, (b, t)).astype("int64")


@pytest.mark.parametrize("kw", [dict(num_beams=2), dict(num_beams=3),
                                dict(num_beams=3, eos="first"),
                                dict(num_beams=3, eos="first",
                                     length_penalty=1.0),
                                dict(num_beams=2, eos="third",
                                     length_penalty=0.6)],
                         ids=["K2", "K3", "K3-eos", "K3-eos-lp1.0",
                              "K2-eos-lp0.6"])
def test_beam_matches_reference(target, kw):
    jm, tm = target
    ids = _ids(13, 2, 5)
    kw = dict(kw)
    where = kw.pop("eos", None)
    if where is not None:
        greedy = tm.generate(ids, max_new_tokens=3).numpy()
        kw["eos_token_id"] = int(greedy[0, 5 if where == "first" else 7])
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=6, **kw).numpy()
    np.testing.assert_array_equal(
        tm.generate(ids, max_new_tokens=6, **kw).numpy(), want)


def test_one_beam_equals_greedy(target):
    _, tm = target
    ids = _ids(14, 2, 4)
    beam = tgen._generate_beam(tm, torch.as_tensor(ids), max_new_tokens=5,
                               num_beams=1, eos_token_id=None)
    np.testing.assert_array_equal(
        beam.numpy(), tm.generate(ids, max_new_tokens=5).numpy())


def test_topk_breaks_ties_as_lax_top_k():
    rng = np.random.RandomState(0)
    x = np.round(rng.randn(6, 40), 0).astype(np.float32)   # many ties
    x[0] = 1.0                                             # all tied
    x[1, 5:] = -np.inf                                     # finished beam
    x[2, ::3] = -np.inf
    for k in (1, 3, 7, 40):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = tgen._topk(torch.as_tensor(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_beam_with_tied_tokens_matches_reference():
    """Tokens 5 and 6 share one (scaled-up) head row, so every beam's two
    best candidates tie at every step: which one survives, and so every
    later token, depends on the tie order."""
    def tie(state):
        head = state["lm_head.weight"]          # reference layout [H, V]
        head[:, 5] = head[:, 5] * 6.0
        head[:, 6] = head[:, 5]

    jm, tm = _pair(_TINY, 3, tie)
    ids = _ids(17, 2, 5)
    for k in (2, 3):
        want = jm.generate(paddle.to_tensor(ids), max_new_tokens=5,
                           num_beams=k).numpy()
        got = tm.generate(ids, max_new_tokens=5, num_beams=k).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.isin(got[:, 5:], (5, 6)).any()


@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_speculative_matches_reference_and_greedy(target, draft, gamma):
    jm, tm = target
    jd, td = draft
    ids = _ids(50, 1, 6)
    want = jspec(jm, jd, paddle.to_tensor(ids), max_new_tokens=9,
                 gamma=gamma).numpy()
    got = tgen.generate_speculative(tm, td, ids, max_new_tokens=9,
                                    gamma=gamma).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tm.generate(ids, max_new_tokens=9).numpy())


def test_speculative_with_a_perfect_draft(target):
    """draft == target: every draft token is accepted (the all-accept and
    bonus-token path)."""
    _, tm = target
    ids = _ids(51, 1, 5)
    np.testing.assert_array_equal(
        tgen.generate_speculative(tm, tm, ids, max_new_tokens=8,
                                  gamma=4).numpy(),
        tm.generate(ids, max_new_tokens=8).numpy())


def test_speculative_eos_and_short_horizon(target, draft):
    jm, tm = target
    jd, td = draft
    ids = _ids(52, 1, 4)
    eos = int(tm.generate(ids, max_new_tokens=3).numpy()[0, 6])
    want = jspec(jm, jd, paddle.to_tensor(ids), max_new_tokens=7, gamma=3,
                 eos_token_id=eos).numpy()
    got = tgen.generate_speculative(tm, td, ids, max_new_tokens=7, gamma=3,
                                    eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tm.generate(ids, max_new_tokens=7, eos_token_id=eos).numpy())
    # max_new < gamma: the overshooting round is clipped
    np.testing.assert_array_equal(
        tgen.generate_speculative(tm, td, ids, max_new_tokens=2,
                                  gamma=5).numpy(),
        tm.generate(ids, max_new_tokens=2).numpy())
    np.testing.assert_array_equal(
        tgen.generate_speculative(tm, td, ids, max_new_tokens=0).numpy(),
        ids)


@pytest.mark.parametrize("case", ["batch2", "gamma0", "vocab"])
def test_speculative_argument_errors(target, draft, case):
    jm, tm = target
    jd, td = draft
    ids, kw = _ids(53, 1, 4), {}
    if case == "batch2":
        ids = _ids(53, 2, 4)
    elif case == "gamma0":
        kw = dict(gamma=0)
    else:
        jd, td = _pair(dict(_DRAFT, vocab_size=50), 78)
    with pytest.raises(ValueError):
        jspec(jm, jd, paddle.to_tensor(ids), max_new_tokens=2, **kw)
    with pytest.raises(ValueError):
        tgen.generate_speculative(tm, td, ids, max_new_tokens=2, **kw)


def test_speculative_non_llama_draft_raises_type_error(target):
    _, tm = target
    with pytest.raises(TypeError):
        tgen.generate_speculative(tm, torch.nn.Linear(4, 4),
                                  _ids(54, 1, 4), max_new_tokens=2)


@pytest.mark.parametrize("extra_forward", [True, False])
def test_draft_cache_hole(draft, extra_forward):
    """One draft phase of ``gamma`` tokens writes k/v for [pending,
    d_1..d_{gamma-1}] only; a fully accepted round then moves past slot
    P+gamma, so ``generate_speculative`` forwards d_gamma too. With that
    forward the slot is written; without it (the broken variant) it stays
    zero."""
    _, td = draft
    p = tgen._llama_decode_params(td)
    t0, gamma, s_max = 5, 3, 15
    caches = tgen._new_caches(p, 1, s_max, "cpu")
    ids = torch.as_tensor(_ids(55, 1, t0))
    with torch.no_grad():
        tok = torch.argmax(tgen._head_logits(
            p, tgen._cached_forward(p, ids, caches, 0, s_max)), dim=-1)
        for i in range(gamma):
            tok = torch.argmax(tgen._head_logits(p, tgen._cached_forward(
                p, tok[:, None], caches, t0 + i, s_max)), dim=-1)
        if extra_forward:
            tgen._cached_forward(p, tok[:, None], caches, t0 + gamma, s_max)
    written = caches[0][0][0, t0 + gamma].abs().sum().item() > 0
    assert written == extra_forward
