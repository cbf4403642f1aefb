"""The port's ``generate`` for the GPT family (paddle_tpu_torch/models/
generation.py: ``_gpt_decode_params``, ``_gpt_stack``, the tied head)
against the reference's on the CPU, token for token in greedy mode.

The reference's GPT cases of ``tests/test_generation.py`` run through
both packages from the same bridged fp32 weights (drawn with numpy,
normal(0, 0.3), so greedy choices are not near-ties): multi-token decode
with a tied and an untied head, the unsupported-family and
position-table errors in every mode, ``paged=True`` equal to the dense
path (ragged rows too), each ragged row equal to its solo decode (the
learned position row is the LOGICAL position), beam search, and
speculative decoding with a GPT target and a draft of either family
(and a GPT draft for a Llama target). The ticks run through ``Graphed``
(one per call, eagerly on the CPU) as the Llama family's do. Then, within
the port: the cached forward's logits against the full-prefix forward
within 1e-5 (ragged rows at their real tokens), eos, the sampling knobs
as the reference, and sampled dense streams equal to paged ones.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertForPretraining as JBert
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models.generation import generate as jgenerate
from paddle_tpu.models.generation import generate_speculative as jspec

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.models import generation as tgen
from _torch_zoo import one_torch_thread  # noqa: F401

_CFG = dict(vocab_size=89, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _bridge(jm, tm, seed, scale=0.3):
    """Draw every weight with numpy (LayerNorm weights near 1), set it on
    the reference model and bridge it into the port's."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v._value.shape)
        base = 1.0 if ".norm" in k and k.endswith("weight") else 0.0
        state[k] = (base + scale * rng.standard_normal(shape)).astype(
            np.float32)
    jm.set_state_dict(state)
    jm.eval()
    load_paddle_tpu_state(tm, state)
    return jm, tm.eval()


def _gpt_pair(tie=False, seed=4, **kw):
    cfg = dict(_CFG, tie_word_embeddings=tie, **kw)
    return _bridge(JGPT(JGPTConfig.tiny(**cfg)),
                   GPTForCausalLM(GPTConfig.tiny(**cfg), device="cpu"), seed)


def _llama_pair(vocab, seed):
    cfg = dict(vocab_size=vocab, hidden_size=32, intermediate_size=64,
               num_hidden_layers=1, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64)
    return _bridge(JLlama(JLlamaConfig.tiny(**cfg)),
                   LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu"),
                   seed)


@pytest.fixture(scope="module")
def untied():
    return _gpt_pair(tie=False)


@pytest.fixture(scope="module")
def tied():
    return _gpt_pair(tie=True, seed=5)


def _ref(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


def _port(tm, ids, **kw):
    out = tm.generate(ids, **kw)
    assert out.dtype == torch.int64 and out.device.type == "cpu"
    return out.numpy()


def _ids(seed, b, t, vocab=89):
    return np.random.RandomState(seed).randint(1, vocab, (b, t)).astype(
        "int64")


def _ragged(seed, lens=(2, 6, 4), t0=6, pad=0):
    rng = np.random.RandomState(seed)
    singles = [rng.randint(1, 89, (n,)).astype("int64") for n in lens]
    rows = [np.concatenate([np.full(t0 - len(s), pad, "int64"), s])
            for s in singles]
    return np.stack(rows), singles


@pytest.mark.parametrize("head", ["untied", "tied"])
def test_multi_token_matches_reference(head, request):
    jm, tm = request.getfixturevalue(head)
    ids = _ids(2, 2, 6)
    want = _ref(jm, ids, max_new_tokens=6)
    got = _port(tm, ids, max_new_tokens=6)
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 6:].ravel().tolist())) > 2   # not a constant run


@pytest.mark.parametrize("kw", [{}, dict(num_beams=2)], ids=["dense", "beam"])
def test_unsupported_family_rejected(kw):
    ids = np.array([[1, 2]], dtype="int64")
    paddle.seed(4)
    with pytest.raises(TypeError, match="families"):
        jgenerate(JBert(JBertConfig.tiny()), paddle.to_tensor(ids),
                  max_new_tokens=2, **kw)
    with pytest.raises(TypeError, match="families"):
        tgen.generate(torch.nn.Linear(4, 4), ids, max_new_tokens=2, **kw)


@pytest.mark.parametrize("kw", [{}, dict(paged=True, block_size=8),
                                dict(num_beams=2)],
                         ids=["dense", "paged", "beam"])
def test_position_table_overflow_rejected(untied, kw):
    jm, tm = untied
    ids = np.ones((1, 60), dtype="int64")
    with pytest.raises(ValueError, match="position"):
        jm.generate(paddle.to_tensor(ids), max_new_tokens=32, **kw)
    with pytest.raises(ValueError, match="position"):
        tm.generate(ids, max_new_tokens=32, **kw)
    # the last position that fits still decodes
    assert _port(tm, ids, max_new_tokens=4, **kw).shape == (1, 64)


def test_speculative_position_table_overflow_rejected(untied):
    jm, tm = untied
    ids = np.ones((1, 56), dtype="int64")   # 56 + 4 + gamma 4 + 1 > 64
    with pytest.raises(ValueError, match="position"):
        jspec(jm, jm, paddle.to_tensor(ids), max_new_tokens=4, gamma=4)
    with pytest.raises(ValueError, match="position"):
        tgen.generate_speculative(tm, tm, ids, max_new_tokens=4, gamma=4)


@pytest.mark.parametrize("block_size", [4, 8])
@pytest.mark.parametrize("ragged", [False, True])
def test_paged_equals_dense_and_reference(tied, ragged, block_size):
    """Learned positions at the embedding by LOGICAL position while the
    paged program runs without rope: paged = dense = the reference's
    paged, token for token."""
    jm, tm = tied
    ids = _ragged(11)[0] if ragged else _ids(11, 2, 6)
    kw = dict(max_new_tokens=5, pad_token_id=0 if ragged else None)
    dense = _port(tm, ids, **kw)
    paged = _port(tm, ids, paged=True, block_size=block_size, **kw)
    np.testing.assert_array_equal(paged, dense)
    np.testing.assert_array_equal(
        paged, _ref(jm, ids, paged=True, block_size=block_size, **kw))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_ragged_rows_match_their_solo_decode(untied, paged):
    jm, tm = untied
    batch, singles = _ragged(10)
    kw = dict(paged=True, block_size=4) if paged else {}
    out = _port(tm, batch, max_new_tokens=5, pad_token_id=0, **kw)
    np.testing.assert_array_equal(
        out, _ref(jm, batch, max_new_tokens=5, pad_token_id=0, **kw))
    for r, s in enumerate(singles):
        solo = _port(tm, s[None], max_new_tokens=5, **kw)
        np.testing.assert_array_equal(out[r, 6:], solo[0, len(s):])


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=3, num_beams=2),
    dict(max_new_tokens=6, num_beams=3, length_penalty=0.8),
    dict(max_new_tokens=6, num_beams=4, eos_token_id="greedy")],
    ids=["reference_case", "length_penalty", "eos"])
@pytest.mark.parametrize("head", ["untied", "tied"])
def test_beam_search_matches_reference(head, kw, request):
    jm, tm = request.getfixturevalue(head)
    ids = _ids(17, 2, 4)
    kw = dict(kw)
    if kw.get("eos_token_id") == "greedy":
        kw["eos_token_id"] = int(_port(tm, ids, max_new_tokens=3)[0, 6])
    np.testing.assert_array_equal(_port(tm, ids, **kw), _ref(jm, ids, **kw))


@pytest.mark.parametrize("draft_family", ["llama", "gpt"])
def test_speculative_gpt_target(draft_family):
    """The acceptance rule is family-agnostic: a draft of either family
    proposing for a GPT target (same vocab) gives exactly the target's
    greedy output, in both packages (``tests/test_generation.py``'s
    cross-family case)."""
    jt, tt = _gpt_pair(vocab_size=97, seed=21)
    if draft_family == "llama":
        jd, td = _llama_pair(97, 22)
    else:
        jd, td = _gpt_pair(vocab_size=97, seed=22, num_hidden_layers=1)
    ids = _ids(56, 1, 5, vocab=97)
    want = _ref(jt, ids, max_new_tokens=8)
    ref = np.asarray(jspec(jt, jd, paddle.to_tensor(ids), max_new_tokens=8,
                           gamma=3).numpy())
    got = tgen.generate_speculative(tt, td, ids, max_new_tokens=8,
                                    gamma=3).numpy()
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got, want)


def test_speculative_gpt_draft_for_a_llama_target():
    jt, tt = _llama_pair(97, 23)
    jd, td = _gpt_pair(vocab_size=97, seed=24, num_hidden_layers=1)
    ids = _ids(57, 1, 5, vocab=97)
    want = _port(tt, ids, max_new_tokens=8)
    np.testing.assert_array_equal(want, _ref(jt, ids, max_new_tokens=8))
    got = tgen.generate_speculative(tt, td, ids, max_new_tokens=8, gamma=4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [{}, dict(pad_token_id=0),
                                dict(paged=True, block_size=4),
                                dict(do_sample=True, seed=3)],
                         ids=["dense", "ragged", "paged", "sampled"])
def test_ticks_run_through_one_graph_per_call(tied, kw, monkeypatch):
    jm, tm = tied
    ids = _ragged(31)[0] if "pad_token_id" in kw else _ids(31, 2, 6)
    made = []
    real = tgen.Graphed

    def counting(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(tgen, "Graphed", counting)
    got = _port(tm, ids, max_new_tokens=10, **kw)
    assert len(made) == 1 and made[0].calls == 9
    assert made[0].name == ("generate.paged" if kw.get("paged")
                            else "generate.dense")
    if not kw.get("do_sample"):
        np.testing.assert_array_equal(got, _ref(jm, ids, max_new_tokens=10,
                                                **kw))


@pytest.mark.parametrize("ragged", [False, True])
def test_cached_logits_match_full_prefix_forward(tied, ragged):
    """Teacher-forced: the prefill and each cached one-token forward give
    the logits of the port's own full-prefix forward within 1e-5 (a wrong
    position row, mask or cache slot moves them by O(1)); a left-padded
    row's logits are those of its real tokens alone."""
    _, tm = tied
    if ragged:
        ids, singles = _ragged(0)
        pads = torch.tensor([6 - len(s) for s in singles])
    else:
        ids, pads = _ids(0, 3, 6), None
    ids = torch.from_numpy(ids)
    n_new = 6
    seq = torch.cat([ids, torch.from_numpy(_ids(1, 3, n_new))], dim=1)
    p = tgen._decode_family(tm)
    assert p["family"] == "gpt" and p["tied_head"] and "head" not in p
    s_max = 6 + n_new
    caches = tgen._new_caches(p, 3, s_max, "cpu")
    with torch.no_grad():
        hid = tgen._cached_forward(p, ids, caches, 0, s_max, pads=pads)
        for i in range(n_new):
            for r in range(3):
                start = 0 if pads is None else int(pads[r])
                full = tm(seq[r:r + 1, start:6 + i])[0, -1]
                err = (tgen._head_logits(p, hid[r]) - full).abs().max()
                assert float(err) <= 1e-5, (i, r, float(err))
            hid = tgen._cached_forward(p, seq[:, 6 + i:7 + i], caches, 6 + i,
                                       s_max, pads=pads)


@pytest.mark.parametrize("kw", [
    dict(eos_token_id="greedy"), dict(repetition_penalty=1.8),
    dict(repetition_penalty=0.7, pad_token_id=0),
    dict(min_length=4, eos_token_id="greedy"),
    dict(paged=True, eos_token_id="greedy")],
    ids=["eos", "repetition", "repetition_ragged", "min_length",
         "paged_eos"])
def test_knobs_match_reference(untied, kw):
    jm, tm = untied
    kw = dict(kw)
    ids = _ragged(12)[0] if "pad_token_id" in kw else _ids(12, 2, 6)
    if kw.get("eos_token_id") == "greedy":
        kw["eos_token_id"] = int(_port(tm, ids, max_new_tokens=3)[0, 7])
    np.testing.assert_array_equal(_port(tm, ids, max_new_tokens=8, **kw),
                                  _ref(jm, ids, max_new_tokens=8, **kw))


def test_sampled_streams_within_the_port(untied):
    """Sampled GPT streams (the port's own Gumbel draws): one seed twice
    equal, dense equal to paged, ``top_k=1`` equal to greedy."""
    _, tm = untied
    ids, _ = _ragged(13)
    kw = dict(max_new_tokens=8, pad_token_id=0, do_sample=True, top_k=20,
              top_p=0.9, temperature=1.3, seed=5)
    a = _port(tm, ids, **kw)
    np.testing.assert_array_equal(a, _port(tm, ids, **kw))
    np.testing.assert_array_equal(a, _port(tm, ids, paged=True,
                                           block_size=4, **kw))
    assert not np.array_equal(a, _port(tm, ids, **dict(kw, seed=6)))
    np.testing.assert_array_equal(
        _port(tm, ids, **dict(kw, top_k=1)),
        _port(tm, ids, max_new_tokens=8, pad_token_id=0))
