"""The port's ``generate()`` (paddle_tpu_torch/models/generation.py), dense
KV-cache path, against the reference's on the CPU.

Both packages decode the same bridged fp32 weights (the tiny Llama of
tests/test_generation.py) from the same numpy prompts, and every
comparison is token for token: greedy (MHA and GQA, batch 1 and 2), the
eos tail, left-padded rows (against the reference and against each row's
solo decode), ``repetition_penalty`` and ``min_length``. Every argument
error raises the reference's exception type; a non-Llama model raises
``TypeError``. The cached forward's logits are held within 1e-5 of the
port's own full-prefix forward at every step.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertForPretraining as JBert
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models.generation import generate as jgenerate

import paddle_tpu_torch.models as tmodels
from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import generation as tgen

_TINY = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=64)


def _pair(kv_heads):
    """The reference's tiny Llama (tests/test_generation.py's seed) and the
    port's on its weights, fp32 on the CPU."""
    paddle.seed(3)
    jm = JLlama(JConfig.tiny(num_key_value_heads=kv_heads, **_TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=kv_heads,
                                           **_TINY), device="cpu").eval()
    load_paddle_tpu_state(
        tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def gqa():
    return _pair(2)


@pytest.fixture(scope="module")
def mha():
    return _pair(4)


def _ref(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


def _port(tm, ids, **kw):
    out = tm.generate(ids, **kw)
    assert out.dtype == torch.int64 and out.device.type == "cpu"
    return out.numpy()


def _ids(seed, b, t):
    return np.random.RandomState(seed).randint(1, 97, (b, t)).astype("int64")


def _ragged(seed, lens=(4, 7, 2), t0=7, pad=0):
    rng = np.random.RandomState(seed)
    singles = [rng.randint(1, 97, (n,)).astype("int64") for n in lens]
    rows = [np.concatenate([np.full(t0 - len(s), pad, "int64"), s])
            for s in singles]
    return np.stack(rows), singles


@pytest.mark.parametrize("heads,batch", [("mha", 1), ("mha", 2),
                                         ("gqa", 1), ("gqa", 2)])
def test_greedy_matches_reference(heads, batch, request):
    jm, tm = request.getfixturevalue(heads)
    ids = _ids(batch, batch, 7)
    want = _ref(jm, ids, max_new_tokens=9)
    np.testing.assert_array_equal(_port(tm, ids, max_new_tokens=9), want)
    # the module function and the method are one path
    np.testing.assert_array_equal(
        tmodels.generate(tm, torch.as_tensor(ids), max_new_tokens=9).numpy(),
        want)


@pytest.mark.parametrize("kind", ["numpy", "list", "tensor"])
def test_prompt_forms_zero_new_tokens_and_prompt_kept(gqa, kind):
    _, tm = gqa
    ids = _ids(11, 2, 5)
    given = {"numpy": ids, "list": ids.tolist(),
             "tensor": torch.as_tensor(ids, dtype=torch.int32)}[kind]
    np.testing.assert_array_equal(_port(tm, given, max_new_tokens=0), ids)
    out = _port(tm, given, max_new_tokens=4)
    assert out.shape == (2, 9)
    np.testing.assert_array_equal(out[:, :5], ids)


def test_eos_fills_the_tail(gqa):
    jm, tm = gqa
    ids = _ids(12, 2, 6)
    greedy = _ref(jm, ids, max_new_tokens=8)
    eos = int(greedy[0, 8])          # row 0 emits it at its third token
    want = _ref(jm, ids, max_new_tokens=8, eos_token_id=eos)
    got = _port(tm, ids, max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[0, 6:] == eos))
    assert (got[0, 6 + first:] == eos).all() and first < 7


def test_left_padded_rows_match_reference_and_solo_decode(gqa):
    jm, tm = gqa
    batch, singles = _ragged(5)
    got = _port(tm, batch, max_new_tokens=6, pad_token_id=0)
    np.testing.assert_array_equal(
        got, _ref(jm, batch, max_new_tokens=6, pad_token_id=0))
    for i, real in enumerate(singles):
        solo = _port(tm, real[None, :], max_new_tokens=6)[0]
        np.testing.assert_array_equal(got[i, 7:], solo[len(real):],
                                      err_msg=f"row {i}")


def test_pad_id_on_an_unpadded_batch_is_a_no_op(gqa):
    _, tm = gqa
    ids = _ids(6, 2, 5)
    np.testing.assert_array_equal(
        _port(tm, ids, max_new_tokens=4, pad_token_id=0),
        _port(tm, ids, max_new_tokens=4))


@pytest.mark.parametrize("kw", [
    dict(repetition_penalty=1.8),
    dict(repetition_penalty=0.6),
    dict(repetition_penalty=1.8, pad_token_id=0),
    dict(min_length=5),
    dict(min_length=5, repetition_penalty=1.3, pad_token_id=0),
], ids=["rep1.8", "rep0.6", "rep-ragged", "min_length", "both-ragged"])
def test_penalty_and_min_length_match_reference(gqa, kw):
    jm, tm = gqa
    batch, _ = _ragged(7, lens=(5, 3), t0=5)
    eos = int(_ref(jm, batch, max_new_tokens=1)[1, 5])   # row 1's first token
    kw = dict(kw, max_new_tokens=8, eos_token_id=eos)
    want = _ref(jm, batch, **kw)
    np.testing.assert_array_equal(_port(tm, batch, **kw), want)
    if "min_length" in kw:
        assert not (want[:, 5:10] == eos).any()


_PADDED = np.array([[0, 0, 3, 4], [5, 6, 7, 8]])

#: (ids, generate keywords, the exception both packages raise), in the
#: order of the reference's checks (generation.py:515-582)
_ERRORS = [
    (np.array([1, 2, 3]), {}, ValueError),
    (np.array([[0, 5, 0, 0], [1, 2, 3, 4]]), dict(pad_token_id=0),
     ValueError),                                   # right padding
    (np.array([[0, 0, 0], [1, 2, 3]]), dict(pad_token_id=0), ValueError),
    (_PADDED, dict(repetition_penalty=0.0), ValueError),
    (_PADDED, dict(length_penalty=1.0), ValueError),
    (_PADDED, dict(num_blocks=8), ValueError),
    (_PADDED, dict(num_blocks=8, num_beams=2), ValueError),
    (_PADDED, dict(num_beams=2, do_sample=True), ValueError),
    (_PADDED, dict(num_beams=2, paged=True), NotImplementedError),
    (_PADDED, dict(num_beams=2, pad_token_id=0), NotImplementedError),
    (_PADDED, dict(num_beams=2, repetition_penalty=1.5),
     NotImplementedError),
    (_PADDED, dict(num_beams=2, min_length=2, eos_token_id=1),
     NotImplementedError),
    (_PADDED, dict(paged=True, repetition_penalty=1.5), NotImplementedError),
    (_PADDED, dict(paged=True, min_length=2, eos_token_id=1),
     NotImplementedError),
    (_PADDED, dict(min_length=2), ValueError),
    (_PADDED, dict(num_beams=98), ValueError),       # more beams than vocab
    (_PADDED, dict(paged=True, block_size=4, num_blocks=3), ValueError),
    # two faults: the earlier check decides
    (_PADDED, dict(num_beams=2, do_sample=True, paged=True), ValueError),
    (_PADDED, dict(paged=True, min_length=2), NotImplementedError),
]


@pytest.mark.parametrize("ids,kw,exc", _ERRORS,
                         ids=[f"case{i}" for i in range(len(_ERRORS))])
def test_argument_errors_match_reference(gqa, ids, kw, exc):
    jm, tm = gqa
    with pytest.raises(exc) as ref:
        jm.generate(paddle.to_tensor(ids), max_new_tokens=3, **kw)
    with pytest.raises(exc) as port:
        tm.generate(ids, max_new_tokens=3, **kw)
    assert type(port.value) is type(ref.value)


@pytest.mark.parametrize("kw,exc", [({}, TypeError),
                                    (dict(num_beams=2), TypeError),
                                    (dict(paged=True), NotImplementedError)],
                         ids=["dense", "beam", "paged"])
def test_non_llama_model_raises(kw, exc):
    ids = np.array([[1, 2, 3]])
    paddle.seed(4)
    bert = JBert(JBertConfig.tiny())
    with pytest.raises(exc):
        jgenerate(bert, paddle.to_tensor(ids), max_new_tokens=2, **kw)
    with pytest.raises(exc):
        tgen.generate(torch.nn.Linear(4, 4), ids, max_new_tokens=2, **kw)


@pytest.mark.parametrize("heads", ["mha", "gqa"])
def test_cached_logits_match_full_prefix_forward(heads, request):
    """Teacher-forced: the prefill and then each cached one-token forward
    give the logits of the port's own full-prefix forward within 1e-5 (a
    wrong position, mask or cache slot moves them by O(1))."""
    _, tm = request.getfixturevalue(heads)
    ids = torch.as_tensor(_ids(0, 2, 7))
    n_new = 6
    seq = torch.cat([ids, torch.as_tensor(_ids(1, 2, n_new))], dim=1)
    p = tgen._llama_decode_params(tm)
    s_max = 7 + n_new
    caches = tgen._new_caches(p, 2, s_max, "cpu")
    with torch.no_grad():
        hid = tgen._cached_forward(p, ids, caches, 0, s_max)
        for i in range(n_new):
            full = tm(seq[:, :7 + i])[:, -1, :]
            err = (tgen._head_logits(p, hid) - full).abs().max().item()
            assert err <= 1e-5, (i, err)
            hid = tgen._cached_forward(p, seq[:, 7 + i:8 + i], caches, 7 + i,
                                       s_max)
