"""Sampled decoding in the port's ``generate()`` on the CPU.

The port draws from an explicit ``torch.Generator`` (Gumbel-max over the
filtered logits), which cannot reproduce ``jax.random``: sampled streams
are held within the port. One seed gives one stream; ``top_k=1``, a tiny
``top_p`` and ``top_p=0.0`` equal greedy; the dense and paged paths give
the same stream for one seed (one draw for the first token, then one a
tick, on both). The filter itself, ``_filter_logits``, is held against a
numpy transcription of the reference's (paddle_tpu/models/
generation.py:407-420) over random logits with ties, and every sampled
token lies in the filtered support.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.core.generator import make_generator
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import generation as tgen

_TINY = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(scope="module")
def tm():
    """The port's tiny Llama on the reference's weights (seed 3)."""
    paddle.seed(3)
    jm = JLlama(JConfig.tiny(**_TINY))
    m = LlamaForCausalLM(LlamaConfig.tiny(**_TINY), device="cpu").eval()
    load_paddle_tpu_state(
        m, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return m


def _ids(seed, b=2, t=6):
    return np.random.RandomState(seed).randint(1, 97, (b, t)).astype("int64")


_RAGGED = np.array([[0, 0, 0, 11, 12, 13], [21, 22, 23, 24, 25, 26],
                    [0, 31, 32, 33, 34, 35]])
_KNOBS = dict(do_sample=True, temperature=0.9, top_k=20, top_p=0.9)


@pytest.mark.parametrize("ragged", [False, True], ids=["aligned", "ragged"])
def test_one_seed_one_stream(tm, ragged):
    ids = _RAGGED if ragged else _ids(1)
    kw = dict(max_new_tokens=8, pad_token_id=0 if ragged else None, **_KNOBS)
    a = tm.generate(ids, seed=7, **kw).numpy()
    np.testing.assert_array_equal(a, tm.generate(ids, seed=7, **kw).numpy())
    # another seed may differ; the stream stays in range and keeps the
    # prompt
    b = tm.generate(ids, seed=8, **kw).numpy()
    assert b.shape == a.shape and ((b >= 0) & (b < 97)).all()
    np.testing.assert_array_equal(b[:, :6], ids)


@pytest.mark.parametrize("knob", [dict(top_k=1), dict(top_p=1e-6),
                                  dict(top_p=0.0)],
                         ids=["top_k=1", "top_p=1e-6", "top_p=0"])
def test_narrow_filters_equal_greedy(tm, knob):
    ids = _ids(2)
    greedy = tm.generate(ids, max_new_tokens=8).numpy()
    got = tm.generate(ids, max_new_tokens=8, do_sample=True, temperature=1.3,
                      seed=5, **knob).numpy()
    np.testing.assert_array_equal(got, greedy)


@pytest.mark.parametrize("ragged,block", [(False, 4), (True, 4),
                                          (True, 64)],
                         ids=["aligned-b4", "ragged-b4", "ragged-b64"])
def test_dense_and_paged_sample_the_same_stream(tm, ragged, block):
    ids = _RAGGED if ragged else _ids(3)
    kw = dict(max_new_tokens=9, seed=11, pad_token_id=0 if ragged else None,
              **_KNOBS)
    dense = tm.generate(ids, **kw).numpy()
    paged = tm.generate(ids, paged=True, block_size=block, **kw).numpy()
    np.testing.assert_array_equal(paged, dense)
    assert (dense != tm.generate(ids, max_new_tokens=9).numpy()).any()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_one_draw_for_the_first_token_then_one_a_tick(tm, paged,
                                                      monkeypatch):
    draws = []
    real = tgen._gumbel_argmax
    monkeypatch.setattr(tgen, "_gumbel_argmax",
                        lambda logits, g: draws.append(1) or real(logits, g))
    tm.generate(_ids(4), max_new_tokens=7, paged=paged, block_size=4,
                **_KNOBS)
    assert len(draws) == 7


def _numpy_filter(logits, temperature, top_k, top_p):
    """generation.py:407-420 in numpy, fp32. The reference's
    out-of-range gather (every prefix short of top_p) gives NaN, which
    drops nothing."""
    logits = logits.astype(np.float32) / np.float32(max(temperature, 1e-6))
    v = logits.shape[-1]
    if top_k and 0 < top_k < v:
        kth = np.sort(logits, axis=-1)[:, v - top_k][:, None]
        logits = np.where(logits < kth, np.float32(-1e30), logits)
    if top_p < 1.0:
        sorted_l = np.sort(logits, axis=-1)[:, ::-1]
        e = np.exp(sorted_l - sorted_l[:, :1])
        cum = np.cumsum(e / e.sum(axis=-1, keepdims=True), axis=-1)
        cutoff = (cum < np.float32(top_p)).sum(axis=-1)
        kth = np.where(cutoff < v,
                       sorted_l[np.arange(len(cutoff)),
                                np.minimum(cutoff, v - 1)], np.nan)[:, None]
        logits = np.where(logits < kth, np.float32(-1e30), logits)
    return logits


_FILTERS = [(t, k, p) for t in (1.0, 0.7) for k in (0, 1, 5, 50, 64)
            for p in (0.0, 0.5, 0.9, 1.0)]


@pytest.mark.parametrize("temperature,top_k,top_p", _FILTERS)
def test_filter_matches_numpy_transcription(temperature, top_k, top_p):
    rng = np.random.RandomState(int(temperature * 10) + top_k)
    # one decimal: many ties, at the k-th value and across the top-p cut
    logits = np.round(rng.randn(8, 50) * 2, 1).astype(np.float32)
    want = _numpy_filter(logits, temperature, top_k, top_p)
    got = tgen._filter_logits(torch.as_tensor(logits), temperature, top_k,
                              top_p).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (12, 0.8)])
def test_every_sampled_token_is_in_the_filtered_support(top_k, top_p):
    logits = torch.as_tensor(
        np.random.RandomState(top_k).randn(16, 97).astype(np.float32) * 3)
    support = tgen._filter_logits(logits, 0.8, top_k, top_p) > -1e29
    gen = make_generator(0, "cpu")
    seen = torch.zeros_like(support)
    for _ in range(200):
        tok = tgen._sample_token(logits, gen, do_sample=True,
                                 temperature=0.8, top_k=top_k, top_p=top_p)
        assert support[torch.arange(16), tok].all()
        seen[torch.arange(16), tok] = True
    # more than the best token is drawn where the support allows it
    assert (seen.sum(dim=1) > 1).any()
