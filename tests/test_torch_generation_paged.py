"""The port's paged KV-cache decode (``generate(paged=True)``) and its
serving attention ops (paddle_tpu_torch/incubate/nn/functional/
inference_attention.py) against the reference's on the CPU.

- ``generate(paged=True)`` equals the reference's paged decode and the
  port's dense decode token for token in fp32: block edges (prompts of
  block-1, block and block+1 tokens, aligned and ragged), eos, the default
  64-token block; pool exhaustion raises the reference's ``ValueError``;
  the unsupported combinations raise as the reference does.
- Each prefill layer calls the varlen forward once and each tick's layer
  the paged decode once; on the CPU neither reaches a kernel.
- ``block_multihead_attention`` matches the reference's on prefill,
  decode, mixed and GQA batches (outputs and returned caches within 1e-5,
  fp32), with a gap between packed rows and an idle row;
  ``masked_multihead_attention``,
  ``variable_length_memory_efficient_attention``,
  ``fused_dot_product_attention`` and ``blha_get_max_len`` match theirs.

The kernels run their plain versions here (CPU tensors); chip_smoke.py
drives them on the card.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.incubate.nn.functional import _rope_tables
from paddle_tpu_torch.incubate.nn.functional import inference_attention as tia
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import flash_attention_varlen as tfv
from paddle_tpu_torch.ops.cuda import paged_attention as tpa

_TINY = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)
BLOCK = 4


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JLlama(JConfig.tiny(**_TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(**_TINY), device="cpu").eval()
    load_paddle_tpu_state(
        tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(seed, b, t):
    return np.random.RandomState(seed).randint(1, 97, (b, t)).astype("int64")


def _three_ways(jm, tm, ids, block, **kw):
    """(reference paged, port paged, port dense) of one call."""
    ref = jm.generate(paddle.to_tensor(ids), paged=True, block_size=block,
                      **kw).numpy()
    paged = tm.generate(ids, paged=True, block_size=block, **kw).numpy()
    return ref, paged, tm.generate(ids, **kw).numpy()


@pytest.mark.parametrize("t0", [BLOCK - 1, BLOCK, BLOCK + 1, 7])
def test_paged_equals_reference_paged_and_dense(models, t0):
    jm, tm = models
    ref, paged, dense = _three_ways(jm, tm, _ids(20 + t0, 2, t0), BLOCK,
                                    max_new_tokens=6)
    np.testing.assert_array_equal(paged, ref)
    np.testing.assert_array_equal(paged, dense)


def test_ragged_rows_across_block_edges(models):
    """Left-padded rows with block-1, block and block+1 real tokens."""
    jm, tm = models
    t0 = BLOCK + 1
    rng = np.random.RandomState(30)
    batch = np.stack([np.concatenate([np.zeros(t0 - n, "int64"),
                                      rng.randint(1, 97, (n,))])
                      for n in range(BLOCK - 1, t0 + 1)])
    ref, paged, dense = _three_ways(jm, tm, batch, BLOCK, max_new_tokens=5,
                                    pad_token_id=0)
    np.testing.assert_array_equal(paged, ref)
    np.testing.assert_array_equal(paged, dense)


def test_eos_and_the_default_block(models):
    jm, tm = models
    ids = _ids(31, 2, 6)
    eos = int(tm.generate(ids, max_new_tokens=3).numpy()[1, 8])
    ref, paged, dense = _three_ways(jm, tm, ids, 64, max_new_tokens=7,
                                    eos_token_id=eos)
    np.testing.assert_array_equal(paged, ref)
    np.testing.assert_array_equal(paged, dense)
    assert (paged[1, 8:] == eos).all()


def test_pool_exhaustion_raises_the_reference_error(models):
    jm, tm = models
    ids = _ids(40, 2, 6)
    # needs ceil((6+5)/4) = 3 blocks x 2 rows = 6
    for model, given in ((jm, paddle.to_tensor(ids)), (tm, ids)):
        with pytest.raises(ValueError, match="exhausted") as ei:
            model.generate(given, max_new_tokens=5, paged=True,
                           block_size=4, num_blocks=5)
        assert "6 blocks" in str(ei.value)
        assert "num_blocks=5" in str(ei.value)
    got = tm.generate(ids, max_new_tokens=5, paged=True, block_size=4,
                      num_blocks=6).numpy()
    np.testing.assert_array_equal(got, tm.generate(ids,
                                                   max_new_tokens=5).numpy())
    # a larger pool than the batch needs decodes the same
    got = tm.generate(ids, max_new_tokens=5, paged=True, block_size=4,
                      num_blocks=9).numpy()
    np.testing.assert_array_equal(got, tm.generate(ids,
                                                   max_new_tokens=5).numpy())


@pytest.mark.parametrize("kw,exc,match", [
    (dict(num_beams=2), NotImplementedError, "dense"),
    (dict(repetition_penalty=1.5), NotImplementedError, "dense"),
    (dict(min_length=2, eos_token_id=3), NotImplementedError, "dense"),
], ids=["beam", "repetition_penalty", "min_length"])
def test_unsupported_combinations(models, kw, exc, match):
    jm, tm = models
    ids = _ids(41, 1, 5)
    with pytest.raises(exc, match=match):
        jm.generate(paddle.to_tensor(ids), max_new_tokens=4, paged=True, **kw)
    with pytest.raises(exc, match=match):
        tm.generate(ids, max_new_tokens=4, paged=True, **kw)


def test_one_launch_per_layer_per_tick(models, monkeypatch):
    """The prefill calls the varlen forward once per layer and every tick
    calls the paged decode once per layer (on a CUDA model, each call is
    one launch of the kernel)."""
    _, tm = models
    calls = {"varlen": 0, "paged": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tia, "flash_attn_varlen_thd",
                        counting("varlen", tia.flash_attn_varlen_thd))
    monkeypatch.setattr(tia, "paged_attention_decode",
                        counting("paged", tia.paged_attention_decode))
    tm.generate(np.array([[0, 0, 5, 6, 7], [1, 2, 3, 4, 5]]),
                max_new_tokens=6, paged=True, block_size=4, pad_token_id=0)
    layers = _TINY["num_hidden_layers"]
    assert calls == {"varlen": layers, "paged": layers * 5}


def test_cpu_never_reaches_a_kernel(models, monkeypatch):
    _, tm = models

    def no_kernels(name):
        raise AssertionError(f"kernel library {name} loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", no_kernels)
    monkeypatch.setattr(tpa, "launches", 0)
    monkeypatch.setattr(tfv, "launches", 0)
    out = tm.generate(_ids(42, 2, 5), max_new_tokens=4, paged=True,
                      block_size=4)
    assert out.shape == (2, 9)
    assert tpa.launches == 0 and tfv.launches == 0


# ---------------------------------------------------------------------------
# block_multihead_attention and the other serving ops
# ---------------------------------------------------------------------------
_D, _H, _NB, _PPS, _S = 16, 4, 12, 4, 16

#: (seq_lens_encoder, seq_lens_decoder, row starts, tokens T)
_BATCHES = {
    "prefill": ([5, 3], [0, 0], [0, 5], 8),
    "prefill-gap": ([5, 3], [0, 0], [0, 6], 9),
    "decode": ([0, 0, 0], [3, 9, 0], [0, 1, 2], 3),
    "mixed": ([4, 0, 0], [0, 6, 0], [0, 4, 5], 6),
}


def _bmha_inputs(case, kvh, seed):
    enc, dec, starts, t = _BATCHES[case]
    b = len(enc)
    rng = np.random.RandomState(seed)
    qkv = rng.randn(t, (_H + 2 * kvh) * _D).astype(np.float32)
    kc = rng.randn(_NB, kvh, BLOCK, _D).astype(np.float32)
    vc = rng.randn(_NB, kvh, BLOCK, _D).astype(np.float32)
    tables = rng.permutation(_NB)[:b * _PPS].reshape(b, _PPS).astype(
        np.int32)
    cos, sin = (a.numpy() for a in _rope_tables(_S, _D, 10000.0, True,
                                                torch.float32))
    rope = np.stack([np.broadcast_to(cos[None, :, None], (b, _S, 1, _D)),
                     np.broadcast_to(sin[None, :, None], (b, _S, 1, _D))])
    ints = [np.asarray(a, np.int32) for a in
            (enc, dec, np.concatenate([starts, [t]]))]
    return [qkv, kc, vc, *ints, tables, rope.astype(np.float32)]


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("kvh", [2, 4], ids=["gqa", "mha"])
@pytest.mark.parametrize("case", list(_BATCHES))
def test_block_multihead_attention_matches_reference(case, kvh, neox):
    qkv, kc, vc, enc, dec, cu, tables, rope = _bmha_inputs(case, kvh, 7)
    kw = dict(block_size=BLOCK, max_seq_len=_S, use_neox_style=neox)
    j = JF.block_multihead_attention(
        *(paddle.to_tensor(a) for a in (qkv, kc, vc, enc, dec)), None, None,
        None, paddle.to_tensor(cu), paddle.to_tensor(cu),
        paddle.to_tensor(tables), rope_emb=paddle.to_tensor(rope), **kw)
    given = [torch.as_tensor(a) for a in (qkv, kc, vc)]
    t = TF.block_multihead_attention(
        *given, torch.as_tensor(enc), torch.as_tensor(dec), None, None, None,
        torch.as_tensor(cu), torch.as_tensor(cu), torch.as_tensor(tables),
        rope_emb=torch.as_tensor(rope), **kw)
    for name, a, b in zip(("out", "qkv", "key_cache", "value_cache"), t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   atol=1e-5, rtol=0, err_msg=name)
    # the caches passed in are left as they were
    np.testing.assert_array_equal(given[1].numpy(), kc)
    np.testing.assert_array_equal(given[2].numpy(), vc)


def test_block_multihead_attention_rejects_a_quantized_cache():
    qkv, kc, vc, enc, dec, cu, tables, _ = _bmha_inputs("decode", 2, 1)
    with pytest.raises(NotImplementedError):
        TF.block_multihead_attention(
            *(torch.as_tensor(a) for a in (qkv, kc, vc, enc, dec)), None,
            None, None, torch.as_tensor(cu), torch.as_tensor(cu),
            torch.as_tensor(tables), cache_k_quant_scales=torch.ones(2))


@pytest.mark.parametrize("step", ["sequence_lengths", "src_mask", "rotary"])
def test_masked_multihead_attention_matches_reference(step):
    rng = np.random.RandomState(3)
    b, h, s, d = 2, 4, 8, 16
    x = rng.randn(b, 3 * h * d).astype(np.float32)
    cache = rng.randn(2, b, h, s, d).astype(np.float32)
    bias = rng.randn(3 * h * d).astype(np.float32)
    lens = np.array([[2], [5]], np.int32)
    mask = rng.randn(b, 1, 1, 6).astype(np.float32) * 0.1
    cos, sin = (a.numpy() for a in _rope_tables(s, d, 10000.0, False,
                                                torch.float32))
    rot = np.stack([np.broadcast_to(cos[None, :, None], (b, s, 1, d)),
                    np.broadcast_to(sin[None, :, None], (b, s, 1, d))]
                   ).astype(np.float32)
    kw = {"sequence_lengths": dict(sequence_lengths=lens, bias=bias),
          "src_mask": dict(src_mask=mask),
          "rotary": dict(sequence_lengths=lens, rotary_tensor=rot,
                         rotary_emb_dims=1)}[step]
    j = JF.masked_multihead_attention(
        paddle.to_tensor(x), paddle.to_tensor(cache),
        **{k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    t = TF.masked_multihead_attention(
        torch.as_tensor(x), torch.as_tensor(cache),
        **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    for a, b_ in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_.numpy()),
                                   atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        TF.masked_multihead_attention(torch.as_tensor(x),
                                      torch.as_tensor(cache))


@pytest.mark.parametrize("causal,masked,kvh", [(False, False, 4),
                                               (True, False, 2),
                                               (True, True, 4)])
def test_variable_length_attention_matches_reference(causal, masked, kvh):
    rng = np.random.RandomState(4)
    b, h, sq, sk, d = 2, 4, 5, 7, 16
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, kvh, sk, d).astype(np.float32)
    v = rng.randn(b, kvh, sk, d).astype(np.float32)
    lens = np.array([5, 3], np.int32)
    kv_lens = np.array([7, 4], np.int32)
    mask = (rng.randn(b, 1, sq, sk) * 0.5).astype(np.float32)
    kw = dict(causal=causal, scale=0.3)
    j = JF.variable_length_memory_efficient_attention(
        *(paddle.to_tensor(a) for a in (q, k, v, lens, kv_lens)),
        mask=paddle.to_tensor(mask) if masked else None, **kw)
    t = TF.variable_length_memory_efficient_attention(
        *(torch.as_tensor(a) for a in (q, k, v, lens, kv_lens)),
        mask=torch.as_tensor(mask) if masked else None, **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), atol=1e-5,
                               rtol=0)


def test_fused_dot_product_attention_and_max_len_match_reference():
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 6, 4, 16).astype(np.float32) for _ in range(3))
    for kw in (dict(is_causal_masking=True), dict(scaling_factor=0.2)):
        j = JF.fused_dot_product_attention(
            *(paddle.to_tensor(a) for a in (q, k, v)), training=False, **kw)
        t = TF.fused_dot_product_attention(
            *(torch.as_tensor(a) for a in (q, k, v)), training=False, **kw)
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()),
                                   atol=1e-5, rtol=0)
    enc, dec = np.array([3, 0, 7], np.int32), np.array([0, 9, 2], np.int32)
    jm = JF.blha_get_max_len(paddle.to_tensor(enc), paddle.to_tensor(dec), 3)
    tm = TF.blha_get_max_len(torch.as_tensor(enc), torch.as_tensor(dec), 3)
    assert [int(x) for x in tm] == [int(np.asarray(x.numpy())) for x in jm]
