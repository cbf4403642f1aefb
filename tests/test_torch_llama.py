"""The port's Llama forward (paddle_tpu_torch/models/llama.py) against
the reference package's (paddle_tpu/models/llama.py), on the CPU, with
the reference's weights bridged by ``convert.load_paddle_tpu_state``.

fp32 throughout; tolerance 2e-5 absolute on logits of magnitude < 1
(two layers of fp32 matmuls and softmaxes summed in another order).
One configuration passes the reference's kernel gates (head_dim 64,
seq 128) with ``pallas_force_interpret``, so the reference runs its
flash and RMSNorm Pallas kernels under the interpreter while the port
routes to its kernels' plain versions (a CPU tensor never launches).
"""
import numpy as np
import pytest
import torch
from _torch_zoo import no_hybrid_groups, one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import rms_norm as trn

TOL = 2e-5


def _pair(**kw):
    paddle.seed(11)
    jm = JLlama(JConfig.tiny(**kw))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu").eval()
    params = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    load_paddle_tpu_state(tm, params)
    return jm, tm, params


def _logits(jm, tm, ids, **fw):
    want = np.asarray(jm(paddle.to_tensor(ids), **{
        k: paddle.to_tensor(v) for k, v in fw.items()})._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), **{
            k: torch.from_numpy(v) for k, v in fw.items()}).numpy()
    return got, want


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_tiny_logits_match(fused_qkv):
    jm, tm, _ = _pair(fused_qkv=fused_qkv)
    ids = np.random.default_rng(0).integers(0, 256, (2, 11))
    got, want = _logits(jm, tm, ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_position_ids_and_padding_mask():
    jm, tm, _ = _pair()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (2, 9))
    # row 1 is left-padded by 4: its real tokens start at position 0
    pos = np.stack([np.arange(9), np.maximum(np.arange(9) - 4, 0)])
    mask = np.zeros((2, 1, 1, 9), np.float32)
    mask[1, ..., :4] = -1e9
    got, want = _logits(jm, tm, ids, position_ids=pos, attention_mask=mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_kernel_gated_config_matches_interpreted_pallas(masked):
    # masked: a [B, 1, 1, S] padding mask, which the port sends to its
    # flash path as a key bias and the reference (S < 1024) to its
    # masked XLA composition
    kw = dict(hidden_size=128, intermediate_size=256, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=256)
    jm, tm, _ = _pair(**kw)
    ids = np.random.default_rng(2).integers(0, 256, (2, 128))
    fw = {}
    if masked:
        mask = np.zeros((2, 1, 1, 128), np.float32)
        mask[1, ..., :40] = -1e9
        fw["attention_mask"] = mask
    prev = jflags.get_flag("pallas_force_interpret")
    jflags.set_flags({"pallas_force_interpret": True})
    try:
        f0, r0 = tfa.launches, trn.launches
        got, want = _logits(jm, tm, ids, **fw)
    finally:
        jflags.set_flags({"pallas_force_interpret": prev})
    assert (tfa.launches, trn.launches) == (f0, r0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_bridge_checks_names_and_shapes():
    _, tm, params = _pair()
    missing = dict(params)
    missing.pop("lm_head.weight")
    with pytest.raises(KeyError, match="missing"):
        load_paddle_tpu_state(tm, missing)
    with pytest.raises(KeyError, match="extra"):
        load_paddle_tpu_state(tm, {**params, "llama.bogus": np.zeros(1)})
    bad = dict(params)
    bad["llama.layers.0.self_attn.q_proj.weight"] = np.zeros((64, 32))
    with pytest.raises(ValueError, match="shape"):
        load_paddle_tpu_state(tm, bad)
    # Linear weights arrive as paddle's [in, out] and land transposed
    w = params["llama.layers.0.mlp.gate_proj.weight"]
    np.testing.assert_array_equal(
        tm.llama.layers[0].mlp.gate_proj.weight.detach().numpy(), w.T)


def test_later_slices_raise():
    # labels= and recompute=True arrived with the training slice: the
    # loss comes back (and matches the reference's, test_torch_train.py),
    # and a recompute model gives the same loss; context parallelism
    # arrived with the distributed slice: a context-parallel model builds,
    # and, as the reference's, refuses a custom attention mask and needs
    # a mesh (a hybrid group with a sep axis; the sep-2 runs are in
    # test_torch_context_parallel.py)
    jm, tm, params = _pair()
    ids = np.random.default_rng(3).integers(0, 256, (1, 6))
    want, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert logits is None
    np.testing.assert_allclose(loss.item(), float(want), rtol=0, atol=TOL)
    rm = LlamaForCausalLM(LlamaConfig.tiny(recompute=True), device="cpu")
    load_paddle_tpu_state(rm, params)
    rloss, _ = rm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    torch.testing.assert_close(rloss, loss, rtol=0, atol=0)
    cp_ids = np.random.default_rng(4).integers(0, 256, (1, 8))
    mask = np.zeros((1, 1, 8, 8), np.float32)
    for mode in ("ring", "ulysses"):
        jcp = JLlama(JConfig.tiny(context_parallel=mode))
        tcp = LlamaForCausalLM(LlamaConfig.tiny(context_parallel=mode),
                               device="cpu")
        with pytest.raises(NotImplementedError, match="attention_mask"):
            jcp(paddle.to_tensor(cp_ids),
                attention_mask=paddle.to_tensor(mask))
        with pytest.raises(NotImplementedError, match="attention_mask"):
            tcp(torch.from_numpy(cp_ids),
                attention_mask=torch.from_numpy(mask))
        with pytest.raises(ValueError, match="needs a mesh"):
            jcp(paddle.to_tensor(cp_ids))
        with pytest.raises(ValueError, match="needs a mesh"):
            tcp(torch.from_numpy(cp_ids))
