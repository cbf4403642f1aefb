"""The port's Llama training step against the reference package's on a
configuration that passes both packages' kernel gates (head_dim 64, seq
128), on the CPU: with ``pallas_force_interpret`` the reference takes
its flash and RMSNorm Pallas kernels forward and backward under the
interpreter, while the port takes its kernels' autograd functions over
their plain versions (a CPU tensor never launches). The training loop,
the batch and the tolerances are test_torch_train.py's.
"""
from paddle_tpu.core import flags as jflags

from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import rms_norm as trn

from test_torch_train import _check, _train
from _torch_zoo import one_torch_thread  # noqa: F401

GATED = dict(hidden_size=128, intermediate_size=256, num_attention_heads=2,
             num_key_value_heads=1, max_position_embeddings=256)


def test_kernel_gated_config_matches_interpreted_pallas():
    prev = jflags.get_flag("pallas_force_interpret")
    jflags.set_flags({"pallas_force_interpret": True})
    try:
        before = (tfa.launches, tfa.bwd_launches, trn.launches,
                  trn.bwd_launches)
        r = _train(GATED, seq=128, steps=2)
    finally:
        jflags.set_flags({"pallas_force_interpret": prev})
    assert (tfa.launches, tfa.bwd_launches, trn.launches,
            trn.bwd_launches) == before
    _check(r)
