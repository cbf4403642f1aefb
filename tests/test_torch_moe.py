"""The port's MoE gates and layers
(paddle_tpu_torch/incubate/distributed/models/moe) against the
reference's (paddle_tpu/incubate/distributed/models/moe) on the CPU.

- The gates: combine and dispatch, capacity and balance loss of the
  naive, GShard and switch gates from the same weights and inputs,
  with the reference's own property checks (mass, 0/1 dispatch, unique
  positions, capacity bound); random routing through ``_dispatch_from_probs``
  with the reference's ``jax.random.uniform`` draw fed to the port.
- The index path: ``FusedMoELayer`` against the dense dispatch for every
  gate and top-k (within the port) and against the reference's layer;
  ``_moe_idx_ffn_fwd`` and the manual backward against the reference's
  ``_moe_idx_ffn_fwd`` / ``_moe_idx_ffn_vjp`` at the same ``u``, roomy and
  tight (dropping) capacities, normalized or not, random routing, relu,
  gelu (tanh form) and swiglu experts; the manual backward against
  torch autograd of the port's own forward; every real slot owned once.
- ``MoELayer`` over a list of experts, ``fused_ec_moe``, and a
  ``moe_group`` / gate ``group`` without a mesh (the layers keep their
  paths, as the reference's do; the meshes of two ranks are
  ``test_torch_expert_parallel.py``'s).

fp32 throughout. Tolerances: outputs 1e-5 absolute (the products sum in
another order), gradients 2e-4 relative + 2e-5 absolute (the reference's
own manual-vs-autodiff tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.incubate.distributed.models.moe import (
    FusedMoELayer as JFused, GShardGate as JGShard, MoELayer as JMoE,
    NaiveGate as JNaive, SwitchGate as JSwitch)
from paddle_tpu.incubate.distributed.models.moe import gate as jgate
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml
from paddle_tpu.incubate.nn.functional import fused_ec_moe as j_ec_moe

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ExpertsFFN, FusedMoELayer, GShardGate, MoELayer, NaiveGate, SwitchGate)
from paddle_tpu_torch.incubate.distributed.models.moe import gate as tgate
from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer as tml
from paddle_tpu_torch.incubate.nn.functional import fused_ec_moe

D = 16
OUT_TOL = 1e-5
G_RTOL, G_ATOL = 2e-4, 2e-5
CPU = dict(device="cpu")


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


GATES = {"naive": (JNaive, NaiveGate, dict(topk=2)),
         "gshard": (JGShard, GShardGate, dict(random_routing=False)),
         "switch": (JSwitch, SwitchGate, {})}


def _gate_pair(kind, seed, e=4):
    jcls, tcls, kw = GATES[kind]
    paddle.seed(seed)
    jg = jcls(D, e, 1, **kw)
    tg = tcls(D, e, 1, **kw, **CPU)
    load_paddle_tpu_state(tg, _state(jg))
    return jg, tg


@pytest.mark.parametrize("kind,mode,n", [
    ("naive", "train", 32), ("gshard", "train", 64), ("gshard", "eval", 64),
    ("switch", "eval", 32)])
def test_gate_matches_reference(kind, mode, n):
    """combine/dispatch and the aux loss; the reference's own checks."""
    jg, tg = _gate_pair(kind, seed=len(kind) + n)
    getattr(jg, mode)()
    getattr(tg, mode)()
    x = np.random.default_rng(n).standard_normal((n, D)).astype("float32")
    jc, jd = jg(paddle.to_tensor(x))
    tc, td = tg(_t(x))
    jc, jd = np.asarray(jc._value), np.asarray(jd._value)
    np.testing.assert_allclose(tc.detach().numpy(), jc, rtol=0, atol=OUT_TOL)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert tc.shape[:2] == (n, 4)
    assert set(np.unique(td.numpy())) <= {0.0, 1.0}
    assert td.numpy().sum(axis=0).max() <= 1.0        # one token per slot
    assert td.numpy().sum(axis=(0, 2)).max() <= tc.shape[2]   # capacity
    if kind == "naive":                # roomy capacity: every token's mass
        np.testing.assert_allclose(tc.sum(dim=(1, 2)).detach().numpy(),
                                   np.ones(n), atol=1e-5)
        assert tg.get_loss() is None and jg.get_loss() is None
    else:
        jl, tl = jg.get_loss(), tg.get_loss()
        assert abs(tl.item() - float(jl._value)) <= 1e-6
        assert 0.5 < tl.item() < 4.0
        assert tg.get_loss() is None                  # cleared
    if kind == "switch":
        assert td.numpy().sum(axis=(1, 2)).max() <= 1.0   # top-1


@pytest.mark.parametrize("normalize", [True, False])
def test_dispatch_random_routing_at_a_shared_draw(normalize):
    """GShard's random second expert: the reference's uniform draw given
    to the port; a dropped second choice takes no capacity."""
    n, e, c = 48, 4, 10
    rng = np.random.default_rng(3)
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((n, e)),
                                       jnp.float32), axis=-1)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (n,)))
    st = dict(k=2, capacity=c, normalize=normalize, random2=True)
    jc, jd = jgate._dispatch_from_probs(probs, key=key, **st)
    tc, td = tgate._dispatch_from_probs(_t(probs), _t(u), **st)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (u >= 2 * np.sort(np.asarray(probs), 1)[:, -2]).any()


def _dense_forward(layer, x):
    combine, dispatch = layer.gate(x)
    y = layer.experts(torch.einsum("nec,nd->ecd", dispatch, x))
    return torch.einsum("nec,ecd->nd", combine, y)


@pytest.mark.parametrize("gate_type,topk", [("gshard", 2), ("naive", 2),
                                            ("switch", 1)])
def test_index_path_matches_dense_dispatch(gate_type, topk):
    """The index path equals the [N, E, C] einsum path, and the
    reference's index path from the same weights. The dense path's
    experts use the exact gelu and the index path the tanh form (as the
    reference), so this runs relu experts."""
    paddle.seed(0)
    jl = JFused(16, 32, 4, gate={"type": gate_type, "topk": topk},
                activation="relu")
    tl = FusedMoELayer(16, 32, 4, gate={"type": gate_type, "topk": topk},
                       activation="relu", **CPU)
    load_paddle_tpu_state(tl, _state(jl))
    for layer in (jl, tl):
        layer.gate._random2 = False
        layer.eval()
    x = np.random.RandomState(0).randn(24, 16).astype("float32")
    got = tl(_t(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               _dense_forward(tl, _t(x)).detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), rtol=0,
                               atol=OUT_TOL)


def _idx_case(n, d, e, h, seed, activation, scale_b=0.1):
    rng = np.random.RandomState(seed)
    first = 2 * h if activation == "swiglu" else h
    probs = jax.nn.softmax(jnp.asarray(rng.randn(n, e), jnp.float32), -1)
    arrs = [probs, rng.randn(n, d).astype("float32"),
            (rng.randn(e, d, first) * 0.1).astype("float32"),
            (rng.randn(e, 1, first) * scale_b).astype("float32"),
            (rng.randn(e, h, d) * 0.1).astype("float32"),
            (rng.randn(e, 1, d) * scale_b).astype("float32")]
    g = rng.randn(n, d).astype("float32")
    return [jnp.asarray(a, jnp.float32) for a in arrs], g


IDX_CASES = {
    # (n, d, e, h, capacity, activation, normalize, random2)
    "roomy_gelu_norm": (64, 16, 4, 24, 64, "gelu", True, False),
    "roomy_gelu_raw": (64, 16, 4, 24, 64, "gelu", False, False),
    "roomy_gelu_random2": (64, 16, 4, 24, 64, "gelu", True, True),
    "drops_relu": (64, 8, 4, 12, 8, "relu", True, False),
    "drops_random2": (64, 8, 4, 12, 12, "gelu", True, True),
    "swiglu_norm": (64, 16, 4, 12, 64, "swiglu", True, False),
    "swiglu_raw": (64, 16, 4, 12, 64, "swiglu", False, False),
}


@pytest.mark.parametrize("case", list(IDX_CASES))
def test_index_path_forward_and_backward_match_reference(case):
    """``_moe_idx_ffn_fwd`` and the port's manual backward (through
    ``moe_idx_ffn``) against the reference's forward and manual VJP at
    the reference's uniform draw; and against torch autograd of the
    port's own forward."""
    n, d, e, h, c, act, normalize, random2 = IDX_CASES[case]
    (probs, x, w0, b0, w1, b1), g = _idx_case(n, d, e, h, len(case), act)
    key = jax.random.PRNGKey(3)
    u = _t(jax.random.uniform(key, (n,)))
    st = dict(k=2, capacity=c, activation=act, normalize=normalize,
              random2=random2)
    want = jml._moe_idx_ffn_fwd(probs, x, w0, b0, w1, b1, key, **st)
    jgrads = jml._moe_idx_ffn_vjp((jnp.asarray(g),),
                                  (probs, x, w0, b0, w1, b1, key), **st)
    ins = [_t(a).requires_grad_(True) for a in (probs, x, w0, b0, w1, b1)]
    out = tml.moe_idx_ffn(*ins, u, **st)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=OUT_TOL)
    tgrads = torch.autograd.grad(out, ins, _t(g))
    ins2 = [t.detach().clone().requires_grad_(True) for t in ins]
    auto = torch.autograd.grad(tml._moe_idx_ffn_fwd(*ins2, u, **st), ins2,
                               _t(g))
    names = ["dprobs", "dx", "dw0", "db0", "dw1", "db1"]
    for nm, tg_, jg_, ag in zip(names, tgrads, jgrads, auto):
        np.testing.assert_allclose(tg_.numpy(), np.asarray(jg_),
                                   rtol=G_RTOL, atol=G_ATOL, err_msg=nm)
        np.testing.assert_allclose(tg_.numpy(), ag.numpy(), rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=nm)


@pytest.mark.parametrize("random2", [False, True])
def test_route_slots_are_unique_with_drops(random2):
    """Under a tight capacity some choices drop (flat = the overflow bin
    E * C); every real slot is owned by exactly one kept (token, choice),
    and the inverse maps agree with the reference's."""
    n, e, c, k = 64, 4, 8, 2
    rng = np.random.RandomState(5)
    probs = jax.nn.softmax(jnp.asarray(rng.randn(n, e), jnp.float32), -1)
    key = jax.random.PRNGKey(1)
    u = _t(jax.random.uniform(key, (n,)))
    st = dict(k=k, capacity=c, normalize=True, random2=random2)
    tv, _, idx, keep, flat, tok, j, _ = tml._route(_t(probs), u, **st)
    ref = jml._route(probs, key, **st)
    assert (~keep).any() and (flat == e * c).sum() == (~keep).sum()
    real = flat[keep]
    assert real.numel() == real.unique().numel()
    assert (tok[:e * c] < n).sum() == keep.sum()
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(tok[:e * c].numpy(),
                                  np.asarray(ref[5])[:e * c])
    np.testing.assert_array_equal(j[:e * c].numpy(),
                                  np.asarray(ref[6])[:e * c])


def test_swiglu_bank_is_one_wide_projection():
    """ExpertsFFN(swiglu): w0 [E, d, 2h]; the index path equals silu of
    the gate half times the up half, two separate products."""
    ex = ExpertsFFN(4, 8, 12, activation="swiglu", **CPU)
    assert tuple(ex.w0.shape) == (4, 8, 24) and tuple(ex.b0.shape) == (4, 1, 24)
    h = torch.randn(2, 3, 24)
    g, u = h[..., :12], h[..., 12:]
    torch.testing.assert_close(tml._moe_act("swiglu")(h),
                               torch.nn.functional.silu(g) * u)


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_fused_layer_trains_like_reference(gate):
    """FusedMoELayer in training mode (capacity 1.2, drops; random
    routing and jitter off): output, and the gradients of x, the bank
    and the gate's weight."""
    paddle.seed(0)
    spec = {"type": gate}
    if gate == "gshard":
        spec["random_routing"] = False
    else:
        spec["switch_eps"] = 0.0
    jl = JFused(D, 32, 4, gate=dict(spec))
    tl = FusedMoELayer(D, 32, 4, gate=dict(spec), **CPU)
    load_paddle_tpu_state(tl, _state(jl))
    x = np.random.default_rng(2).standard_normal((2, 8, D)).astype("float32")
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jy = jl(jx)
    (jy * jy).sum().backward()
    tx = _t(x).requires_grad_(True)
    ty = tl(tx)
    (ty * ty).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(),
                               rtol=G_RTOL, atol=G_ATOL)
    jp = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[name].grad.numpy(),
                                   rtol=G_RTOL, atol=G_ATOL, err_msg=name)
    assert float(tl.experts.w0.grad.abs().sum()) > 0
    assert float(tl.gate.weight.grad.abs().sum()) > 0


def test_random_routing_reproducible_within_the_port():
    """GShard's random second expert draws from the gate's generator:
    one generator seed twice gives equal outputs, another seed another
    routing."""
    x = torch.randn(64, D, generator=torch.Generator().manual_seed(1))

    def run(gen_seed):
        layer = FusedMoELayer(D, 32, 4, seed=0, **CPU).train()
        layer.gate.generator.manual_seed(gen_seed)
        return layer(x)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


class _Expert(torch.nn.Module):
    def __init__(self, d=D, h=32):
        super().__init__()
        self.fc1 = torch.nn.Linear(d, h)
        self.fc2 = torch.nn.Linear(h, d)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class _JExpert(jnn.Layer):
    def __init__(self, d=D, h=32):
        super().__init__()
        self.fc1 = jnn.Linear(d, h)
        self.fc2 = jnn.Linear(h, d)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


@pytest.mark.parametrize("recompute_interval", [0, 1])
def test_moe_layer_matches_reference(recompute_interval):
    """MoELayer over four Linear experts (GShard gate, random routing
    off, training capacity): output and gradients of x, the experts and
    the gate; with recompute_interval the experts are recomputed."""
    paddle.seed(0)
    jl = JMoE(D, [_JExpert() for _ in range(4)],
              gate={"type": "gshard", "random_routing": False},
              recompute_interval=recompute_interval)
    tl = MoELayer(D, [_Expert() for _ in range(4)],
                  gate={"type": "gshard", "random_routing": False},
                  recompute_interval=recompute_interval)
    load_paddle_tpu_state(tl, _state(jl))
    x = np.random.default_rng(4).standard_normal((2, 8, D)).astype("float32")
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jy = jl(jx)
    jy.mean().backward()
    tx = _t(x).requires_grad_(True)
    ty = tl(tx)
    ty.mean().backward()
    assert tuple(ty.shape) == (2, 8, D)
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(),
                               rtol=G_RTOL, atol=G_ATOL)
    assert float(tl.gate.weight.grad.abs().sum()) > 0
    jp = dict(jl.named_parameters())
    linear = {n for n, m in tl.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in tl.named_parameters():
        g = p.grad.numpy()
        if name.rsplit(".", 1)[0] in linear and g.ndim == 2:
            g = g.T
        np.testing.assert_allclose(g, jp[name].grad.numpy(), rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=name)


def test_single_expert_equals_dense():
    """One expert, a naive gate at top-1 and full capacity: the MoE is
    that expert's FFN."""
    exp = _Expert()
    moe = MoELayer(D, [exp], gate=NaiveGate(D, 1, 1, topk=1,
                                            capacity_factor=2.0, **CPU))
    x = torch.randn(1, 6, D)
    torch.testing.assert_close(moe(x), exp(x.reshape(6, D)).reshape(1, 6, D),
                               rtol=0, atol=1e-5)


def test_fused_ec_moe_matches_reference():
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype("float32") for s in
            ((2, 4, D), (2, 4, 3), (3, D, 8), (3, 1, 8), (3, 8, D),
             (3, 1, D))]
    for act in ("gelu", "relu"):
        want = j_ec_moe(*(paddle.to_tensor(a) for a in arrs), act_type=act)
        got = fused_ec_moe(*(_t(a) for a in arrs), act_type=act)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4)
    got = fused_ec_moe(*(_t(a) for a in arrs[:3]), None, _t(arrs[4]), None)
    assert tuple(got.shape) == (2, 4, D)
    with pytest.raises(ValueError, match="act_type"):
        fused_ec_moe(*(_t(a) for a in arrs), act_type="silu")


class _Group:
    """A group of one rank without a mesh (``moe_group`` / a gate's
    ``group`` outside a mesh, as the reference accepts them)."""

    ranks, nranks, mesh, process_group = [0], 1, None, None


def test_expert_parallel_waits_for_the_distributed_slice():
    """A ``moe_group`` or gate ``group`` without a mesh axis and no hybrid
    group (one process, no process group): as in the reference the
    layers keep their paths (``FusedMoELayer`` the index path) and the
    gate routes this rank's tokens; each output and gradient equals the
    reference layer's built with the same argument. The meshes of two
    ranks are tests/test_torch_expert_parallel.py's."""
    g = _Group()
    paddle.seed(3)
    jf = JFused(D, 32, 4, gate={"type": "gshard", "random_routing": False},
                moe_group=g)
    tf = FusedMoELayer(D, 32, 4, gate={"type": "gshard",
                                       "random_routing": False},
                       moe_group=g, **CPU)
    load_paddle_tpu_state(tf, _state(jf))
    assert jf._mesh is None and tf._mesh is None
    assert tf.gate.batch_group() is None
    paddle.seed(4)
    jl = JMoE(D, [_JExpert() for _ in range(4)],
              gate={"type": "gshard", "random_routing": False}, moe_group=g)
    tl = MoELayer(D, [_Expert() for _ in range(4)],
                  gate={"type": "gshard", "random_routing": False},
                  moe_group=g)
    load_paddle_tpu_state(tl, _state(jl))
    jg, tg = JGShard(D, 4, 1, random_routing=False, group=g), GShardGate(
        D, 4, 1, random_routing=False, group=g, **CPU)
    load_paddle_tpu_state(tg, _state(jg))
    x = np.random.default_rng(5).standard_normal((2, 8, D)).astype("float32")
    linear = {n for n, m in tl.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for jm, tm in ((jf, tf), (jl, tl)):
        jx = paddle.to_tensor(x)
        jx.stop_gradient = False
        jy = jm(jx)
        jy.mean().backward()
        tx = _t(x).requires_grad_(True)
        ty = tm(tx)
        ty.mean().backward()
        np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), rtol=0,
                                   atol=OUT_TOL)
        np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(),
                                   rtol=G_RTOL, atol=G_ATOL)
        jp = dict(jm.named_parameters())
        for name, p in tm.named_parameters():
            grad = p.grad.numpy()
            if name.rsplit(".", 1)[0] in linear and grad.ndim == 2:
                grad = grad.T
            np.testing.assert_allclose(grad, jp[name].grad.numpy(),
                                       rtol=G_RTOL, atol=G_ATOL,
                                       err_msg=name)
    jc, jd = jg(paddle.to_tensor(x.reshape(16, D)))
    tc, td = tg(_t(x.reshape(16, D)))
    np.testing.assert_allclose(tc.detach().numpy(), jc.numpy(), rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_array_equal(td.numpy(), jd.numpy())
    assert abs(tg.get_loss().item() - float(jg.get_loss())) <= OUT_TOL
    with pytest.raises(TypeError, match="gate spec"):
        FusedMoELayer(D, 32, 4, gate=3, **CPU)
