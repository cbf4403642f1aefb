"""Expert parallelism in the port on two gloo ranks on the CPU
(paddle_tpu_torch/incubate/distributed/models/moe: ``moe_group``, the
gates' ``group``, routing over the global batch; models/ernie_moe.py:
``ernie_moe_shard_plan``), held against the reference.

One launch serves every case (``two_ranks``): two launchers of the
port (``python -m paddle_tpu_torch.distributed.launch --nnodes 2``) each
start ``tests/_torch_ep_worker.py`` into a gloo world of two, while this
process computes the reference's results. The cases:

- **C5, routing over the global batch under data parallelism.**
  ``ErnieMoeConfig.tiny`` under ``DataParallel`` at dp 2, each rank half
  of a 4 x 32 batch, three AdamW steps, random routing off in both
  packages, GShard's training capacity factor 1.2: on the first step
  the capacity drops (token, choice) pairs of the global batch
  (counted through the port's ``_route``; routing each rank's half
  alone drops other pairs, ROADMAP queue C, C5). The oracle is the
  reference's full-batch step under its ``jit.to_static`` (its data
  parallelism on a mesh is that computation).
- **ep 2 under ``ernie_moe_shard_plan``** on dp 1 x ep 2 with
  ``mp_axis="ep"`` (``tests/test_ernie_moe.py::TestExpertParallel``'s
  layout: attention tensor parallel over ep, the expert banks
  ``Shard(0)`` on it, the tokens replicated): each rank holds 2 of the 4
  experts ([2, 64, 128]) and takes the index path, as the reference
  does without a ``moe_group``; against the reference's plan on its
  mesh of two devices.
- **C6, the hybrid-group fallback.** After ``fleet.init(mp_degree=2)``
  ``FusedMoELayer`` and ERNIE-MoE shard their banks over mp and take the
  einsum path (exact GELU) in both packages: the layer's output and
  gradients, the model's three steps, against the reference's built
  after its own ``fleet.init``.
- **``moe_group``.** ``FusedMoELayer(moe_group=)`` over an ep axis of two
  (``tests/test_moe.py::TestExpertParallel``'s layer): the einsum path,
  2 experts a rank; ``MoELayer(moe_group=)`` (every rank runs every
  expert module); each against the reference's layer with its
  ``moe_group`` on a mesh of two devices. A batch sharded over the ep
  axis itself raises ``NotImplementedError`` naming both placements.
- **The gates' ``group``.** ``GShardGate`` and ``SwitchGate`` with the
  world as their group, each rank routing its half of 32 tokens:
  combine and dispatch equal the reference's rows of those tokens (the
  capacity and the slots of the global batch), the balance loss its
  loss, the ranks' mean gradient of the gate its gradient of
  ``sum(combine * w) / 2 + aux``, and each token's input gradient twice
  its (a rank's loss weighs its tokens as a mean over its half). The
  GShard gate's capacity drops pairs of the global batch.

The reference's gradients under a ``moe_group`` or the hybrid fallback
are taken with its activations' layouts as the identity
(``_layout_only``): its ``shard_tensor`` of an activation cuts its tape,
so its own einsum path passes no gradient through the dispatch. Its
values are held with and without that.

Tolerances are ``test_torch_train.py``'s: losses 2e-5 absolute (C5: the
mean of the two ranks' losses, as ``tests/test_torch_distributed_launch.py``),
the step-1 gradients 1e-4 of each one's max |g|, parameters after three
steps 1e-5 where every step's gradient is at least 1e-3 of the
parameter's max |g| in both packages (Adam divides by |g|), covering
70% of them; the layers' values 1e-5 absolute, their gradients 1e-5 of
their max; the gates' combine and balance loss 1e-6, dispatch exactly.
fp32 throughout, dtypes asserted.
"""
import contextlib
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.fleet as jfleet
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet.topology import \
    set_hybrid_communicate_group as jset_hcg
from paddle_tpu.incubate.distributed.models.moe import (
    FusedMoELayer as JFused, GShardGate as JGShard, MoELayer as JMoELayer,
    SwitchGate as JSwitch)
from paddle_tpu.incubate.distributed.models.moe import \
    moe_layer as jmoe_layer
from paddle_tpu.models import ErnieMoeConfig as JConfig
from paddle_tpu.models import ErnieMoeForCausalLM as JMoe
from paddle_tpu.models import ernie_moe_shard_plan as jplan

from _torch_zoo import fresh_hybrid_groups

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_ep_worker.py")
TIMEOUT = 240

LOSS_TOL = 2e-5
GRAD_REL = 1e-4
PARAM_TOL = 1e-5
LAYER_TOL = 1e-5
GATE_TOL = 1e-6
G_FLOOR = 1e-3
COVERED = 0.7
LR = 1e-3
STEPS = 3
D, H, E = 16, 32, 4
GSHARD = {"type": "gshard", "random_routing": False}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (4, 32))
    labels = np.roll(ids, -1, axis=1)               # no ignored label
    r = np.random.default_rng(1)
    return dict(ids=ids, labels=labels,
                moe_x=r.standard_normal((2, 8, D)).astype(np.float32),
                moe_w=r.standard_normal((2, 8, D)).astype(np.float32),
                gate_x=r.standard_normal((32, D)).astype(np.float32),
                gate_w_gshard=r.standard_normal((32, E, 24))
                .astype(np.float32),
                gate_w_switch=r.standard_normal((32, E, 24))
                .astype(np.float32))


def _state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


class _JExpert(jnn.Layer):
    """``tests/test_moe.py``'s expert."""

    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(D, H)
        self.fc2 = jnn.Linear(H, D)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


def _ep_group(n=2):
    mesh = jdist.ProcessMesh(np.arange(n), ["ep"])
    g = jdist.new_group(list(range(n)))
    g.mesh, g.axis_name = mesh, "ep"
    return g


def _ref_ernie_steps(jm, ids, labels):
    """Three AdamW steps of ``jm`` under the reference's
    ``jit.to_static``: losses, each step's gradients and the parameters
    after."""
    names = [n for n, _ in jm.named_parameters()]
    params = [p for _, p in jm.named_parameters()]
    jo = jopt.AdamW(learning_rate=LR, parameters=params)
    jo._ensure_accumulators()

    def step(i, lab):
        loss, _ = jm(i, labels=lab)
        loss.backward()
        grads = [p.grad for p in params]
        jo.step()
        jo.clear_grad()
        return loss, grads

    static = paddle.jit.to_static(step, full_graph=True)
    out = dict(losses=[], grads=[])
    for _ in range(STEPS):
        loss, grads = static(paddle.to_tensor(ids), paddle.to_tensor(labels))
        out["losses"].append(float(loss))
        out["grads"].append({n: np.asarray(g._value)
                             for n, g in zip(names, grads)})
    out["params"] = {n: np.asarray(p._value) for n, p in zip(names, params)}
    return out


def _ref_ernie(state, hybrid=False):
    """The reference's tiny ERNIE-MoE from ``state``, random routing off.
    Its MoE layers read the reference's hybrid group when they are built
    (``moe_layer._ep_mesh``): with ``hybrid`` False they are built with
    none (``fresh_hybrid_groups``), else under the caller's."""
    if hybrid:
        jm = JMoe(JConfig.tiny())
    else:
        with fresh_hybrid_groups():
            jm = JMoe(JConfig.tiny())
    jm.set_state_dict(state)
    for layer in jm.model.layers:
        layer.mlp.gate._random2 = False
    return jm


@contextlib.contextmanager
def _layout_only():
    """The reference with its activations' expert-dim layouts as the
    identity. Its ``shard_tensor`` of a tensor that is not a parameter
    returns a new leaf of its tape
    (``paddle_tpu/distributed/auto_parallel/api.py:52-61``), eager and
    under ``jit.to_static``, so its einsum path under a mesh passes no
    gradient back through the dispatch and ``MoELayer``'s experts get
    none. A layout changes no value: the tests take the reference's
    values with and without this and its gradients with it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe_layer, "_shard_expert_dim",
                   lambda t, mesh, axis_name, dim=0: t)
        yield


def _ref_layer_case(layer, inp):
    x = paddle.to_tensor(inp["moe_x"], stop_gradient=False)
    cut = np.asarray(layer(x)._value)
    with _layout_only():
        y = layer(x)
        (y * paddle.to_tensor(inp["moe_w"])).sum().backward()
    out = {"y": np.asarray(y._value), "dx": np.asarray(x.grad._value),
           "y_cut": cut}
    for n, p in layer.named_parameters():
        out[f"grad/{n}"] = np.asarray(p.grad._value)
    return out


def _ref_gates(inp, gate_state):
    out = {}
    for kind, cls, kw in (("gshard", JGShard, dict(random_routing=False)),
                          ("switch", JSwitch, dict(switch_eps=0.0))):
        gate = cls(D, E, 1, **kw)
        gate.train()
        gate.set_state_dict({"weight": gate_state[f"{kind}.weight"],
                             "bias": gate_state[f"{kind}.bias"]})
        x = paddle.to_tensor(inp["gate_x"], stop_gradient=False)
        combine, dispatch = gate(x)
        aux = gate.get_loss()
        c = combine.shape[-1]
        w = paddle.to_tensor(inp[f"gate_w_{kind}"][..., :c])
        ((combine * w).sum() / 2 + aux).backward()
        out[kind] = dict(
            combine=np.asarray(combine._value),
            dispatch=np.asarray(dispatch._value), aux=float(aux),
            dgrad=np.concatenate([np.asarray(gate.weight.grad._value)
                                  .reshape(-1),
                                  np.asarray(gate.bias.grad._value)]),
            dx=np.asarray(x.grad._value))
    return out


def _reference(d, inp):
    """Every oracle of the file, from the weights it writes to ``d``."""
    paddle.seed(3)
    state = _state(JMoe(JConfig.tiny()))
    np.savez(d / "ernie.npz", **state)
    paddle.seed(5)
    fused = _state(JFused(D, H, E, gate=GSHARD))
    np.savez(d / "fused.npz", **fused)
    paddle.seed(6)
    experts = _state(JMoELayer(D, [_JExpert() for _ in range(E)],
                               gate=GSHARD))
    np.savez(d / "experts.npz", **experts)
    paddle.seed(8)
    gates = {f"{k}.{n}": v for k, g in (("gshard", JGShard(D, E, 1)),
                                        ("switch", JSwitch(D, E, 1)))
             for n, v in _state(g).items()}
    np.savez(d / "gates.npz", **gates)
    return state, fused, experts, gates


def _ref_results(inp, state, fused, experts, gates):
    ids, labels = inp["ids"], inp["labels"]
    ref = {"c5": _ref_ernie_steps(_ref_ernie(state), ids, labels)}
    jm = _ref_ernie(state)
    jplan(jm, jdist.ProcessMesh(np.arange(2).reshape(1, 2), ["dp", "ep"]),
          mp_axis="ep", ep_axis="ep")
    ref["ep2_idx"] = jm.model.layers[1].mlp._mesh is None
    ref["ep2"] = _ref_ernie_steps(jm, ids, labels)
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        jf = JFused(D, H, E, gate=GSHARD)
        jf.set_state_dict(fused)
        ref["c6f_mesh"] = jf._mesh is not None
        ref["c6f"] = _ref_layer_case(jf, inp)
        jm = _ref_ernie(state, hybrid=True)
        ref["c6_mesh"] = jm.model.layers[0].mlp._mesh is not None
        ref["c6_cut_loss"] = float(jm(paddle.to_tensor(ids),
                                      labels=paddle.to_tensor(labels))[0])
        with _layout_only():
            ref["c6"] = _ref_ernie_steps(jm, ids, labels)
    finally:
        jset_hcg(None)
    jf = JFused(D, H, E, gate=GSHARD, moe_group=_ep_group())
    jf.set_state_dict(fused)
    ref["epf"] = _ref_layer_case(jf, inp)
    jl = JMoELayer(D, [_JExpert() for _ in range(E)], gate=GSHARD,
                   moe_group=_ep_group())
    jl.set_state_dict(experts)
    ref["epm"] = _ref_layer_case(jl, inp)
    ref["gate"] = _ref_gates(inp, gates)
    return ref


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """``_two_ranks`` with both packages' hybrid groups reset before and
    after (``fresh_hybrid_groups``, ROADMAP queue C, C7)."""
    with fresh_hybrid_groups():
        return _two_ranks(tmp_path_factory)


def _two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    weights = _reference(d, inp)
    master = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    results = {}

    def node(rank):
        results[rank] = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nnodes", "2", "--node_rank", str(rank), "--master", master,
             "--log_dir", str(d / "logs"), WORKER, str(d)],
            capture_output=True, text=True, timeout=TIMEOUT, cwd=REPO,
            env=env)

    threads = [threading.Thread(target=node, args=(r,)) for r in range(2)]
    for th in threads:
        th.start()
    ref = _ref_results(inp, *weights)
    for th in threads:
        th.join(TIMEOUT + 10)
    for rank in range(2):
        log = (d / "logs" / f"workerlog.{rank}")
        assert results[rank].returncode == 0, (
            results[rank].stderr[-2000:]
            + (log.read_text()[-4000:] if log.exists() else ""))
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return inp, ref, got


def _close(got, want, tol=LAYER_TOL, rel=False, err_msg=""):
    want = np.asarray(want, np.float64)
    atol = tol * (np.abs(want).max() if rel else 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=err_msg)


def _hold_steps(g, key, want, losses):
    """Losses, the step-1 gradients and the parameters after three steps
    of ``g``'s ``key`` run against the reference's ``want``."""
    assert str(g[f"{key}/loss_dtype"]) == "torch.float32"
    _close(losses, want["losses"], tol=LOSS_TOL)
    assert want["losses"][-1] < want["losses"][0]
    for name, jg in want["grads"][0].items():
        tg = g[f"{key}/grad0/{name}"]
        assert tg.dtype == np.float32, name
        _close(tg, jg, tol=GRAD_REL, rel=True, err_msg=name)
    covered = total = 0
    for name, jp in want["params"].items():
        gj = np.stack([s[name] for s in want["grads"]])
        gt = np.stack([g[f"{key}/grad{s}/{name}"] for s in range(STEPS)])
        floor = G_FLOOR * float(np.abs(gj).max())
        keep = ((np.abs(gj).min(0) > floor) & (np.abs(gt).min(0) > floor)) \
            | ((gj == 0).all(0) & (gt == 0).all(0))
        _close(g[f"{key}/param/{name}"][keep], jp[keep], tol=PARAM_TOL,
               err_msg=name)
        covered += int(keep.sum())
        total += keep.size
    assert covered >= COVERED * total, (covered, total)


def test_c5_data_parallel_routes_the_global_batch(two_ranks):
    """dp 2: the capacity binds on the first step, the mean of the ranks'
    losses and the averaged gradients are the reference's full-batch
    step's, and the two ranks end with one model."""
    _, ref, got = two_ranks
    g0, g1 = got
    assert g0["c5/path"] == "index"
    assert g0["c5/batch_group"].tolist() == [0, 1]
    drops = g0["c5/global_drops"]
    assert drops.sum() >= 1 and (drops == g1["c5/global_drops"]).all(), drops
    losses = (g0["c5/losses"] + g1["c5/losses"]) / 2
    _hold_steps(g0, "c5", ref["c5"], losses)
    for key in g0:
        if key.startswith("c5/param/"):
            np.testing.assert_array_equal(g0[key], g1[key], err_msg=key)


def test_ep2_under_ernie_moe_shard_plan(two_ranks):
    """dp 1 x ep 2: each rank's banks hold 2 of the 4 experts, every
    parameter is a ``DistParameter``, the index path runs (as the
    reference's without a ``moe_group``), and the steps are the
    reference plan's."""
    _, ref, got = two_ranks
    assert ref["ep2_idx"]
    for g in got:
        assert g["ep2/bank_local"].tolist() == [[2, 64, 128], [2, 1, 64]]
        assert g["ep2/kinds"].tolist() == ["DistParameter"]
        assert g["ep2/path"] == "index"
        _hold_steps(g, "ep2", ref["ep2"], g["ep2/losses"])


def test_c6_hybrid_group_takes_the_einsum_path(two_ranks):
    """After ``fleet.init(mp_degree=2)``: the banks shard over mp (2
    experts a rank), ``FusedMoELayer`` and ERNIE-MoE take the einsum path
    in both packages and give the reference's values."""
    _, ref, got = two_ranks
    assert ref["c6f_mesh"] and ref["c6_mesh"]
    _close(ref["c6f"]["y_cut"], ref["c6f"]["y"], tol=GATE_TOL)
    assert abs(ref["c6_cut_loss"] - ref["c6"]["losses"][0]) <= GATE_TOL
    for g in got:
        assert g["c6f/bank_local"].tolist() == [2, D, H]
        assert g["c6f/path"] == "einsum" and g["c6/path"] == "einsum"
        _close(g["c6f/y"], ref["c6f"]["y"])
        _close(g["c6f/dx"], ref["c6f"]["dx"], rel=True)
        for name, want in ref["c6f"].items():
            if name.startswith("grad/"):
                _close(g[f"c6f/{name}"], want, rel=True, err_msg=name)
        _hold_steps(g, "c6", ref["c6"], g["c6/losses"])


@pytest.mark.parametrize("key", ["epf", "epm"])
def test_moe_group_layers(two_ranks, key):
    """``FusedMoELayer`` (einsum path, 2 experts a rank) and ``MoELayer``
    with a ``moe_group`` over ep 2: output, input gradient and every
    parameter's gradient (whole) equal the reference layer's."""
    _, ref, got = two_ranks
    want = ref[key]
    _close(want["y_cut"], want["y"], tol=GATE_TOL)
    for g in got:
        if key == "epf":
            assert g["epf/bank_local"].tolist() == [2, D, H]
            assert g["epf/path"] == "einsum"
        assert g[f"{key}/y"].dtype == np.float32
        _close(g[f"{key}/y"], want["y"])
        _close(g[f"{key}/dx"], want["dx"], rel=True)
        names = [n for n in want if n.startswith("grad/")]
        assert sorted(names) == sorted(k[len(key) + 1:] for k in g
                                       if k.startswith(f"{key}/grad/"))
        for name in names:
            _close(g[f"{key}/{name}"], want[name], rel=True, err_msg=name)


def test_tokens_sharded_over_the_expert_axis_raise(two_ranks):
    for g in two_ranks[2]:
        msg = str(g["epf/refusal"])
        assert "Shard(0)" in msg and "'ep'" in msg and "all-to-all" in msg


@pytest.mark.parametrize("kind", ["gshard", "switch"])
def test_gate_group_routes_the_global_batch(two_ranks, kind):
    inp, ref, got = two_ranks
    want = ref["gate"][kind]
    for rank, g in enumerate(got):
        rows = slice(16 * rank, 16 * (rank + 1))
        assert g[f"gate/{kind}/combine"].shape == want["combine"][rows].shape
        _close(g[f"gate/{kind}/combine"], want["combine"][rows],
               tol=GATE_TOL)
        np.testing.assert_array_equal(g[f"gate/{kind}/dispatch"],
                                      want["dispatch"][rows])
        _close(g[f"gate/{kind}/aux"], want["aux"], tol=GATE_TOL)
        _close(g[f"gate/{kind}/dgrad"], want["dgrad"], rel=True)
        _close(g[f"gate/{kind}/dx"], 2 * want["dx"][rows], rel=True)
    if kind == "gshard":        # the capacity binds: a pair is dropped
        assert want["dispatch"].sum() < 2 * 32
