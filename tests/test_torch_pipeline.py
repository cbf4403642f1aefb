"""The pipeline in the port (paddle_tpu_torch/distributed/fleet:
``meta_parallel``'s ``pipeline_schedules``, ``pp_layers`` and
``pipeline_parallel``; ``pipeline_spmd``; ``pipeline_spmd_engine``), held
against the reference.

In one process (the reference's cases of ``tests/test_pipeline.py``,
``tests/test_pipeline_schedules.py`` and ``tests/test_pipeline_engine.py``
that need no mesh): the schedule generators and ``simulate`` equal the
reference's task for task and tick for tick, the plans equal its tables
and slot counts, the segmentation and ``SharedLayerDesc``'s tying, and
``PipelineParallel`` under every schedule against the reference's with
its weights (``convert.load_paddle_tpu_state``).

On two gloo ranks (``two_ranks``: ``tests/_torch_pp_worker.py`` after
``fleet.init`` with ``pp_degree`` 2, while this process computes the
reference's results on a mesh of two of its devices): ``PipelineParallel``
with each rank one stage under FThenB, 1F1B, Eager1F1B, ZBH1 and VPP 2,
and with a ``SharedLayerDesc`` tied across the two stages, against the
reference's single controller; ``fleet.distributed_model`` wrapping a
``PipelineLayer``; ``pipeline_spmd_apply`` and ``pipeline_spmd_train_step``
(1F1B and GPipe); ``pipeline_schedule_train_step`` under 1F1B, Eager1F1B,
FThenB, ZBH1 and VPP 2, with tensor parallelism inside a stage (pp 1 x
mp 2) and data parallelism around it (dp 2 x pp 1).

Tolerances: fp32 throughout; losses 1e-6 absolute, gradients and
parameters 1e-5 of their max |value|; 25 Adam steps' losses 1e-5.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.auto_parallel.placement import \
    ProcessMesh as JMesh
from paddle_tpu.distributed.fleet import pipeline_spmd as jspmd
from paddle_tpu.distributed.fleet import pipeline_spmd_engine as jeng
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JDesc, PipelineLayer as JLayer,
    PipelineParallel as JParallel, SharedLayerDesc as JShared)
from paddle_tpu.distributed.fleet.meta_parallel import \
    pipeline_schedules as jsched

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.distributed.fleet import \
    pipeline_spmd_engine as teng
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel, SharedLayerDesc)
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    pipeline_schedules as tsched

from _torch_zoo import fresh_hybrid_groups, no_hybrid_groups  # noqa: F401
from _torch_zoo import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_pp_worker.py")
TIMEOUT = 240
LOSS_TOL = 1e-6
REL = 1e-5

sys.path.insert(0, os.path.dirname(WORKER))
from _torch_pp_worker import ENGINE_CASES, PP_MODES  # noqa: E402


def _close(got, want, tol=REL, rel=True, err_msg=""):
    want = np.asarray(want, np.float64)
    atol = tol * (max(np.abs(want).max(), 1e-30) if rel else 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=err_msg)


def _state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


class _JBlock(jnn.Layer):
    def __init__(self, d=8):
        super().__init__()
        self.fc = jnn.Linear(d, d)

    def forward(self, x):
        return paddle.tanh(self.fc(x))


class _Block(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        self.fc = torch.nn.Linear(d, d)

    def forward(self, x):
        return torch.tanh(self.fc(x))


def _pair(n_layers=4, num_stages=2, seed=7, **kw):
    paddle.seed(seed)
    jp = JLayer([JDesc(_JBlock, 8) for _ in range(n_layers)],
                num_stages=num_stages, **kw)
    tp = PipelineLayer([LayerDesc(_Block, 8) for _ in range(n_layers)],
                       num_stages=num_stages, **kw)
    load_paddle_tpu_state(tp, _state(jp))
    return jp, tp


# --------------------------------------------------------------------------
# schedules and plans
# --------------------------------------------------------------------------
def _tasks(seq):
    return [tuple(t) for t in seq]


def _same_simulation(mod_a, mod_b, streams_a, streams_b, pp, m, vpp=1):
    a = mod_a.simulate(streams_a, pp, m, vpp)
    b = mod_b.simulate(streams_b, pp, m, vpp)
    for key in ("makespan", "bubble_fraction", "peak_activations"):
        assert a[key] == b[key], key
    assert [(s, tuple(t)) for s, t in a["order"]] == \
        [(s, tuple(t)) for s, t in b["order"]]
    assert [{s: tuple(t) for s, t in tick.items()} for tick in a["ticks"]] \
        == [{s: tuple(t) for s, t in tick.items()} for tick in b["ticks"]]


@pytest.mark.parametrize("mode", ["FThenB", "1F1B", "Eager1F1B", "ZBH1"])
@pytest.mark.parametrize("pp,m", [(2, 4), (4, 8), (4, 4), (3, 6)])
def test_schedules_equal_the_reference(mode, pp, m):
    """Every stage's stream and the simulation (order, ticks, makespan,
    bubble, peak activations) equal the reference's."""
    ts = {s: tsched.make_schedule(mode, s, pp, m) for s in range(pp)}
    js = {s: jsched.make_schedule(mode, s, pp, m) for s in range(pp)}
    assert {s: _tasks(v) for s, v in ts.items()} == \
        {s: _tasks(v) for s, v in js.items()}
    _same_simulation(tsched, jsched, ts, js, pp, m)


@pytest.mark.parametrize("pp,m,vpp", [(2, 4, 2), (2, 2, 3), (4, 4, 2)])
def test_vpp_schedules_equal_the_reference(pp, m, vpp):
    ts = {s: tsched.vpp_schedule(s, pp, m, vpp) for s in range(pp)}
    js = {s: jsched.vpp_schedule(s, pp, m, vpp) for s in range(pp)}
    assert {s: _tasks(v) for s, v in ts.items()} == \
        {s: _tasks(v) for s, v in js.items()}
    _same_simulation(tsched, jsched, ts, js, pp, m, vpp)


@pytest.mark.parametrize("call,exc", [
    (lambda m: m.vpp_schedule(0, 4, 6, 2), ValueError),
    (lambda m: m.make_schedule("bogus", 0, 2, 4), ValueError),
    (lambda m: m.simulate({0: [m.Task("B", 0, 0)],
                           1: [m.Task("F", 0, 1), m.Task("B", 0, 1)]},
                          2, 1), RuntimeError),
], ids=["vpp_divisibility", "unknown_mode", "deadlock"])
def test_schedule_refusals_as_the_reference(call, exc):
    for mod in (jsched, tsched):
        with pytest.raises(exc):
            call(mod)


PLAN_CASES = [("1f1b", 4, 16, 1), ("fthenb", 4, 16, 1), ("zbh1", 4, 12, 1),
              ("eager1f1b", 4, 8, 1), ("vpp", 4, 8, 2), ("vpp", 4, 4, 3),
              ("1f1b", 2, 4, 1)]


@pytest.mark.parametrize("schedule,S,M,vpp", PLAN_CASES)
def test_plans_equal_the_reference(schedule, S, M, vpp):
    """``compile_pipeline_plan``: every routing table, the slot count and
    the bubble equal the reference's (1F1B's slots stay O(S), FThenB's
    grow with M)."""
    a = teng.compile_pipeline_plan(schedule, S, M, vpp)
    b = jeng.compile_pipeline_plan(schedule, S, M, vpp)
    for field in a._fields:
        va, vb = getattr(a, field), getattr(b, field)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=field)
        else:
            assert va == vb, field
    assert a.masked_compute_overhead() == b.masked_compute_overhead()


def test_plan_refuses_a_mesh_of_another_size():
    from paddle_tpu_torch.distributed import ProcessMesh

    plan = teng.compile_pipeline_plan("1f1b", S=2, M=4)
    with pytest.raises(ValueError, match="stages"):
        teng.pipeline_schedule_train_step(
            None, None, {}, torch.zeros(4, 2, 8), torch.zeros(4, 2, 8),
            mesh=ProcessMesh(np.arange(4), ["pp"]), plan=plan)


# --------------------------------------------------------------------------
# PipelineLayer and PipelineParallel in one process
# --------------------------------------------------------------------------
def test_segmentation_as_the_reference():
    jp, tp = _pair(n_layers=5)
    assert tp.segment_parts == jp.segment_parts == [0, 3, 5]
    assert tp.get_stage_from_index(2) == 0 and tp.get_stage_from_index(3) == 1
    assert len(tp.stage_layers(0)) == 3 and tp.stage is None
    jd = [JDesc(_JBlock, 8) for _ in range(4)]
    td = [LayerDesc(_Block, 8) for _ in range(4)]
    assert PipelineLayer(td, num_stages=4, seg_method="layer:Block") \
        .segment_parts == JLayer(jd, num_stages=4,
                                 seg_method="layer:Block").segment_parts
    with pytest.raises(TypeError):
        LayerDesc(int)


def test_forward_matches_the_reference():
    jp, tp = _pair()
    x = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)
    _close(tp(torch.from_numpy(x)).detach(),
           np.asarray(jp(paddle.to_tensor(x))._value))


def test_shared_layer_desc_ties_weights():
    td = [SharedLayerDesc("emb", _Block, None, "fc", 8),
          LayerDesc(_Block, 8), SharedLayerDesc("emb", _Block, None, "fc", 8),
          LayerDesc(_Block, 8)]
    jd = [JShared("emb", _JBlock, None, "fc", 8), JDesc(_JBlock, 8),
          JShared("emb", _JBlock, None, "fc", 8), JDesc(_JBlock, 8)]
    tp, jp = PipelineLayer(td, num_stages=2), JLayer(jd, num_stages=2)
    assert tp.run_function[0] is tp.run_function[2]
    assert jp.run_function[0] is jp.run_function[2]


def _mse(out, label):
    return ((out - label) * (out - label)).mean()


@pytest.mark.parametrize("schedule", ["FThenB", "1F1B", "Eager1F1B"])
def test_pipeline_parallel_matches_the_reference(schedule):
    """One ``train_batch`` (4 micro-batches, SGD 0.1): the loss and every
    parameter after it equal the reference's."""
    jp, tp = _pair(loss_fn=None)
    jp._loss_fn, tp._loss_fn = _mse, _mse
    cfg = {"accumulate_steps": 4, "schedule_mode": schedule}
    jpp = JParallel(jp, strategy=type("S", (), {"pipeline_configs": cfg})())
    tpp = PipelineParallel(tp, strategy=type("S", (), {
        "pipeline_configs": cfg})())
    rng = np.random.default_rng(2)
    xs, ys = (rng.standard_normal((8, 8)).astype(np.float32)
              for _ in range(2))
    jl = jpp.train_batch([paddle.to_tensor(xs), paddle.to_tensor(ys)],
                         jopt.SGD(learning_rate=0.1,
                                  parameters=jpp.parameters()))
    tl = tpp.train_batch([torch.from_numpy(xs), torch.from_numpy(ys)],
                         topt.SGD(learning_rate=0.1,
                                  parameters=list(tpp.parameters())))
    assert tl.dtype == torch.float32
    _close(tl, float(jl._value), tol=LOSS_TOL, rel=False)
    want = _state(jp)
    for name, p in tp.named_parameters():
        got = p.detach().numpy()
        _close(got.T if got.ndim == 2 else got, want[name], err_msg=name)


def _schedule_pair(mode, vpp=1, seed=0, recompute=0):
    """``tests/test_pipeline_schedules.py``'s model in both packages."""
    paddle.seed(seed)
    jd = [JDesc(jnn.Linear, 8, 8) for _ in range(4)] + [JDesc(jnn.Linear, 8,
                                                              2)]
    td = [LayerDesc(torch.nn.Linear, 8, 8) for _ in range(4)] + [
        LayerDesc(torch.nn.Linear, 8, 2)]
    cfg = type("S", (), {"pipeline_configs": {"accumulate_steps": 4,
                                              "schedule_mode": mode}})()
    kw = dict(num_stages=2, num_virtual_pipeline_stages=vpp,
              recompute_interval=recompute)
    jl = JLayer(jd, loss_fn=jnn.CrossEntropyLoss(), **kw)
    tl = PipelineLayer(td, loss_fn=torch.nn.CrossEntropyLoss(), **kw)
    load_paddle_tpu_state(tl, _state(jl))
    return JParallel(jl, strategy=cfg), PipelineParallel(tl, strategy=cfg)


def _xy(seed, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    return x, rng.integers(0, 2, (n,))


@pytest.mark.parametrize("mode,vpp,recompute", [
    ("VPP", 2, 0), ("ZBH1", 1, 0), ("VPP", 2, 1), ("1F1B", 1, 0)])
def test_task_schedules_match_the_reference(mode, vpp, recompute):
    """``forward_backward_pipeline``: the loss and every gradient equal
    the reference's (VPP and ZBH1 run ``simulate``'s order chunk by
    chunk; VPP with a recompute interval of 1)."""
    jpp, tpp = _schedule_pair(mode, vpp, recompute=recompute)
    x, y = _xy(0)
    jl = jpp.forward_backward_pipeline([paddle.to_tensor(x),
                                        paddle.to_tensor(y)])
    tl = tpp.forward_backward_pipeline([torch.from_numpy(x),
                                        torch.from_numpy(y)])
    _close(tl, float(jl._value), tol=LOSS_TOL, rel=False)
    jg = {n: np.asarray(p.grad._value)
          for n, p in jpp._layers.named_parameters()}
    for name, p in tpp._layers.named_parameters():
        g = p.grad.numpy()
        _close(g.T if g.ndim == 2 else g, jg[name], err_msg=name)


def test_zbh1_refuses_virtual_stages_as_the_reference():
    jpp, tpp = _schedule_pair("ZBH1", vpp=2)
    x, y = _xy(0)
    with pytest.raises(ValueError):
        jpp.forward_backward_pipeline([paddle.to_tensor(x),
                                       paddle.to_tensor(y)])
    with pytest.raises(ValueError, match="virtual"):
        tpp.forward_backward_pipeline([torch.from_numpy(x),
                                       torch.from_numpy(y)])


@pytest.mark.parametrize("mode,vpp", [("VPP", 2), ("ZBH1", 1)])
def test_train_batch_converges_as_the_reference(mode, vpp):
    """25 Adam steps of ``train_batch``: the losses equal the reference's
    and fall below 0.7 of the first."""
    jpp, tpp = _schedule_pair(mode, vpp, seed=1)
    x, _ = _xy(1, 16)
    y = (x.sum(-1) > 0).astype("int64")
    jo = jopt.Adam(learning_rate=0.05, parameters=jpp.parameters())
    to = topt.Adam(learning_rate=0.05, parameters=list(tpp.parameters()))
    jl, tl = [], []
    for _ in range(25):
        jl.append(float(jpp.train_batch([paddle.to_tensor(x),
                                         paddle.to_tensor(y)], jo)._value))
        tl.append(float(tpp.train_batch([torch.from_numpy(x),
                                         torch.from_numpy(y)], to)))
    _close(tl, jl, tol=REL, rel=False)
    assert tl[-1] < tl[0] * 0.7


def test_eval_batch_matches_the_reference():
    jpp, tpp = _schedule_pair("1F1B")
    x, y = _xy(3)
    jl = jpp.eval_batch([paddle.to_tensor(x), paddle.to_tensor(y)])
    tl = tpp.eval_batch([torch.from_numpy(x), torch.from_numpy(y)])
    _close(tl, float(jl._value), tol=LOSS_TOL, rel=False)


@pytest.mark.parametrize("mode,vpp", [("1F1B", 1), ("FThenB", 1),
                                      ("ZBH1", 1), ("VPP", 2)])
def test_transfers_go_between_neighbours_and_pair_up(mode, vpp):
    """At pp 4, each stage's ``_Exchange`` over the whole tick table:
    a stage sends at most one payload a tick, to the next or previous
    stage (wrapping for virtual chunks), each send is one receive
    posted by its peer at the same tick, and a stage's bytes sent are
    its payloads' alone."""
    from types import SimpleNamespace

    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        pipeline_parallel as tpp

    S, m, shape = 4, 8, (2, 3)
    ticks = tsched.simulate(
        {s: tsched.make_schedule(mode, s, S, m, vpp) for s in range(S)},
        S, m, vpp)["ticks"]
    posted = []

    def p2p_of(stage):
        def p2p(sends, recvs):
            meta = any(t.dtype == torch.int64 for t, _, _ in sends) or \
                any(dt == torch.int64 for _, dt, _, _ in recvs)
            posted.append((stage, meta, [(stage, d) for _, d, _ in sends],
                           [(src, stage) for _, _, src, _ in recvs]))
            return [torch.tensor([0, 2, *shape, 0, 0, 0, 0])
                    if sh == (8,) else torch.zeros(sh, dtype=dt)
                    for sh, dt, _, _ in recvs]
        return p2p

    exes = []
    for s in range(S):
        ex = tpp._Exchange(SimpleNamespace(process_group=None), "cpu")
        ex._p2p = p2p_of(s)
        exes.append(ex)
    payload = torch.ones(shape)
    sent = [0] * S
    for assign in ticks:
        transfers = tpp._transfers(assign, S, S * vpp - 1)
        if not transfers:
            continue
        del posted[:]
        for s, ex in enumerate(exes):
            got = ex.run(s, payload if s in transfers else None, transfers)
            assert sorted(got) == sorted(
                src for src, (_, dst) in transfers.items() if dst == s)
            assert all(x.shape == shape for x in got.values())
            sent[s] += payload.nbytes if s in transfers else 0
        for meta in (True, False):
            sends = [p for _, mt, ss, _ in posted if mt == meta for p in ss]
            recvs = [p for _, mt, _, rr in posted if mt == meta for p in rr]
            assert sorted(sends) == sorted(recvs)
            assert all(d in ((s + 1) % S, (s - 1) % S) for s, d in sends)
        assert all(len(ss) <= 1 for _, _, ss, _ in posted)
    assert [ex.bytes_sent for ex in exes] == sent
    assert all(ex.meta for ex in exes)


def test_data_parallel_around_pipeline_ranks_is_refused():
    """Over pipeline ranks a data-parallel degree above 1 raises until a
    later slice makes the replicas' stages equal and averages their
    gradients."""
    _, tpp = _schedule_pair("1F1B")
    layers = tpp._layers
    layers._stage = 0
    layers._hcg = type("Hcg", (), {
        "get_data_parallel_world_size": lambda self: 2})()
    with pytest.raises(NotImplementedError, match="data-parallel"):
        PipelineParallel(layers)


# --------------------------------------------------------------------------
# two ranks
# --------------------------------------------------------------------------
def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(f)
    return dict(x=n(8, 8), y=rng.integers(0, 2, (8,)),
                spmd_w=n(2, 4, 4, scale=0.3), spmd_b=n(2, 4, scale=0.1),
                spmd_xs=n(4, 2, 4), spmd_ys=n(4, 2, 4),
                eng1_w=n(2, 8, 8, scale=0.4), eng1_b=n(2, 8, scale=0.1),
                eng2_w=n(4, 8, 8, scale=0.4), eng2_b=n(4, 8, scale=0.1),
                eng_xs=n(4, 2, 8), eng_ys=n(4, 2, 8),
                tp_wg=n(1, 8, 12, scale=0.4), tp_wd=n(1, 12, 8, scale=0.4),
                tp_b=n(1, 8, scale=0.1), tp_xs=n(4, 2, 8), tp_ys=n(4, 2, 8),
                dp_xs=n(4, 4, 8), dp_ys=n(4, 4, 8))


def _ref_descs(shared):
    if shared:
        return [JShared("t", jnn.Linear, None, "weight", 8, 8),
                JDesc(jnn.Linear, 8, 8), JDesc(jnn.Linear, 8, 8),
                JShared("t", jnn.Linear, None, "weight", 8, 8),
                JDesc(jnn.Linear, 8, 2)]
    return [JDesc(jnn.Linear, 8, 8) for _ in range(4)] + [
        JDesc(jnn.Linear, 8, 2)]


def _ref_pipeline(inp, state, mode, vpp, shared):
    layers = JLayer(_ref_descs(shared), num_stages=2,
                    loss_fn=jnn.CrossEntropyLoss(),
                    num_virtual_pipeline_stages=vpp)
    layers.set_state_dict(state)
    cfg = type("S", (), {"pipeline_configs": {"accumulate_steps": 4,
                                              "schedule_mode": mode}})()
    pipe = JParallel(layers, strategy=cfg)
    data = [paddle.to_tensor(inp["x"]), paddle.to_tensor(inp["y"])]
    out = {"loss": float(pipe.forward_backward_pipeline(data)._value)}
    params = dict(layers.named_parameters())
    out["grad"] = {n: np.asarray(p.grad._value) for n, p in params.items()}
    opt = jopt.SGD(learning_rate=0.1, parameters=list(params.values()))
    opt.step()
    opt.clear_grad()
    out["param"] = {n: np.asarray(p._value) for n, p in params.items()}
    out["eval"] = float(pipe.eval_batch(data)._value)
    return out


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jloss(y, label):
    return jnp.mean((y - label) ** 2)


def _ref_spmd(inp):
    mesh = JMesh(np.arange(2), ["pp"]).jax_mesh
    stacked = {"w": jnp.asarray(inp["spmd_w"]),
               "b": jnp.asarray(inp["spmd_b"])}
    xs, ys = jnp.asarray(inp["spmd_xs"]), jnp.asarray(inp["spmd_ys"])

    def apply(params):
        return jspmd.pipeline_spmd_apply(
            lambda p, x: jnp.tanh(x @ p["w"]), params, xs, mesh=mesh,
            axis="pp")

    out = {"apply/outs": np.asarray(apply(stacked)),
           "apply/dw": np.asarray(jax.grad(
               lambda p: (apply(p) ** 2).sum())(stacked)["w"])}
    for schedule in ("1f1b", "gpipe"):
        loss, grads = jspmd.pipeline_spmd_train_step(
            _jstage, _jloss, stacked, xs, ys, mesh=mesh, schedule=schedule)
        out[f"spmd_{schedule}/loss"] = float(loss)
        for n, g in grads.items():
            out[f"spmd_{schedule}/{n}"] = np.asarray(g)
    return out


def _ref_engine(inp):
    mesh = JMesh(np.arange(2), ["pp"]).jax_mesh
    out = {}
    for schedule, vpp, m in ENGINE_CASES:
        plan = jeng.compile_pipeline_plan(schedule, S=2, M=m, vpp=vpp)
        params = {n: jnp.asarray(inp[f"eng{vpp}_{n}"]) for n in ("w", "b")}
        loss, grads = jeng.pipeline_schedule_train_step(
            _jstage, _jloss, params, jnp.asarray(inp["eng_xs"]),
            jnp.asarray(inp["eng_ys"]), mesh=mesh, plan=plan)
        key = f"engine/{schedule}{vpp}"
        out[f"{key}/loss"] = float(loss)
        out[f"{key}/slots"] = plan.num_slots
        for n, g in grads.items():
            out[f"{key}/{n}"] = np.asarray(g)

    def tp_stage(p, x):
        h = jax.nn.silu(jeng.mp_copy(x, "mp") @ p["wg"])
        return x + jeng.mp_reduce(h @ p["wd"], "mp") + p["b"]

    loss, grads = jeng.pipeline_schedule_train_step(
        tp_stage, _jloss, {n: jnp.asarray(inp[f"tp_{n}"])
                           for n in ("wg", "wd", "b")},
        jnp.asarray(inp["tp_xs"]), jnp.asarray(inp["tp_ys"]),
        mesh=JMesh(np.arange(2).reshape(1, 2), ["pp", "mp"]).jax_mesh,
        plan=jeng.compile_pipeline_plan("1f1b", S=1, M=4), axis="pp",
        param_pspecs={"wg": P(None, "mp"), "wd": P("mp", None),
                      "b": P(None)})
    out["engine/tp/loss"] = float(loss)
    for n, g in grads.items():
        out[f"engine/tp/{n}"] = np.asarray(g)
    loss, grads = jeng.pipeline_schedule_train_step(
        _jstage, _jloss, {n: jnp.asarray(inp[f"eng1_{n}"])[:1]
                          for n in ("w", "b")},
        jnp.asarray(inp["dp_xs"]), jnp.asarray(inp["dp_ys"]),
        mesh=JMesh(np.arange(2).reshape(2, 1), ["dp", "pp"]).jax_mesh,
        plan=jeng.compile_pipeline_plan("1f1b", S=1, M=4), axis="pp",
        data_axis="dp")
    out["engine/dp/loss"] = float(loss)
    for n, g in grads.items():
        out[f"engine/dp/{n}"] = np.asarray(g)
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """``_two_ranks`` with both packages' hybrid groups reset before and
    after (``fresh_hybrid_groups``)."""
    with fresh_hybrid_groups():
        return _two_ranks(tmp_path_factory)


def _two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    states = {}
    for name, shared in (("pipe", False), ("shared", True)):
        paddle.seed(5)
        states[name] = _state(JLayer(_ref_descs(shared), num_stages=2))
        np.savez(d / f"{name}.npz", **states[name])
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""),
           "PADDLE_TRAINERS_NUM": "2",
           "PADDLE_MASTER": f"127.0.0.1:{_free_port()}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(d)], cwd=REPO,
        env={**env, "PADDLE_TRAINER_ID": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        ref = {f"pipe/{mode}": _ref_pipeline(inp, states["pipe"], mode, vpp,
                                             False)
               for mode, vpp in PP_MODES}
        ref["shared/1F1B"] = _ref_pipeline(inp, states["shared"], "1F1B", 1,
                                           True)
        ref.update(_ref_spmd(inp))
        ref.update(_ref_engine(inp))
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return inp, ref, got


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ref_name(name):
    """A port parameter's name in the reference's state: the reference
    names a shared layer once, at its first occurrence (layer 0 here)."""
    head, rest = name.split(".", 1)
    return f"shared_t_0.{rest}" if head.startswith("shared_t_") else name


@pytest.mark.parametrize("key", [f"pipe/{m}" for m, _ in PP_MODES]
                         + ["shared/1F1B"])
def test_pipeline_parallel_over_two_ranks(two_ranks, key):
    """Each rank holds its stage's layers (VPP: chunks 0 and 2, or 1 and
    3); the mean loss on both ranks, every held parameter's gradient and
    value after an SGD step, and ``eval_batch`` equal the reference's
    single controller; a tied weight is one across the stages."""
    _, ref, got = two_ranks
    want = ref[key]
    held = {"pipe/VPP": [[0, 1, 3], [2, 4]]}.get(key, [[0, 1, 2], [3, 4]])
    for rank, g in enumerate(got):
        assert int(g[f"{key}/stage"]) == rank
        assert g[f"{key}/held"].tolist() == held[rank]
        assert g[f"{key}/loss"].dtype == np.float32
        _close(g[f"{key}/loss"], want["loss"], tol=LOSS_TOL, rel=False)
        _close(g[f"{key}/eval"], want["eval"], tol=LOSS_TOL, rel=False)
        assert int(g[f"{key}/bytes_sent"]) > 0
        names = [k.split("/", 3)[3] for k in g if k.startswith(f"{key}/grad/")]
        assert names
        for name in names:
            _close(g[f"{key}/grad/{name}"], want["grad"][_ref_name(name)],
                   err_msg=name)
            _close(g[f"{key}/param/{name}"], want["param"][_ref_name(name)],
                   err_msg=name)
    if key.startswith("shared"):
        np.testing.assert_array_equal(got[0][f"{key}/param/shared_t_0.weight"],
                                      got[1][f"{key}/param/shared_t_3.weight"])


def test_distributed_model_wraps_a_pipeline_layer(two_ranks):
    for g in two_ranks[2]:
        assert str(g["fleet_model"]) == "PipelineParallel"


def test_pipeline_spmd_over_two_ranks(two_ranks):
    """``pipeline_spmd_apply``'s outputs on both ranks and each rank's row
    of the gradient; ``pipeline_spmd_train_step``'s loss and gradients
    under 1F1B and GPipe (whole stacks gathered; a rank passing its own
    row gets its row's gradient); an unknown schedule refused."""
    _, ref, got = two_ranks
    for rank, g in enumerate(got):
        _close(g["apply/outs"], ref["apply/outs"])
        _close(g["apply/dw"][rank], ref["apply/dw"][rank])
        assert not g["apply/dw"][1 - rank].any()
        for schedule in ("1f1b", "gpipe"):
            key = f"spmd_{schedule}"
            _close(g[f"{key}/loss"], ref[f"{key}/loss"], tol=LOSS_TOL,
                   rel=False)
            for n in ("w", "b"):
                assert g[f"{key}/{n}"].shape == ref[f"{key}/{n}"].shape
                _close(g[f"{key}/{n}"], ref[f"{key}/{n}"], err_msg=key + n)
        _close(g["spmd_own/w"], ref["spmd_1f1b/w"][rank:rank + 1])
        # 1F1B's saved inputs: a ring of S (2) micro-batches [2, 4], not M
        assert g["spmd_ring"].tolist() == [2, 2, 4]
        assert "schedule" in str(g["spmd_refusal"])


@pytest.mark.parametrize("case", [f"{s}{v}" for s, v, _ in ENGINE_CASES]
                         + ["tp", "dp"])
def test_pipeline_schedule_train_step_over_two_ranks(two_ranks, case):
    """``pipeline_schedule_train_step`` at pp 2 (and at pp 1 with mp 2 in
    a stage, or dp 2 around it): the loss, every chunk's gradient and the
    plan's slot count equal the reference's on its two-device mesh."""
    _, ref, got = two_ranks
    key = f"engine/{case}"
    for g in got:
        _close(g[f"{key}/loss"], ref[f"{key}/loss"], tol=LOSS_TOL, rel=False)
        if f"{key}/slots" in g:
            assert int(g[f"{key}/slots"]) == ref[f"{key}/slots"]
        names = [k[len(key) + 1:] for k in ref if k.startswith(f"{key}/")
                 and k not in (f"{key}/loss", f"{key}/slots")]
        for n in names:
            assert g[f"{key}/{n}"].dtype == np.float32
            _close(g[f"{key}/{n}"], ref[f"{key}/{n}"], err_msg=n)
