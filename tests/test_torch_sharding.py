"""ZeRO sharding in the port on two gloo ranks on the CPU
(paddle_tpu_torch/distributed/: ``sharding`` (``group_sharded_parallel``,
``save_group_sharded_model``), ``auto_parallel.api``'s
``ShardingStage2`` / ``ShardingStage3``, ``fleet.meta_parallel``'s
``GroupSharded*`` and ``fleet.meta_optimizers``, ``DistModel`` at
sharding stage 3), held against the reference.

One spawn serves every case (``two_ranks``): two processes of
``tests/_torch_zero_worker.py`` in a gloo world of two, each on its half
of every batch, while this process computes the reference's results on
the whole batches. The cases are ``tests/test_sharding.py``'s:

- each level (``"os"``, ``"os_g"``, ``"p_g_os"``) trains like the
  unsharded model: the reference's MLP three AdamW steps (its
  ``_train_steps``), the mean of the ranks' losses, the ranks' mean
  step gradients and the parameters after; stage 1 keeps the states in
  halves and the parameters whole; stage 3 shards the parameters too;
- a level not in the list raises ``ValueError``;
- ``save_group_sharded_model`` after a ``"p_g_os"`` step writes the
  whole model, which the reference's ``paddle.load`` and the port's
  read, and whole optimizer states;
- ``fleet.init`` with a ``sharding`` axis (degree 2 here; the reference
  test's 4 x mp 2 on its mesh of eight): ``distributed_optimizer``
  returns the ``HybridParallelOptimizer``, the moments in halves, two
  steps as the reference's; ``DygraphShardingOptimizer`` alone;
- ``GroupShardedOptimizerStage2`` + ``GroupShardedStage2`` and
  ``GroupShardedStage3`` built directly;
- the ``"os_g"`` step under ``jit.to_static`` (the reference's jitted
  step's two losses);
- ``shard_optimizer(ShardingStage2)`` with a global-norm clip that
  bites (the norm sums each rank's rows over the axis);
- ``DistModel`` with ``strategy.sharding`` at stage 3 against the
  reference's ``DistModel`` at stage 3;
- the tiny Llama at each level against the reference's full batch (its
  steps under its ``jit.to_static``), and the tiny ERNIE-MoE at
  ``"os_g"``, whose gates route both ranks' tokens as one batch.

Tolerances: losses 2e-5 absolute (the reference test's 2e-5 relative,
here on values near 1), the mean gradients 1e-4 of their max |g|,
parameters 1e-5 absolute where every step's gradient is at least 1e-3
of the parameter's max |g| in both packages (Adam divides by |g|),
covering 70% of them (``test_torch_train.py``'s); the saved model equal
bit for bit to the gathered parameters. fp32 throughout.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.fleet as jfleet
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet.topology import \
    set_hybrid_communicate_group as jset_hcg
from paddle_tpu.models import ErnieMoeConfig as JConfig
from paddle_tpu.models import ErnieMoeForCausalLM as JMoe
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

import paddle_tpu_torch.distributed as tdist
import paddle_tpu_torch.optimizer as topt
from _torch_zoo import (fresh_hybrid_groups, numpy_init,  # noqa: F401
                        one_torch_thread)
from test_torch_expert_parallel import _inputs as ep_inputs
from test_torch_expert_parallel import _ref_ernie, _ref_ernie_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_zero_worker.py")
TIMEOUT = 240

LOSS_TOL = 2e-5
GRAD_REL = 1e-4
PARAM_TOL = 1e-5
G_FLOOR = 1e-3
COVERED = 0.7
CLIP = 0.05
LEVELS = ("os", "os_g", "p_g_os")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _inputs():
    """``tests/test_sharding.py``'s batches (``_train_steps``: seed 3, three
    [8, 16] -> [8, 8]; the jitted step's seed 0) and a tiny Llama
    batch."""
    rng = np.random.default_rng(3)
    xs, ys = [], []
    for _ in range(3):
        xs.append(rng.standard_normal((8, 16)).astype("float32"))
        ys.append(rng.standard_normal((8, 8)).astype("float32"))
    rng = np.random.default_rng(0)
    jx = rng.standard_normal((8, 16)).astype("float32")
    jy = rng.standard_normal((8, 8)).astype("float32")
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 256, (4, 16))
    moe = ep_inputs()
    return dict(xs=np.stack(xs), ys=np.stack(ys), jx=jx, jy=jy,
                lm_ids=ids, lm_labels=np.roll(ids, -1, axis=1),
                moe_ids=moe["ids"], moe_labels=moe["labels"],
                clip=np.float32(CLIP))


def _make_model(state=None):
    """``tests/test_sharding.py``'s MLP (seed 7), or these weights."""
    paddle.seed(7)
    m = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 8))
    if state is not None:
        m.set_state_dict(state)
    return m


def _state(m):
    return {k: np.asarray(v._value) for k, v in m.state_dict().items()}


def _train_steps(model, optimizer, xs, ys):
    """``_train_steps`` with the gradients of each step."""
    params = dict(model.named_parameters())
    out = dict(losses=[], grads=[])
    for x, y in zip(xs, ys):
        loss = ((model(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2
                ).mean()
        loss.backward()
        out["grads"].append({n: np.asarray(p.grad._value)
                             for n, p in params.items()})
        optimizer.step()
        optimizer.clear_grad()
        out["losses"].append(float(loss))
    out["params"] = {n: np.asarray(p._value) for n, p in params.items()}
    return out


def _mlp_run(state, inp, n=3, clip=None):
    m = _make_model(state)
    kw = {} if clip is None else dict(grad_clip=jnn.ClipGradByGlobalNorm(
        clip))
    opt = jopt.AdamW(learning_rate=0.01, parameters=m.parameters(), **kw)
    return _train_steps(m, opt, inp["xs"][:n], inp["ys"][:n])


def _hybrid_run(state, inp):
    """The reference test's hybrid topology (mp 2 x sharding 4 on its
    eight devices) and two steps."""
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 4,
                               "sep_degree": 1}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        model = jfleet.distributed_model(_make_model(state))
        opt = jfleet.distributed_optimizer(jopt.AdamW(
            learning_rate=0.01, parameters=model.parameters()))
        return _train_steps(model, opt, inp["xs"][:2], inp["ys"][:2])
    finally:
        jset_hcg(None)


def _jitted_losses(state, inp):
    model = _make_model(state)
    opt = jopt.AdamW(learning_rate=0.01, parameters=model.parameters())
    model, opt, _ = jdist.group_sharded_parallel(model, opt, "os_g")

    @paddle.jit.to_static
    def step(x, y):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    x, y = paddle.to_tensor(inp["jx"]), paddle.to_tensor(inp["jy"])
    return [float(step(x, y)) for _ in range(2)]


def _dist_model_stage3(state, inp):
    mesh = jdist.ProcessMesh(np.arange(2), ["dp"])
    model = _make_model(state)
    for p in model.parameters():
        jdist.shard_tensor(p, mesh, [jdist.Replicate()])
    opt = jopt.AdamW(learning_rate=0.01, parameters=model.parameters())
    strategy = jdist.Strategy({"sharding": {"enable": True, "stage": 3}})
    dm = jdist.to_static(model, loss=lambda o, y: ((o - y) ** 2).mean(),
                         optimizer=opt, strategy=strategy)
    losses = []
    for x, y in zip(inp["xs"], inp["ys"]):
        losses.append(float(dm(
            jdist.shard_tensor(paddle.to_tensor(x), mesh, [jdist.Shard(0)]),
            jdist.shard_tensor(paddle.to_tensor(y), mesh,
                               [jdist.Shard(0)]))))
    return dict(losses=losses, params={n: np.asarray(p._value) for n, p
                                       in model.named_parameters()})


def _llama_run(state, inp):
    """The tiny Llama's three AdamW steps on the whole batch under the
    reference's ``jit.to_static``."""
    with pytest.MonkeyPatch.context() as mp:
        numpy_init(mp, seed=7)
        jm = JLlama(JLlamaConfig.tiny())
    jm.set_state_dict(state)
    names = [n for n, _ in jm.named_parameters()]
    params = [p for _, p in jm.named_parameters()]
    jo = jopt.AdamW(learning_rate=1e-3, parameters=params)
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
    for _ in range(3):
        loss, grads = static(paddle.to_tensor(inp["lm_ids"]),
                             paddle.to_tensor(inp["lm_labels"]))
        out["losses"].append(float(loss))
        out["grads"].append({n: np.asarray(g._value)
                             for n, g in zip(names, grads)})
    out["params"] = {n: np.asarray(p._value) for n, p in zip(names, params)}
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """``_two_ranks`` with both packages' hybrid groups reset before and
    after (``fresh_hybrid_groups``, ROADMAP queue C, C7)."""
    with fresh_hybrid_groups():
        return _two_ranks(tmp_path_factory)


def _two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    state = _state(_make_model())
    np.savez(d / "mlp.npz", **state)
    with pytest.MonkeyPatch.context() as mp:
        numpy_init(mp, seed=7)
        llama = _state(JLlama(JLlamaConfig.tiny()))
    np.savez(d / "llama.npz", **llama)
    paddle.seed(3)
    ernie = _state(JMoe(JConfig.tiny()))
    np.savez(d / "ernie.npz", **ernie)
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
        ref = {"mlp": _mlp_run(state, inp),
               "mlp2": _mlp_run(state, inp, n=2),
               "clip": _mlp_run(state, inp, clip=CLIP),
               "hybrid": _hybrid_run(state, inp),
               "jit": _jitted_losses(state, inp),
               "dm3": _dist_model_stage3(state, inp),
               "llama": _llama_run(llama, inp),
               "ernie": _ref_ernie_steps(_ref_ernie(ernie), inp["moe_ids"],
                                         inp["moe_labels"])}
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return d, inp, ref, got


def _close(got, want, tol, rel=False, err_msg=""):
    want = np.asarray(want, np.float64)
    atol = tol * (np.abs(want).max() if rel else 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=err_msg)


def _hold(got, key, want, n):
    """The mean of the ranks' losses, the ranks' mean step-1 gradients and
    the parameters after ``n`` steps against the reference's ``want``;
    both ranks hold one model."""
    g0, g1 = got
    _close((g0[f"{key}/losses"] + g1[f"{key}/losses"]) / 2,
           want["losses"][:n], LOSS_TOL)
    for name, jg in want["grads"][0].items():
        assert g0[f"{key}/grad0/{name}"].dtype == np.float32
        _close(g0[f"{key}/grad0/{name}"], jg, GRAD_REL, rel=True,
               err_msg=name)
    covered = total = 0
    for name, jp in want["params"].items():
        gj = np.stack([s[name] for s in want["grads"][:n]])
        gt = np.stack([g0[f"{key}/grad{s}/{name}"] for s in range(n)])
        floor = G_FLOOR * float(np.abs(gj).max())
        keep = ((np.abs(gj).min(0) > floor) & (np.abs(gt).min(0) > floor)) \
            | ((gj == 0).all(0) & (gt == 0).all(0))
        _close(g0[f"{key}/param/{name}"][keep], jp[keep], PARAM_TOL,
               err_msg=name)
        covered += int(keep.sum())
        total += keep.size
        np.testing.assert_array_equal(g0[f"{key}/param/{name}"],
                                      g1[f"{key}/param/{name}"])
    assert covered >= COVERED * total, (covered, total)


@pytest.mark.parametrize("level", LEVELS)
def test_matches_unsharded_training(two_ranks, level):
    _, _, ref, got = two_ranks
    wrapper = {"os": "DataParallel", "os_g": "GroupShardedStage2",
               "p_g_os": "GroupShardedStage3"}[level]
    assert str(got[0][f"{level}/wrapper"]) == wrapper
    _hold(got, level, ref["mlp"], 3)


def test_stage1_states_sharded(two_ranks):
    """``"os"``: each rank holds half of every moment's rows; the
    parameters stay whole and unsharded."""
    g = two_ranks[3][0]
    assert g["os/m1_local"].tolist() == ["[16, 16]", "[16]", "[4, 32]",
                                         "[4]"]
    assert g["os/param_local"].tolist() == ["[32, 16]", "[32]", "[8, 32]",
                                            "[8]"]
    assert g["os/kinds"].tolist() == ["Parameter"] * 4
    assert g["os_g/m1_local"].tolist() == g["os/m1_local"].tolist()


def test_stage3_params_sharded(two_ranks):
    """``"p_g_os"``: every parameter is this rank's rows between steps (a
    ``DistParameter``), its moments too; direct ``GroupShardedStage3`` the
    same; training still matches (``test_matches_unsharded_training``)."""
    g = two_ranks[3][0]
    shards = ["[16, 16]", "[16]", "[4, 32]", "[4]"]
    assert g["p_g_os/param_local"].tolist() == shards
    assert g["p_g_os/m1_local"].tolist() == shards
    assert g["p_g_os/kinds"].tolist() == ["DistParameter"] * 4
    assert g["stage3_classes/param_local"].tolist() == shards


def test_bad_level_rejected():
    model = torch.nn.Linear(4, 4)
    opt = topt.AdamW(learning_rate=0.01, parameters=model.parameters())
    with pytest.raises(ValueError):
        tdist.group_sharded_parallel(model, opt, "zeRO-9")
    jm = _make_model()
    with pytest.raises(ValueError):
        jdist.group_sharded_parallel(
            jm, jopt.AdamW(learning_rate=0.01, parameters=jm.parameters()),
            "zeRO-9")


def test_save_group_sharded_model(two_ranks):
    """The whole model after one ``"p_g_os"`` step: the reference's
    ``paddle.load`` reads the port's file, whose values are the gathered
    parameters bit for bit, as a fresh port model loaded from it; the
    optimizer file holds whole moments."""
    d, _, ref, got = two_ranks
    state = paddle.load(str(d / "ckpt" / "model.pdparams"))
    assert sorted(state) == ["0.bias", "0.weight", "2.bias", "2.weight"]
    for g in got:
        for name, t in state.items():
            a = np.asarray(t._value)
            assert a.dtype == np.float32
            # torch's [out, in] in the file; the worker's in [in, out]
            np.testing.assert_array_equal(a.T if a.ndim == 2 else a,
                                          g[f"save/param/{name}"])
            np.testing.assert_array_equal(g[f"save/fresh/{name}"],
                                          g[f"save/param/{name}"])
    _close(got[0]["save/param/0.weight"], ref["mlp"]["params"]["0.weight"],
           1.0)      # finite and of the whole shape
    shapes = got[0]["save/opt_shapes"].tolist()
    assert "param_0__moment1:[32, 16]" in shapes or any(
        s.endswith("__moment1:[32, 16]") for s in shapes), shapes


@pytest.mark.parametrize("key", ["hybrid", "dygraph"])
def test_hybrid_topology_sharding_axis(two_ranks, key):
    """At a sharding degree of 2 ``distributed_optimizer`` is the
    ``HybridParallelOptimizer``; it and ``DygraphShardingOptimizer`` keep
    half of each moment's rows and train as the reference's hybrid
    run."""
    _, _, ref, got = two_ranks
    want = {"hybrid": "HybridParallelOptimizer",
            "dygraph": "DygraphShardingOptimizer"}[key]
    for g in got:
        assert str(g[f"{key}/class"]) == want
        assert g[f"{key}/m1_rows"].tolist() == [16, 16, 4, 4]
    _close(ref["hybrid"]["losses"], ref["mlp2"]["losses"], LOSS_TOL)
    _hold(got, key, ref["hybrid"], 2)


@pytest.mark.parametrize("key", ["stage2_classes", "stage3_classes"])
def test_group_sharded_classes(two_ranks, key):
    _, _, ref, got = two_ranks
    _hold(got, key, ref["mlp2"], 2)


def test_jitted_sharded_step(two_ranks):
    _, _, ref, got = two_ranks
    l0, l1 = (g["jit/losses"] for g in got)
    _close((l0 + l1) / 2, ref["jit"], LOSS_TOL)
    assert ref["jit"][1] < ref["jit"][0]


def test_stage2_clip_norm_over_the_rows(two_ranks):
    _, _, ref, got = two_ranks
    norm = np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                       for a in ref["clip"]["grads"][0].values()))
    assert norm > 2 * CLIP, norm        # the clip bites
    _hold(got, "clip2", ref["clip"], 3)


def test_dist_model_stage3(two_ranks):
    """``strategy.sharding`` stage 3: the parameters in halves between
    steps, the losses and parameters the reference ``DistModel``'s."""
    _, _, ref, got = two_ranks
    for g in got:
        assert g["dm3/param_local"].tolist() == ["[16, 16]", "[16]",
                                                 "[4, 32]", "[4]"]
        _close(g["dm3/losses"], ref["dm3"]["losses"], LOSS_TOL)
        for name, jp in ref["dm3"]["params"].items():
            _close(g[f"dm3/param/{name}"], jp, PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("level", LEVELS)
def test_llama_trains_at_each_level(two_ranks, level):
    _, _, ref, got = two_ranks
    key = f"llama_{level}"
    assert str(got[0][f"{key}/loss_dtype"]) == "torch.float32"
    assert int(got[0][f"{key}/sharded"]) == (
        len(ref["llama"]["params"]) if level == "p_g_os" else 0)
    _hold(got, key, ref["llama"], 3)


def test_moe_routes_both_ranks_tokens_under_zero2(two_ranks):
    """ERNIE-MoE tiny at ``"os_g"``: ``GroupShardedStage2`` hands its
    group to the gates, so each rank routes in the global batch and the
    steps are the reference's full batch's (C5's case)."""
    _, _, ref, got = two_ranks
    assert got[0]["ernie_os_g/batch_group"].tolist() == [0, 1]
    assert str(got[0]["ernie_os_g/loss_dtype"]) == "torch.float32"
    _hold(got, "ernie_os_g", ref["ernie"], 3)
