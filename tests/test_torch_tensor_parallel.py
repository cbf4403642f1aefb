"""Tensor and sequence parallelism of the port on two gloo ranks on the
CPU (paddle_tpu_torch/distributed/: auto_parallel, fleet, the in-trace
collectives, ``DataParallel(mesh=)``, and the models' shard plans), held
against the reference.

One spawn serves every case (``two_ranks``): two processes of
``tests/_torch_tp_worker.py`` in a gloo world of two, started before
this process computes the reference (and a third, this file as a
script, computes BERT's reference steps), so they run side by side. The
worker runs:
- the mp layers and sequence-parallel ops of
  ``tests/test_distributed.py:116-189`` at mp 2 under ``fleet.init``,
  the sequence-parallel linears and ``paddle.distributed.split``
  (values and gradients; the reference's layers are GSPMD layouts of the
  dense math, so the dense math in numpy / ``jax.vjp`` is what they are
  held to), ``ParallelCrossEntropy`` against the reference's
  ``cross_entropy`` and its gradient, and the four in-trace collectives
  against ``jax.pmap`` of the reference's ``lax`` calls and their
  ``jax.grad``;
- every ``reshard`` pair (r, s0, s1, p into r, s0, s1): the whole tensor,
  the local shape and the gradient;
- every kernel wrapper refusing a ``DTensor`` argument;
- ``DataParallel(mesh=)`` with ``shard_optimizer`` stage 1 on a dp mesh
  of two (the moments' local shape [8, 16] of a [16, 16] weight; two
  AdamW steps equal to the reference's full-batch steps);
- ``DistModel`` (train, eval, predict; and with ``strategy.sharding``
  at stage 1) and ``Engine.fit`` on the reference test's ``_MLP``,
  against the reference's ``DistModel`` (``Engine.fit`` over three
  batches runs its three steps); ``shard_layer`` with row- and
  column-sharded weights against the dense MLP;
- ``fleet.distributed_model`` / ``distributed_optimizer`` at mp 2, and
  the ``HybridParallelOptimizer`` at a sharding degree of 2;
- tiny Llama, GPT and BERT (dropout 0) under their shard plans on
  dp 1 x mp 2, three AdamW steps, the last with a
  ``ClipGradByGlobalNorm`` that bites, against the reference's plans on
  its mesh of two devices.

Tolerances are ``test_torch_train.py``'s: losses 2e-5 absolute, the
step-1 gradients 1e-4 of each one's max |g|, parameters after three steps
1e-5 where every step's gradient is stable (as there); each parameter's
``full_tensor()`` before training equal to the reference's weight
(transposed where the layouts differ); dtypes asserted. The layer cases
hold values to 1e-5 and gradients to 1e-5 of their max.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import (BertConfig as JBertConfig,
                               BertForPretraining as JBert,
                               GPTConfig as JGPTConfig,
                               GPTForCausalLM as JGPT,
                               LlamaConfig as JLlamaConfig,
                               LlamaForCausalLM as JLlama)
from paddle_tpu.models.bert import bert_shard_plan as jbert_plan
from paddle_tpu.models.gpt import gpt_shard_plan as jgpt_plan
from paddle_tpu.models.llama import llama_shard_plan as jllama_plan

from _torch_zoo import fresh_hybrid_groups, numpy_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_tp_worker.py")
TIMEOUT = 240

LOSS_TOL = 2e-5
GRAD_REL = 1e-4
PARAM_TOL = 1e-5
LAYER_TOL = 1e-5
LR = 1e-3
STEPS = 3
BIG = 1e9
CLIP = 0.05
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rng_inputs():
    rng = np.random.default_rng(11)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    inp = dict(
        col_w=r(16, 32, scale=0.3), col_b=r(32, scale=0.1),
        row_w=r(32, 16, scale=0.3), row_b=r(16, scale=0.1),
        x=r(8, 16), dy=r(8, 16),
        emb_w=r(64, 16), emb_ids=rng.integers(0, 64, (4, 10)),
        emb_dy=r(4, 10, 16),
        ce_logits=r(4, 64), ce_labels=rng.integers(0, 64, (4,)),
        sp_x=r(2, 16, 8), sp_w=r(2, 16, 8), sp_w1=r(8, 16, scale=0.3),
        sp_b1=r(16, scale=0.1), sp_w2=r(16, 8, scale=0.3),
        sp_b2=r(8, scale=0.1),
        it_x=r(2, 4, 6), it_w_psum=r(2, 4, 6), it_w_all_gather=r(2, 8, 6),
        it_w_ppermute=r(2, 4, 6), it_w_all_to_all=r(2, 2, 12),
        rs_x=r(8, 6), rs_w=r(8, 6),
        dp_w=r(16, 16, scale=0.3), dp_b=r(16, scale=0.1), dp_x=r(8, 16),
        dp_y=r(8, 16),
        mlp_x=r(8, 16), mlp_y=r(8, 4),
        **{f"mlp_fc1.{k}": v for k, v in
           (("weight", r(16, 64, scale=0.2)), ("bias", r(64, scale=0.1)))},
        **{f"mlp_fc2.{k}": v for k, v in
           (("weight", r(64, 4, scale=0.2)), ("bias", r(4, scale=0.1)))},
    )
    ids = rng.integers(0, 256, (2, 16))
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    labels[1, :3] = -100
    inp.update(lm_ids=ids, lm_labels=labels)
    tt = (np.arange(16)[None, :] >= 8).astype("int64") * np.ones((2, 1),
                                                                 "int64")
    mlm = np.where(rng.random((2, 16)) < 0.3, ids, -100)
    mlm[0, 1] = ids[0, 1]
    mask = np.ones((2, 16), "int64")
    mask[1, 11:] = 0
    inp.update(bert_ids=ids, bert_tt=tt, bert_mlm=mlm,
               bert_nsp=rng.integers(0, 2, (2, 1)), bert_mask=mask)
    for key in ("llama", "gpt", "bert"):
        inp[f"{key}_clip"] = np.float32(CLIP)
    return inp


def _numpy_weights(jm, seed):
    """Weights drawn with numpy, set on the reference model (matrices and
    embeddings normal(0, 0.1), norm weights 1 + normal(0, 0.1), biases
    normal(0, 0.02), as test_torch_gpt.py / test_torch_bert.py draw
    them). Returns the state."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in jm.state_dict().items():
        shape = np.asarray(v._value).shape
        if k.endswith("bias"):
            a = 0.02 * rng.standard_normal(shape)
        elif "norm" in k:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        state[k] = a.astype(np.float32)
    jm.set_state_dict(state)
    return state


#: the three reference models
REF_MODELS = {"llama": lambda: JLlama(JLlamaConfig.tiny()),
              "gpt": lambda: JGPT(JGPTConfig.tiny(**NO_DROPOUT)),
              "bert": lambda: JBert(JBertConfig.tiny(**NO_DROPOUT))}


def _ref_model(key):
    with pytest.MonkeyPatch.context() as mp:
        numpy_init(mp, seed=7)
        return REF_MODELS[key]()


def _ref_states():
    """The three models' weights: drawn with numpy at the reference's
    initializers' scales (``_torch_zoo.numpy_init``), GPT's and BERT's
    then as their tests draw them."""
    llama = _ref_model("llama")
    return {"llama": {k: np.asarray(v._value)
                      for k, v in llama.state_dict().items()},
            "gpt": _numpy_weights(_ref_model("gpt"), 7),
            "bert": _numpy_weights(_ref_model("bert"), 7)}


def _ref_model_steps(key, d):
    """``_ref_train`` of model ``key`` from the weights and inputs in
    directory ``d``."""
    jm = _ref_model(key)
    jm.set_state_dict(dict(np.load(d / f"{key}.npz")))
    inp = dict(np.load(d / "inputs.npz"))
    if key == "bert":
        batch = [paddle.to_tensor(inp[f"bert_{k}"])
                 for k in ("ids", "tt", "mlm", "nsp", "mask")]
        return _ref_train(jm, jbert_plan, lambda m, b: m(
            b[0], b[1], attention_mask=b[4], masked_lm_labels=b[2],
            next_sentence_labels=b[3])[0], batch)
    batch = (paddle.to_tensor(inp["lm_ids"]),
             paddle.to_tensor(inp["lm_labels"]))
    plan = jllama_plan if key == "llama" else jgpt_plan
    return _ref_train(jm, plan, lambda m, b: m(b[0], labels=b[1])[0], batch)


def _save_ref(path, r):
    np.savez(path, losses=np.array(r["losses"]),
             **{f"grad{i}/{n}": g for i, s in enumerate(r["grads"])
                for n, g in s.items()},
             **{f"param/{n}": p for n, p in r["params"].items()})


def _load_ref(path):
    z = dict(np.load(path))
    names = [k[len("param/"):] for k in z if k.startswith("param/")]
    return dict(losses=list(z["losses"]),
                grads=[{n: z[f"grad{i}/{n}"] for n in names}
                       for i in range(STEPS)],
                params={n: z[f"param/{n}"] for n in names})


def _ref_train(jm, plan, call, batch):
    """The reference's plan on dp 1 x mp 2 of its devices and three AdamW
    steps, the third with the clip at ``CLIP``. Each step runs as one
    program under the reference's own ``jit.to_static(full_graph=True)``
    (its eager dispatch compiles one XLA program per op, shape and
    layout); the clip's norm is a constant of a program, so the third
    step is a second program."""
    mesh = jdist.ProcessMesh(np.arange(2).reshape(1, 2), ["dp", "mp"])
    plan(jm, mesh)
    names = [n for n, _ in jm.named_parameters()]
    params = [p for _, p in jm.named_parameters()]
    clip = jnn.ClipGradByGlobalNorm(BIG)
    jo = jopt.AdamW(learning_rate=LR, parameters=params, grad_clip=clip)
    jo._ensure_accumulators()

    def step(*args):
        loss = call(jm, args)
        loss.backward()
        grads = [p.grad for p in params]
        jo.step()
        jo.clear_grad()
        return loss, grads

    out = dict(losses=[], grads=[])
    for i in range(STEPS):
        if i in (0, STEPS - 1):
            if i:
                clip.clip_norm = CLIP
            static = paddle.jit.to_static(step, full_graph=True)
        loss, grads = static(*batch)
        out["losses"].append(float(loss))
        out["grads"].append({n: np.asarray(g._value)
                             for n, g in zip(names, grads)})
    out["params"] = {n: np.asarray(p._value) for n, p in zip(names, params)}
    return out


def _pmap_collectives(inp):
    from jax import lax

    ops = {
        "psum": lambda v: lax.psum(v, "i"),
        "all_gather": lambda v: lax.all_gather(v, "i", axis=0, tiled=True),
        "ppermute": lambda v: lax.ppermute(v, "i", [(0, 1), (1, 0)]),
        "all_to_all": lambda v: lax.all_to_all(v, "i", 0, 1, tiled=True),
    }
    devices = jax.devices()[:2]
    out = {}
    for name, op in ops.items():
        w = jnp.asarray(inp[f"it_w_{name}"])
        x = jnp.asarray(inp["it_x"])
        out[name] = np.asarray(jax.pmap(op, axis_name="i",
                                        devices=devices)(x))
        out[name + "_dx"] = np.asarray(jax.pmap(
            jax.grad(lambda v, ww: jnp.sum(op(v) * ww)), axis_name="i",
            devices=devices)(x, w))
    return out


class _JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 64)
        self.fc2 = jnn.Linear(64, 4)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


def _jmlp(inp):
    m = _JMLP()
    m.set_state_dict({k: inp[f"mlp_{k}"] for k in
                      ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")})
    return m


def _loss_fn(out, label):
    return ((out - label) ** 2).mean()


def _ref_dist_model(inp):
    mesh = jdist.ProcessMesh(np.arange(2), ["dp"])
    model = _jmlp(inp)
    for p in model.parameters():
        jdist.shard_tensor(p, mesh, [jdist.Replicate()])
    opt = jopt.AdamW(learning_rate=0.01, parameters=model.parameters())
    dm = jdist.to_static(model, loss=_loss_fn, optimizer=opt)
    x = jdist.shard_tensor(paddle.to_tensor(inp["mlp_x"]), mesh,
                           [jdist.Shard(0)])
    y = jdist.shard_tensor(paddle.to_tensor(inp["mlp_y"]), mesh,
                           [jdist.Shard(0)])
    out = {"losses": [float(dm(x, y)) for _ in range(3)]}
    dm.eval()
    out["eval"] = float(dm(x, y))
    dm.predict()
    out["predict"] = np.asarray(dm(x)._value)
    out["fc1_w"] = np.asarray(model.fc1.weight._value)
    # the reference's Engine.fit of one epoch of these three batches is
    # these three steps: its history is their mean loss
    out["engine"] = [float(np.mean(out["losses"]))]
    return out


def _ref_data_parallel(inp):
    lin = jnn.Linear(16, 16)
    lin.set_state_dict({"weight": inp["dp_w"], "bias": inp["dp_b"]})
    opt = jopt.AdamW(learning_rate=0.01, parameters=lin.parameters())
    x, y = paddle.to_tensor(inp["dp_x"]), paddle.to_tensor(inp["dp_y"])
    out = {}
    for step in range(2):
        loss = ((lin(x) - y) ** 2).mean()
        loss.backward()
        if step == 0:
            out["dw"] = np.asarray(lin.weight.grad._value)
        opt.step()
        opt.clear_grad()
    out["w"] = np.asarray(lin.weight._value)
    out["b"] = np.asarray(lin.bias._value)
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """``_two_ranks`` with both packages' hybrid groups reset before and
    after (``fresh_hybrid_groups``, ROADMAP queue C, C7)."""
    with fresh_hybrid_groups():
        return _two_ranks(tmp_path_factory)


def _two_ranks(tmp_path_factory):
    """The worker's results by rank, and the reference's, computed while
    the two ranks run."""
    d = tmp_path_factory.mktemp("tp")
    inp = _rng_inputs()
    np.savez(d / "inputs.npz", **inp)
    states = _ref_states()
    for key, state in states.items():
        np.savez(d / f"{key}.npz", **state)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""),
           "PADDLE_TRAINERS_NUM": "2",
           "PADDLE_MASTER": f"127.0.0.1:{_free_port()}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(d)], cwd=REPO,
        env={**env, "PADDLE_TRAINER_ID": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    # BERT's reference steps in a third process, beside the ranks (this
    # file run as a script, below)
    procs.append(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(d), "bert"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    try:
        ref = {"collectives": _pmap_collectives(inp),
               "dist_model": _ref_dist_model(inp),
               "data_parallel": _ref_data_parallel(inp),
               "llama": _ref_model_steps("llama", d),
               "gpt": _ref_model_steps("gpt", d)}
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ref["bert"] = _load_ref(d / "ref_bert.npz")
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return inp, ref, states, got


def _close(got, want, tol=LAYER_TOL, rel=False, err_msg=""):
    want = np.asarray(want, np.float64)
    atol = tol * (np.abs(want).max() if rel else 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=err_msg)


def _grad(fn, *args, argnums=0):
    return np.asarray(jax.grad(fn, argnums=argnums)(*args))


def test_mp_layers_match_the_dense_math(two_ranks):
    """ColumnParallelLinear -> RowParallelLinear at mp 2 equals the dense
    MLP with the same weights, and so do the gradients; the weight
    layouts are the reference's Shard(1) / Shard(0) of [in, out]."""
    inp, _, _, got = two_ranks
    cw, cb, rw, rb = (jnp.asarray(inp[k]) for k in
                      ("col_w", "col_b", "row_w", "row_b"))
    x, dy = jnp.asarray(inp["x"]), jnp.asarray(inp["dy"])

    def f(x, cw, rw, rb):
        return jnp.sum(((x @ cw + cb) @ rw + rb) * dy)

    for rank, g in enumerate(got):
        assert g["hcg"].tolist() == [2, 1, rank]
        assert g["col_local_shape"].tolist() == [16, 16]
        np.testing.assert_array_equal(g["col_weight_full"], inp["col_w"])
        _close(g["tp_y"], (x @ cw + cb) @ rw + rb)
        for i, name in enumerate(("tp_dx", "tp_dcol_w", "tp_drow_w",
                                  "tp_drow_b")):
            _close(g[name], _grad(f, x, cw, rw, rb, argnums=i), rel=True,
                   err_msg=name)
        assert g["tp_y"].dtype == np.float32


def test_vocab_parallel_embedding(two_ranks):
    inp, _, _, got = two_ranks
    w, ids, dy = inp["emb_w"], inp["emb_ids"], inp["emb_dy"]
    dw = np.zeros_like(w, np.float64)
    np.add.at(dw, ids.reshape(-1), dy.reshape(-1, 16))
    for g in got:
        np.testing.assert_array_equal(g["emb_out"], w[ids])
        _close(g["emb_dw"], dw, rel=True)


def test_parallel_cross_entropy(two_ranks):
    """[N, 1] per token and its gradient, against the reference's
    ``cross_entropy`` over the whole logits."""
    inp, _, _, got = two_ranks
    logits = paddle.to_tensor(inp["ce_logits"], stop_gradient=False)
    loss = paddle.nn.functional.cross_entropy(
        logits, paddle.to_tensor(inp["ce_labels"]), reduction="none")
    loss.sum().backward()
    for g in got:
        assert g["pce_loss"].shape == (4, 1)
        _close(g["pce_loss"][:, 0], np.asarray(loss._value).reshape(-1))
        _close(g["pce_dlogits"], np.asarray(logits.grad._value), rel=True)


def test_sequence_parallel_ops(two_ranks):
    """ScatterOp / GatherOp round trip on [2, 16, 8] (each rank holds
    [2, 8, 8]); AllGatherOp's gradient is the reduce-scatter of the
    cotangent, ReduceScatterOp's the all-gather."""
    inp, _, _, got = two_ranks
    x, w = inp["sp_x"], inp["sp_w"]
    for rank, g in enumerate(got):
        assert g["sp_scatter_shape"].tolist() == [2, 8, 8]
        np.testing.assert_array_equal(g["sp_gather"], x)
        np.testing.assert_array_equal(g["sp_dx"], w)
        np.testing.assert_array_equal(g["sp_allgather"], x)
        _close(g["sp_allgather_dx"], 2 * np.split(w, 2, 1)[rank])
        _close(g["sp_reduce_scatter"], 3 * np.split(x, 2, 1)[rank])
        whole = np.concatenate(np.split(w, 2, 1), 1)
        _close(g["sp_reduce_scatter_dx"], whole)


def test_sequence_parallel_linears(two_ranks):
    """Column- then RowSequenceParallelLinear on [2, 16, 8] with the
    sequence split over mp (each rank [2, 8, 8]) equal the dense MLP on
    the rank's rows, with its gradients; the row layer's bias, marked
    sequence-parallel, gets the whole gradient through
    ``register_sequence_parallel_allreduce_hooks``."""
    inp, _, _, got = two_ranks
    w1, b1, w2, b2 = (jnp.asarray(inp[k]) for k in
                      ("sp_w1", "sp_b1", "sp_w2", "sp_b2"))
    x, w = jnp.asarray(inp["sp_x"]), jnp.asarray(inp["sp_w"])

    def f(x, w1, w2, b2):
        return jnp.sum(((x @ w1 + b1) @ w2 + b2) * w)

    y = (x @ w1 + b1) @ w2 + b2
    grads = [_grad(f, x, w1, w2, b2, argnums=i) for i in range(4)]
    for rank, g in enumerate(got):
        _close(g["spl_y"], np.split(np.asarray(y), 2, 1)[rank])
        _close(g["spl_dx"], np.split(grads[0], 2, 1)[rank], rel=True)
        _close(g["spl_dw1"], grads[1], rel=True)
        _close(g["spl_dw2"], grads[2], rel=True)
        _close(g["spl_db2"], grads[3], rel=True)


def test_split_column_parallel_linear(two_ranks):
    """``paddle.distributed.split`` at mp 2: a column-parallel linear of
    [16 -> 32] whose gathered output is the whole layer's."""
    for g in two_ranks[3]:
        assert g["split_local"].tolist() == [16, 16]
        _close(g["split_y"], g["split_want"])


@pytest.mark.parametrize("name", ["psum", "all_gather", "ppermute",
                                  "all_to_all"])
def test_in_trace_collectives_match_jax_grad(two_ranks, name):
    """Each in-trace collective over the hybrid group's mp axis, and its
    gradient, against ``jax.pmap`` of the reference's ``lax`` call and
    ``jax.grad`` of it."""
    _, ref, _, got = two_ranks
    want = ref["collectives"]
    for rank, g in enumerate(got):
        _close(g[f"it_{name}"], want[name][rank])
        _close(g[f"it_{name}_dx"], want[name + "_dx"][rank], rel=True)


@pytest.mark.parametrize("src", ["r", "s0", "s1", "p"])
def test_reshard_pairs(two_ranks, src):
    """``reshard`` from ``src`` into r, s0 and s1 keeps the whole tensor,
    gives each rank its shape, and passes the gradient back."""
    inp, _, _, got = two_ranks
    shapes = {"r": [8, 6], "s0": [4, 6], "s1": [8, 3]}
    for g in got:
        for dst, shape in shapes.items():
            key = f"rs_{src}_{dst}"
            np.testing.assert_array_equal(g[key + "_full"], inp["rs_x"])
            assert g[key + "_local"].tolist() == shape, key
            np.testing.assert_array_equal(g[key + "_grad"], inp["rs_w"])


def test_kernel_wrappers_refuse_dtensors(two_ranks):
    """Each kernel wrapper (flash forward and backward, RMSNorm forward and
    backward, varlen, paged, tiled matmul) raises TypeError on a DTensor
    argument instead of gathering it or taking its plain version."""
    for g in two_ranks[3]:
        refusals = {k: str(v) for k, v in g.items()
                    if k.startswith("refuse_")}
        assert len(refusals) == 7
        for name, msg in refusals.items():
            assert msg.startswith("TypeError") and "DTensor" in msg, name


def test_data_parallel_mesh_with_stage1_states(two_ranks):
    """``DataParallel(mesh=)`` averages the dp ranks' gradients (the
    reference's full-batch gradient); ``shard_optimizer`` stage 1 keeps
    half the moment rows on each rank, and two AdamW steps equal the
    reference's, on both ranks."""
    _, ref, _, got = two_ranks
    want = ref["data_parallel"]
    for g in got:
        assert g["zero_m1_shape"].tolist() == [8, 16]
        _close(g["dp_dw"], want["dw"], rel=True)
        _close(g["dp_w_after"], want["w"], tol=PARAM_TOL)
        _close(g["dp_b_after"], want["b"], tol=PARAM_TOL)
    np.testing.assert_array_equal(got[0]["dp_w_after"], got[1]["dp_w_after"])


def test_dist_model_and_engine_on_the_mlp(two_ranks):
    """``to_static`` -> ``DistModel`` train / eval / predict and
    ``Engine.fit`` on the reference test's ``_MLP``, each rank on half of
    every batch, equal to the reference's ``DistModel`` (``fit``'s history
    is the mean loss of its three steps); ``Engine.prepare`` raises,
    naming item 7."""
    _, ref, _, got = two_ranks
    want = ref["dist_model"]
    for g in got:
        _close(g["dm_losses"], want["losses"], tol=LOSS_TOL)
        assert want["losses"][-1] < want["losses"][0]
        _close(g["dm_eval"], want["eval"], tol=LOSS_TOL)
        _close(g["dm_predict"], want["predict"])
        _close(g["dm_fc1_w"], want["fc1_w"], tol=PARAM_TOL)
        _close(g["engine_fit"], want["engine"], tol=LOSS_TOL)
        assert "item 7" in str(g["engine_prepare"])
        # strategy.sharding stage 1: the same losses, half of each
        # parameter's moment rows ([64, 16], [64], [4, 64], [4] in torch's
        # layout)
        _close(g["dm_stage1_losses"], want["losses"], tol=LOSS_TOL)
        assert g["dm_stage1_m1_rows"].tolist() == [32, 32, 2, 2]


def test_shard_layer_computes_on_dtensors(two_ranks):
    """``shard_layer`` with fc1's weight sharded by rows and fc2's by
    columns: each rank holds its half, the layer computes on ``DTensor``s
    and the output and gradients are the dense MLP's."""
    inp, _, _, got = two_ranks
    w1, b1, w2, b2 = (jnp.asarray(inp[f"mlp_{k}"]) for k in (
        "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"))
    x, y = jnp.asarray(inp["mlp_x"]), jnp.asarray(inp["mlp_y"])

    def forward(w1, w2):
        return jax.nn.relu(x @ w1 + b1) @ w2 + b2

    def loss(w1, w2):
        return jnp.mean((forward(w1, w2) - y) ** 2)

    for g in got:
        assert g["sl_fc1_local"].tolist() == [32, 16]
        _close(g["sl_out"], forward(w1, w2))
        _close(g["sl_dfc1_w"], _grad(loss, w1, w2), rel=True)
        _close(g["sl_dfc2_w"], _grad(loss, w1, w2, argnums=1), rel=True)


def test_fleet_distributed_model_and_optimizer(two_ranks):
    """At dp 1 x mp 2 ``distributed_model`` replicates every parameter
    (``DistParameter``s) and returns the model, ``distributed_optimizer``
    the optimizer; at a sharding degree of 2 it returns the
    ``HybridParallelOptimizer`` over the optimizer, sharded in place at
    ZeRO stage 2 (its training is test_torch_sharding.py's)."""
    for g in two_ranks[3]:
        assert g["fleet_model"].tolist() == ["MLP", "['DistParameter']"]
        assert bool(g["fleet_opt_same"])
        assert g["fleet_sharding"].tolist() == ["HybridParallelOptimizer",
                                                "2"]


#: params compared after three steps where each step's |g| is at least
#: this share of the parameter's max |g| in both packages (Adam divides by
#: |g|), or the gradient is 0 in both; at least COVERED of them
G_FLOOR = 1e-3
COVERED = 0.7
ZERO_GRAD = 1e-6


@pytest.mark.parametrize("key", ["llama", "gpt", "bert"])
def test_models_train_under_their_plans(two_ranks, key):
    _, ref, states, got = two_ranks
    want = ref[key]
    for g in got:
        assert str(g[f"{key}/loss_dtype"]) == "torch.float32"
        assert g[f"{key}/grad_dtype"].tolist() == ["torch.float32"]
        assert g[f"{key}/param_dtype"].tolist() == ["torch.float32"]
        for name, w in states[key].items():
            np.testing.assert_array_equal(g[f"{key}/init/{name}"], w,
                                          err_msg=name)
        _close(g[f"{key}/losses"], want["losses"], tol=LOSS_TOL)
        last = want["grads"][-1]
        norm = float(np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                                 for a in last.values())))
        assert norm > 2 * CLIP, norm      # the third step's clip bites
        for name, jg in want["grads"][0].items():
            tg = g[f"{key}/grad0/{name}"]
            if name.endswith("k_proj.bias"):
                assert max(np.abs(jg).max(), np.abs(tg).max()) < ZERO_GRAD
                continue
            _close(tg, jg, tol=GRAD_REL, rel=True, err_msg=name)
        covered = total = 0
        for name, jp in want["params"].items():
            if name.endswith("k_proj.bias"):
                continue
            gj = np.stack([s[name] for s in want["grads"]])
            gt = np.stack([g[f"{key}/grad{s}/{name}"] for s in range(STEPS)])
            floor = G_FLOOR * float(np.abs(gj).max())
            stable = (np.abs(gj).min(0) > floor) & (np.abs(gt).min(0) > floor)
            keep = stable | ((gj == 0).all(0) & (gt == 0).all(0))
            _close(g[f"{key}/param/{name}"][keep], jp[keep], tol=PARAM_TOL,
                   err_msg=name)
            covered += int(keep.sum())
            total += keep.size
        assert covered >= COVERED * total, (covered, total)
    # the two ranks hold one model
    for name in want["params"]:
        np.testing.assert_array_equal(got[0][f"{key}/param/{name}"],
                                      got[1][f"{key}/param/{name}"])


if __name__ == "__main__":
    # the reference's plan steps of the named models (``two_ranks`` runs
    # BERT's here): python test_torch_tensor_parallel.py DIR KEY...
    import pathlib

    out_dir = pathlib.Path(sys.argv[1])
    for key in sys.argv[2:]:
        _save_ref(out_dir / f"ref_{key}.npz", _ref_model_steps(key, out_dir))
