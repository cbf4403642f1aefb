"""Worker of tests/test_torch_sharding.py: one rank of a gloo world of two
on the CPU (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM`` and
``PADDLE_MASTER`` set by the test). Its one argument is the test's
directory, which holds the inputs (``inputs.npz``) and the reference's
weights (``mlp.npz``, ``llama.npz``, ``ernie.npz``). It runs every case of the file on
the port, each rank on its half of every batch, and saves what it got
(``rank<R>.npz``; ``nn.Linear`` weights in the reference's ``[in,
out]``); the test holds that against the reference.
"""
import os
import sys

import numpy as np
import torch

from paddle_tpu_torch.core.place import set_device

set_device("cpu")
torch.set_num_threads(1)

import paddle_tpu_torch as ptt  # noqa: E402
import paddle_tpu_torch.distributed as dist  # noqa: E402
import paddle_tpu_torch.optimizer as topt  # noqa: E402
from paddle_tpu_torch import jit  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.auto_parallel.api import (  # noqa: E402
    DistParameter)
from paddle_tpu_torch.distributed.fleet.meta_optimizers import (  # noqa: E402
    DygraphShardingOptimizer)
from paddle_tpu_torch.distributed.fleet.meta_parallel import (  # noqa: E402
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3)
from paddle_tpu_torch.models import (  # noqa: E402
    ErnieMoeConfig, ErnieMoeForCausalLM, LlamaConfig, LlamaForCausalLM)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm  # noqa: E402

LEVELS = ("os", "os_g", "p_g_os")
RANK = 0


def t(a):
    return torch.from_numpy(np.asarray(a))


def npy(x):
    return x.detach().numpy().copy()


def half(a):
    return t(a).chunk(2)[RANK]


def mlp(state):
    m = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                            torch.nn.Linear(32, 8))
    ptt.load_paddle_tpu_state(m, state)
    return m


def whole(p, local):
    """The whole tensor of ``local`` (the parameter's own data, or a
    gradient of its layout) on every rank."""
    local = local.detach()
    if "_zero3" in p.__dict__:
        pg, n = p.__dict__["_zero3"]
        out = local.new_empty((n * local.shape[0],) + local.shape[1:])
        torch.distributed.all_gather_into_tensor(out, local.contiguous(),
                                                 group=pg)
        return out
    if isinstance(p, DistParameter):
        return p.gather(local)
    return local


def mean_grad(p):
    """``p``'s gradient averaged over the two ranks, whole: a ZeRO-3
    shard's gradient is already the mean of its rows; any other is this
    rank's own (or, under ``DataParallel``, the mean already)."""
    if "_zero3" in p.__dict__:
        return whole(p, p.grad)
    g = p.grad.clone()
    torch.distributed.all_reduce(g)
    return g / 2


def steps(key, model, opt, xs, ys, out, names, n=3, linear=()):
    """``n`` steps of the MSE loss on each rank's half of batch ``i``: the
    losses, each step's mean gradients and the parameters after."""
    losses = []
    for i in range(n):
        loss = ((model(half(xs[i])) - half(ys[i])) ** 2).mean()
        loss.backward()
        losses.append(loss.item())
        for name, p in names.items():
            out[f"{key}/grad{i}/{name}"] = ref_layout(name, mean_grad(p),
                                                     linear)
        opt.step()
        opt.clear_grad()
    out[f"{key}/losses"] = np.array(losses)
    for name, p in names.items():
        out[f"{key}/param/{name}"] = ref_layout(name, whole(p, p), linear)


def ref_layout(name, a, linear):
    a = npy(a)
    return a.T if name.rsplit(".", 1)[0] in linear else a


MLP_LINEAR = {"0", "2"}


def levels(inp, state, out):
    """``group_sharded_parallel`` at each level on the MLP; the states'
    and parameters' local shapes."""
    for level in LEVELS:
        m = mlp(state)
        names = dict(m.named_parameters())
        opt = topt.AdamW(learning_rate=0.01, parameters=list(names.items()))
        model, opt, _ = dist.group_sharded_parallel(m, opt, level)
        out[f"{level}/wrapper"] = np.array(type(model).__name__)
        out[f"{level}/param_local"] = np.array(
            [str(list(p.shape)) for p in names.values()])
        out[f"{level}/kinds"] = np.array(
            [type(p).__name__ for p in names.values()])
        rows = opt._row_shards
        out[f"{level}/m1_local"] = np.array(
            [str(list(opt._accum("moment1", rows.views.get(id(p),
                                                          (p, p))[1]).shape))
             for p in names.values()])
        steps(level, model, opt, inp["xs"], inp["ys"], out, names,
              linear=MLP_LINEAR)


def save_and_load(inp, state, out_dir, out):
    """``p_g_os`` one step, ``save_group_sharded_model``, then ``paddle.load``
    into a fresh model."""
    m = mlp(state)
    names = dict(m.named_parameters())
    opt = topt.AdamW(learning_rate=0.01, parameters=list(names.items()))
    model, opt, _ = dist.group_sharded_parallel(m, opt, "p_g_os")
    steps("save", model, opt, inp["xs"], inp["ys"], out, names, n=1,
          linear=MLP_LINEAR)
    ckpt = os.path.join(out_dir, "ckpt")
    dist.save_group_sharded_model(model, ckpt, opt)
    loaded = ptt.load(os.path.join(ckpt, "model.pdparams"), device="cpu")
    fresh = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 8))
    fresh.load_state_dict(loaded)
    for name, p in fresh.named_parameters():
        out[f"save/fresh/{name}"] = ref_layout(name, p, MLP_LINEAR)
    optstate = ptt.load(os.path.join(ckpt, "model.pdopt"), device="cpu")
    out["save/opt_shapes"] = np.array(sorted(
        f"{k}:{list(v.shape)}" for k, v in optstate.items()
        if isinstance(v, torch.Tensor)))


def hybrid(inp, state, out):
    """``fleet.init`` with ``sharding_degree`` 2: ``distributed_model``,
    ``distributed_optimizer`` (a ``HybridParallelOptimizer``), two steps;
    then ``DygraphShardingOptimizer`` on its own."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "sharding_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    for key, wrap in (("hybrid", fleet.distributed_optimizer),
                      ("dygraph", DygraphShardingOptimizer)):
        m = fleet.distributed_model(mlp(state))
        names = dict(m.named_parameters())
        opt = wrap(topt.AdamW(learning_rate=0.01,
                              parameters=list(names.items())))
        out[f"{key}/class"] = np.array(type(opt).__name__)
        inner = opt._inner_opt
        out[f"{key}/m1_rows"] = np.array(
            [inner._accum("moment1", v).shape[0]
             for _, v in inner._row_shards.views.values()])
        steps(key, m, opt, inp["xs"], inp["ys"], out, names, n=2,
              linear=MLP_LINEAR)
    fleet.set_hybrid_communicate_group(None)


def classes(inp, state, out):
    """``GroupShardedOptimizerStage2`` + ``GroupShardedStage2``, and
    ``GroupShardedStage3`` built directly."""
    m = mlp(state)
    names = dict(m.named_parameters())
    inner = topt.AdamW(learning_rate=0.01, parameters=list(names.items()))
    sh_opt = GroupShardedOptimizerStage2(list(names.values()), inner)
    wrapped = GroupShardedStage2(m, sh_opt)
    steps("stage2_classes", wrapped, sh_opt, inp["xs"], inp["ys"], out,
          names, n=2, linear=MLP_LINEAR)
    m = mlp(state)
    names = dict(m.named_parameters())
    inner = topt.AdamW(learning_rate=0.01, parameters=list(names.items()))
    wrapped = GroupShardedStage3(m, inner)
    out["stage3_classes/param_local"] = np.array(
        [str(list(p.shape)) for p in names.values()])
    steps("stage3_classes", wrapped, wrapped.optimizer, inp["xs"],
          inp["ys"], out, names, n=2, linear=MLP_LINEAR)


def clipped_stage2(inp, state, out):
    """``shard_optimizer`` at ``ShardingStage2`` on a dp mesh of two with a
    global-norm clip that bites (the norm sums the rows over the axis)."""
    mesh = dist.ProcessMesh([0, 1], ["dp"])
    m = mlp(state)
    names = dict(m.named_parameters())
    opt = topt.AdamW(learning_rate=0.01, parameters=list(names.items()),
                     grad_clip=ClipGradByGlobalNorm(float(inp["clip"])))
    dist.shard_optimizer(opt, dist.ShardingStage2("dp", mesh=mesh))
    steps("clip2", m, opt, inp["xs"], inp["ys"], out, names,
          linear=MLP_LINEAR)


def jitted(inp, state, out):
    """The ``os_g`` step under ``jit.to_static`` (eager on the CPU), the
    same batch twice."""
    m = mlp(state)
    opt = topt.AdamW(learning_rate=0.01, parameters=list(
        m.named_parameters()))
    model, opt, _ = dist.group_sharded_parallel(m, opt, "os_g")

    @jit.to_static
    def step(x, y):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    x, y = half(inp["jx"]), half(inp["jy"])
    out["jit/losses"] = np.array([float(step(x, y)) for _ in range(2)])


def dist_model_stage3(inp, state, out):
    """``DistModel`` with ``strategy.sharding`` at stage 3 on a dp mesh of
    two: the parameters sharded between steps, the batch ``Shard(0)``."""
    mesh = dist.ProcessMesh([0, 1], ["dp"])
    m = mlp(state)
    for p in m.parameters():
        dist.shard_tensor(p, mesh, [dist.Replicate()])
    opt = topt.AdamW(learning_rate=0.01, parameters=list(
        m.named_parameters()))
    strategy = dist.Strategy({"sharding": {"enable": True, "stage": 3}})
    dm = dist.to_static(m, loss=lambda o, y: ((o - y) ** 2).mean(),
                        optimizer=opt, strategy=strategy)
    out["dm3/param_local"] = np.array(
        [str(list(p.shape)) for p in m.parameters()])
    losses = []
    for i in range(3):
        x = dist.shard_tensor(t(inp["xs"][i]), mesh, [dist.Shard(0)])
        y = dist.shard_tensor(t(inp["ys"][i]), mesh, [dist.Shard(0)])
        losses.append(float(dm(x, y)))
    out["dm3/losses"] = np.array(losses)
    for name, p in m.named_parameters():
        out[f"dm3/param/{name}"] = ref_layout(name, p.full_tensor(),
                                              MLP_LINEAR)


def lm_steps(key, model, level, ids, labels, out, linear):
    """Three AdamW steps of a causal LM through ``group_sharded_parallel``
    at ``level``, each rank on its half of the batch: the losses, the
    ranks' mean gradients of each step and the parameters after."""
    names = dict(model.named_parameters())
    opt = topt.AdamW(learning_rate=1e-3, parameters=list(names.items()))
    wrapped, opt, _ = dist.group_sharded_parallel(model, opt, level)
    losses = []
    for i in range(3):
        loss, _ = wrapped(half(ids), labels=half(labels))
        loss.backward()
        losses.append(loss.item())
        out[f"{key}/loss_dtype"] = np.array(str(loss.dtype))
        for name, p in names.items():
            out[f"{key}/grad{i}/{name}"] = ref_layout(name, mean_grad(p),
                                                      linear)
        opt.step()
        opt.clear_grad()
    out[f"{key}/losses"] = np.array(losses)
    for name, p in names.items():
        out[f"{key}/param/{name}"] = ref_layout(name, whole(p, p), linear)
    out[f"{key}/sharded"] = np.array(sum(
        "_zero3" in p.__dict__ for p in names.values()))


def lm_levels(inp, llama_state, ernie_state, out):
    """The tiny Llama at each level; the tiny ERNIE-MoE (random routing
    off) at ``"os_g"``, its gates routing both ranks' tokens."""
    def linear_names(m):
        return {n for n, mod in m.named_modules()
                if isinstance(mod, torch.nn.Linear)}

    for level in LEVELS:
        m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        ptt.load_paddle_tpu_state(m, llama_state)
        lm_steps(f"llama_{level}", m, level, inp["lm_ids"],
                 inp["lm_labels"], out, linear_names(m))
    m = ErnieMoeForCausalLM(ErnieMoeConfig.tiny(), device="cpu")
    ptt.load_paddle_tpu_state(m, ernie_state)
    for layer in m.model.layers:
        layer.mlp.gate._random2 = False
    linear = linear_names(m)
    lm_steps("ernie_os_g", m, "os_g", inp["moe_ids"], inp["moe_labels"],
             out, linear)
    out["ernie_os_g/batch_group"] = np.array(
        m.model.layers[0].mlp.gate.batch_group().ranks)


def main():
    global RANK
    out_dir = sys.argv[1]
    dist.init_parallel_env()
    RANK = dist.get_rank()
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    state = dict(np.load(os.path.join(out_dir, "mlp.npz")))
    llama = dict(np.load(os.path.join(out_dir, "llama.npz")))
    ernie = dict(np.load(os.path.join(out_dir, "ernie.npz")))
    out = {}
    levels(inp, state, out)
    save_and_load(inp, state, out_dir, out)
    hybrid(inp, state, out)
    classes(inp, state, out)
    clipped_stage2(inp, state, out)
    jitted(inp, state, out)
    dist_model_stage3(inp, state, out)
    lm_levels(inp, llama, ernie, out)
    np.savez(os.path.join(out_dir, f"rank{RANK}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank{RANK} done", flush=True)


if __name__ == "__main__":
    main()
