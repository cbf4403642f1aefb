"""Worker of tests/test_torch_pipeline.py: one rank of a gloo world of
two on the CPU (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM`` and
``PADDLE_MASTER`` set by the test). Its one argument is the test's
directory, which holds the inputs (``inputs.npz``) and the reference's
weights (``pipe.npz``, ``shared.npz``). It runs every two-rank case of
the file, each rank one pipeline stage, and saves what it got
(``rank<R>.npz``; ``nn.Linear`` weights in the reference's ``[in,
out]``); the test holds that against the reference.
"""
import os
import sys

import numpy as np
import torch

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.core.place import set_device
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import pipeline_spmd as spmd_mod
from paddle_tpu_torch.distributed.fleet import pipeline_spmd_engine as eng
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel, SharedLayerDesc)
from paddle_tpu_torch.distributed.fleet.pipeline_spmd import (
    pipeline_spmd_apply, pipeline_spmd_train_step)

#: (schedule mode, virtual stages) of the PipelineParallel cases
PP_MODES = (("FThenB", 1), ("1F1B", 1), ("Eager1F1B", 1), ("ZBH1", 1),
            ("VPP", 2))
#: (schedule, vpp, micro-batches) of the plan-engine cases
ENGINE_CASES = (("1f1b", 1, 4), ("eager1f1b", 1, 4), ("fthenb", 1, 4),
                ("zbh1", 1, 4), ("vpp", 2, 4))


def t(a):
    return torch.from_numpy(np.asarray(a))


def npy(x):
    return x.detach().numpy().copy()


def _state_for(layer, state):
    """The reference's ``state`` under this rank's names: a shared layer's
    occurrence at layer ``i`` takes its key's first occurrence's
    weights (the reference names a shared layer once)."""
    first = {}
    for name in state:
        if name.startswith("shared_"):
            key = name.split(".")[0].rsplit("_", 1)[0]
            first.setdefault(key, name.split(".")[0])
    own = {}
    for name, _ in layer.named_parameters():
        head, rest = name.split(".", 1)
        if head.startswith("shared_"):
            head = first[head.rsplit("_", 1)[0]]
        own[name] = state[f"{head}.{rest}"]
    return own


def _descs(shared):
    lin = torch.nn.Linear
    if shared:
        return [SharedLayerDesc("t", lin, None, "weight", 8, 8),
                LayerDesc(lin, 8, 8), LayerDesc(lin, 8, 8),
                SharedLayerDesc("t", lin, None, "weight", 8, 8),
                LayerDesc(lin, 8, 2)]
    return [LayerDesc(lin, 8, 8) for _ in range(4)] + [LayerDesc(lin, 8, 2)]


class _Strategy:
    def __init__(self, mode):
        self.pipeline_configs = {"accumulate_steps": 4,
                                 "schedule_mode": mode}


def pipeline_parallel(rank, inp, out, state, key, mode, vpp, shared=False):
    """One ``forward_backward_pipeline`` (loss, gradients) then an SGD step
    (parameters) of the reference's schedule test model at pp 2, and one
    ``eval_batch`` after it."""
    layers = PipelineLayer(_descs(shared), num_stages=2,
                           loss_fn=torch.nn.CrossEntropyLoss(),
                           num_virtual_pipeline_stages=vpp)
    ptt.load_paddle_tpu_state(layers, _state_for(layers, state))
    pipe = PipelineParallel(layers, strategy=_Strategy(mode))
    data = [t(inp["x"]), t(inp["y"])]
    loss = pipe.forward_backward_pipeline(data)
    out[f"{key}/loss"] = npy(loss)
    out[f"{key}/stage"] = np.array(layers.stage)
    out[f"{key}/held"] = np.array([i for i, f in
                                   enumerate(layers.run_function)
                                   if f is not None])
    opt = topt.SGD(learning_rate=0.1, parameters=list(pipe.parameters()))
    for name, p in layers.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[f"{key}/grad/{name}"] = npy(g).T if g.ndim == 2 else npy(g)
    opt.step()
    opt.clear_grad()
    for name, p in layers.named_parameters():
        out[f"{key}/param/{name}"] = npy(p).T if p.ndim == 2 else npy(p)
    out[f"{key}/eval"] = npy(pipe.eval_batch(data))
    out[f"{key}/bytes_sent"] = np.array(pipe._exchange.bytes_sent)


def distributed_model(out):
    layers = PipelineLayer(_descs(False), num_stages=2,
                           loss_fn=torch.nn.CrossEntropyLoss())
    out["fleet_model"] = np.array(type(fleet.distributed_model(layers))
                                  .__name__)


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _loss_fn(y, label):
    return ((y - label) ** 2).mean()


def spmd(rank, inp, out):
    mesh = dist.ProcessMesh(np.arange(2), ["pp"])
    stacked = {"w": t(inp["spmd_w"]).requires_grad_(),
               "b": t(inp["spmd_b"])}
    outs = pipeline_spmd_apply(lambda p, x: torch.tanh(x @ p["w"]), stacked,
                               t(inp["spmd_xs"]), mesh=mesh, axis="pp")
    (outs ** 2).sum().backward()
    out["apply/outs"] = npy(outs)
    out["apply/dw"] = npy(stacked["w"].grad)
    for schedule in ("1f1b", "gpipe"):
        loss, grads = pipeline_spmd_train_step(
            _stage_fn, _loss_fn, {"w": t(inp["spmd_w"]),
                                  "b": t(inp["spmd_b"])},
            t(inp["spmd_xs"]), t(inp["spmd_ys"]), mesh=mesh,
            schedule=schedule)
        out[f"spmd_{schedule}/loss"] = npy(loss)
        for n, g in grads.items():
            out[f"spmd_{schedule}/{n}"] = npy(g)
    # each rank holding only its own row gets its own row's gradient
    own = {n: t(inp[f"spmd_{n}"])[rank:rank + 1] for n in ("w", "b")}
    _, grads = pipeline_spmd_train_step(
        _stage_fn, _loss_fn, own, t(inp["spmd_xs"]), t(inp["spmd_ys"]),
        mesh=mesh)
    out["spmd_own/w"] = npy(grads["w"])
    out["spmd_ring"] = np.array(spmd_mod._LAST_1F1B_RING_SHAPES["in_ring"])
    try:
        pipeline_spmd_train_step(_stage_fn, _loss_fn, own, t(inp["spmd_xs"]),
                                 t(inp["spmd_ys"]), mesh=mesh,
                                 schedule="zigzag")
    except ValueError as e:
        out["spmd_refusal"] = np.array(str(e))


def engine(rank, inp, out):
    mesh = dist.ProcessMesh(np.arange(2), ["pp"])
    for schedule, vpp, m in ENGINE_CASES:
        plan = eng.compile_pipeline_plan(schedule, S=2, M=m, vpp=vpp)
        params = {n: t(inp[f"eng{vpp}_{n}"]) for n in ("w", "b")}
        loss, grads = eng.pipeline_schedule_train_step(
            _stage_fn, _loss_fn, params, t(inp["eng_xs"]), t(inp["eng_ys"]),
            mesh=mesh, plan=plan)
        key = f"engine/{schedule}{vpp}"
        out[f"{key}/loss"] = npy(loss)
        out[f"{key}/slots"] = np.array(plan.num_slots)
        for n, g in grads.items():
            out[f"{key}/{n}"] = npy(g)
    # tensor parallelism inside a stage (pp 1 x mp 2) and data
    # parallelism around the pipeline (dp 2 x pp 1)
    tp_mesh = dist.ProcessMesh(np.arange(2).reshape(1, 2), ["pp", "mp"])
    params = {n: t(inp[f"tp_{n}"]) for n in ("wg", "wd", "b")}

    def tp_stage(p, x):
        h = torch.nn.functional.silu(eng.mp_copy(x, "mp") @ p["wg"])
        return x + eng.mp_reduce(h @ p["wd"], "mp") + p["b"]

    loss, grads = eng.pipeline_schedule_train_step(
        tp_stage, _loss_fn, params, t(inp["tp_xs"]), t(inp["tp_ys"]),
        mesh=tp_mesh, plan=eng.compile_pipeline_plan("1f1b", S=1, M=4),
        param_pspecs={"wg": (None, "mp"), "wd": ("mp", None), "b": (None,)})
    out["engine/tp/loss"] = npy(loss)
    for n, g in grads.items():
        out[f"engine/tp/{n}"] = npy(g)
    dp_mesh = dist.ProcessMesh(np.arange(2).reshape(2, 1), ["dp", "pp"])
    params = {n: t(inp[f"eng1_{n}"])[:1] for n in ("w", "b")}
    loss, grads = eng.pipeline_schedule_train_step(
        _stage_fn, _loss_fn, params, t(inp["dp_xs"]), t(inp["dp_ys"]),
        mesh=dp_mesh, plan=eng.compile_pipeline_plan("1f1b", S=1, M=4),
        data_axis="dp")
    out["engine/dp/loss"] = npy(loss)
    for n, g in grads.items():
        out[f"engine/dp/{n}"] = npy(g)


def main():
    # the CPU and one thread for this process only: the test imports this
    # module for its case tables
    set_device("cpu")
    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "pp_degree": 2}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    rank = hcg.get_stage_id()
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    out = {}
    for shared, name in ((False, "pipe"), (True, "shared")):
        state = dict(np.load(os.path.join(out_dir, f"{name}.npz")))
        modes = PP_MODES if not shared else (("1F1B", 1),)
        for mode, vpp in modes:
            pipeline_parallel(rank, inp, out, state, f"{name}/{mode}", mode,
                              vpp, shared)
    distributed_model(out)
    spmd(rank, inp, out)
    engine(rank, inp, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank{rank} done", flush=True)


if __name__ == "__main__":
    main()
