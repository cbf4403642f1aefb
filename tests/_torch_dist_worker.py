"""Worker of tests/test_torch_distributed_launch.py, started by the
port's launcher (``python -m paddle_tpu_torch.distributed.launch
--nnodes 2 ...``) on each of two nodes: a gloo world of two ranks on the
CPU. Its one argument is the test's directory, which holds the
reference's tiny-Llama weights (``weights.npz``) and the batch
(``batch.npz``).

At restart generation 0 (``PADDLE_RESTART_GEN``) it plays the
reference's coordinated-restart test: both ranks bring the group up and
pass a barrier, then rank 1 dies and rank 0 waits to be stopped; both
launchers must start their workers again at generation 1. There it
brings the group up, takes the rendezvous store's hello round of the
reference's launcher test, runs every collective and records what it
got (``rank<R>.json``), then trains ``LlamaConfig.tiny`` three AdamW
steps under ``DataParallel`` on its half of the batch and saves the
losses, the step-1 gradients and the final parameters
(``rank<R>.npz``; ``nn.Linear`` weights in the reference's
``[in, out]``). The test holds them against the reference and against
each other.
"""
import json
import os
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.core.place import set_device

set_device("cpu")
torch.set_num_threads(1)

import paddle_tpu_torch as ptt  # noqa: E402
import paddle_tpu_torch.distributed as dist  # noqa: E402
import paddle_tpu_torch.optimizer as topt  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa

LR = 1e-3
STEPS = 3


def f32(*values):
    return torch.tensor(values, dtype=torch.float32)


def collectives(rank):
    """Every collective on small tensors; name -> what this rank got."""
    got = {}
    x = f32(rank + 1.0, 10.0 * (rank + 1))
    dist.all_reduce(x)
    got["all_reduce_sum"] = x.tolist()
    m = f32(float(rank))
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    got["all_reduce_max"] = m.tolist()
    m = f32(float(rank))
    dist.all_reduce(m, op=dist.ReduceOp.MIN)
    got["all_reduce_min"] = m.tolist()
    p = f32(rank + 2.0)
    dist.all_reduce(p, op=dist.ReduceOp.PROD)
    got["all_reduce_prod"] = p.tolist()
    a = f32(rank + 1.0, 2.0 * rank)
    dist.all_reduce(a, op=dist.ReduceOp.AVG)
    got["all_reduce_avg"] = a.tolist()
    i = torch.tensor([3 * rank + 1, -3 * rank - 2], dtype=torch.int64)
    dist.all_reduce(i, op=dist.ReduceOp.AVG)
    got["all_reduce_avg_int"] = i.tolist()
    a = f32(rank + 1.0)
    task = dist.all_reduce(a, op=dist.ReduceOp.AVG, sync_op=False)
    task.wait()
    got["all_reduce_avg_async"] = a.tolist()
    b = f32(100.0 * rank)
    dist.broadcast(b, src=1)
    got["broadcast"] = b.tolist()
    outs = []
    dist.all_gather(outs, f32(rank * 7.0))
    got["all_gather"] = torch.cat(outs).tolist()
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "tag": "x" * (rank + 1)})
    got["all_gather_object"] = [[o["rank"], o["tag"]] for o in objs]
    blist = [f"from-{rank}"] * (2 - rank)
    dist.broadcast_object_list(blist, src=0)
    got["broadcast_object_list"] = blist
    ins = [f32(10.0 * rank + j) for j in range(2)]
    outs = []
    dist.all_to_all(outs, ins)
    got["all_to_all"] = torch.cat(outs).tolist()
    dst = torch.zeros(1)
    dist.reduce_scatter(dst, [f32(1.0 + rank), f32(5.0 + rank)])
    got["reduce_scatter"] = dst.tolist()
    r = f32(rank + 1.0)
    dist.reduce(r, dst=0)
    got["reduce"] = r.tolist()
    s = torch.zeros(1)
    dist.scatter(s, [f32(10.0), f32(20.0)] if rank == 1 else None, src=1)
    got["scatter"] = s.tolist()
    gl = []
    dist.gather(f32(rank + 5.0), gl, dst=0)
    got["gather"] = [t.tolist() for t in gl]
    single = torch.zeros(4)
    dist.all_to_all_single(single, f32(*(10.0 * rank + k for k in range(4))))
    got["all_to_all_single"] = single.tolist()
    try:
        dist.all_to_all_single(torch.zeros(4), torch.zeros(4), [1, 3],
                               [3, 1])
        got["all_to_all_single_splits"] = "no error"
    except NotImplementedError:
        got["all_to_all_single_splits"] = "NotImplementedError"
    try:
        dist.send(f32(1.0), dst=1 - rank)
        got["send"] = "no error"
    except NotImplementedError:
        got["send"] = "NotImplementedError"
    dist.barrier()
    got["barrier"] = True
    return got


def hello(rank, world):
    """The reference launcher test's store round."""
    store = dist.get_store()
    store.set(f"hello/{rank}", f"rank{rank}")
    store.wait([f"hello/{r}" for r in range(world)])
    peer = store.get(f"hello/{(rank + 1) % world}").decode()
    assert peer == f"rank{(rank + 1) % world}", peer
    dist.barrier()
    print(f"worker {rank}/{world} OK: saw {peer}", flush=True)


def data_parallel(rank, world, out_dir):
    weights = dict(np.load(os.path.join(out_dir, "weights.npz")))
    batch = np.load(os.path.join(out_dir, "batch.npz"))
    half = batch["ids"].shape[0] // world
    rows = slice(rank * half, (rank + 1) * half)
    ids = torch.from_numpy(batch["ids"][rows])
    labels = torch.from_numpy(batch["labels"][rows])
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    ptt.load_paddle_tpu_state(model, weights)
    if rank == 1:
        # rank 0's weights must reach rank 1 through DataParallel's
        # broadcast at construction
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    dp = ptt.DataParallel(model, comm_buffer_size_MB=0.1,
                          last_comm_buffer_size_MB=0.02)
    linear = {n for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}

    def ref_layout(name, t):
        # a copy: a gradient is a view of a bucket the next step rewrites
        a = t.detach().numpy().copy()
        return a.T if name.rsplit(".", 1)[0] in linear else a

    opt = topt.AdamW(learning_rate=LR, parameters=list(dp.parameters()))
    out = {}
    for step in range(STEPS):
        loss, _ = dp(ids, labels=labels)
        loss.backward()
        out[f"loss/{step}"] = np.float64(loss.item())
        if step == 0:
            for n, p in dp.named_parameters():
                out[f"grad/{n}"] = ref_layout(n, p.grad)
        opt.step()
        opt.clear_grad()
    for n, p in dp.named_parameters():
        out[f"param/{n}"] = ref_layout(n, p)
    out["buckets"] = np.array([nb for _, _, nb in dp.buckets])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def main():
    out_dir = sys.argv[1]
    gen = int(os.environ["PADDLE_RESTART_GEN"])
    group = dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    assert (rank, world) == (int(os.environ["PADDLE_TRAINER_ID"]), 2)
    if gen == 0:
        dist.barrier()
        if rank == 1:
            sys.exit(3)         # rank 1 dies at generation 0
        time.sleep(60)          # rank 0 is healthy: its launcher stops it
        sys.exit(9)             # (never reached if the restart works)
    assert dist.get_backend() == "gloo", dist.get_backend()
    assert group.rank == rank and group.ranks == [0, 1]
    hello(rank, world)
    got = collectives(rank)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(got, f)
    data_parallel(rank, world, out_dir)
    dist.barrier()
    dist.destroy_process_group()
    print(f"gen{gen} rank{rank} done", flush=True)


if __name__ == "__main__":
    main()
