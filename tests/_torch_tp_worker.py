"""Worker of tests/test_torch_tensor_parallel.py: one rank of a gloo
world of two on the CPU (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``
and ``PADDLE_MASTER`` set by the test). Its one argument is the test's
directory, which holds the inputs (``inputs.npz``) and the reference's
weights (``<model>.npz``). It runs every case of the file on the port
and saves what it got (``rank<R>.npz``; ``nn.Linear`` weights in the
reference's ``[in, out]``); the test holds that against the reference.
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
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.auto_parallel.api import (  # noqa: E402
    DistParameter)
from paddle_tpu_torch.models import (  # noqa: E402
    BertConfig, BertForPretraining, GPTConfig, GPTForCausalLM, LlamaConfig,
    LlamaForCausalLM, bert_shard_plan, gpt_shard_plan, llama_shard_plan)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm  # noqa: E402

LR = 1e-3
STEPS = 3
BIG = 1e9
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def t(a):
    return torch.from_numpy(np.asarray(a))


def npy(x):
    return x.detach().numpy().copy()


def mp_layers(rank, inp, out):
    """tests/test_distributed.py:116-189 on two mp ranks."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    out["hcg"] = np.array([hcg.get_model_parallel_world_size(),
                           hcg.get_data_parallel_world_size(),
                           hcg.get_model_parallel_rank()])
    col = fleet.ColumnParallelLinear(16, 32, gather_output=False)
    row = fleet.RowParallelLinear(32, 16, input_is_parallel=True)
    with torch.no_grad():
        for layer, name in ((col, "col"), (row, "row")):
            w = t(inp[f"{name}_w"]).T.contiguous()      # [out, in]
            layer.weight.copy_(w.chunk(2, 0 if name == "col" else 1)[rank])
            b = t(inp[f"{name}_b"])
            layer.bias.copy_(b.chunk(2)[rank] if name == "col" else b)
    out["col_local_shape"] = np.array(col.weight.shape)
    out["col_weight_full"] = npy(col.weight.full_tensor()).T
    x = t(inp["x"]).requires_grad_()
    y = row(col(x))
    y.backward(t(inp["dy"]))
    out["tp_y"] = npy(y)
    out["tp_dx"] = npy(x.grad)
    out["tp_dcol_w"] = npy(col.weight.gather(col.weight.grad)).T
    out["tp_drow_w"] = npy(row.weight.gather(row.weight.grad)).T
    out["tp_drow_b"] = npy(row.bias.grad)

    emb = fleet.VocabParallelEmbedding(64, 16)
    with torch.no_grad():
        emb.weight.copy_(t(inp["emb_w"]).chunk(2)[rank])
    e = emb(t(inp["emb_ids"]))
    e.backward(t(inp["emb_dy"]))
    out["emb_out"] = npy(e)
    out["emb_dw"] = npy(emb.weight.gather(emb.weight.grad))

    pce = fleet.ParallelCrossEntropy()
    logits = t(inp["ce_logits"]).chunk(2, -1)[rank].clone().requires_grad_()
    loss = pce(logits, t(inp["ce_labels"]))
    loss.sum().backward()
    out["pce_loss"] = npy(loss)
    grads = [torch.empty_like(logits.grad) for _ in range(2)]
    torch.distributed.all_gather(grads, logits.grad)
    out["pce_dlogits"] = npy(torch.cat(grads, -1))

    # sequence parallelism: [b, s, h] with s split over mp
    from paddle_tpu_torch.distributed.fleet import (AllGatherOp, GatherOp,
                                                    ReduceScatterOp,
                                                    ScatterOp)
    xs = t(inp["sp_x"]).requires_grad_()
    part = ScatterOp(xs)
    out["sp_scatter_shape"] = np.array(part.shape)
    whole = GatherOp(part)
    out["sp_gather"] = npy(whole)
    (whole * t(inp["sp_w"])).sum().backward()
    out["sp_dx"] = npy(xs.grad)
    loc = t(inp["sp_x"]).chunk(2, 1)[rank].clone().requires_grad_()
    ag = AllGatherOp(loc)
    (ag * t(inp["sp_w"])).sum().backward()
    out["sp_allgather"] = npy(ag)
    out["sp_allgather_dx"] = npy(loc.grad)
    full = (t(inp["sp_x"]) * (rank + 1)).requires_grad_()
    rs = ReduceScatterOp(full)
    (rs * t(inp["sp_w"]).chunk(2, 1)[rank]).sum().backward()
    out["sp_reduce_scatter"] = npy(rs)
    out["sp_reduce_scatter_dx"] = npy(full.grad)

    # the sequence-parallel linears: the sequence split over mp in and out
    from paddle_tpu_torch.distributed.fleet import (
        ColumnSequenceParallelLinear, RowSequenceParallelLinear,
        register_sequence_parallel_allreduce_hooks)
    seq = torch.nn.Sequential(ColumnSequenceParallelLinear(8, 16),
                              RowSequenceParallelLinear(16, 8))
    with torch.no_grad():
        seq[0].weight.copy_(t(inp["sp_w1"]).T.chunk(2, 0)[rank])
        seq[0].bias.copy_(t(inp["sp_b1"]).chunk(2)[rank])
        seq[1].weight.copy_(t(inp["sp_w2"]).T.chunk(2, 1)[rank])
        seq[1].bias.copy_(t(inp["sp_b2"]))
    register_sequence_parallel_allreduce_hooks(seq)
    xl = t(inp["sp_x"]).chunk(2, 1)[rank].clone().requires_grad_()
    yl = seq(xl)
    (yl * t(inp["sp_w"]).chunk(2, 1)[rank]).sum().backward()
    out["spl_y"] = npy(yl)
    out["spl_dx"] = npy(xl.grad)
    out["spl_dw1"] = npy(seq[0].weight.gather(seq[0].weight.grad)).T
    out["spl_dw2"] = npy(seq[1].weight.gather(seq[1].weight.grad)).T
    out["spl_db2"] = npy(seq[1].bias.grad)

    # paddle.distributed.split: a column-parallel linear, gathered
    xsplit = t(inp["x"])
    ys = dist.split(xsplit, (16, 32), "linear", axis=1, gather_out=True,
                    name="tp_case")
    layer = dist._split_layers[("tp_case", "linear", (16, 32), 1, 1, True)]
    out["split_y"] = npy(ys)
    out["split_want"] = npy(torch.nn.functional.linear(
        xsplit, layer.weight.full_tensor(), layer.bias.full_tensor()))
    out["split_local"] = np.array(layer.weight.shape)

    # in-trace collectives over the hybrid group's mp axis
    from paddle_tpu_torch.distributed.communication import (
        all_gather_in_trace, all_to_all_in_trace, ppermute, psum)
    for name, fn in (
            ("psum", lambda v: psum(v, "mp")),
            ("all_gather", lambda v: all_gather_in_trace(v, "mp", axis=0)),
            ("ppermute", lambda v: ppermute(v, "mp", [(0, 1), (1, 0)])),
            ("all_to_all", lambda v: all_to_all_in_trace(v, "mp", 0, 1))):
        v = t(inp["it_x"])[rank].clone().requires_grad_()
        r = fn(v)
        (r * t(inp[f"it_w_{name}"])[rank]).sum().backward()
        out[f"it_{name}"] = npy(r)
        out[f"it_{name}_dx"] = npy(v.grad)
    fleet.set_hybrid_communicate_group(None)


def reshard_pairs(rank, inp, out):
    """Every pair of r, s0, s1, p into r, s0, s1 on a one-axis mesh of
    two: the whole tensor, this rank's shape and the gradient."""
    mesh = dist.ProcessMesh([0, 1], ["x"])
    src = {"r": [dist.Replicate()], "s0": [dist.Shard(0)],
           "s1": [dist.Shard(1)], "p": [dist.Partial()]}
    a = t(inp["rs_x"])
    for sn, sp in src.items():
        for dn, dp in src.items():
            if dn == "p":
                continue
            d = dist.shard_tensor(a, mesh, sp)
            d.requires_grad_()
            r = dist.reshard(d, mesh, dp)
            out[f"rs_{sn}_{dn}_full"] = npy(r.full_tensor())
            out[f"rs_{sn}_{dn}_local"] = np.array(r.to_local().shape)
            (r.full_tensor() * t(inp["rs_w"])).sum().backward()
            out[f"rs_{sn}_{dn}_grad"] = npy(d.grad.full_tensor())


def kernel_refusals(rank, out):
    """Every kernel wrapper refuses a DTensor argument with TypeError."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_attention_varlen as fv
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import rms_norm as rn
    from paddle_tpu_torch.ops.cuda import tiled_mm as tm

    mesh = dist.ProcessMesh([0, 1], ["x"])

    def rep(x):
        return dist.shard_tensor(x, mesh, [dist.Replicate()])

    q = torch.randn(1, 2, 4, 16)
    pk = torch.randn(2, 2, 4, 16)
    cu = torch.tensor([0, 4], dtype=torch.int32)
    calls = {
        "flash_fwd": lambda: fa._flash_fwd_bhsd(rep(q), q, q, causal=True,
                                                scale=0.25),
        "flash_bwd": lambda: fa._flash_bwd_bhsd(
            rep(q), q, q, q, torch.zeros(1, 2, 4), q, causal=True,
            scale=0.25),
        "rms_fwd": lambda: rn.rms_norm_fwd(rep(torch.randn(4, 8)),
                                           torch.ones(8), eps=1e-6),
        "rms_bwd": lambda: rn.rms_norm_bwd(torch.randn(4, 8),
                                           rep(torch.ones(8)),
                                           torch.randn(4, 8), eps=1e-6),
        "varlen": lambda: fv._vflash_fwd(rep(q[0].transpose(0, 1)),
                                         q[0].transpose(0, 1),
                                         q[0].transpose(0, 1), cu, cu,
                                         causal=True, scale=0.25),
        "paged": lambda: pa.paged_attention_decode(
            rep(torch.randn(1, 2, 16)), pk, pk,
            torch.tensor([3], dtype=torch.int32),
            torch.tensor([[0, 1]], dtype=torch.int32)),
        "tiled_mm": lambda: tm.tiled_mm(rep(torch.randn(8, 8).bfloat16()),
                                        torch.randn(8, 8).bfloat16()),
    }
    for name, call in calls.items():
        try:
            call()
            out[f"refuse_{name}"] = np.array("no error")
        except TypeError as e:
            out[f"refuse_{name}"] = np.array(f"TypeError: {e}")


def data_parallel_and_sharding(rank, inp, out):
    """``DataParallel(mesh=)`` and ``shard_optimizer`` stage 1 on a dp
    mesh of two: a linear layer, each rank on its half of the batch."""
    mesh = dist.ProcessMesh([0, 1], ["dp"])
    lin = torch.nn.Linear(16, 16)
    with torch.no_grad():
        lin.weight.copy_(t(inp["dp_w"]).T)
        lin.bias.copy_(t(inp["dp_b"]))
    model = dist.DataParallel(lin, mesh=mesh)
    opt = topt.AdamW(learning_rate=0.01, parameters=lin.parameters())
    dist.shard_optimizer(opt, dist.ShardingStage1("dp", mesh=mesh))
    out["zero_m1_shape"] = np.array(
        opt._accum("moment1", opt._row_shards.views[id(lin.weight)][1])
        .shape)
    x, y = t(inp["dp_x"]).chunk(2)[rank], t(inp["dp_y"]).chunk(2)[rank]
    for step in range(2):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        if step == 0:
            out["dp_dw"] = npy(lin.weight.grad).T
        opt.step()
        opt.clear_grad()
    out["dp_w_after"] = npy(lin.weight).T
    out["dp_b_after"] = npy(lin.bias)


class MLP(torch.nn.Module):
    """The reference test's ``_MLP``."""

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(16, 64)
        self.fc2 = torch.nn.Linear(64, 4)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _mlp(inp):
    m = MLP()
    with torch.no_grad():
        for name, p in m.named_parameters():
            a = t(inp[f"mlp_{name}"])
            p.copy_(a.T if p.ndim == 2 else a)
    return m


def loss_fn(out, label):
    return ((out - label) ** 2).mean()


def dist_model_and_engine(rank, inp, out):
    mesh = dist.ProcessMesh([0, 1], ["dp"])
    model = _mlp(inp)
    for p in model.parameters():
        dist.shard_tensor(p, mesh, [dist.Replicate()])
    opt = topt.AdamW(learning_rate=0.01, parameters=model.parameters())
    dm = dist.to_static(model, loss=loss_fn, optimizer=opt)
    x = dist.shard_tensor(t(inp["mlp_x"]), mesh, [dist.Shard(0)])
    y = dist.shard_tensor(t(inp["mlp_y"]), mesh, [dist.Shard(0)])
    out["dm_losses"] = np.array([float(dm(x, y)) for _ in range(3)])
    dm.eval()
    out["dm_eval"] = np.array(float(dm(x, y)))
    dm.predict()
    out["dm_predict"] = npy(dm(x))
    out["dm_fc1_w"] = npy(model.fc1.weight.full_tensor()).T

    model = _mlp(inp)
    engine = dist.auto_parallel.Engine(
        model, loss=loss_fn,
        optimizer=topt.AdamW(learning_rate=0.01,
                             parameters=model.parameters()))
    batches = [(t(inp["mlp_x"]), t(inp["mlp_y"]))] * 3
    out["engine_fit"] = np.array(engine.fit(batches, verbose=0)["loss"])
    try:
        engine.prepare()
    except NotImplementedError as e:
        out["engine_prepare"] = np.array(str(e))

    # strategy.sharding (stage 1): the same steps with moments in halves
    model = _mlp(inp)
    for p in model.parameters():
        dist.shard_tensor(p, mesh, [dist.Replicate()])
    opt = topt.AdamW(learning_rate=0.01, parameters=model.parameters())
    strategy = dist.Strategy({"sharding": {"enable": True, "stage": 1}})
    dm = dist.to_static(model, loss=loss_fn, optimizer=opt,
                        strategy=strategy)
    out["dm_stage1_losses"] = np.array([float(dm(x, y)) for _ in range(3)])
    out["dm_stage1_m1_rows"] = np.array(
        [opt._accumulators["moment1"][id(v)].shape[0]
         for _, v in opt._row_shards.views.values()])

    # shard_layer with sharded weights: fc1 by output rows, fc2 by input
    # columns (torch's [out, in]); the layer computes on DTensors
    model = _mlp(inp)

    def shard_fn(name, layer, mesh):
        if name == "fc1":
            dist.shard_tensor(layer.weight, mesh, [dist.Shard(0)])
            dist.shard_tensor(layer.bias, mesh, [dist.Shard(0)])
        elif name == "fc2":
            dist.shard_tensor(layer.weight, mesh, [dist.Shard(1)])
            dist.shard_tensor(layer.bias, mesh, [dist.Replicate()])

    dist.shard_layer(model, mesh, shard_fn)
    out["sl_fc1_local"] = np.array(model.fc1.weight.shape)
    o = model(t(inp["mlp_x"]))
    ys = dist.shard_tensor(t(inp["mlp_y"]), mesh, [dist.Replicate()])
    loss_fn(o, ys).full_tensor().backward()
    out["sl_out"] = npy(o.full_tensor())
    out["sl_dfc1_w"] = npy(model.fc1.weight.gather(model.fc1.weight.grad)).T
    out["sl_dfc2_w"] = npy(model.fc2.weight.gather(model.fc2.weight.grad)).T


def fleet_model_and_optimizer(rank, inp, out):
    """``fleet.distributed_model`` / ``distributed_optimizer`` at mp 2,
    and ``distributed_optimizer`` at a sharding degree of 2."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(_mlp(inp))
    out["fleet_model"] = np.array([
        type(model).__name__,
        str(sorted({type(p).__name__ for p in model.parameters()}))])
    opt = topt.AdamW(learning_rate=0.01, parameters=model.parameters())
    out["fleet_opt_same"] = np.array(fleet.distributed_optimizer(opt) is opt)
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "sharding_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    sharded = fleet.distributed_optimizer(opt)
    out["fleet_sharding"] = np.array(
        [type(sharded).__name__,
         str(sharded._inner_opt is opt and opt._row_shards.stage)])
    fleet.set_hybrid_communicate_group(None)


def _ref_layout(linear):
    def conv(name, a):
        a = npy(a)
        return a.T if name.rsplit(".", 1)[0] in linear else a
    return conv


def train_plan(rank, inp, out, key, build, plan, batch, call):
    """Three AdamW steps of the model under its plan on dp 1 x mp 2, the
    third with a clip that bites."""
    weights = dict(np.load(os.path.join(sys.argv[1], f"{key}.npz")))
    model = build()
    ptt.load_paddle_tpu_state(model, weights)
    linear = {n for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    conv = _ref_layout(linear)
    plan(model, dist.ProcessMesh([[0, 1]], ["dp", "mp"]))
    params = dict(model.named_parameters())
    assert all(isinstance(p, DistParameter) for p in params.values())
    for n, p in params.items():
        out[f"{key}/init/{n}"] = conv(n, p.full_tensor())
        out[f"{key}/local/{n}"] = np.array(p.shape)
    clip = ClipGradByGlobalNorm(BIG)
    opt = topt.AdamW(learning_rate=LR, parameters=list(params.items()),
                     grad_clip=clip)
    losses = []
    for step in range(STEPS):
        if step == STEPS - 1:
            clip.clip_norm = float(inp[f"{key}_clip"])
        loss = call(model, batch)
        loss.backward()
        losses.append(loss.item())
        out[f"{key}/loss_dtype"] = np.array(str(loss.dtype))
        for n, p in params.items():
            out[f"{key}/grad{step}/{n}"] = conv(n, p.gather(p.grad))
        if step == 0:
            out[f"{key}/grad_dtype"] = np.array(
                sorted({str(p.grad.dtype) for p in params.values()}))
        opt.step()
        opt.clear_grad()
    out[f"{key}/losses"] = np.array(losses)
    for n, p in params.items():
        out[f"{key}/param/{n}"] = conv(n, p.full_tensor())
    out[f"{key}/param_dtype"] = np.array(
        sorted({str(p.dtype) for p in params.values()}))


def models(rank, inp, out):
    ids, labels = t(inp["lm_ids"]), t(inp["lm_labels"])
    train_plan(
        rank, inp, out, "llama",
        lambda: LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"),
        llama_shard_plan, (ids, labels),
        lambda m, b: m(b[0], labels=b[1])[0])
    train_plan(
        rank, inp, out, "gpt",
        lambda: GPTForCausalLM(GPTConfig.tiny(**NO_DROPOUT), device="cpu"),
        gpt_shard_plan, (ids, labels),
        lambda m, b: m(b[0], labels=b[1])[0])
    bert_batch = [None if inp[f"bert_{k}"].ndim == 0 else t(inp[f"bert_{k}"])
                  for k in ("ids", "tt", "mlm", "nsp", "mask")]
    train_plan(
        rank, inp, out, "bert",
        lambda: BertForPretraining(BertConfig.tiny(**NO_DROPOUT),
                                   device="cpu"),
        bert_shard_plan, bert_batch,
        lambda m, b: m(b[0], b[1], attention_mask=b[4],
                       masked_lm_labels=b[2], next_sentence_labels=b[3])[0])


def main():
    out_dir = sys.argv[1]
    dist.init_parallel_env()
    rank = dist.get_rank()
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    out = {}
    mp_layers(rank, inp, out)
    reshard_pairs(rank, inp, out)
    kernel_refusals(rank, out)
    data_parallel_and_sharding(rank, inp, out)
    dist_model_and_engine(rank, inp, out)
    fleet_model_and_optimizer(rank, inp, out)
    models(rank, inp, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank{rank} done", flush=True)


if __name__ == "__main__":
    main()
