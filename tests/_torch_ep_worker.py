"""Worker of tests/test_torch_expert_parallel.py: one rank of a gloo world
of two on the CPU, started by the port's launcher (``python -m
paddle_tpu_torch.distributed.launch --nnodes 2``). Its one argument is
the test's directory, which holds the inputs (``inputs.npz``) and the
reference's weights (``ernie.npz``, ``fused.npz``, ``experts.npz``). It
runs every case of the file on the port and saves what it got
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
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.auto_parallel.api import (  # noqa: E402
    DistParameter, _local_shard)
from paddle_tpu_torch.distributed.communication.group import (  # noqa: E402
    axis_group)
from paddle_tpu_torch.incubate.distributed.models.moe import (  # noqa: E402
    FusedMoELayer, GShardGate, MoELayer, SwitchGate, moe_layer)
from paddle_tpu_torch.models import (  # noqa: E402
    ErnieMoeConfig, ErnieMoeForCausalLM, ernie_moe_shard_plan)

LR = 1e-3
STEPS = 3
D, H, E = 16, 32, 4


def t(a):
    return torch.from_numpy(np.asarray(a))


def npy(x):
    return x.detach().numpy().copy()


def whole(p, local):
    """The whole tensor of ``local`` (a parameter's, its gradient's) on
    every rank."""
    return p.gather(local) if isinstance(p, DistParameter) else local


def load_state(model, state):
    """The reference's weights into ``model``, whose parameters may already
    be sharded (each rank takes its shard of the whole)."""
    linear = {n for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            a = t(state[name])
            if name.rsplit(".", 1)[0] in linear:
                a = a.T
            if isinstance(p, DistParameter):
                a = _local_shard(a.contiguous(), p.device_mesh,
                                 p.torch_placements)
            p.copy_(a)
    return linear


class Paths:
    """Counts the index path (``moe_idx_ffn``) and the einsum path
    (``ExpertsFFN.forward``) while active."""

    def __init__(self):
        self.index = self.einsum = 0

    def __enter__(self):
        self._idx, self._fwd = moe_layer.moe_idx_ffn, \
            moe_layer.ExpertsFFN.forward

        def idx(*a, **k):
            self.index += 1
            return self._idx(*a, **k)

        def fwd(mod, *a, **k):
            self.einsum += 1
            return self._fwd(mod, *a, **k)
        moe_layer.moe_idx_ffn = idx
        moe_layer.ExpertsFFN.forward = fwd
        return self

    def __exit__(self, *exc):
        moe_layer.moe_idx_ffn = self._idx
        moe_layer.ExpertsFFN.forward = self._fwd

    def name(self):
        return np.array(("index" if self.index else "")
                        + ("einsum" if self.einsum else ""))


def ernie():
    m = ErnieMoeForCausalLM(ErnieMoeConfig.tiny(), device="cpu")
    for layer in m.model.layers:
        layer.mlp.gate._random2 = False
    return m


#: the names of ERNIE-MoE's ``nn.Linear`` modules before any plan
LINEAR = {n for n, m in ErnieMoeForCausalLM(
    ErnieMoeConfig.tiny(), device="cpu").named_modules()
    if isinstance(m, torch.nn.Linear)}


def train(key, model, ids, labels, out, inner=None):
    """Three AdamW steps; the losses, each step's gradients and the
    parameters after, whole, by the reference's names and layouts."""
    inner = inner or model
    linear = LINEAR

    def ref(name, a):
        a = npy(a)
        return a.T if name.rsplit(".", 1)[0] in linear else a

    params = dict(inner.named_parameters())
    opt = topt.AdamW(learning_rate=LR, parameters=list(params.items()))
    losses = []
    drops = []
    real = moe_layer._route

    def spy(*a, **k):
        r = real(*a, **k)
        drops.append(int(((r[1] > 0) & ~r[3]).sum()))
        return r

    with Paths() as paths:
        for step in range(STEPS):
            moe_layer._route = spy if step == 0 else real
            try:
                loss, _ = model(ids, labels=labels)
            finally:
                moe_layer._route = real
            loss.backward()
            losses.append(loss.item())
            for n, p in params.items():
                out[f"{key}/grad{step}/{n}"] = ref(n, whole(p, p.grad))
            opt.step()
            opt.clear_grad()
    out[f"{key}/losses"] = np.array(losses)
    out[f"{key}/drops"] = np.array(drops)
    out[f"{key}/path"] = paths.name()
    out[f"{key}/loss_dtype"] = np.array(str(loss.dtype))
    for n, p in params.items():
        out[f"{key}/param/{n}"] = ref(n, whole(p, p))


def c5_data_parallel(rank, inp, state, out):
    """ERNIE-MoE under ``DataParallel`` at dp 2, each rank half the batch,
    routing over the global batch (C5)."""
    m = ernie()
    load_state(m, state)
    dp = dist.DataParallel(m)
    ids, labels = t(inp["ids"]).chunk(2)[rank], t(inp["labels"]).chunk(2)[
        rank]
    train("c5", dp, ids, labels, out, inner=m)
    drops = torch.tensor(out["c5/drops"])
    torch.distributed.all_reduce(drops)
    out["c5/global_drops"] = drops.numpy()
    gate = m.model.layers[0].mlp.gate
    out["c5/batch_group"] = np.array(gate.batch_group().ranks)


def ep2_plan(rank, inp, state, out):
    """ERNIE-MoE under ``ernie_moe_shard_plan`` on dp 1 x ep 2 (attention
    tensor parallel over ep, the reference test's layout), the tokens
    replicated: the index path on each rank's two experts."""
    m = ernie()
    load_state(m, state)
    mesh = dist.ProcessMesh([[0, 1]], ["dp", "ep"])
    ernie_moe_shard_plan(m, mesh, mp_axis="ep", ep_axis="ep")
    ex = m.model.layers[1].mlp.experts
    out["ep2/bank_local"] = np.array([list(ex.w0.shape), list(ex.b1.shape)])
    out["ep2/kinds"] = np.array(sorted({type(p).__name__
                                        for p in m.parameters()}))
    train("ep2", m, t(inp["ids"]), t(inp["labels"]), out)


def c6_hybrid(rank, inp, state, fused_state, out):
    """After ``fleet.init(mp_degree=2)``: ``FusedMoELayer`` and ERNIE-MoE
    shard their banks over mp and take the einsum path (C6)."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    fm = FusedMoELayer(D, H, E, gate={"type": "gshard",
                                      "random_routing": False},
                       device="cpu")
    load_state(fm, fused_state)
    out["c6f/bank_local"] = np.array(fm.experts.w0.shape)
    x = t(inp["moe_x"]).clone().requires_grad_()
    with Paths() as paths:
        y = fm(x)
        (y * t(inp["moe_w"])).sum().backward()
    out["c6f/path"] = paths.name()
    out["c6f/y"] = npy(y)
    out["c6f/dx"] = npy(x.grad)
    for n, p in fm.named_parameters():
        out[f"c6f/grad/{n}"] = npy(whole(p, p.grad))
    m = ernie()
    load_state(m, state)
    train("c6", m, t(inp["ids"]), t(inp["labels"]), out)
    fleet.set_hybrid_communicate_group(None)


def ep2_layers(rank, inp, fused_state, experts_state, out):
    """``FusedMoELayer(moe_group=)`` and ``MoELayer(moe_group=)`` over an
    ep axis of two, the tokens replicated; the refusal of tokens sharded
    over that axis."""
    mesh = dist.ProcessMesh([0, 1], ["ep"])
    g = axis_group(mesh, "ep")
    fm = FusedMoELayer(D, H, E, gate={"type": "gshard",
                                      "random_routing": False},
                       moe_group=g, device="cpu")
    load_state(fm, fused_state)
    out["epf/bank_local"] = np.array(fm.experts.w0.shape)
    x = t(inp["moe_x"]).clone().requires_grad_()
    with Paths() as paths:
        y = fm(x)
        (y * t(inp["moe_w"])).sum().backward()
    out["epf/path"] = paths.name()
    out["epf/y"] = npy(y)
    out["epf/dx"] = npy(x.grad)
    for n, p in fm.named_parameters():
        out[f"epf/grad/{n}"] = npy(whole(p, p.grad))

    class Expert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = torch.nn.Linear(D, H)
            self.fc2 = torch.nn.Linear(H, D)

        def forward(self, v):
            return self.fc2(torch.relu(self.fc1(v)))

    ml = MoELayer(D, [Expert() for _ in range(E)],
                  gate={"type": "gshard", "random_routing": False},
                  moe_group=g)
    linear = load_state(ml, experts_state)
    x = t(inp["moe_x"]).clone().requires_grad_()
    y = ml(x)
    (y * t(inp["moe_w"])).sum().backward()
    out["epm/y"] = npy(y)
    out["epm/dx"] = npy(x.grad)
    for n, p in ml.named_parameters():
        a = npy(p.grad)
        out[f"epm/grad/{n}"] = a.T if n.rsplit(".", 1)[0] in linear else a

    # the tokens sharded over the ep axis itself: the ranks of the batch
    # group are those of the expert group
    dp = dist.DataParallel(FusedMoELayer(
        D, H, E, gate={"type": "gshard", "random_routing": False},
        moe_group=g, device="cpu"), group=g)
    try:
        dp(t(inp["moe_x"]).chunk(2)[rank])
        out["epf/refusal"] = np.array("no error")
    except NotImplementedError as e:
        out["epf/refusal"] = np.array(str(e))


def gates(rank, inp, gate_state, out):
    """GShard and switch gates with ``group`` the world: each rank routes
    its half of the tokens in the global order."""
    world = dist.get_group()
    x_all = t(inp["gate_x"])
    for kind, cls, kw in (("gshard", GShardGate,
                           dict(random_routing=False)),
                          ("switch", SwitchGate, dict(switch_eps=0.0))):
        gate = cls(D, E, 1, group=world, device="cpu", **kw)
        with torch.no_grad():
            gate.weight.copy_(t(gate_state[f"{kind}.weight"]))
            gate.bias.copy_(t(gate_state[f"{kind}.bias"]))
        x = x_all.chunk(2)[rank].clone().requires_grad_()
        combine, dispatch = gate(x)
        aux = gate.get_loss()
        w = t(inp[f"gate_w_{kind}"]).chunk(2)[rank][..., :combine.shape[-1]]
        ((combine * w).sum() + aux).backward()
        grads = torch.cat([gate.weight.grad.reshape(-1), gate.bias.grad])
        torch.distributed.all_reduce(grads)
        out[f"gate/{kind}/combine"] = npy(combine)
        out[f"gate/{kind}/dispatch"] = npy(dispatch)
        out[f"gate/{kind}/aux"] = npy(aux)
        out[f"gate/{kind}/dgrad"] = npy(grads / 2)
        out[f"gate/{kind}/dx"] = npy(x.grad)


def main():
    out_dir = sys.argv[1]
    dist.init_parallel_env()
    rank = dist.get_rank()
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    state = dict(np.load(os.path.join(out_dir, "ernie.npz")))
    fused = dict(np.load(os.path.join(out_dir, "fused.npz")))
    experts = dict(np.load(os.path.join(out_dir, "experts.npz")))
    gate_state = dict(np.load(os.path.join(out_dir, "gates.npz")))
    out = {}
    c5_data_parallel(rank, inp, state, out)
    ep2_plan(rank, inp, state, out)
    c6_hybrid(rank, inp, state, fused, out)
    ep2_layers(rank, inp, fused, experts, out)
    gates(rank, inp, gate_state, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank{rank} done", flush=True)


if __name__ == "__main__":
    main()
