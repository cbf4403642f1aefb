"""Worker of tests/test_torch_context_parallel.py: one rank of a gloo
world of two on the CPU (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``
and ``PADDLE_MASTER`` set by the test). Its one argument is the test's
directory, which holds the inputs (``inputs.npz``) and the reference's
Llama weights (``llama.npz``). It runs every case of the file at sep 2,
each rank on its chunk of the sequence, and saves what it got
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
from paddle_tpu_torch.distributed.communication.group import (  # noqa: E402
    axis_group)
from paddle_tpu_torch.distributed.fleet import \
    context_parallel as cp  # noqa: E402
from paddle_tpu_torch.distributed.fleet.meta_parallel import (  # noqa: E402
    SegmentParallel)
from paddle_tpu_torch.models import (LlamaConfig,  # noqa: E402
                                     LlamaForCausalLM)

LR = 1e-3
STEPS = 3
RANK = 0


def t(a):
    return torch.from_numpy(np.asarray(a))


def npy(x):
    return x.detach().numpy().copy()


def chunk(a, dim=1):
    return t(a).chunk(2, dim)[RANK].contiguous()


class _Counted:
    """``_flash_fwd_bhsd`` / ``_flash_bwd_bhsd`` of the ring counted (the
    plain versions run on the CPU, where the kernels would on the card)."""

    def __enter__(self):
        self.saved = (cp._flash_fwd_bhsd, cp._flash_bwd_bhsd)
        self.n = [0, 0]

        def fwd(*a, **k):
            self.n[0] += 1
            return self.saved[0](*a, **k)

        def bwd(*a, **k):
            self.n[1] += 1
            return self.saved[1](*a, **k)
        cp._flash_fwd_bhsd, cp._flash_bwd_bhsd = fwd, bwd
        return self

    def __exit__(self, *exc):
        cp._flash_fwd_bhsd, cp._flash_bwd_bhsd = self.saved


def attention(inp, out, mesh):
    """ring and Ulysses attention on this rank's chunk: output, the
    gradients of sum(out * w) into q and the unexpanded k, v, the flash
    blocks launched, and the einsum ring (the plain version)."""
    group = axis_group(mesh, "sep")
    for fn_name in ("ring", "ulysses"):
        fn = {"ring": cp.ring_attention, "ulysses": cp.ulysses_attention}[
            fn_name]
        for causal in (False, True):
            key = f"{fn_name}/{'causal' if causal else 'full'}"
            q, k, v = (chunk(inp[n]).requires_grad_() for n in ("q", "k", "v"))
            rep = q.shape[2] // k.shape[2]
            ke, ve = (x.repeat_interleave(rep, dim=2) for x in (k, v))
            with _Counted() as counted:
                o = fn(q, ke, ve, mesh, "sep", causal=causal)
                (o * chunk(inp["w"])).sum().backward()
            out[f"{key}/out"] = npy(o)
            out[f"{key}/blocks"] = np.array(counted.n)
            for n, x in (("q", q), ("k", k), ("v", v)):
                out[f"{key}/d{n}"] = npy(x.grad)
            if fn_name != "ring":
                continue
            q2, k2, v2 = (chunk(inp[n]).requires_grad_()
                          for n in ("q", "k", "v"))
            ke, ve = (x.repeat_interleave(rep, dim=2) for x in (k2, v2))
            o2 = cp._ring_attn_local(q2, ke, ve, group=group, n=2, rank=RANK,
                                     causal=causal, scale=q.shape[-1] ** -0.5)
            (o2 * chunk(inp["w"])).sum().backward()
            out[f"{key}/einsum_out"] = npy(o2)
            for n, x in (("q", q2), ("k", k2), ("v", v2)):
                out[f"{key}/einsum_d{n}"] = npy(x.grad)


def refusals(out, hcg):
    """``ValueError`` for chunks that differ between the ranks (checked at
    the first call over a group: a mesh of its own here), heads that do
    not divide by the axis degree, and a sequence ``SegmentParallel``
    cannot cut evenly."""
    msgs = []
    s = 8 if RANK == 0 else 7
    x = torch.zeros(1, s, 2, 8)
    calls = (
        lambda: cp.ring_attention(x, x, x, dist.ProcessMesh([0, 1], ["cp"]),
                                  "cp"),
        lambda: cp.ulysses_attention(*[torch.zeros(1, 8, 3, 8)] * 3,
                                     dist.ProcessMesh([0, 1], ["sep"]),
                                     "sep"),
        lambda: SegmentParallel(torch.nn.Identity(), hcg=hcg)(
            torch.zeros(1, 15, 2)))
    for call in calls:
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
    out["refusals"] = np.array(msgs)


class _Recorder(torch.nn.Module):
    def __init__(self, lin):
        super().__init__()
        self.lin = lin
        self.seen = None

    def forward(self, x):
        self.seen = x.shape
        return self.lin(x)


def segment(inp, out, hcg):
    lin = torch.nn.Linear(8, 8)
    ptt.load_paddle_tpu_state(lin, {"weight": inp["seg_w"],
                                    "bias": inp["seg_b"]})
    model = SegmentParallel(_Recorder(lin), hcg=hcg)
    y = model(t(inp["seg_x"]))
    out["segment/y"] = npy(y)
    out["segment/seen"] = np.array(model._layers.seen)


def conv(name, p):
    """A parameter or gradient in the reference's layout."""
    a = npy(p)
    return a.T if name.endswith("proj.weight") or name == "lm_head.weight" \
        else a


def llama(inp, out, state, mode):
    """Three AdamW steps of the tiny Llama under ``fleet.distributed_model``
    at sep 2 (``SegmentParallel``): the global batch in, each rank on its
    chunk."""
    model = LlamaForCausalLM(LlamaConfig.tiny(context_parallel=mode),
                             device="cpu")
    ptt.load_paddle_tpu_state(model, state)
    wrapped = fleet.distributed_model(model)
    out[f"{mode}/wrapper"] = np.array(type(wrapped).__name__)
    params = dict(model.named_parameters())
    opt = topt.AdamW(learning_rate=LR, parameters=list(params.values()))
    ids, labels = t(inp["ids"]), t(inp["labels"])
    losses = []
    for step in range(STEPS):
        loss, _ = wrapped(ids, labels=labels)
        loss.backward()
        out[f"{mode}/loss_dtype"] = np.array(str(loss.dtype))
        for n, p in params.items():
            out[f"{mode}/grad{step}/{n}"] = conv(n, p.grad)
        losses.append(float(loss.detach()))
        opt.step()
        opt.clear_grad()
    out[f"{mode}/losses"] = np.array(losses)
    for n, p in params.items():
        out[f"{mode}/param/{n}"] = conv(n, p)


def main():
    global RANK
    out_dir = sys.argv[1]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "sep_degree": 2}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    RANK = hcg.get_sep_parallel_rank()
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    state = dict(np.load(os.path.join(out_dir, "llama.npz")))
    out = {"hcg": np.array([hcg.get_sep_parallel_world_size(), RANK])}
    mesh = dist.ProcessMesh(np.arange(2), ["sep"])
    attention(inp, out, mesh)
    refusals(out, hcg)
    segment(inp, out, hcg)
    for mode in ("ring", "ulysses"):
        llama(inp, out, state, mode)
    np.savez(os.path.join(out_dir, f"rank{RANK}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank{RANK} done", flush=True)


if __name__ == "__main__":
    main()
