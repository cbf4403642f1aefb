"""Mixture-of-experts layers: gate, dispatch, experts, combine.

Counterpart of ``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``.

- ``MoELayer`` takes a list of expert modules and routes through the
  gate's dense ``[N, E, C]`` tensors: ``dispatched = einsum('nec,nd->ecd',
  dispatch, x)``, each expert on its ``[C, d]`` buffer, ``out =
  einsum('nec,ecd->nd', combine, y)``.
- ``ExpertsFFN`` is the stacked bank: ``w0`` ``[E, d, h]`` (``[E, d, 2h]``
  for ``swiglu``, gate and up side by side), ``w1`` ``[E, h, d]``, biases
  ``[E, 1, h]`` / ``[E, 1, d]``, raw parameters in paddle's ``[in, out]``
  order (``convert.load_paddle_tpu_state`` copies them as they are). Its
  ``forward`` is the einsum path's expert step (``gelu`` exact, as
  paddle's ``F.gelu``).
- ``FusedMoELayer`` is gate + bank. With a top-k gate (every gate here)
  it runs the index path: ``gate._route`` turns the gate's probabilities
  into a slot for each kept (token, choice) and the inverse maps slot ->
  token and slot -> choice, the dispatch and the combine are row
  gathers, and ``_MoeIdxFFN``'s backward is the reference's manual
  gather-only VJP (``_moe_idx_ffn_vjp``): autograd of a gather would be
  an ``index_add_`` whose float order changes from run to run, and a
  captured training step must equal an eager one exactly. The index
  path's ``gelu`` is the tanh form: the reference resolves it as
  ``jax.nn.gelu``, whose default is ``approximate=True``.

The reference leaves all of this to XLA, so here it is plain PyTorch:
the expert products are ``torch.bmm``. Expert parallelism (``moe_group``)
waits for ``ROADMAP.md`` queue A item 4: a ``moe_group`` other than
None raises.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .....core.generator import make_generator
from .....core.place import resolve_device
from .....distributed.fleet.utils import recompute
from .....nn import functional as F
from .gate import (BaseGate, GShardGate, NaiveGate, SwitchGate, _one_hot,
                   _route, _xavier_uniform_)

__all__ = ["MoELayer", "ExpertsFFN", "FusedMoELayer"]


def _ep_mesh(moe_group, num_expert: int):
    """The mesh axis the experts shard over: none until the port has
    distributed training."""
    if moe_group is not None:
        raise NotImplementedError(
            "moe_group (expert parallelism) waits for ROADMAP.md queue A "
            "item 4 (distributed training) of the port")
    return None, None


def _make_gate(gate, d_model: int, num_expert: int, **factory) -> BaseGate:
    if isinstance(gate, BaseGate):
        return gate
    if isinstance(gate, (dict, str)):
        cfg = {"type": gate} if isinstance(gate, str) else dict(gate)
        kind = cfg.pop("type", "gshard")
        cls = {"gshard": GShardGate, "switch": SwitchGate,
               "naive": NaiveGate}[kind]
        return cls(d_model, num_expert, 1, **cfg, **factory)
    raise TypeError(f"unsupported gate spec: {gate!r}")


class MoELayer(nn.Module):
    """MoE over a list of expert modules (``experts``, one per expert),
    routed by ``gate`` (a dict or name, or a ``BaseGate``), through the
    dense dispatch. ``recompute_interval > 0`` recomputes each expert in
    the backward. The gate is made on the experts' device and dtype
    (``device`` where they have no parameters: None is the card) from
    ``seed``, its draws from ``generator``."""

    def __init__(self, d_model: int, experts: Sequence[nn.Module],
                 gate=None, moe_group=None, mp_group=None,
                 recompute_interval: int = 0, *, device=None, seed=0,
                 generator=None, **kwargs):
        super().__init__()
        self.d_model = d_model
        self.experts = nn.ModuleList(list(experts))
        self.num_expert = len(self.experts)
        self.recompute_interval = recompute_interval
        self.moe_group = moe_group
        self._mesh, self._ep_axis = _ep_mesh(moe_group, self.num_expert)
        ref = next(self.experts.parameters(), None)
        factory = (dict(device=resolve_device(device)) if ref is None
                   else dict(device=ref.device, dtype=ref.dtype))
        self.gate = _make_gate(gate or {"type": "gshard"}, d_model,
                               self.num_expert, seed=seed,
                               generator=generator, **factory)

    def forward(self, inp):
        x = inp.reshape(-1, self.d_model)
        combine, dispatch = self.gate(x)
        dispatched = torch.einsum("nec,nd->ecd", dispatch, x)
        outs = []
        for e, expert in enumerate(self.experts):
            xe = dispatched[e]
            if self.recompute_interval > 0 and xe.requires_grad:
                outs.append(recompute(expert, xe))
            else:
                outs.append(expert(xe))
        out = torch.einsum("nec,ecd->nd", combine, torch.stack(outs))
        return out.reshape(*inp.shape[:-1], out.shape[-1])


class ExpertsFFN(nn.Module):
    """The stacked expert bank (see the module docstring); ``forward``
    maps ``[E, C, d]`` to ``[E, C, d]`` with two batched products."""

    def __init__(self, num_expert: int, d_model: int, d_hidden: int,
                 activation: str = "gelu", moe_group=None, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        _ep_mesh(moe_group, num_expert)
        dev = resolve_device(device)
        self.num_expert = num_expert
        self.activation = activation
        first_out = 2 * d_hidden if activation == "swiglu" else d_hidden
        f = dict(device=dev, dtype=dtype)
        self.w0 = nn.Parameter(torch.empty(num_expert, d_model, first_out,
                                           **f))
        self.b0 = nn.Parameter(torch.zeros(num_expert, 1, first_out, **f))
        self.w1 = nn.Parameter(torch.empty(num_expert, d_hidden, d_model,
                                           **f))
        self.b1 = nn.Parameter(torch.zeros(num_expert, 1, d_model, **f))
        gen = make_generator(seed, dev)
        with torch.no_grad():
            _xavier_uniform_(self.w0, gen)
            _xavier_uniform_(self.w1, gen)

    def forward(self, dispatched):
        h = torch.einsum("ecd,edh->ech", dispatched, self.w0) + self.b0
        if self.activation == "swiglu":
            g, u = torch.chunk(h, 2, dim=-1)
            h = torch.nn.functional.silu(g) * u
        else:
            h = getattr(F, self.activation)(h)
        return torch.einsum("ech,ehd->ecd", h, self.w1) + self.b1


class FusedMoELayer(nn.Module):
    """MoE with a stacked ``ExpertsFFN`` bank, on the index path (see the
    module docstring). Extra arguments as ``NaiveGate``'s: ``device``,
    ``dtype``, ``seed`` and ``generator`` (the gate's draws)."""

    def __init__(self, d_model: int, d_hidden: int, num_expert: int,
                 gate=None, activation: str = "gelu", moe_group=None, *,
                 device=None, dtype=torch.float32, seed=0, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        self.experts = ExpertsFFN(num_expert, d_model, d_hidden, activation,
                                  moe_group, device=dev, dtype=dtype,
                                  seed=seed)
        self.num_expert = num_expert
        self._mesh, self._ep_axis = _ep_mesh(moe_group, num_expert)
        self.gate = _make_gate(gate or {"type": "gshard"}, d_model,
                               num_expert, device=dev, dtype=dtype,
                               seed=seed, generator=generator)

    def forward(self, inp):
        x = inp.reshape(-1, self.d_model)
        if isinstance(self.gate, NaiveGate):
            probs, cap, u = self.gate.route(x)
            ex = self.experts
            out = moe_idx_ffn(
                probs, x, ex.w0, ex.b0, ex.w1, ex.b1, u, k=self.gate.topk,
                capacity=cap, activation=ex.activation,
                normalize=self.gate._normalize,
                random2=self.gate._random2 and self.gate.training)
            return out.reshape(*inp.shape[:-1], self.d_model)
        combine, dispatch = self.gate(x)
        y = self.experts(torch.einsum("nec,nd->ecd", dispatch, x))
        out = torch.einsum("nec,ecd->nd", combine, y)
        return out.reshape(*inp.shape[:-1], self.d_model)


# ---------------------------------------------------------------------------
# the index path
# ---------------------------------------------------------------------------
def _moe_act(activation):
    """The index path's expert activation, as the reference resolves it
    from ``jax.nn``: ``gelu`` is the tanh form; ``swiglu`` splits a
    ``[.., 2h]`` projection into silu(gate) * up."""
    if activation == "swiglu":
        def swiglu(h):
            g, u = torch.chunk(h, 2, dim=-1)
            return torch.nn.functional.silu(g) * u
        return swiglu
    if activation == "gelu":
        return lambda h: torch.nn.functional.gelu(h, approximate="tanh")
    fn = getattr(torch.nn.functional, activation, None)
    return fn if fn is not None else getattr(torch, activation)


def _pad_row(t):
    """``t`` [R, d] with a zero row appended (the gathers' empty slot)."""
    return torch.cat([t, t.new_zeros(1, t.shape[1])])


def _moe_idx_ffn_fwd(probs, x, w0, b0, w1, b1, u, *, k, capacity,
                     activation, normalize, random2, saved=None):
    """The routed expert FFN by row gathers: x [N, d] -> [N, d]. Each
    expert's buffer is gathered through slot -> token (empty slots read
    the zero row), the two products run on the stacked bank (bmm, then
    the bias, in x's dtype), and each token sums its kept choices'
    outputs, weighted. ``saved`` (a dict) receives what the backward
    needs."""
    n, d = x.shape
    e, c = probs.shape[-1], capacity
    route = _route(probs, u, k=k, capacity=capacity, normalize=normalize,
                   random2=random2)
    tv, _, _, keep, flat, token_of_slot, _, _ = route
    w = torch.where(keep, tv, 0.0)
    disp = _pad_row(x)[token_of_slot[:e * c]].reshape(e, c, d)
    h1 = torch.bmm(disp, w0) + b0
    a = _moe_act(activation)(h1)
    y = torch.bmm(a, w1) + b1
    yf = _pad_row(y.reshape(e * c, d))
    out = (w[..., None].to(x.dtype) * yf[flat]).sum(dim=1)
    if saved is not None:
        saved.update(route=route, disp=disp, h1=h1, a=a, yf=yf)
    return out


def _moe_idx_ffn_bwd(g, probs, w0, w1, b0, b1, st, *, k, capacity,
                     activation, normalize, random2):
    """The reference's manual backward (``_moe_idx_ffn_vjp``): every
    dispatch and combine adjoint is a gather through the slot maps, the
    expert adjoints are batched products, and no gradient flows through
    the routing integers. Returns (dprobs, dx, dw0, db0, dw1, db1)."""
    tv, raw_tv, top_idx, keep, flat, token_of_slot, j_of_slot, keep2 = \
        st["route"]
    n, d = g.shape
    e, c = probs.shape[-1], capacity
    f32 = torch.float32
    disp, h1, a, yf = st["disp"], st["h1"], st["a"], st["yf"]
    w_comb = torch.where(keep, tv, 0.0)
    tok = token_of_slot[:e * c]

    # combine: d(weights) and dy[slot] = w[token(slot), j(slot)] * g[token]
    d_wcomb = torch.einsum("nkd,nd->nk", yf[flat].to(f32), g.to(f32))
    w_pad = torch.cat([w_comb, w_comb.new_zeros(1, k)])
    w_slot = w_pad[tok, j_of_slot[:e * c]]
    dy = (_pad_row(g)[tok] * w_slot[:, None].to(g.dtype)).reshape(e, c, d)

    # the experts
    dw1 = torch.bmm(a.transpose(1, 2), dy).to(w1.dtype)
    db1 = dy.to(f32).sum(dim=1, keepdim=True).to(b1.dtype)
    da = torch.bmm(dy, w1.transpose(1, 2)).to(a.dtype)
    with torch.enable_grad():
        h = h1.detach().requires_grad_(True)
        (dh1,) = torch.autograd.grad(_moe_act(activation)(h), h, da)
    dw0 = torch.bmm(disp.transpose(1, 2), dh1).to(w0.dtype)
    db0 = dh1.to(f32).sum(dim=1, keepdim=True).to(b0.dtype)
    ddisp = torch.bmm(dh1, w0.transpose(1, 2))

    # dispatch: dx[n] = sum_j keep * ddisp[slot(n, j)]
    dx = (_pad_row(ddisp.reshape(e * c, d))[flat]
          * keep[..., None].to(ddisp.dtype)).sum(dim=1)

    # the gate's probabilities, through the top-k weights
    dtv = d_wcomb * keep.to(f32)
    if normalize:
        ssum = raw_tv.sum(dim=1, keepdim=True)
        s = torch.clamp(ssum, min=1e-9)
        ds = -(dtv * raw_tv).sum(dim=1, keepdim=True) / (s * s)
        draw = dtv / s + torch.where(ssum > 1e-9, ds, 0.0)
    else:
        draw = dtv
    if random2 and k >= 2:
        draw = torch.cat([draw[:, :1],
                          torch.where(keep2, draw[:, 1], 0.0)[:, None],
                          draw[:, 2:]], dim=1)
    dprobs = (_one_hot(top_idx, e, f32) * draw[..., None]).sum(dim=1)
    return (dprobs.to(probs.dtype), dx.to(g.dtype), dw0, db0, dw1, db1)


class _MoeIdxFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, probs, x, w0, b0, w1, b1, u, statics):
        saved = {}
        out = _moe_idx_ffn_fwd(probs, x, w0, b0, w1, b1, u, **statics,
                               saved=saved)
        ctx.statics = statics
        ctx.saved = saved
        ctx.save_for_backward(probs, w0, w1, b0, b1)
        return out

    @staticmethod
    def backward(ctx, g):
        probs, w0, w1, b0, b1 = ctx.saved_tensors
        grads = _moe_idx_ffn_bwd(g.contiguous(), probs, w0, w1, b0, b1,
                                 ctx.saved, **ctx.statics)
        ctx.saved = None
        return (*grads, None, None)


def moe_idx_ffn(probs, x, w0, b0, w1, b1, u=None, *, k, capacity,
                activation, normalize, random2):
    """The index path of ``FusedMoELayer``: probs [N, E] and x [N, d] to
    [N, d], differentiable in probs, x and the bank through the manual
    backward. ``u`` [N] is random routing's uniform draw (with
    ``random2``)."""
    statics = dict(k=k, capacity=capacity, activation=activation,
                   normalize=normalize, random2=random2)
    return _MoeIdxFFN.apply(probs, x, w0, b0, w1, b1, u, statics)
