"""SPMD placement-propagation rules.

Counterpart of ``paddle_tpu/distributed/auto_parallel/spmd_rules.py``
(Paddle's ``phi/infermeta/spmd_rules/``, queried through
``get_spmd_rule``). Each rule takes input ``DistTensorSpec``\\ s and
infers (possibly re-laid-out) input placements and the output
placements, by the reference's einsum-notation approach: map each
tensor dim to a letter, align shardings on matching letters, drop
conflicting or reduced letters. The rules are pure Python over the
port's own placements (``placement.py``), a copy of the reference's.

They are not on the execution path: a ``DTensor`` op propagates its
placements through torch's own rules. They serve planning and checking,
as in the reference. The reference's table from jax primitives to rules
serves its completion pass over a traced program; the port's counterpart
(aten ops to rules) comes with that pass, ROADMAP queue A item 7.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .placement import Partial, Placement, ProcessMesh, Replicate, Shard

__all__ = ["DistTensorSpec", "get_spmd_rule", "register_spmd_rule",
           "SpmdRule"]


class DistTensorSpec:
    """Shape + placements over a mesh (reference:
    auto_parallel/static/dist_tensor_spec.py DistTensorSpec)."""

    def __init__(self, shape: Sequence[int], mesh: ProcessMesh,
                 placements: Sequence[Placement]):
        self.shape = list(shape)
        self.mesh = mesh
        self.placements = list(placements)
        if len(self.placements) != mesh.ndim:
            raise ValueError(
                f"placements rank {len(self.placements)} != mesh rank "
                f"{mesh.ndim}"
            )

    @property
    def ndim(self):
        return len(self.shape)

    def dims_mapping(self) -> List[int]:
        """tensor dim -> mesh dim (or -1), the reference's dims_mapping."""
        mapping = [-1] * self.ndim
        for mesh_dim, pl in enumerate(self.placements):
            if isinstance(pl, Shard) and mapping[pl.dim] == -1:
                mapping[pl.dim] = mesh_dim
        return mapping

    @classmethod
    def from_dims_mapping(cls, shape, mesh, mapping) -> "DistTensorSpec":
        placements: List[Placement] = [Replicate()] * mesh.ndim
        for tdim, mdim in enumerate(mapping):
            if mdim >= 0:
                placements[mdim] = Shard(tdim)
        return cls(shape, mesh, placements)

    def __repr__(self):
        return f"DistTensorSpec(shape={self.shape}, placements={self.placements})"


class SpmdRule:
    def __init__(self, name: str, fn: Callable):
        self.name = name
        self._fn = fn

    def infer_forward(self, *specs, **attrs):
        """Returns (inferred_input_specs, output_specs) — both lists."""
        return self._fn(*specs, **attrs)

    def __repr__(self):
        return f"SpmdRule({self.name})"


_REGISTRY: Dict[str, SpmdRule] = {}


def register_spmd_rule(name: str):
    def deco(fn):
        rule = SpmdRule(name, fn)
        _REGISTRY[name] = rule
        return fn
    return deco


def get_spmd_rule(name: str) -> SpmdRule:
    """Reference: phi/infermeta/spmd_rules/rules.cc registry lookup; falls
    back to the default (replicate-everything) rule like unregistered ops."""
    return _REGISTRY.get(name, _REGISTRY["default"])


# --------------------------------------------------------------- helpers
def _merge_letter_shardings(notations: Sequence[str],
                            specs: Sequence[DistTensorSpec]):
    """Align shardings across inputs by einsum letter. First writer wins;
    conflicting later shardings are dropped (the reference resolves
    conflicts the same way, preferring the earlier operand)."""
    letter_to_mesh_dim: Dict[str, int] = {}
    used_mesh_dims = set()
    for notation, spec in zip(notations, specs):
        mapping = spec.dims_mapping()
        for i, letter in enumerate(notation):
            mdim = mapping[i]
            if mdim < 0 or letter == "1":
                continue
            if letter not in letter_to_mesh_dim and mdim not in used_mesh_dims:
                letter_to_mesh_dim[letter] = mdim
                used_mesh_dims.add(mdim)
    return letter_to_mesh_dim


def _apply_letters(notation: str, shape, mesh, letter_to_mesh_dim,
                   partial_dims: Sequence[int] = ()) -> DistTensorSpec:
    mapping = [-1] * len(notation)
    for i, letter in enumerate(notation):
        if letter in letter_to_mesh_dim:
            mapping[i] = letter_to_mesh_dim[letter]
    spec = DistTensorSpec.from_dims_mapping(shape, mesh, mapping)
    for mdim in partial_dims:
        spec.placements[mdim] = Partial("sum")
    return spec


def _einsum_like(notations_in: Sequence[str], notation_out: str,
                 specs: Sequence[DistTensorSpec],
                 out_shape: Sequence[int]) -> Tuple[list, list]:
    mesh = specs[0].mesh
    letters = _merge_letter_shardings(notations_in, specs)
    new_inputs = [
        _apply_letters(n, s.shape, mesh, letters)
        for n, s in zip(notations_in, specs)
    ]
    # letters contracted away (present in inputs, absent in output) leave
    # the output Partial on their mesh dims
    contracted = {l for n in notations_in for l in n} - set(notation_out)
    partial_dims = [letters[l] for l in contracted if l in letters]
    out = _apply_letters(notation_out, out_shape, mesh, letters, partial_dims)
    return new_inputs, [out]


def _letters(n: int, skip: str = "") -> str:
    alphabet = "abcdefghijklmnopqrstuvwxyz"
    out = "".join(c for c in alphabet if c not in skip)
    return out[:n]


# ----------------------------------------------------------------- rules
@register_spmd_rule("default")
def _default_rule(*specs, **attrs):
    """Replicate everything (unregistered-op fallback)."""
    mesh = specs[0].mesh
    new = [DistTensorSpec(s.shape, mesh, [Replicate()] * mesh.ndim)
           for s in specs]
    return new, []


@register_spmd_rule("matmul")
def _matmul_rule(x: DistTensorSpec, y: DistTensorSpec,
                 trans_x: bool = False, trans_y: bool = False):
    """Reference: spmd_rules/matmul.cc. Batched dims broadcast-align; the
    contracted dim's sharding makes the output Partial on that mesh dim."""
    xs, ys = list(x.shape), list(y.shape)
    if trans_x:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if trans_y:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    nb = max(len(xs), len(ys)) - 2
    batch = _letters(nb, skip="mnk")
    x_nb = len(xs) - 2
    y_nb = len(ys) - 2
    x_not = batch[nb - x_nb:] + "mk"
    y_not = batch[nb - y_nb:] + "kn"
    out_not = batch + "mn"
    if trans_x:
        x_not = x_not[:-2] + x_not[-1] + x_not[-2]
    if trans_y:
        y_not = y_not[:-2] + y_not[-1] + y_not[-2]
    out_shape = [max(a, b) for a, b in
                 zip([1] * (nb - x_nb) + xs[:-2], [1] * (nb - y_nb) + ys[:-2])]
    out_shape += [xs[-2], ys[-1]]
    return _einsum_like([x_not, y_not], out_not, [x, y], out_shape)


@register_spmd_rule("elementwise")
def _elementwise_rule(*specs, **attrs):
    """Reference: spmd_rules/elementwise.cc with numpy broadcasting."""
    mesh = specs[0].mesh
    ndim = max(s.ndim for s in specs)
    out_shape = [1] * ndim
    for s in specs:
        for i, d in enumerate(s.shape):
            j = ndim - s.ndim + i
            out_shape[j] = max(out_shape[j], d)
    base = _letters(ndim)
    notations = []
    for s in specs:
        off = ndim - s.ndim
        # broadcasted (size-1) dims don't propagate sharding: letter "1"
        notation = "".join(
            "1" if s.shape[i] == 1 and out_shape[off + i] != 1
            else base[off + i]
            for i in range(s.ndim)
        )
        notations.append(notation)
    return _einsum_like(notations, base, list(specs), out_shape)


@register_spmd_rule("reduction")
def _reduction_rule(x: DistTensorSpec, axis=None, keepdim: bool = False,
                    **attrs):
    """Reference: spmd_rules/reduction.cc — reduced dims become Partial."""
    mesh = x.mesh
    ndim = x.ndim
    if axis is None:
        axes = list(range(ndim))
    else:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % ndim for a in axes]
    notation = _letters(ndim)
    if keepdim:
        out_not = "".join("1" if i in axes else notation[i]
                          for i in range(ndim))
        out_shape = [1 if i in axes else x.shape[i] for i in range(ndim)]
    else:
        out_not = "".join(notation[i] for i in range(ndim) if i not in axes)
        out_shape = [x.shape[i] for i in range(ndim) if i not in axes]
    letters = _merge_letter_shardings([notation], [x])
    new_in = [_apply_letters(notation, x.shape, mesh, letters)]
    reduced = {notation[i] for i in axes}
    partial_dims = [letters[l] for l in reduced if l in letters]
    out = _apply_letters(out_not, out_shape, mesh, letters, partial_dims)
    return new_in, [out]


@register_spmd_rule("transpose")
def _transpose_rule(x: DistTensorSpec, perm=None, **attrs):
    perm = perm or list(reversed(range(x.ndim)))
    notation = _letters(x.ndim)
    out_not = "".join(notation[p] for p in perm)
    out_shape = [x.shape[p] for p in perm]
    return _einsum_like([notation], out_not, [x], out_shape)


@register_spmd_rule("reshape")
def _reshape_rule(x: DistTensorSpec, shape=None, **attrs):
    """Reference: spmd_rules/reshape.cc (dim-transform analysis). We keep
    shardings on dims whose size is unchanged and aligned from the left;
    anything split/merged falls back to replicated."""
    mesh = x.mesh
    out_shape = list(shape or [])
    neg = [i for i, d in enumerate(out_shape) if d == -1]
    if neg:
        known = 1
        for d in out_shape:
            if d != -1:
                known *= d
        total = 1
        for d in x.shape:
            total *= d
        out_shape[neg[0]] = total // max(known, 1)
    mapping_in = x.dims_mapping()
    mapping_out = [-1] * len(out_shape)
    for i in range(min(x.ndim, len(out_shape))):
        if x.shape[i] == out_shape[i]:
            mapping_out[i] = mapping_in[i]
        else:
            break
    out = DistTensorSpec.from_dims_mapping(out_shape, mesh, mapping_out)
    return [x], [out]


@register_spmd_rule("embedding")
def _embedding_rule(w: DistTensorSpec, ids: DistTensorSpec, **attrs):
    """Reference: spmd_rules/embedding.cc — vocab-sharded weight makes the
    output Partial (masked local lookup + allreduce); ids batch sharding
    propagates to output rows."""
    mesh = w.mesh
    id_not = _letters(ids.ndim, skip="vh")
    w_not = "vh"
    out_not = id_not + "h"
    out_shape = list(ids.shape) + [w.shape[1]]
    return _einsum_like([w_not, id_not], out_not, [w, ids], out_shape)


@register_spmd_rule("layer_norm")
def _layer_norm_rule(x: DistTensorSpec, scale: Optional[DistTensorSpec] = None,
                     bias: Optional[DistTensorSpec] = None,
                     begin_norm_axis: int = -1, **attrs):
    """Reference: spmd_rules/layer_norm.cc — normalized trailing dims must
    be replicated; leading (batch) shardings pass through."""
    mesh = x.mesh
    ax = begin_norm_axis % x.ndim
    mapping = x.dims_mapping()
    for i in range(ax, x.ndim):
        mapping[i] = -1
    out = DistTensorSpec.from_dims_mapping(x.shape, mesh, mapping)
    new_x = DistTensorSpec.from_dims_mapping(x.shape, mesh, mapping)
    mean_shape = x.shape[:ax]
    mean = DistTensorSpec.from_dims_mapping(mean_shape, mesh, mapping[:ax])
    new_inputs = [new_x]
    for aux in (scale, bias):
        if aux is not None:
            new_inputs.append(
                DistTensorSpec(aux.shape, mesh, [Replicate()] * mesh.ndim)
            )
    return new_inputs, [out, mean, mean]


@register_spmd_rule("rms_norm")
def _rms_norm_rule(x: DistTensorSpec, scale: Optional[DistTensorSpec] = None,
                   **attrs):
    new_in, outs = _layer_norm_rule(x, scale, None, begin_norm_axis=-1)
    return new_in, outs[:1]


@register_spmd_rule("softmax")
def _softmax_rule(x: DistTensorSpec, axis: int = -1, **attrs):
    """Softmax axis must be whole; other shardings pass through."""
    mesh = x.mesh
    ax = axis % x.ndim
    mapping = x.dims_mapping()
    mapping[ax] = -1
    spec = DistTensorSpec.from_dims_mapping(x.shape, mesh, mapping)
    return [spec], [DistTensorSpec.from_dims_mapping(x.shape, mesh, mapping)]


@register_spmd_rule("cross_entropy_with_softmax")
def _ce_rule(logits: DistTensorSpec, label: DistTensorSpec, **attrs):
    """Reference: spmd_rules/cross_entropy_with_softmax.cc. Class-dim
    sharding is allowed (ParallelCrossEntropy) → loss Partial; otherwise
    batch shardings pass through."""
    mesh = logits.mesh
    mapping = logits.dims_mapping()
    class_mesh_dim = mapping[-1]
    batch_mapping = mapping[:-1]
    loss_shape = logits.shape[:-1] + [1]
    loss = DistTensorSpec.from_dims_mapping(
        loss_shape, mesh, batch_mapping + [-1]
    )
    if class_mesh_dim >= 0:
        loss.placements[class_mesh_dim] = Partial("sum")
    softmax_out = DistTensorSpec.from_dims_mapping(
        logits.shape, mesh, mapping
    )
    return [logits, label], [softmax_out, loss]


@register_spmd_rule("flash_attention")
def _flash_attention_rule(q: DistTensorSpec, k: DistTensorSpec,
                          v: DistTensorSpec, **attrs):
    """Reference: spmd_rules/flash_attention.cc — shard batch and heads;
    seq/head_dim replicated (ring attention handles seq sharding)."""
    mesh = q.mesh
    # dims: (batch, seq, heads, head_dim)
    mq = q.dims_mapping()
    mk = k.dims_mapping()
    batch = mq[0] if mq[0] >= 0 else mk[0]
    heads = mq[2] if mq[2] >= 0 else mk[2]
    used = set()
    mapping = [-1, -1, -1, -1]
    if batch >= 0:
        mapping[0] = batch
        used.add(batch)
    if heads >= 0 and heads not in used:
        mapping[2] = heads
    new = [DistTensorSpec.from_dims_mapping(s.shape, mesh, mapping)
           for s in (q, k, v)]
    out = DistTensorSpec.from_dims_mapping(q.shape, mesh, mapping)
    return new, [out]


@register_spmd_rule("concat")
def _concat_rule(*specs, axis: int = 0, **attrs):
    mesh = specs[0].mesh
    ndim = specs[0].ndim
    ax = axis % ndim
    notation = _letters(ndim)
    notation = notation[:ax] + "1" + notation[ax + 1:]
    out_shape = list(specs[0].shape)
    out_shape[ax] = sum(s.shape[ax] for s in specs)
    return _einsum_like([notation] * len(specs), notation, list(specs),
                        out_shape)


@register_spmd_rule("split")
def _split_rule(x: DistTensorSpec, num_or_sections=2, axis: int = 0, **attrs):
    mesh = x.mesh
    ax = axis % x.ndim
    mapping = x.dims_mapping()
    mapping[ax] = -1
    n = num_or_sections if isinstance(num_or_sections, int) \
        else len(num_or_sections)
    sizes = [x.shape[ax] // n] * n if isinstance(num_or_sections, int) \
        else list(num_or_sections)
    outs = []
    for s in sizes:
        shape = list(x.shape)
        shape[ax] = s
        outs.append(DistTensorSpec.from_dims_mapping(shape, mesh, mapping))
    return [DistTensorSpec.from_dims_mapping(x.shape, mesh, mapping)], outs


# ------------------------------------------------- pass-through & unary
def _passthrough(x: DistTensorSpec) -> Tuple[list, list]:
    spec = DistTensorSpec.from_dims_mapping(x.shape, x.mesh,
                                            x.dims_mapping())
    return [spec], [DistTensorSpec.from_dims_mapping(
        x.shape, x.mesh, x.dims_mapping())]


@register_spmd_rule("cast")
def _cast_rule(x: DistTensorSpec, dtype=None, **attrs):
    """Reference: spmd_rules/cast.cc — layout-preserving."""
    return _passthrough(x)


@register_spmd_rule("scale")
def _scale_rule(x: DistTensorSpec, scale=1.0, bias=0.0, **attrs):
    """Reference: spmd_rules/scale.cc — layout-preserving."""
    return _passthrough(x)


@register_spmd_rule("pow")
def _pow_rule(x: DistTensorSpec, factor=1.0, **attrs):
    """Reference: spmd_rules/pow.cc — layout-preserving."""
    return _passthrough(x)


@register_spmd_rule("full_like")
def _full_like_rule(x: DistTensorSpec, value=0.0, **attrs):
    """Reference: spmd_rules/full_like.cc — output mirrors input layout
    (a fill needs no data movement under any sharding)."""
    return _passthrough(x)


@register_spmd_rule("triu")
def _triu_rule(x: DistTensorSpec, diagonal: int = 0, **attrs):
    """Reference: spmd_rules/triu.cc — the masked last two dims stay
    replicated (the mask needs global row/col indices); batch dims pass."""
    mapping = x.dims_mapping()
    for i in (x.ndim - 2, x.ndim - 1):
        mapping[i] = -1
    spec = DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)
    return [spec], [DistTensorSpec.from_dims_mapping(x.shape, x.mesh,
                                                     mapping)]


@register_spmd_rule("flip")
def _flip_rule(x: DistTensorSpec, axis=(), **attrs):
    """Flipped axes must be whole (a local flip would reverse only the
    shard); others pass through."""
    axes = [axis] if isinstance(axis, int) else list(axis)
    mapping = x.dims_mapping()
    for a in axes:
        mapping[a % x.ndim] = -1
    spec = DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)
    return [spec], [DistTensorSpec.from_dims_mapping(x.shape, x.mesh,
                                                     mapping)]


# ------------------------------------------------ dim-transform family
@register_spmd_rule("squeeze")
def _squeeze_rule(x: DistTensorSpec, axis=None, **attrs):
    """Reference: spmd_rules/squeeze.cc (dim_trans) — dropped size-1 dims
    carry no sharding; surviving dims keep theirs."""
    if axis is None:
        drop = [i for i, d in enumerate(x.shape) if d == 1]
    else:
        axes = [axis] if isinstance(axis, int) else list(axis)
        drop = sorted(a % x.ndim for a in axes if x.shape[a % x.ndim] == 1)
    mapping = x.dims_mapping()
    out_shape = [d for i, d in enumerate(x.shape) if i not in drop]
    out_mapping = [m for i, m in enumerate(mapping) if i not in drop]
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, out_mapping)
    return [DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)], [out]


@register_spmd_rule("unsqueeze")
def _unsqueeze_rule(x: DistTensorSpec, axis=0, **attrs):
    """Reference: spmd_rules/unsqueeze.cc — inserted size-1 dims are
    replicated; existing dims keep their sharding."""
    axes = [axis] if isinstance(axis, int) else list(axis)
    out_ndim = x.ndim + len(axes)
    axes = sorted(a % out_ndim for a in axes)
    mapping = x.dims_mapping()
    out_shape, out_mapping, src = [], [], 0
    for i in range(out_ndim):
        if i in axes:
            out_shape.append(1)
            out_mapping.append(-1)
        else:
            out_shape.append(x.shape[src])
            out_mapping.append(mapping[src])
            src += 1
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, out_mapping)
    return [DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)], [out]


@register_spmd_rule("flatten")
def _flatten_rule(x: DistTensorSpec, start_axis: int = 0,
                  stop_axis: int = -1, **attrs):
    """Reference: spmd_rules/flatten.cc — the merged range keeps the
    FIRST merged dim's sharding (a [s, ...] merge stays contiguous per
    shard); outside dims pass through."""
    a = start_axis % x.ndim
    b = stop_axis % x.ndim
    mapping = x.dims_mapping()
    merged = 1
    for d in x.shape[a:b + 1]:
        merged *= d
    out_shape = x.shape[:a] + [merged] + x.shape[b + 1:]
    out_mapping = mapping[:a] + [mapping[a]] + mapping[b + 1:]
    new_in_mapping = list(mapping)
    for i in range(a + 1, b + 1):
        new_in_mapping[i] = -1  # only the leading merged dim may shard
    new_in = DistTensorSpec.from_dims_mapping(x.shape, x.mesh,
                                              new_in_mapping)
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, out_mapping)
    return [new_in], [out]


@register_spmd_rule("tile")
def _tile_rule(x: DistTensorSpec, repeat_times=(), **attrs):
    """Reference: spmd_rules/tile.cc — tiled (repeat > 1) dims must be
    whole; untouched dims keep their sharding."""
    reps = list(repeat_times)
    out_ndim = max(x.ndim, len(reps))
    reps = [1] * (out_ndim - len(reps)) + reps
    in_off = out_ndim - x.ndim
    mapping = x.dims_mapping()
    new_in_mapping = list(mapping)
    out_shape, out_mapping = [], []
    for i in range(out_ndim):
        src = i - in_off
        size = x.shape[src] if src >= 0 else 1
        if reps[i] != 1:
            if src >= 0:
                new_in_mapping[src] = -1
            out_shape.append(size * reps[i])
            out_mapping.append(-1)
        else:
            out_shape.append(size)
            out_mapping.append(mapping[src] if src >= 0 else -1)
    new_in = DistTensorSpec.from_dims_mapping(x.shape, x.mesh,
                                              new_in_mapping)
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, out_mapping)
    return [new_in], [out]


@register_spmd_rule("expand_as")
def _expand_as_rule(x: DistTensorSpec, y: DistTensorSpec = None,
                    target_shape=None, **attrs):
    """Reference: spmd_rules/expand_as.cc — broadcasted dims replicated;
    matching dims take x's sharding (or y's where x is size-1)."""
    out_shape = list(y.shape) if y is not None else list(target_shape)
    off = len(out_shape) - x.ndim
    mapping = x.dims_mapping()
    y_map = y.dims_mapping() if y is not None else [-1] * len(out_shape)
    out_mapping = []
    for i, d in enumerate(out_shape):
        src = i - off
        if src >= 0 and x.shape[src] == d:
            out_mapping.append(mapping[src])
        else:
            out_mapping.append(y_map[i] if y is not None else -1)
    # one mesh dim may not shard two tensor dims: first writer wins
    # (matching _merge_letter_shardings' conflict rule)
    seen = set()
    for i, m in enumerate(out_mapping):
        if m >= 0 and m in seen:
            out_mapping[i] = -1
        elif m >= 0:
            seen.add(m)
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, out_mapping)
    new_in = [DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)]
    if y is not None:
        new_in.append(DistTensorSpec.from_dims_mapping(y.shape, y.mesh,
                                                       y.dims_mapping()))
    return new_in, [out]


@register_spmd_rule("slice")
def _slice_rule(x: DistTensorSpec, axes=(), starts=(), ends=(), **attrs):
    """Reference: spmd_rules/slice.cc — sliced dims must be whole (a
    local slice would cut every shard); untouched dims pass through."""
    mapping = x.dims_mapping()
    out_shape = list(x.shape)
    for a, s, e in zip(axes, starts, ends):
        a = a % x.ndim
        mapping[a] = -1
        lo = s % x.shape[a] if s < 0 else min(s, x.shape[a])
        hi = e % x.shape[a] if e < 0 else min(e, x.shape[a])
        out_shape[a] = max(hi - lo, 0)
    new_in = DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, mapping)
    return [new_in], [out]


@register_spmd_rule("stack")
def _stack_rule(*specs, axis: int = 0, **attrs):
    """Reference: spmd_rules/stack.cc — inputs align; the new axis is
    replicated."""
    mesh = specs[0].mesh
    ndim = specs[0].ndim
    notation = _letters(ndim)
    letters = _merge_letter_shardings([notation] * len(specs), list(specs))
    new_in = [_apply_letters(notation, s.shape, mesh, letters)
              for s in specs]
    ax = axis % (ndim + 1)
    out_not = notation[:ax] + "1" + notation[ax:]
    out_shape = list(specs[0].shape)
    out_shape.insert(ax, len(specs))
    out = _apply_letters(out_not, out_shape, mesh, letters)
    return new_in, [out]


@register_spmd_rule("unbind")
def _unbind_rule(x: DistTensorSpec, axis: int = 0, **attrs):
    """Reference: spmd_rules/unbind.cc — the unbound axis must be whole;
    each output drops it."""
    ax = axis % x.ndim
    mapping = x.dims_mapping()
    mapping[ax] = -1
    out_shape = [d for i, d in enumerate(x.shape) if i != ax]
    out_mapping = [m for i, m in enumerate(mapping) if i != ax]
    outs = [DistTensorSpec.from_dims_mapping(out_shape, x.mesh, out_mapping)
            for _ in range(x.shape[ax])]
    return [DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)], outs


# ------------------------------------------------- scan / index family
@register_spmd_rule("cumsum")
def _cumsum_rule(x: DistTensorSpec, axis=None, flatten: bool = False,
                 **attrs):
    """Reference: spmd_rules/cumsum.cc — the scan axis must be whole
    (prefix sums need the full axis); flatten mode replicates all."""
    mapping = x.dims_mapping()
    if flatten or axis is None:
        mapping = [-1] * x.ndim
    else:
        mapping[axis % x.ndim] = -1
    spec = DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)
    return [spec], [DistTensorSpec.from_dims_mapping(x.shape, x.mesh,
                                                     mapping)]


@register_spmd_rule("argmax")
def _argmax_rule(x: DistTensorSpec, axis: int = -1, keepdim: bool = False,
                 **attrs):
    """Reference: spmd_rules/argmax.cc — the reduced axis must be whole
    (local argmax yields local indices); other dims pass through."""
    ax = axis % x.ndim
    mapping = x.dims_mapping()
    mapping[ax] = -1
    new_in = DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)
    if keepdim:
        out_shape = [1 if i == ax else d for i, d in enumerate(x.shape)]
        out_mapping = list(mapping)
        out_mapping[ax] = -1
    else:
        out_shape = [d for i, d in enumerate(x.shape) if i != ax]
        out_mapping = [m for i, m in enumerate(mapping) if i != ax]
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, out_mapping)
    return [new_in], [out]


@register_spmd_rule("topk")
def _topk_rule(x: DistTensorSpec, k: int = 1, axis: int = -1, **attrs):
    """topk along a sharded axis would return shard-local winners: the
    axis must be whole. values and indices share the layout."""
    ax = axis % x.ndim
    mapping = x.dims_mapping()
    mapping[ax] = -1
    out_shape = list(x.shape)
    out_shape[ax] = k
    new_in = DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, mapping)
    idx = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, mapping)
    return [new_in], [out, idx]


@register_spmd_rule("gather")
def _gather_rule(x: DistTensorSpec, index: DistTensorSpec, axis: int = 0,
                 **attrs):
    """Reference: spmd_rules/gather.cc — the gathered axis of x must be
    whole; the index's sharding lands on the output's axis position."""
    ax = axis % x.ndim
    x_map = x.dims_mapping()
    x_map[ax] = -1
    idx_map = index.dims_mapping()
    out_shape = x.shape[:ax] + list(index.shape) + x.shape[ax + 1:]
    out_mapping = x_map[:ax] + idx_map + x_map[ax + 1:]
    # one mesh dim may not shard two tensor dims
    seen = set()
    for i, m in enumerate(out_mapping):
        if m >= 0 and m in seen:
            out_mapping[i] = -1
        elif m >= 0:
            seen.add(m)
    new_x = DistTensorSpec.from_dims_mapping(x.shape, x.mesh, x_map)
    new_idx = DistTensorSpec.from_dims_mapping(index.shape, x.mesh, idx_map)
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh, out_mapping)
    return [new_x, new_idx], [out]


@register_spmd_rule("gather_nd")
def _gather_nd_rule(x: DistTensorSpec, index: DistTensorSpec, **attrs):
    """Reference: spmd_rules/gather_nd.cc — x replicated (arbitrary
    addressing), index batch dims pass to the output."""
    mesh = x.mesh
    new_x = DistTensorSpec(x.shape, mesh, [Replicate()] * mesh.ndim)
    idx_map = index.dims_mapping()
    k = index.shape[-1]
    out_shape = index.shape[:-1] + x.shape[k:]
    out_mapping = idx_map[:-1] + [-1] * (x.ndim - k)
    new_idx = DistTensorSpec.from_dims_mapping(index.shape, mesh, idx_map)
    out = DistTensorSpec.from_dims_mapping(out_shape, mesh, out_mapping)
    return [new_x, new_idx], [out]


@register_spmd_rule("take_along_axis")
def _take_along_axis_rule(x: DistTensorSpec, index: DistTensorSpec,
                          axis: int = 0, **attrs):
    """x and index align on non-axis dims; the axis must be whole."""
    ax = axis % x.ndim
    notation = _letters(x.ndim)
    x_not = notation[:ax] + "1" + notation[ax + 1:]
    letters = _merge_letter_shardings([x_not, x_not], [x, index])
    new_x = _apply_letters(x_not, x.shape, x.mesh, letters)
    new_idx = _apply_letters(x_not, index.shape, x.mesh, letters)
    out = _apply_letters(x_not, index.shape, x.mesh, letters)
    return [new_x, new_idx], [out]


@register_spmd_rule("scatter")
def _scatter_rule(x: DistTensorSpec, index: DistTensorSpec,
                  updates: DistTensorSpec, overwrite: bool = True, **attrs):
    """Reference: spmd_rules/scatter.cc — the scattered dim 0 must be
    whole; trailing dims align between x and updates."""
    notation = _letters(x.ndim)
    x_not = "1" + notation[1:x.ndim]
    u_not = "1" + notation[1:updates.ndim]
    letters = _merge_letter_shardings([x_not, u_not], [x, updates])
    new_x = _apply_letters(x_not, x.shape, x.mesh, letters)
    new_u = _apply_letters(u_not, updates.shape, x.mesh, letters)
    new_idx = DistTensorSpec(index.shape, x.mesh,
                             [Replicate()] * x.mesh.ndim)
    out = _apply_letters(x_not, x.shape, x.mesh, letters)
    return [new_x, new_idx, new_u], [out]


@register_spmd_rule("one_hot")
def _one_hot_rule(x: DistTensorSpec, num_classes: int = 1, **attrs):
    """Reference: spmd_rules/one_hot.cc — input layout passes through;
    the new class dim is replicated."""
    mapping = x.dims_mapping()
    out_shape = list(x.shape) + [num_classes]
    out = DistTensorSpec.from_dims_mapping(out_shape, x.mesh,
                                           mapping + [-1])
    return [DistTensorSpec.from_dims_mapping(x.shape, x.mesh,
                                             mapping)], [out]


@register_spmd_rule("where")
def _where_rule(cond: DistTensorSpec, x: DistTensorSpec, y: DistTensorSpec,
                **attrs):
    """Reference: spmd_rules/where.cc — ternary elementwise broadcast."""
    return _elementwise_rule(cond, x, y)


@register_spmd_rule("add_n")
def _add_n_rule(*specs, **attrs):
    """Reference: spmd_rules/add_n.cc — n-ary elementwise sum."""
    return _elementwise_rule(*specs)


# --------------------------------------------- scalar-output reductions
@register_spmd_rule("numel")
def _numel_rule(x: DistTensorSpec, **attrs):
    """Reference: spmd_rules/numel.cc — metadata-only scalar, replicated
    output regardless of input sharding."""
    mesh = x.mesh
    new_x = DistTensorSpec.from_dims_mapping(x.shape, mesh,
                                             x.dims_mapping())
    out = DistTensorSpec([], mesh, [Replicate()] * mesh.ndim)
    return [new_x], [out]


@register_spmd_rule("squared_l2_norm")
def _squared_l2_norm_rule(x: DistTensorSpec, **attrs):
    """Reference: spmd_rules/squared_l2_norm.cc — keeps the input
    sharding; the scalar is Partial over every sharded mesh dim (the
    grad-clip global-norm pattern)."""
    mesh = x.mesh
    mapping = x.dims_mapping()
    new_x = DistTensorSpec.from_dims_mapping(x.shape, mesh, mapping)
    out = DistTensorSpec([], mesh, [Replicate()] * mesh.ndim)
    for mdim in {m for m in mapping if m >= 0}:
        out.placements[mdim] = Partial("sum")
    return [new_x], [out]


# ------------------------------------------------------- fused kernels
@register_spmd_rule("swiglu")
def _swiglu_rule(x: DistTensorSpec, y: Optional[DistTensorSpec] = None,
                 **attrs):
    """Reference: spmd_rules/swiglu.cc — elementwise over (gate, up)."""
    if y is None:
        return _passthrough(x)
    return _elementwise_rule(x, y)


@register_spmd_rule("fused_rope")
def _fused_rope_rule(q: DistTensorSpec, k: Optional[DistTensorSpec] = None,
                     v: Optional[DistTensorSpec] = None, **attrs):
    """Reference: spmd_rules/fused_rope.cc — [B, S, H, D] layout: batch
    and head dims may shard; seq (position lookup) and head_dim (the
    rotated pairs) stay whole. q/k/v align batch/head mesh dims."""
    specs = [s for s in (q, k, v) if s is not None]
    mesh = q.mesh
    notation = "b1h1"
    letters = _merge_letter_shardings([notation] * len(specs), specs)
    new_in = [_apply_letters(notation, s.shape, mesh, letters)
              for s in specs]
    outs = [_apply_letters(notation, s.shape, mesh, letters)
            for s in specs]
    return new_in, outs


@register_spmd_rule("fused_linear_param_grad_add")
def _fused_linear_param_grad_add_rule(
        x: DistTensorSpec, dout: DistTensorSpec,
        dweight: Optional[DistTensorSpec] = None,
        dbias: Optional[DistTensorSpec] = None, **attrs):
    """Reference: spmd_rules/fused_linear_param_grad_add.cc —
    dweight = x^T @ dout contracts every batch/token dim: sharded batch
    dims make the grads Partial; feature dims pass through."""
    mesh = x.mesh
    nb = x.ndim - 1
    batch = _letters(nb, skip="kn")
    x_not = batch + "k"
    d_not = batch + "n"
    letters = _merge_letter_shardings([x_not, d_not], [x, dout])
    new_x = _apply_letters(x_not, x.shape, mesh, letters)
    new_d = _apply_letters(d_not, dout.shape, mesh, letters)
    partial_dims = [letters[l] for l in batch if l in letters]
    w_shape = [x.shape[-1], dout.shape[-1]]
    dw = _apply_letters("kn", w_shape, mesh, letters, partial_dims)
    db = _apply_letters("n", [dout.shape[-1]], mesh, letters, partial_dims)
    return [new_x, new_d], [dw, db]


# ---------------------------------------------------- optimizer family
def _optimizer_align(param: DistTensorSpec, grad: DistTensorSpec,
                     *moments: DistTensorSpec):
    """Shared layout logic (reference: spmd_rules/optimizer.cc): param,
    grad, and every moment adopt ONE common sharding (first-writer-wins
    merge across them); scalars (lr, beta_pow) are replicated; updated
    outputs mirror it. A Partial grad must be reduced before the update —
    the inferred grad layout is therefore the merged Shard layout."""
    mesh = param.mesh
    notation = _letters(param.ndim)
    specs = [param, grad] + [m for m in moments if m is not None]
    letters = _merge_letter_shardings([notation] * len(specs), specs)
    aligned = _apply_letters(notation, param.shape, mesh, letters)

    def like():
        return DistTensorSpec(param.shape, mesh, list(aligned.placements))

    return like


@register_spmd_rule("sgd")
def _sgd_rule(param: DistTensorSpec, grad: DistTensorSpec,
              learning_rate: Optional[DistTensorSpec] = None, **attrs):
    like = _optimizer_align(param, grad)
    mesh = param.mesh
    new_in = [like(), like()]
    if learning_rate is not None:
        new_in.append(DistTensorSpec(learning_rate.shape, mesh,
                                     [Replicate()] * mesh.ndim))
    return new_in, [like()]


@register_spmd_rule("momentum")
def _momentum_rule(param: DistTensorSpec, grad: DistTensorSpec,
                   velocity: DistTensorSpec = None, **attrs):
    like = _optimizer_align(param, grad, velocity)
    return [like(), like(), like()], [like(), like()]


@register_spmd_rule("adam")
def _adam_rule(param: DistTensorSpec, grad: DistTensorSpec,
               moment1: DistTensorSpec = None,
               moment2: DistTensorSpec = None,
               master_param: Optional[DistTensorSpec] = None, **attrs):
    """Reference: optimizer.cc AdamInferSpmdDynamic — param/grad/moments/
    master share one layout; outputs (param, m1, m2, master) mirror it."""
    like = _optimizer_align(param, grad, moment1, moment2, master_param)
    n_in = 4 + (1 if master_param is not None else 0)
    n_out = 3 + (1 if master_param is not None else 0)
    return [like() for _ in range(n_in)], [like() for _ in range(n_out)]


@register_spmd_rule("adamw")
def _adamw_rule(param: DistTensorSpec, grad: DistTensorSpec,
                moment1: DistTensorSpec = None,
                moment2: DistTensorSpec = None,
                master_param: Optional[DistTensorSpec] = None, **attrs):
    """Reference: optimizer.cc AdamwInferSpmdDynamic (decoupled decay
    shares Adam's layout logic)."""
    return _adam_rule(param, grad, moment1, moment2, master_param)


# ------------------------------------------------------- amp / utility
@register_spmd_rule("check_finite_and_unscale")
def _check_finite_rule(*specs, **attrs):
    """Reference: spmd_rules/amp_ops.cc — every param keeps its layout;
    found_inf is a replicated scalar (an all-reduce OR under the hood)."""
    mesh = specs[0].mesh
    new_in = [DistTensorSpec.from_dims_mapping(s.shape, mesh,
                                               s.dims_mapping())
              for s in specs]
    outs = [DistTensorSpec.from_dims_mapping(s.shape, mesh,
                                             s.dims_mapping())
            for s in specs]
    outs.append(DistTensorSpec([], mesh, [Replicate()] * mesh.ndim))
    return new_in, outs


@register_spmd_rule("replicated")
def _replicated_rule(*specs, **attrs):
    """Reference: spmd_rules/replicated.cc — force-replicate in and out."""
    mesh = specs[0].mesh
    new = [DistTensorSpec(s.shape, mesh, [Replicate()] * mesh.ndim)
           for s in specs]
    outs = [DistTensorSpec(s.shape, mesh, [Replicate()] * mesh.ndim)
            for s in specs]
    return new, outs


@register_spmd_rule("conv2d")
def _conv2d_rule(x: DistTensorSpec, w: DistTensorSpec, **attrs):
    """Conv [N, C, H, W] x [O, I, kh, kw]: batch and out-channel dims may
    shard; in-channels contract (Partial); spatial dims stay whole (halo
    exchange is GSPMD's job, not a layout choice). The reference routes
    conv through replicated/default — this rule keeps the data-parallel
    and channel-parallel layouts instead of dropping them."""
    mesh = x.mesh
    xm, wm = x.dims_mapping(), w.dims_mapping()
    used = set()
    n_dim = xm[0] if xm[0] >= 0 else -1
    if n_dim >= 0:
        used.add(n_dim)
    c_dim = xm[1] if xm[1] >= 0 and xm[1] not in used else -1
    if c_dim >= 0:
        used.add(c_dim)
    o_dim = wm[0] if wm[0] >= 0 and wm[0] not in used else -1
    new_x = DistTensorSpec.from_dims_mapping(
        x.shape, mesh, [n_dim, c_dim] + [-1] * (x.ndim - 2))
    new_w = DistTensorSpec.from_dims_mapping(
        w.shape, mesh, [o_dim, c_dim] + [-1] * (w.ndim - 2))
    # spatial extents: caller may pass the true output via out_shape; the
    # default (stride-1 same-padding) preserves the input's spatial dims
    spatial = list(attrs.get("out_shape", x.shape[2:]))
    out_shape = [x.shape[0], w.shape[0]] + spatial
    out = DistTensorSpec.from_dims_mapping(
        out_shape, mesh, [n_dim, o_dim] + [-1] * len(spatial))
    if c_dim >= 0:
        out.placements[c_dim] = Partial("sum")
    return [new_x, new_w], [out]


@register_spmd_rule("pad")
def _pad_rule(x: DistTensorSpec, paddings=(), **attrs):
    """Padded dims must be whole (edge shards would pad interior
    boundaries); untouched dims pass through."""
    mapping = x.dims_mapping()
    pads = list(paddings)
    if pads and not isinstance(pads[0], (list, tuple)):
        pads = [(pads[i], pads[i + 1]) for i in range(0, len(pads), 2)]
    for i, (lo, hi) in enumerate(pads[:x.ndim]):
        if lo or hi:
            mapping[i] = -1
    spec = DistTensorSpec.from_dims_mapping(x.shape, x.mesh, mapping)
    return [spec], [DistTensorSpec.from_dims_mapping(x.shape, x.mesh,
                                                     mapping)]


@register_spmd_rule("default_data_parallel")
def _default_data_parallel_rule(*specs, **attrs):
    """Reference: spmd_rules/default_data_parallel.cc — shard every
    tensor's dim 0 on the mesh dim the first batch-sharded input uses;
    everything else replicated."""
    mesh = specs[0].mesh
    batch_mdim = -1
    for s in specs:
        m = s.dims_mapping()
        if m and m[0] >= 0:
            batch_mdim = m[0]
            break
    new = []
    for s in specs:
        mapping = [-1] * s.ndim
        if s.ndim and batch_mdim >= 0:
            mapping[0] = batch_mdim
        new.append(DistTensorSpec.from_dims_mapping(s.shape, mesh, mapping))
    return new, [DistTensorSpec(s.shape, mesh, list(n.placements))
                 for s, n in zip(specs, new)]
