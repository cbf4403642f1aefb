"""The port's placements, ``ProcessMesh``, spec conversions, SPMD rules and
``Strategy`` against the reference's, in one process with no process
group (paddle_tpu_torch/distributed/auto_parallel/{placement,
spmd_rules,strategy}.py).

Every case of ``tests/test_spmd_rules.py`` and of
``tests/test_auto_parallel.py::TestSpmdRules`` runs through both
packages' rules (``RULE_CASES``): the inferred input and output specs,
shapes and placements, must be equal; so must the registry and its
default rule. The reference's primitive-coverage test belongs to its
completion pass, whose port waits for ROADMAP queue A item 7. The mp-2
runs are in test_torch_tensor_parallel.py.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.auto_parallel import placement as jpl
from paddle_tpu.distributed.auto_parallel import spmd_rules as jrules
from paddle_tpu.distributed.auto_parallel.strategy import Strategy as JStrategy

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed.auto_parallel import placement as tpl
from paddle_tpu_torch.distributed.auto_parallel import spmd_rules as trules
from paddle_tpu_torch.distributed.auto_parallel.strategy import \
    Strategy as TStrategy

PKGS = {"ref": (jpl, jrules), "port": (tpl, trules)}


def _placements(pl, spec):
    out = []
    for p in spec:
        if p == "R":
            out.append(pl.Replicate())
        elif p == "P":
            out.append(pl.Partial())
        else:
            out.append(pl.Shard(int(p[1:])))
    return out


def _key(placements):
    out = []
    for p in placements:
        if p.is_partial():
            out.append(("P", p.reduce_type))
        elif p.is_shard():
            out.append(("S", p.dim))
        else:
            out.append(("R",))
    return tuple(out)


def _run_rule(pkg, mesh_shape, rule, specs, attrs):
    pl, rules = PKGS[pkg]
    n = int(np.prod(mesh_shape))
    mesh = pl.ProcessMesh(np.arange(n).reshape(mesh_shape), ["dp", "mp"])
    ins = [rules.DistTensorSpec(shape, mesh, _placements(pl, p))
           for shape, p in specs]
    new_in, outs = rules.get_spmd_rule(rule).infer_forward(*ins, **attrs)
    return ([(list(s.shape), _key(s.placements)) for s in new_in],
            [(list(s.shape), _key(s.placements)) for s in outs])


M24, M22 = (2, 4), (2, 2)
#: (id, mesh shape, rule, [(shape, placements per mesh dim)], attrs): the
#: cases of test_auto_parallel.py::TestSpmdRules (mesh 2 x 4) and of
#: test_spmd_rules.py (mesh 2 x 2)
RULE_CASES = [
    ("matmul_contracted_dim_partial", M24, "matmul",
     [([8, 16], "R S1"), ([16, 32], "R S0")], {}),
    ("matmul_row_col", M24, "matmul",
     [([8, 16], "S0 R"), ([16, 32], "R S1")], {}),
    ("elementwise_broadcast", M24, "elementwise",
     [([8, 1, 32], "S0 R"), ([32], "R R")], {}),
    ("reduction_partial", M24, "reduction", [([8, 32], "S0 S1")],
     {"axis": 1}),
    ("reduction_keepdim", M24, "reduction", [([8, 32], "S0 R")],
     {"axis": 1, "keepdim": True}),
    ("layer_norm_frees_normalized_dims", M24, "layer_norm",
     [([8, 16, 64], "S0 S2")], {"begin_norm_axis": 2}),
    ("embedding_vocab_parallel", M24, "embedding",
     [([1000, 64], "R S0"), ([8, 16], "S0 R")], {}),
    ("transpose", M24, "transpose", [([8, 16, 32], "S0 S2")],
     {"perm": [2, 0, 1]}),
    ("flash_attention", M24, "flash_attention",
     [([4, 128, 8, 64], "S0 S2")] * 3, {}),
    ("default_rule_for_unknown_op", M24, "totally_unknown_op",
     [([8], "S0 R")], {}),
    ("cross_entropy_class_parallel", M24, "cross_entropy_with_softmax",
     [([8, 1000], "S0 S1"), ([8, 1], "S0 R")], {}),
    ("squeeze", M22, "squeeze", [([8, 1, 32], "S0 S2")], {"axis": 1}),
    ("unsqueeze", M22, "unsqueeze", [([8, 32], "S0 S1")], {"axis": 1}),
    ("flatten", M22, "flatten", [([8, 4, 32], "S0 R")],
     {"start_axis": 0, "stop_axis": 1}),
    ("tile", M22, "tile", [([8, 32], "S0 S1")], {"repeat_times": [1, 3]}),
    ("stack", M22, "stack", [([8, 32], "S0 R")] * 2, {"axis": 0}),
    ("unbind", M22, "unbind", [([4, 8, 32], "S1 S0")], {"axis": 0}),
    ("flip", M22, "flip", [([8, 32], "S0 S1")], {"axis": 1}),
    ("slice", M22, "slice", [([8, 32], "S0 S1")],
     {"axes": [1], "starts": [0], "ends": [16]}),
    ("cumsum", M22, "cumsum", [([8, 32], "S0 S1")], {"axis": 1}),
    ("argmax", M22, "argmax", [([8, 32], "S0 S1")], {"axis": 1}),
    ("topk", M22, "topk", [([8, 32], "S0 S1")], {"k": 4, "axis": -1}),
    ("gather", M22, "gather", [([100, 64], "R S0"), ([8], "S0 R")],
     {"axis": 0}),
    ("take_along_axis", M22, "take_along_axis",
     [([8, 32], "S0 R"), ([8, 4], "R R")], {"axis": 1}),
    ("scatter", M22, "scatter",
     [([100, 64], "S0 S1"), ([8], "R R"), ([8, 64], "R R")], {}),
    ("one_hot", M22, "one_hot", [([8, 16], "S0 R")], {"num_classes": 10}),
    ("fused_rope", M22, "fused_rope",
     [([4, 128, 8, 64], "S0 S2"), ([4, 128, 8, 64], "R R")], {}),
    ("swiglu", M22, "swiglu", [([8, 1024], "S0 S1"), ([8, 1024], "R R")],
     {}),
    ("fused_linear_param_grad_add", M22, "fused_linear_param_grad_add",
     [([8, 16, 64], "S0 R"), ([8, 16, 128], "S0 S2")], {}),
    ("adam", M22, "adam", [([1024, 64], "R S0")] + [([1024, 64], "R R")] * 3,
     {}),
    ("adamw", M22, "adamw",
     [([1024, 64], "R S0")] + [([1024, 64], "R R")] * 3, {}),
    ("sgd", M22, "sgd", [([1024], "S0 R"), ([1024], "R R")], {}),
    ("momentum", M22, "momentum",
     [([1024], "S0 R"), ([1024], "R R"), ([1024], "R R")], {}),
    ("check_finite_and_unscale", M22, "check_finite_and_unscale",
     [([64, 64], "S0 R"), ([128], "R R")], {}),
    ("squared_l2_norm", M22, "squared_l2_norm", [([1024, 64], "S0 S1")], {}),
    ("conv2d", M22, "conv2d",
     [([32, 64, 28, 28], "S0 S1"), ([128, 64, 3, 3], "R R")], {}),
]


@pytest.mark.parametrize("case", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_spmd_rules_equal_the_reference(case):
    _, mesh_shape, rule, specs, attrs = case
    specs = [(shape, p.split()) for shape, p in specs]
    want = _run_rule("ref", mesh_shape, rule, specs, attrs)
    got = _run_rule("port", mesh_shape, rule, specs, attrs)
    assert got == want


def test_every_reference_rule_is_registered():
    assert sorted(trules._REGISTRY) == sorted(jrules._REGISTRY)


def test_register_and_default_rule_as_the_reference():
    """``register_spmd_rule`` adds a rule that ``get_spmd_rule`` returns
    by name, and an unknown name gets the replicate-everything default,
    whose output is the reference's."""
    name = "test_only_identity"

    def rule(*specs, **attrs):
        return list(specs), list(specs)

    try:
        for mod in (jrules, trules):
            assert mod.register_spmd_rule(name)(rule) is rule
            got = mod.get_spmd_rule(name)
            assert got.name == name and got._fn is rule
            assert mod.get_spmd_rule("no-such-op") is mod._REGISTRY["default"]
    finally:
        for mod in (jrules, trules):
            mod._REGISTRY.pop(name, None)
    specs = [([8, 32], "S0 S1"), ([32, 16], "R S0")]
    specs = [(shape, p.split()) for shape, p in specs]
    want = _run_rule("ref", M22, "no-such-op", specs, {})
    assert _run_rule("port", M22, "no-such-op", specs, {}) == want
    assert want == ([([8, 32], (("R",), ("R",))),
                     ([32, 16], (("R",), ("R",)))], [])


def _mesh_facts(pl, mesh):
    return (mesh.shape, mesh.ndim, mesh.dim_names, mesh.process_ids,
            mesh.mesh.tolist(), mesh.get_dim_size("mp"),
            [mesh.get_rank_by_dim_and_process_id(d, 5)
             for d in ("dp", "mp")], repr(mesh))


def test_process_mesh_is_metadata_as_the_reference():
    ids = np.arange(8).reshape(2, 4)
    jm, tm = jpl.ProcessMesh(ids, ["dp", "mp"]), tpl.ProcessMesh(
        ids, ["dp", "mp"])
    assert _mesh_facts(tpl, tm) == _mesh_facts(jpl, jm)
    assert tm == tpl.ProcessMesh(ids.copy(), ["dp", "mp"])
    assert tm != tpl.ProcessMesh(ids, ["x", "mp"])
    assert hash(tm) == hash(tpl.ProcessMesh(ids, ["dp", "mp"]))
    assert tpl.get_current_mesh() is None
    with tm:
        assert tpl.get_current_mesh() is tm
    assert tpl.get_current_mesh() is None
    # built at any shape without a group; the DeviceMesh refuses a mesh
    # larger than the world, naming both sizes, before any group comes up
    big = tpl.ProcessMesh(np.arange(64).reshape(8, 8), ["a", "b"])
    with pytest.raises(ValueError, match="rank 63, but the world has 1"):
        big.device_mesh
    assert not torch.distributed.is_initialized()


def test_auto_mesh_and_candidates_as_the_reference():
    assert repr(tpl.auto_mesh(2, 2, dim_names=["x", "y"])) == repr(
        jpl.auto_mesh(2, 2, dim_names=["x", "y"]))
    want = [(label, m.shape, m.dim_names, m.process_ids)
            for label, m in jpl.dp_mp_mesh_candidates(8)]
    got = [(label, m.shape, m.dim_names, m.process_ids)
           for label, m in tpl.dp_mp_mesh_candidates(8)]
    assert got == want
    with pytest.raises(ValueError):
        tpl.dp_mp_mesh_candidates(0)


SPEC_CASES = [
    ([("S0",), ("R",)], 2), ([("R",), ("S1",)], 2), ([("S0",), ("S0",)], 2),
    ([("S1",), ("S0",)], 3), ([("R",), ("R",)], 2), ([("S2",), ("R",)], 3),
]


@pytest.mark.parametrize("placements,ndim", SPEC_CASES)
def test_spec_conversions_as_the_reference(placements, ndim):
    names = [p[0] for p in placements]
    mesh_ids = np.arange(8).reshape(2, 4)
    jm = jpl.ProcessMesh(mesh_ids, ["dp", "mp"])
    tm = tpl.ProcessMesh(mesh_ids, ["dp", "mp"])
    want = tuple(jpl.placements_to_spec(_placements(jpl, names), jm, ndim))
    got = tpl.placements_to_spec(_placements(tpl, names), tm, ndim)
    assert got == want
    back_j = jpl.spec_to_placements(jpl.placements_to_spec(
        _placements(jpl, names), jm, ndim), jm, ndim)
    back_t = tpl.spec_to_placements(got, tm, ndim)
    assert _key(back_t) == _key(back_j)


def test_placements_as_the_reference():
    for name in ("Replicate", "Shard", "Partial"):
        args = (1,) if name == "Shard" else ()
        j, t = getattr(jpl, name)(*args), getattr(tpl, name)(*args)
        assert repr(t) == repr(j)
        assert (t.is_shard(), t.is_replicated(), t.is_partial()) == (
            j.is_shard(), j.is_replicated(), j.is_partial())
        assert t == getattr(tpl, name)(*args) and hash(t) == hash(
            getattr(tpl, name)(*args))
    assert tpl.Shard(1) != tpl.Shard(0) and tpl.Partial("max") != \
        tpl.Partial()
    # the torch placements they stand for
    from torch.distributed import tensor as tdt
    assert tpl.to_torch_placements(
        [tpl.Shard(1), tpl.Replicate(), tpl.Partial("max")]) == [
        tdt.Shard(1), tdt.Replicate(), tdt.Partial("max")]
    with pytest.raises(ValueError, match="reduce types"):
        tpl.to_torch_placements([tpl.Partial("xor")])
    # the package exports the reference's names
    for name in ("ProcessMesh", "Shard", "Replicate", "Partial",
                 "shard_tensor", "reshard", "shard_layer",
                 "shard_optimizer", "to_static", "Strategy"):
        assert hasattr(tdist, name) and hasattr(jdist, name)


def test_strategy_as_the_reference():
    config = {"sharding": {"enable": True, "stage": 2},
              "amp": {"dtype": "float16"}, "unknown": {"x": 1}}
    for cfg in (None, config):
        j, t = JStrategy(cfg), TStrategy(cfg)
        for section in ("sharding", "amp", "recompute", "pipeline",
                        "gradient_merge", "fused_passes"):
            assert vars(getattr(t, section)) == vars(getattr(j, section))
        assert repr(t) == repr(j)
