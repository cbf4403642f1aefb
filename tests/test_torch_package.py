"""Package-level rules of the PyTorch/CUDA port (paddle_tpu_torch).

- it imports neither jax nor anything of paddle_tpu (checked in a fresh
  interpreter and by an AST scan of every module);
- its entry points run on the card by default and raise when there is
  none, unless the caller passes ``device="cpu"``;
- a CPU tensor never reaches a kernel: with the kernel loader broken, the
  whole inference path, a training step, varlen attention forward and
  backward and the calibration probe still run on the CPU and no launch
  is counted;
- chip_smoke.py alone, or without a card, exits non-zero and prints no
  result.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu_torch
from paddle_tpu_torch import (BertConfig, BertForPretraining,
                              BertForSequenceClassification, ErnieMoeConfig,
                              ErnieMoeForCausalLM, LlamaConfig,
                              LlamaForCausalLM, ServeEngine)
from paddle_tpu_torch.incubate.distributed.models.moe import (FusedMoELayer,
                                                              GShardGate)
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import flash_attention_varlen as tvf
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.ops.cuda import rms_norm as trn
from paddle_tpu_torch.ops.cuda import tiled_mm as ttm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.vision.models import LeNet, mobilenet_v3_small, resnet18
from paddle_tpu_torch.vision.ops import DeformConv2D, read_file
from paddle_tpu_torch.serve import default_serving_setup

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(paddle_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serve, "
            "paddle_tpu_torch.models, paddle_tpu_torch.convert, "
            "paddle_tpu_torch.nn.functional.flash_attention, "
            "paddle_tpu_torch.tools.conv_calibration, "
            "paddle_tpu_torch.incubate.nn, "
            "paddle_tpu_torch.incubate.nn.memory_efficient_attention, "
            "paddle_tpu_torch.vision.models, paddle_tpu_torch.vision, "
            "paddle_tpu_torch.observability, paddle_tpu_torch.profiler, "
            "paddle_tpu_torch.device, paddle_tpu_torch.utils, "
            "paddle_tpu_torch.tools.metrics_report; "
            "print('\\n'.join(sys.modules))")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120,
                         check=True).stdout.split()
    assert "paddle_tpu_torch.serve.engine" in out
    assert "paddle_tpu_torch.ops.cuda.flash_attention_varlen" in out
    assert "paddle_tpu_torch.ops.cuda.tiled_mm" in out
    assert "paddle_tpu_torch.incubate.nn.layer" in out
    assert "paddle_tpu_torch.incubate.nn.attn_bias" in out
    assert "paddle_tpu_torch.nn.functional.extra_loss" in out
    assert "paddle_tpu_torch.nn.functional.extra_pooling" in out
    assert "paddle_tpu_torch.nn.functional.vision" in out
    assert "paddle_tpu_torch.vision.models.inceptionv3" in out
    assert "paddle_tpu_torch.vision.ops" in out
    for mod in ("observability.runtime", "observability.timeseries",
                "observability.health", "observability.report",
                "profiler.kineto", "profiler.statistic", "device.memory",
                "device.cuda", "device.xpu", "utils.flops",
                "distributed.auto_parallel.api",
                "distributed.auto_parallel.spmd_rules",
                "distributed.auto_parallel.engine",
                "distributed.fleet.mp_layers",
                "distributed.fleet.sequence_parallel",
                "distributed.fleet.topology",
                "distributed.communication.functional",
                "distributed.sharding",
                "distributed.fleet.meta_parallel.sharding",
                "distributed.fleet.meta_optimizers.dygraph_optimizer",
                "framework.io_",
                "distributed.fleet.context_parallel",
                "distributed.fleet.meta_parallel.segment_parallel",
                "distributed.fleet.meta_parallel.pipeline_schedules",
                "distributed.fleet.meta_parallel.pp_layers",
                "distributed.fleet.meta_parallel.pipeline_parallel",
                "distributed.fleet.pipeline_spmd",
                "distributed.fleet.pipeline_spmd_engine"):
        assert f"paddle_tpu_torch.{mod}" in out
    assert [m for m in out if _forbidden(m)] == []


#: the reference's exported names the port leaves to later ROADMAP items:
#: observability/fleet.py (item 4) and observability/opprof.py (item 7);
#: amp/debugging.py (item 6) exports nothing through these packages
NOT_PORTED = {
    "observability": ["FleetAggregator", "FleetReporter", "OpCalibration",
                      "OpProfile", "OpProfiler", "OpSpan",
                      "attribute_profile", "calibrate_op_costs",
                      "check_opprof_overhead", "fleet",
                      "lint_op_profile", "load_op_calibration", "opprof",
                      "render_op_profile", "resolve_op_calibration",
                      "save_op_calibration"],
    "profiler": [],
    "device": [],
}


@pytest.mark.parametrize("module", sorted(NOT_PORTED))
def test_item5_packages_export_the_reference_names(module):
    """``observability``, ``profiler`` and ``device`` export the
    reference's ``__all__`` but exactly the names of the modules that wait
    for other ROADMAP items, and every exported name is defined."""
    import importlib

    ref = importlib.import_module(f"paddle_tpu.{module}")
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    assert sorted(set(ref.__all__) - set(port.__all__)) == NOT_PORTED[module]
    assert set(port.__all__) <= set(ref.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


#: the reference's ``fleet`` names that wait for ROADMAP queue A item 4
#: (f): its utilities, the parameter server's role and data generators,
#: and the elastic launch
FLEET_LATER = ["MultiSlotStringDataGenerator", "Role", "UtilBase",
               "elastic_train", "launch", "run_elastic"]


def test_fleet_exports_the_reference_collective_names():
    """``distributed.fleet`` exports the reference's ``__all__`` but the
    names of part (f), each defined; the tensor- and sequence-parallel
    layers and the topology resolve there as in the reference."""
    import importlib

    ref = importlib.import_module("paddle_tpu.distributed.fleet")
    port = importlib.import_module("paddle_tpu_torch.distributed.fleet")
    assert sorted(set(ref.__all__) - set(port.__all__)) == FLEET_LATER
    assert set(port.__all__) <= set(ref.__all__)
    assert all(hasattr(port, n) for n in port.__all__)
    for name in ("ColumnParallelLinear", "RowParallelLinear",
                 "VocabParallelEmbedding", "ParallelCrossEntropy",
                 "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
                 "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
                 "mark_as_sequence_parallel_parameter",
                 "register_sequence_parallel_allreduce_hooks",
                 "set_hybrid_communicate_group"):
        assert hasattr(ref, name) and hasattr(port, name), name
    with pytest.raises(NotImplementedError, match=r"item 4 \(f\)"):
        port.init()
    with pytest.raises(NotImplementedError, match=r"item 4 \(f\)"):
        port.init_server()


#: ``fleet.meta_parallel``'s names and the port module that defines each
META_PARALLEL = {
    "LayerDesc": "pp_layers", "SharedLayerDesc": "pp_layers",
    "PipelineLayer": "pp_layers", "PipelineParallel": "pipeline_parallel",
    "SegmentParallel": "segment_parallel",
    "GroupShardedOptimizerStage2": "sharding",
    "GroupShardedStage2": "sharding", "GroupShardedStage3": "sharding",
    "pipeline_spmd_apply": "pipeline_spmd"}


def test_meta_parallel_exports_the_reference_names():
    """``fleet.meta_parallel`` exports the reference's ``__all__``, each
    name the real one of its module (the pipeline and context
    parallelism no longer raise), and ``fleet`` has ``context_parallel``,
    ``pipeline_spmd`` and ``pipeline_spmd_engine`` with the reference's
    ``__all__``."""
    import importlib

    ref = importlib.import_module("paddle_tpu.distributed.fleet.meta_parallel")
    port = importlib.import_module(
        "paddle_tpu_torch.distributed.fleet.meta_parallel")
    assert sorted(port.__all__) == sorted(ref.__all__) == sorted(
        META_PARALLEL)
    for name, mod in META_PARALLEL.items():
        assert getattr(port, name).__module__.endswith(mod), name
    for mod in ("context_parallel", "pipeline_spmd", "pipeline_spmd_engine",
                "meta_parallel.pipeline_schedules",
                "meta_parallel.pp_layers",
                "meta_parallel.pipeline_parallel"):
        r = importlib.import_module(f"paddle_tpu.distributed.fleet.{mod}")
        p = importlib.import_module(
            f"paddle_tpu_torch.distributed.fleet.{mod}")
        # without an __all__: the classes and functions the module
        # defines, but the reference's jax helper shard_map
        names = getattr(r, "__all__", None) or [
            n for n, o in vars(r).items() if not n.startswith("_")
            and getattr(o, "__module__", None) == r.__name__
            and n != "shard_map"]
        assert set(names) <= set(p.__all__), (mod, names)
        assert all(hasattr(p, n) for n in p.__all__), mod


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_no_module_imports_jax_or_the_reference(path):
    tree = ast.parse((PKG / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if _forbidden(n)] == []


@pytest.mark.parametrize("module", ["incubate.nn", "incubate.nn.functional",
                                    "incubate.nn.attn_bias",
                                    "incubate.nn.layer"])
def test_incubate_all_matches_the_reference(module):
    """The port's incubate ``__all__`` names the reference's, each name
    defined."""
    import importlib

    ref = importlib.import_module(f"paddle_tpu.{module}")
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


def test_vision_ops_all_matches_the_reference():
    """``vision.ops.__all__`` is the reference's 18 names, each defined;
    ``vision`` exports ``ops``, ``image_load`` and the image backend
    setting, as the reference's ``vision`` does."""
    from paddle_tpu import vision as ref
    from paddle_tpu.vision import ops as ref_ops

    from paddle_tpu_torch import vision as port
    from paddle_tpu_torch.vision import ops as port_ops

    assert sorted(port_ops.__all__) == sorted(ref_ops.__all__)
    assert len(port_ops.__all__) == 18
    assert all(hasattr(port_ops, n) for n in port_ops.__all__)
    for name in ("ops", "image_load", "set_image_backend",
                 "get_image_backend"):
        assert hasattr(ref, name) and name in port.__all__
        assert hasattr(port, name)


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


@pytest.mark.parametrize("module", ["nn.functional", "vision.models"])
def test_every_public_name_of_the_reference_is_in_the_port(module):
    """Every public name of the reference's ``nn.functional`` and
    ``vision.models`` (functions, classes, submodules; neither has an
    ``__all__`` that lists them all) exists in the port's; ``annotations``
    is the reference's ``from __future__`` import, not a name."""
    import importlib

    ref = importlib.import_module(f"paddle_tpu.{module}")
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    missing = sorted(_public(ref) - _public(port) - {"annotations"})
    assert missing == []
    assert all(hasattr(port, n) for n in port.__all__)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_serving_setup()
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model)
    assert resolve_device("cpu") == torch.device("cpu")
    assert default_serving_setup("cpu")[0].hidden_size == cfg.hidden_size
    ServeEngine(model, device="cpu")
    # BERT, ERNIE-MoE and the MoE layers and gates; ResNet and the UNet
    bert, moe = BertConfig.tiny(), ErnieMoeConfig.tiny()
    for make in (lambda **k: BertForPretraining(bert, **k),
                 lambda **k: BertForSequenceClassification(bert, **k),
                 lambda **k: ErnieMoeForCausalLM(moe, **k),
                 lambda **k: FusedMoELayer(16, 32, 4, **k),
                 lambda **k: GShardGate(16, 4, 1, **k),
                 lambda **k: resnet18(num_classes=10, **k),
                 lambda **k: LeNet(**k),
                 lambda **k: mobilenet_v3_small(scale=0.5, **k),
                 lambda **k: UNet2DConditionModel(UNetConfig.tiny(), **k),
                 lambda **k: FusedMultiTransformer(16, 2, 32, **k),
                 lambda **k: DeformConv2D(4, 4, 3, **k),
                 lambda **k: read_file(__file__, **k)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")


def test_cpu_tensors_never_reach_a_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU run tried to load the {name} kernel")

    monkeypatch.setattr(_build, "load", no_build)

    def launches():
        return (tfa.launches, tfa.bwd_launches, trn.launches,
                trn.bwd_launches, tpa.launches, tvf.launches,
                tvf.dq_launches, tvf.dkv_launches, ttm.launches)

    counts = launches()
    # head_dim 64: the flash and RMSNorm gates pass, so the forward goes
    # through the kernel wrappers, which send CPU tensors to plain code
    cfg = LlamaConfig.tiny(hidden_size=128, num_attention_heads=2,
                           num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device="cpu").eval()
    with torch.no_grad():
        logits = model(torch.randint(0, 256, (2, 16)))
    assert torch.isfinite(logits).all()
    eng = ServeEngine(model, max_slots=2, block_size=8, num_blocks=8,
                      max_seq_len=32, name="t_pkg", device="cpu",
                      prefix_cache=True)
    for _ in range(2):
        eng.submit(np.arange(1, 18), max_new_tokens=4)   # 2nd: prefix hit
        eng.run()
    assert all(r.state == "FINISHED" for r in eng.finished)
    # a training step: the loss, the backward through the kernels'
    # autograd functions, and AdamW
    model.train()
    opt = AdamW(parameters=model.parameters(), multi_precision=True)
    ids = torch.randint(0, 256, (2, 16))
    loss, _ = model(ids, labels=ids)
    loss.backward()
    opt.step()
    assert torch.isfinite(loss)
    # packed varlen attention, forward and backward, at a kernel head dim,
    # through both entry points; and the calibration probe
    cu = torch.tensor([0, 5, 16], dtype=torch.int32)
    qkv = torch.randn(16, 3, 2, 64, requires_grad=True)
    out, _ = TF.flash_attn_unpadded(*torch.unbind(qkv, 1), cu, cu, 11, 11,
                                    0.125, causal=True)
    out2, _ = TF.flash_attn_varlen_qkvpacked(qkv, cu, cu, 11, 11, scale=0.125,
                                             causal=True)
    (out + out2).sum().backward()
    assert torch.isfinite(qkv.grad).all()
    a = torch.randn(40, 64).to(torch.bfloat16)
    assert ttm.tiled_mm(a, a.t()).shape == (40, 40)
    assert launches() == counts


def test_chip_smoke_fails_without_the_package_or_a_card(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


#: the reference's ``paddle.distributed`` names that wait for later parts
#: of ROADMAP queue A item 4 (checkpoints, elastic training, the
#: parameter server, RPC and the fleet executor (f)) and for item 7
#: (``passes`` rewrite static programs)
DISTRIBUTED_LATER = {
    "4f": ["checkpoint", "elastic", "elastic_train", "fleet_executor",
           "load_state_dict", "ps", "rpc", "save_state_dict"],
    "7": ["passes"],
}


def test_distributed_exports_the_reference_names():
    """``paddle_tpu_torch.distributed`` exports only reference names,
    each defined; the reference's names it lacks are exactly those of
    the later parts (``DISTRIBUTED_LATER``). ``DataParallel`` and
    ``flops`` resolve at top level, as ``paddle.DataParallel`` and
    ``paddle.flops`` do."""
    import importlib

    import paddle_tpu

    # the reference's names as its import makes them, in a fresh
    # interpreter: other tests of a process import more of its submodules
    code = ("import paddle_tpu.distributed as d; "
            "print(' '.join(n for n in dir(d) if not n.startswith('_')))")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    public = set(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=120, check=True).stdout.split())
    public -= {"annotations"}
    port = importlib.import_module("paddle_tpu_torch.distributed")
    later = sorted(n for names in DISTRIBUTED_LATER.values() for n in names)
    assert sorted(public - set(port.__all__)) == later
    assert set(port.__all__) <= public
    assert {n for n in dir(port) if not n.startswith("_")} - {
        "annotations"} <= public
    assert all(hasattr(port, n) for n in port.__all__)
    flops = importlib.import_module("paddle_tpu_torch.utils.flops")
    assert paddle_tpu_torch.DataParallel is port.DataParallel
    assert paddle_tpu_torch.flops is flops.dynamic_flops
    assert callable(paddle_tpu.DataParallel) and callable(paddle_tpu.flops)
