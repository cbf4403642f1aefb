"""The port's vision zoo (paddle_tpu_torch/vision/models/) against the
reference's (paddle_tpu/vision/models/): every constructor's state names
and shapes (``nn.Linear`` weights transposed), ``pretrained=True``
raising for every constructor, the ``with_pool`` / ``num_classes``
options, and ``dtype`` / ``seed`` / the dropout generator within the
port. The reference's models are built with ``_torch_zoo.numpy_init`` (zero
weights: only names and shapes are compared here)."""
import pytest
import torch

from _torch_zoo import (  # noqa: F401
    names_and_shapes_match, numpy_init, one_torch_thread, pair)

from paddle_tpu_torch import vision as tvision


@pytest.fixture(autouse=True)
def _fast_reference_init(monkeypatch):
    numpy_init(monkeypatch, zeros=True)


CONSTRUCTORS = [
    ("LeNet", {}), ("alexnet", {}),
    *[(f"vgg{d}", dict(batch_norm=bn)) for d in (11, 13, 16, 19)
      for bn in (False, True)],
    ("squeezenet1_0", {}), ("squeezenet1_1", {}),
    ("mobilenet_v1", {}), ("mobilenet_v1", dict(scale=0.5)),
    ("mobilenet_v2", {}), ("mobilenet_v2", dict(scale=1.4)),
    ("mobilenet_v3_small", {}), ("mobilenet_v3_large", {}),
    ("mobilenet_v3_large", dict(scale=0.75)),
    *[(f"shufflenet_v2_{w}", {}) for w in ("x0_25", "x0_33", "x0_5",
                                           "x1_0", "x1_5", "x2_0",
                                           "swish")],
    *[(f"densenet{d}", {}) for d in (121, 161, 169, 201, 264)],
    ("googlenet", {}), ("inception_v3", {}),
]


@pytest.mark.parametrize("name, kw", CONSTRUCTORS,
                         ids=[f"{c[0]}-{c[1]}" for c in CONSTRUCTORS])
def test_constructor_names_and_shapes(name, kw):
    names_and_shapes_match(name, **kw)


PRETRAINED = [n for n in tvision.models.__all__ if n[0].islower()]


@pytest.mark.parametrize("name", PRETRAINED)
def test_pretrained_raises(name):
    with pytest.raises(NotImplementedError, match="download"):
        getattr(tvision.models, name)(pretrained=True, device="cpu")


@pytest.mark.parametrize("name, kw, shape, want", [
    ("squeezenet1_0", dict(num_classes=0, with_pool=False),
     (1, 3, 128, 128), (1, 512, 2, 2)),
    ("mobilenet_v2", dict(num_classes=0), (1, 3, 64, 64), (1, 1280, 1, 1)),
    ("shufflenet_v2_x0_5", dict(with_pool=False, num_classes=0),
     (1, 3, 64, 64), (1, 1024, 2, 2)),
    ("vgg11", dict(num_classes=0, with_pool=False), (1, 3, 64, 64),
     (1, 512, 2, 2)),
    ("LeNet", dict(num_classes=0), (1, 1, 28, 28), (1, 16, 5, 5))])
def test_pool_and_head_options(name, kw, shape, want):
    """``with_pool=False`` and ``num_classes=0`` leave the feature map, as
    in the reference."""
    _, tm = pair(name, **kw)
    with torch.no_grad():
        assert tuple(tm.eval()(torch.zeros(shape)).shape) == want


def test_dtype_seed_and_dropout_generator():
    a, b = (tvision.models.mobilenet_v2(scale=0.25, num_classes=10,
                                        device="cpu", dtype=torch.bfloat16,
                                        seed=3) for _ in range(2))
    assert all(p.dtype == torch.bfloat16 for p in a.parameters())
    assert all(t.dtype == torch.bfloat16 for t in a.buffers())
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    # training-mode dropout draws from the model's own generator
    c, d = (tvision.models.squeezenet1_1(num_classes=10, device="cpu",
                                         seed=5) for _ in range(2))
    x = torch.randn(2, 3, 48, 48, generator=torch.Generator().manual_seed(0))
    assert torch.equal(c.train()(x), d.train()(x))
    assert not torch.equal(c(x), c.eval()(x))


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v2"])
def test_flops_counts_batch_norm_as_the_reference(name, capsys):
    """``paddle_tpu_torch.flops`` (``utils.flops.dynamic_flops``, resolved
    at top level as ``paddle.flops`` is) counts each batch norm as
    ``5 * numel(out)`` plus its parameters, as the reference does: the
    port's models normalise through ``nn.functional.norm.BatchNorm``, a
    plain ``torch.nn.Module``, which the table must name. FLOPs and the
    printed parameter count equal the reference's exactly."""
    import importlib

    import paddle_tpu_torch

    jflops = importlib.import_module("paddle_tpu.utils.flops")
    jm, tm = pair(name)
    ref = jflops.dynamic_flops(jm, [1, 3, 64, 64])
    port = paddle_tpu_torch.flops(tm, [1, 3, 64, 64])
    assert port == ref > 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]        # "Total Flops: ... Total Params: ..."
