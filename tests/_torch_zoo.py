"""Shared steps of the vision-zoo tests (test_torch_vision_zoo*.py): a
family's port model from the reference's weights and buffers, and one
training step of both held against each other.

The reference draws each parameter with a ``jax.random`` call compiled
for its shape (about 19 s to build ``mobilenet_v3_large`` on the CPU),
so the tests build its models with ``numpy_init``: the same
initializers (``Constant``, ``Normal``, ``XavierNormal`` and zero
biases, with their parameters), drawn with numpy (zeros where only
names and shapes are compared). The port's weights are bridged from the
reference's in every case, so the draws only have to be of the right
scale.

The reference runs its forward and its training step under its own
``jit.to_static`` (``reference_programs``): one XLA program each, where
its eager dispatch compiles a program for every op at every shape,
which made the reference the slow side of these tests. The compiled
step is the eager one's computation, equal to it up to rounding far
inside the tolerances below. The port runs on one torch thread
(``one_torch_thread``, autouse where imported): beside XLA's own thread
pool in the same process, torch's default of one thread per core spent
many times the CPU of one thread on these small inputs, which the zoo's
files, run side by side, pay in wall time.

``step_matches_reference`` runs the smallest configuration of each
family (``FAMILIES``) at a small input, ``num_classes=10``, dropout off
(the draws are each package's own). How well fp32 can agree was
measured first, as the port's own fp32 run against its fp64 run from
the same weights (worst gradient relative to its own max |g|, a floor
of 1e-6 of the largest):
- without batch norm, training mode: LeNet 1.2e-6, AlexNet 1.3e-6 (224 x
  224: its 6 x 6 adaptive pool needs a 6 x 6 map, and the reference
  refuses an adaptive pool that would repeat windows), SqueezeNet 1.1
  9.5e-7, GoogLeNet 1.3e-6 at 64 x 64 (its auxiliary heads in the loss
  as ``out + 0.3 * (aux1 + aux2)``). ``vgg11`` (224 x 224, for its 7 x 7
  pool) 3.4e-6 on one input and 1.1e-3 on another, in one weight
  gradient only (its bias 1.1e-6): two entries of a 2 x 2 max-pool
  window equal to within a rounding route that window's gradient to
  different inputs in fp32 and fp64. So ``vgg11``'s gradients are held
  to ``VGG_GRAD_TOL``.
- with batch norm over two images, training mode: the MobileNets and
  ShuffleNet at 64 x 64, logits 1.0e-6 to 2.7e-5 apart, gradients
  4.1e-2 to 2.3e-1 (batch norm over a few values a channel in the last
  stages); ``densenet121`` at 64 x 64 6.4e-6 / 2.2e-2; ``inception_v3``
  at 139 x 139 (its last blocks 3 x 3; at 75 x 75, 1 x 1, the logits are
  0.29 apart) 3.8e-5 / 0.21. In eval mode 7.9e-7 to 6.3e-6. So these
  hold their training-mode forward to ``DEEP_OUT_TOL`` and take their
  gradients and step in eval mode, from the reference's statistics.
Tolerances otherwise: logits and statistics ``OUT_TOL`` of their own max
|value|; each gradient ``GRAD_TOL`` of its own max |g|; each parameter
after the step within lr x that gradient bound plus ``PARAM_TOL`` of its
own max |value|."""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import vision as jvision

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch import vision as tvision
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Momentum

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
LR = 0.1
#: the batch-norm families' training-mode forward (see the docstring)
DEEP_OUT_TOL = 5e-4
#: vgg11's gradients: a max-pool window's near-tie (see the docstring)
VGG_GRAD_TOL = 2e-3
#: the least scale a running statistic is compared at: the running mean
#: after a 1 x 1 convolution of batch-normalised channels is 0 in exact
#: arithmetic, rounding noise of about 1e-8 in fp32
BUFFER_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's intra-op threads set to 1 for a test (see the module
    docstring), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def fresh_hybrid_groups():
    """Both packages' hybrid groups (``fleet.init``'s process-wide
    ``HybridCommunicateGroup``) and the reference's fleet strategy reset
    on entry and again on exit. A reference test that calls
    ``fleet.init`` and never resets (``tests/test_sharding.py:141``)
    leaves its eight-device group behind, and a later oracle that reads
    it takes that mesh: the reference's MoE ``_ep_mesh`` falls back to
    it (ROADMAP queue C, C7). Every port test whose oracle reads either
    package's hybrid group or fleet state runs it inside this."""
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.fleet import topology as jtopology
    from paddle_tpu_torch.distributed.fleet import topology as ttopology

    def reset():
        jtopology.set_hybrid_communicate_group(None)
        ttopology.set_hybrid_communicate_group(None)
        jfleet._fleet_state.update(initialized=False, strategy=None)

    reset()
    try:
        yield
    finally:
        reset()


@pytest.fixture(autouse=True)
def no_hybrid_groups():
    """Each test inside ``fresh_hybrid_groups`` (autouse where
    imported)."""
    with fresh_hybrid_groups():
        yield


def numpy_init(monkeypatch, seed=0, zeros=False):
    """Make the reference's ``Layer.create_parameter`` draw with numpy
    (see the module docstring); with ``zeros`` every parameter is 0."""
    from paddle_tpu.core.tensor import Parameter
    from paddle_tpu.nn import initializer as I
    from paddle_tpu.nn.layer import Layer

    rng = np.random.default_rng(seed)
    original = Layer.create_parameter

    def create(self, shape, attr=None, dtype=None, is_bias=False,
               default_initializer=None):
        init = default_initializer
        shape = tuple(int(n) for n in shape)
        if attr is not None or (dtype not in (None, "float32")):
            return original(self, shape, attr, dtype, is_bias,
                            default_initializer)
        if zeros:
            value = np.zeros(shape, np.float32)
        elif isinstance(init, I.Constant) or (init is None and is_bias):
            value = np.full(shape, init.value if init else 0.0, np.float32)
        elif isinstance(init, I.Normal):
            value = rng.normal(init.mean, init.std, shape)
        elif isinstance(init, I.XavierNormal) or init is None:
            value = rng.normal(0.0, np.sqrt(2.0 / (shape[0] + shape[-1])),
                               shape)
        else:
            return original(self, shape, attr, dtype, is_bias,
                            default_initializer)
        return Parameter(paddle.to_tensor(
            value.astype(np.float32, copy=False))._value)

    monkeypatch.setattr(Layer, "create_parameter", create)


def share(got, want, floor=1e-30):
    """``|got - want|`` over ``want``'s max |value| (at least ``floor``)."""
    got = got.detach().float().numpy()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 floor)


def state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def linear_names(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)}


def torch_layout(arrays, tm):
    """The reference's arrays in the port's layout (``nn.Linear``
    weights ``[out, in]``)."""
    lin = linear_names(tm)
    return {k: (v.T if k in lin else v) for k, v in arrays.items()}


def pair(name, **kw):
    paddle.seed(7)
    jm = getattr(jvision.models, name)(**kw)
    tm = getattr(tvision.models, name)(device="cpu", **kw)
    load_paddle_tpu_state(tm, state(jm))
    return jm, tm


def no_dropout(jm, tm):
    """Dropout off in both (its draws are each package's own)."""
    for layer in jm.sublayers():
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0
    for mod in tm.modules():
        if type(mod).__name__ == "Dropout":
            mod.p = 0.0


def loss_of(out, y, functional):
    """Cross-entropy of the logits; GoogLeNet's training tuple weighs its
    auxiliary heads by 0.3."""
    if isinstance(out, tuple):
        main, aux1, aux2 = (functional.cross_entropy(o, y) for o in out)
        return main + 0.3 * (aux1 + aux2)
    return functional.cross_entropy(out, y)


def reference_programs(jm, jo):
    """The reference model's forward and its training step (forward,
    ``loss_of``, backward, ``jo.step()``; it returns the output and the
    gradients by parameter name), each under the reference's
    ``jit.to_static(full_graph=True)`` (see the module docstring)."""
    names = [n for n, _ in jm.named_parameters()]
    params = [p for _, p in jm.named_parameters()]

    def step(x, y):
        out = jm(x)
        loss_of(out, y, paddle.nn.functional).backward()
        grads = [p.grad for p in params]
        jo.step()
        return out, grads

    static = paddle.jit.to_static(step, full_graph=True)

    def run_step(x, y):
        out, grads = static(x, y)
        return out, {n: np.asarray(g._value) for n, g in zip(names, grads)
                     if g is not None}

    return paddle.jit.to_static(lambda x: jm(x), full_graph=True), run_step


def step_matches_reference(name, kw, shape, out_tol, grads_in,
                           grad_tol=GRAD_TOL):
    """One step of ``name(num_classes=10, **kw)`` in both packages from
    the same weights (the reference's through ``reference_programs``):
    the training-mode forward (dropout off) and the
    batch-norm statistics it leaves within ``out_tol`` (of their max
    |value|, at least ``BUFFER_FLOOR``); with ``grads_in == "eval"`` both
    switch to eval mode for the gradients, from the reference's
    statistics (the logits then within ``OUT_TOL``); each gradient within
    ``grad_tol`` of its own max |g|; each parameter after one
    ``Momentum(0.1, 0.9)`` step within lr x that bound plus ``PARAM_TOL``
    of its max."""
    jm, tm = pair(name, num_classes=10, **kw)
    no_dropout(jm, tm)
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.integers(0, 10, (shape[0],)).astype(np.int64)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    jy, ty = paddle.to_tensor(y), torch.from_numpy(y)
    jo = jopt.Momentum(learning_rate=LR, momentum=0.9,
                       parameters=jm.parameters())
    to = Momentum(learning_rate=LR, momentum=0.9, parameters=tm.parameters())
    jforward, jstep = reference_programs(jm, jo)

    tout = tm(tx)
    if grads_in == "eval":
        jout = jforward(jx)
    else:       # the training-mode forward is the step's
        jout, jgrads = jstep(jx, jy)
    assert isinstance(jout, tuple) == isinstance(tout, tuple)
    for j, t in zip(jout if isinstance(jout, tuple) else [jout],
                    tout if isinstance(tout, tuple) else [tout]):
        assert share(t, np.asarray(j._value)) <= out_tol, "logits"
    jstate = state(jm)
    for n, b in tm.named_buffers():
        err = share(b, jstate[n], BUFFER_FLOOR)
        assert err <= out_tol, (n, err)
    if grads_in == "eval":
        # from the same statistics: the training-mode forward's are only
        # as close as its conditioning allows
        load_paddle_tpu_state(tm, state(jm))
        jm.eval()
        tm.eval()
        tout = tm(tx)
        jout, jgrads = jstep(jx, jy)
        assert share(tout, np.asarray(jout._value)) <= OUT_TOL, "eval"
    loss_of(tout, ty, TF).backward()
    jgrads = torch_layout(jgrads, tm)
    tgrads = {n: p.grad for n, p in tm.named_parameters()
              if p.grad is not None}
    assert set(tgrads) == set(jgrads)
    worst = max((share(g, jgrads[n]), n) for n, g in tgrads.items())
    assert worst[0] <= grad_tol, worst
    to.step()
    jstate = torch_layout(state(jm), tm)
    for n, p in tm.named_parameters():
        err = float(np.abs(p.detach().numpy() - jstate[n]).max())
        g = float(np.abs(jgrads[n]).max()) if n in jgrads else 0.0
        bound = LR * grad_tol * g + PARAM_TOL * float(
            np.abs(jstate[n]).max())
        assert err <= bound, (n, err, bound)


#: name -> (constructor arguments, input shape, training-mode forward
#: tolerance, mode of the gradients and step, gradient tolerance)
FAMILIES = {
    "LeNet": ({}, (2, 1, 28, 28), OUT_TOL, "train", GRAD_TOL),
    "alexnet": (dict(dropout=0.0), (1, 3, 224, 224), OUT_TOL, "train",
                GRAD_TOL),
    "vgg11": ({}, (1, 3, 224, 224), OUT_TOL, "train", VGG_GRAD_TOL),
    "squeezenet1_1": ({}, (2, 3, 64, 64), OUT_TOL, "train", GRAD_TOL),
    "mobilenet_v1": (dict(scale=0.25), (2, 3, 64, 64), DEEP_OUT_TOL, "eval",
                     GRAD_TOL),
    "mobilenet_v2": (dict(scale=0.25), (2, 3, 64, 64), DEEP_OUT_TOL, "eval",
                     GRAD_TOL),
    "mobilenet_v3_small": (dict(scale=0.5), (2, 3, 64, 64), DEEP_OUT_TOL,
                           "eval", GRAD_TOL),
    "shufflenet_v2_x0_25": ({}, (2, 3, 64, 64), DEEP_OUT_TOL, "eval",
                            GRAD_TOL),
    "densenet121": ({}, (2, 3, 64, 64), DEEP_OUT_TOL, "eval", GRAD_TOL),
    "googlenet": ({}, (2, 3, 64, 64), OUT_TOL, "train", GRAD_TOL),
    "inception_v3": ({}, (2, 3, 139, 139), DEEP_OUT_TOL, "eval", GRAD_TOL),
}


def family_step(name):
    kw, shape, out_tol, grads_in, grad_tol = FAMILIES[name]
    step_matches_reference(name, kw, shape, out_tol, grads_in, grad_tol)


def names_and_shapes_match(name, **kw):
    """The port's state names and shapes are the reference's (``nn.Linear``
    weights transposed)."""
    paddle.seed(0)
    jm = getattr(jvision.models, name)(num_classes=10, **kw)
    tm = getattr(tvision.models, name)(num_classes=10, device="cpu", **kw)
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    lin = linear_names(tm)
    got = {k: tuple(v.shape)[::-1] if k in lin else tuple(v.shape)
           for k, v in tm.state_dict().items()}
    assert got == want
