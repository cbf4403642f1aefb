"""Context parallelism in the port on two gloo ranks on the CPU
(paddle_tpu_torch/distributed/fleet: ``context_parallel``'s ring and
Ulysses attention, ``meta_parallel.SegmentParallel``, Llama's
``context_parallel``), held against the reference at sep 2.

One launch serves every case (``two_ranks``): two processes run
``tests/_torch_cp_worker.py`` in a gloo world of two, after
``fleet.init`` with ``sep_degree`` 2, each rank on its chunk of every
sequence, while this process computes the reference's results on a
``ProcessMesh`` of two of its devices (its einsum ring on the CPU; its
Pallas interpreter is not forced). The cases:

- ``ring_attention`` and ``ulysses_attention``, causal and not, fp32,
  q ``[2, 16, 4, 8]`` and k, v with 2 heads repeated to 4 before the
  call (the reference's Llama does so): each rank's output chunk and the
  gradients of ``sum(out * w)`` into q and the unrepeated k and v. The
  port's ring runs the flash entry points (their plain versions on the
  CPU) and, causal, launches one forward and one backward block on rank
  0 and two of each on rank 1; its einsum ring (the plain version) gives
  the same numbers.
- The refusals, ``ValueError`` naming "divisible" in both packages:
  chunks that differ between the ranks (the reference: a sequence of 31
  over 2), 3 heads over 2 ranks, a sequence of 15 for
  ``SegmentParallel``.
- ``SegmentParallel``: each rank's layer sees its chunk, and its output
  is the reference's rows.
- ``LlamaConfig.tiny(context_parallel="ring" / "ulysses")`` under
  ``fleet.distributed_model`` (``SegmentParallel``): three AdamW steps
  on a 2 x 32 batch, against the reference's model under a hybrid group
  of sep 2 (its steps under its own ``jit.to_static``).

Tolerances: attention values 1e-5 absolute, gradients 1e-5 of their
max |g|; the model's those of ``test_torch_train.py`` (losses 2e-5, the
step-1 gradients 1e-4 of their max, parameters after three steps 1e-5
where every step's gradient is at least 1e-3 of its max in both
packages); dtypes asserted.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.fleet.context_parallel import (
    ring_attention as jring, ulysses_attention as julysses)
from paddle_tpu.distributed.fleet.meta_parallel.segment_parallel import \
    SegmentParallel as JSegment
from paddle_tpu.distributed.fleet.topology import (
    CommunicateTopology as JTopo, HybridCommunicateGroup as JHcg,
    set_hybrid_communicate_group as jset_hcg)
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

from _torch_zoo import fresh_hybrid_groups, numpy_init  # noqa: F401
from test_torch_expert_parallel import _hold_steps, _ref_ernie_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_cp_worker.py")
TIMEOUT = 240
TOL = 1e-5
CASES = [(fn, causal) for fn in ("ring", "ulysses")
         for causal in ("full", "causal")]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    ids = rng.integers(0, 256, (2, 32))
    return dict(q=rng.standard_normal((2, 16, 4, 8)).astype(f32),
                k=rng.standard_normal((2, 16, 2, 8)).astype(f32),
                v=rng.standard_normal((2, 16, 2, 8)).astype(f32),
                w=rng.standard_normal((2, 16, 4, 8)).astype(f32),
                seg_x=rng.standard_normal((2, 8, 8)).astype(f32),
                seg_w=rng.standard_normal((8, 8)).astype(f32),
                seg_b=rng.standard_normal((8,)).astype(f32),
                ids=ids, labels=np.roll(ids, -1, axis=1))


def _sep2():
    return JHcg(JTopo(["pp", "dp", "sharding", "sep", "mp"], [1, 1, 1, 2, 1]))


def _ref_attention(inp):
    mesh = jdist.ProcessMesh(np.arange(2), ["sep"])
    out = {}
    for fn_name, causal in CASES:
        fn = {"ring": jring, "ulysses": julysses}[fn_name]
        q, k, v = (paddle.to_tensor(inp[n], stop_gradient=False)
                   for n in ("q", "k", "v"))
        ke, ve = (paddle.repeat_interleave(x, 2, axis=2) for x in (k, v))
        o = fn(q, ke, ve, mesh, "sep", causal=causal == "causal")
        (o * paddle.to_tensor(inp["w"])).sum().backward()
        key = f"{fn_name}/{causal}"
        out[f"{key}/out"] = np.asarray(o._value)
        for n, x in (("q", q), ("k", k), ("v", v)):
            out[f"{key}/d{n}"] = np.asarray(x.grad._value)
    msgs = []
    for call in (lambda: jring(*[paddle.zeros([1, 31, 2, 8])] * 3, mesh,
                               "sep"),
                 lambda: julysses(*[paddle.zeros([1, 8, 3, 8])] * 3, mesh,
                                  "sep")):
        with pytest.raises(ValueError) as e:
            call()
        msgs.append(str(e.value))
    out["refusals"] = msgs
    return out


def _ref_segment(inp):
    hcg = _sep2()
    jset_hcg(hcg)
    try:
        lin = jnn.Linear(8, 8)
        lin.set_state_dict({"weight": inp["seg_w"], "bias": inp["seg_b"]})
        y = JSegment(lin, hcg=hcg)(paddle.to_tensor(inp["seg_x"]))
        return np.asarray(y._value)
    finally:
        jset_hcg(None)


def _ref_llama(inp, state):
    out = {}
    jset_hcg(_sep2())
    try:
        for mode in ("ring", "ulysses"):
            jm = JLlama(JConfig.tiny(context_parallel=mode))
            jm.set_state_dict(state)
            out[mode] = _ref_ernie_steps(jm, inp["ids"], inp["labels"])
    finally:
        jset_hcg(None)
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """``_two_ranks`` with both packages' hybrid groups reset before and
    after (``fresh_hybrid_groups``)."""
    with fresh_hybrid_groups():
        return _two_ranks(tmp_path_factory)


def _two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("cp")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    with pytest.MonkeyPatch.context() as mp:
        numpy_init(mp, seed=4)
        state = {k: np.asarray(v._value)
                 for k, v in JLlama(JConfig.tiny()).state_dict().items()}
    np.savez(d / "llama.npz", **state)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""),
           "PADDLE_TRAINERS_NUM": "2",
           "PADDLE_MASTER": f"127.0.0.1:{_free_port()}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(d)], cwd=REPO,
        env={**env, "PADDLE_TRAINER_ID": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        ref = _ref_attention(inp)
        ref["segment"] = _ref_segment(inp)
        ref["llama"] = _ref_llama(inp, state)
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return inp, ref, got


def _close(got, want, tol=TOL, rel=False, err_msg=""):
    want = np.asarray(want, np.float64)
    atol = tol * (np.abs(want).max() if rel else 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=err_msg)


def _rows(a, rank, dim=1):
    return np.split(np.asarray(a), 2, axis=dim)[rank]


@pytest.mark.parametrize("fn,causal", CASES)
def test_attention_at_sep2_matches_the_reference(two_ranks, fn, causal):
    """Each rank's output and input gradients are the reference's rows of
    its chunk; the ring's causal blocks are launched only where a rank
    holds past keys."""
    _, ref, got = two_ranks
    key = f"{fn}/{causal}"
    for rank, g in enumerate(got):
        assert g["hcg"].tolist() == [2, rank]
        assert g[f"{key}/out"].dtype == np.float32
        _close(g[f"{key}/out"], _rows(ref[f"{key}/out"], rank))
        for n in ("q", "k", "v"):
            assert g[f"{key}/d{n}"].dtype == np.float32
            _close(g[f"{key}/d{n}"], _rows(ref[f"{key}/d{n}"], rank),
                   rel=True, err_msg=f"d{n}")
        if fn == "ring":
            blocks = [rank + 1] * 2 if causal == "causal" else [2, 2]
            assert g[f"{key}/blocks"].tolist() == blocks
        else:
            assert g[f"{key}/blocks"].tolist() == [0, 0]


@pytest.mark.parametrize("causal", ["full", "causal"])
def test_flash_ring_equals_the_einsum_ring(two_ranks, causal):
    """The flash ring against its plain version, the reference's einsum
    ring (``_ring_attn_local``), on the same ranks."""
    for g in two_ranks[2]:
        key = f"ring/{causal}"
        _close(g[f"{key}/out"], g[f"{key}/einsum_out"])
        for n in ("q", "k", "v"):
            _close(g[f"{key}/d{n}"], g[f"{key}/einsum_d{n}"], rel=True)


def test_refusals_name_divisibility_as_the_reference(two_ranks):
    _, ref, got = two_ranks
    assert all("divisible" in m for m in ref["refusals"])
    for g in got:
        msgs = g["refusals"].tolist()
        assert len(msgs) == 3 and all("divisible" in m for m in msgs), msgs
        assert "ring_attention" in msgs[0] and "[8, 7]" in msgs[0]
        assert "num_heads 3" in msgs[1]
        assert "SegmentParallel" in msgs[2]


def test_segment_parallel_shards_the_sequence(two_ranks):
    _, ref, got = two_ranks
    for rank, g in enumerate(got):
        assert g["segment/seen"].tolist() == [2, 4, 8]
        _close(g["segment/y"], _rows(ref["segment"], rank))


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_llama_context_parallel_trains_as_the_reference(two_ranks, mode):
    """Three AdamW steps at sep 2 under ``fleet.distributed_model``: each
    rank's loss is the global mean, its gradients the whole sequence's,
    and the two ranks end with one model."""
    _, ref, got = two_ranks
    g0, g1 = got
    for g in got:
        assert str(g[f"{mode}/wrapper"]) == "SegmentParallel"
        _hold_steps(g, mode, ref["llama"][mode], g[f"{mode}/losses"])
    np.testing.assert_array_equal(g0[f"{mode}/losses"], g1[f"{mode}/losses"])
    for key in g0:
        if key.startswith(f"{mode}/param/"):
            np.testing.assert_array_equal(g0[key], g1[key], err_msg=key)
