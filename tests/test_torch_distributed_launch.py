"""The port's distributed runtime through its real launcher, on the CPU
(paddle_tpu_torch/distributed/: launch_utils, env, store, communication,
parallel_wrapper), held against the reference.

One two-node spawn serves most cases (``two_ranks``): two launchers
(``python -m paddle_tpu_torch.distributed.launch --nnodes 2
--max_restarts 2``) on one master port, each starting
``tests/_torch_dist_worker.py`` into a gloo world of two ranks. At
restart generation 0 rank 1 dies after a barrier and rank 0 waits, so
both nodes must restart at generation 1 (the reference's coordinated
restart). There each worker
- takes the reference launcher test's store round (``hello``: set, wait,
  read the peer's key, barrier) and prints ``worker R/2 OK``;
- runs every collective and records what it got: the values of
  ``tests/launch_collective_worker.py``, plus MIN, PROD, AVG (an integer
  tensor truncates), an async AVG, ``reduce`` on the non-``dst`` rank,
  ``scatter``, ``gather``, ``all_to_all_single`` and the two refusals;
- trains ``LlamaConfig.tiny`` three AdamW steps under ``DataParallel``
  (buckets of 0.1 MB, the first 0.02 MB), each rank on its half of a
  4 x 16 batch with no ignored label, from the reference's weights
  (rank 1 starts from other weights, which the wrapper's broadcast
  replaces).
Meanwhile this process trains the reference's tiny Llama three steps on
the whole batch (``JAdamW``): the reference's data parallelism on a mesh
computes exactly the full batch. Tolerances are
``test_torch_train.py``'s: each loss (the mean of the two ranks')
2e-5 absolute, the step-1 gradients 1e-4 of each one's max |g|, the
parameters 1e-5 absolute where every step's gradient is above 1e-5 (at
least 95% of them); both ranks' parameters equal bit for bit.

The reference's four launcher tests (``tests/test_launch_elastic.py``)
run on the port's launcher: the two-node rendezvous and the coordinated
restart of both nodes at a bumped generation (on the shared spawn),
restart on failure, and the exhausted restart budget's exit code. Every
subprocess has a timeout.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

from paddle_tpu_torch.distributed.launch_utils import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
TIMEOUT = 150

LOSS_TOL = 2e-5
GRAD_REL = 1e-4
PARAM_TOL = 1e-5
G_FLOOR = 1e-5
LR = 1e-3
STEPS = 3


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    return {**os.environ, "PYTHONPATH": REPO + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def _launch_nodes(script, log_dir, *extra, args=()):
    """Two launchers of one job on a free master port, run to the end;
    returns their CompletedProcess by node rank."""
    master = f"127.0.0.1:{_free_port()}"
    results = {}

    def run_node(rank):
        results[rank] = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nnodes", "2", "--node_rank", str(rank), "--master", master,
             "--log_dir", log_dir, *extra, str(script), *args],
            capture_output=True, text=True, timeout=TIMEOUT, cwd=REPO,
            env=_env())

    threads = [threading.Thread(target=run_node, args=(r,))
               for r in range(2)]
    for t in threads:
        t.start()
    return threads, results


def _log(log_dir, rank):
    return open(os.path.join(log_dir, f"workerlog.{rank}")).read()


def _reference_full_batch(jm, ids, labels):
    """The reference's three AdamW steps on the whole batch."""
    params = dict(jm.named_parameters())
    jo = jopt.AdamW(learning_rate=LR, parameters=list(params.values()))
    out = dict(losses=[], grads=[])
    for _ in range(STEPS):
        loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss.backward()
        out["losses"].append(float(loss))
        out["grads"].append({n: np.asarray(p.grad._value)
                             for n, p in params.items()})
        jo.step()
        jo.clear_grad()
    out["params"] = {n: np.asarray(p._value) for n, p in params.items()}
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("two_ranks")
    paddle.seed(7)
    jm = JLlama(JConfig.tiny())
    weights = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    np.savez(d / "weights.npz", **weights)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (4, 16))
    labels = np.roll(ids, -1, axis=1)        # no ignored label
    np.savez(d / "batch.npz", ids=ids, labels=labels)
    log_dir = str(d / "logs")
    threads, procs = _launch_nodes(WORKER, log_dir, "--max_restarts", "2",
                                   args=(str(d),))
    ref = _reference_full_batch(jm, ids, labels)
    for t in threads:
        t.join(TIMEOUT + 10)
    for rank in range(2):
        assert procs[rank].returncode == 0, (
            f"node {rank} rc={procs[rank].returncode}\n"
            f"stderr:{procs[rank].stderr}\nlog:{_log(log_dir, rank)}")
    got = [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return dict(log_dir=log_dir, got=got, arrays=arrays, ref=ref)


#: name -> (rank 0's value, rank 1's value)
COLLECTIVES = {
    "all_reduce_sum": ([3.0, 30.0], [3.0, 30.0]),
    "all_reduce_max": ([1.0], [1.0]),
    "all_reduce_min": ([0.0], [0.0]),
    "all_reduce_prod": ([6.0], [6.0]),
    "all_reduce_avg": ([1.5, 1.0], [1.5, 1.0]),
    # (1 + 4) / 2 and (-2 - 5) / 2, truncated toward zero
    "all_reduce_avg_int": ([2, -3], [2, -3]),
    "all_reduce_avg_async": ([1.5], [1.5]),
    "broadcast": ([100.0], [100.0]),
    "all_gather": ([0.0, 7.0], [0.0, 7.0]),
    "all_gather_object": ([[0, "x"], [1, "xx"]], [[0, "x"], [1, "xx"]]),
    "broadcast_object_list": (["from-0", "from-0"], ["from-0", "from-0"]),
    "all_to_all": ([0.0, 10.0], [1.0, 11.0]),
    "reduce_scatter": ([3.0], [11.0]),
    "reduce": ([3.0], [3.0]),
    "scatter": ([10.0], [20.0]),
    "gather": ([[5.0], [6.0]], []),
    "all_to_all_single": ([0.0, 1.0, 10.0, 11.0], [2.0, 3.0, 12.0, 13.0]),
    "all_to_all_single_splits": ("NotImplementedError",
                                 "NotImplementedError"),
    "send": ("NotImplementedError", "NotImplementedError"),
    "barrier": (True, True),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_values(two_ranks, name):
    for rank in range(2):
        assert two_ranks["got"][rank][name] == COLLECTIVES[name][rank], (
            name, rank)


def test_two_node_launch_on_localhost(two_ranks):
    """The reference's rendezvous test: both workers passed the store
    round through the trainers' store and the barrier."""
    for rank in range(2):
        log = _log(two_ranks["log_dir"], rank)
        assert f"worker {rank}/2 OK: saw rank{1 - rank}" in log


def test_multinode_coordinated_restart(two_ranks):
    """When one node's worker dies, both nodes restart at a bumped
    generation (rendezvous keys under its prefix) and finish there."""
    for rank in range(2):
        log = _log(two_ranks["log_dir"], rank)
        assert f"gen1 rank{rank} done" in log
        assert "gen0" not in log


def test_data_parallel_matches_the_reference_full_batch(two_ranks):
    ref, (a0, a1) = two_ranks["ref"], two_ranks["arrays"]
    losses = [(a0[f"loss/{s}"] + a1[f"loss/{s}"]) / 2 for s in range(STEPS)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=LOSS_TOL)
    assert losses[-1] < losses[0]
    for name, jg in ref["grads"][0].items():
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(a0[f"grad/{name}"], jg, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)
    covered = total = 0
    for name, jp in ref["params"].items():
        gj = np.stack([g[name] for g in ref["grads"]])
        keep = (np.abs(gj).min(0) > G_FLOOR) | (gj == 0).all(0)
        np.testing.assert_allclose(a0[f"param/{name}"][keep], jp[keep],
                                   rtol=0, atol=PARAM_TOL, err_msg=name)
        covered += int(keep.sum())
        total += keep.size
    assert covered >= 0.95 * total, (covered, total)


def test_ranks_end_bit_equal(two_ranks):
    a0, a1 = two_ranks["arrays"]
    assert sorted(a0) == sorted(a1)
    for key in a0:
        if key.startswith(("param/", "grad/")):
            np.testing.assert_array_equal(a0[key], a1[key], err_msg=key)


def test_reducer_buckets(two_ranks):
    """Several buckets: the first up to 0.02 MB, the rest up to 0.1 MB
    (a parameter larger than a bucket has one of its own), one fp32
    flat buffer each, the same on both ranks, covering every
    parameter."""
    a0, a1 = two_ranks["arrays"]
    np.testing.assert_array_equal(a0["buckets"], a1["buckets"])
    sizes = a0["buckets"].tolist()
    n_bytes = 4 * sum(v.size for k, v in a0.items()
                      if k.startswith("param/"))
    assert len(sizes) >= 3 and sum(sizes) == n_bytes, sizes


def test_restart_on_failure(tmp_path):
    """The watch loop restarts a crashing worker up to max_restarts."""
    marker = tmp_path / "attempt_count"
    script = tmp_path / "flaky.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        path = {str(marker)!r}
        n = int(open(path).read()) if os.path.exists(path) else 0
        open(path, "w").write(str(n + 1))
        sys.exit(0 if n >= 2 else 1)  # fail twice, succeed third
    """))
    rc = launch(str(script), [], nnodes=1, node_rank=0,
                log_dir=str(tmp_path / "logs"), max_restarts=3)
    assert rc == 0
    assert int(marker.read_text()) == 3


def test_restart_budget_exhausted(tmp_path):
    script = tmp_path / "alwaysfail.py"
    script.write_text("import sys; sys.exit(7)\n")
    rc = launch(str(script), [], nnodes=1, node_rank=0,
                log_dir=str(tmp_path / "logs"), max_restarts=1)
    assert rc == 7
