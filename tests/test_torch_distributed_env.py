"""The port's distributed runtime in one process
(paddle_tpu_torch/distributed/), against the reference's
(paddle_tpu/distributed/) on the same inputs.

- ``get_rank`` / ``get_world_size`` from the launcher's variables,
  ``ParallelEnv``, and ``gloo_init_parallel_env``'s validation (bad
  arguments raise before the environment is touched, as
  ``tests/test_distributed.py::TestGlooInitValidation`` holds the
  reference);
- ``InMemoryStore`` through both packages, and the port's ``TCPStore``
  (a server and a client in this process): set, get, add, wait and the
  ``TimeoutError`` of an expired wait;
- every collective in a gloo world of one (``world1``, made and
  destroyed around each test) equal to the reference's one-rank
  identity, value and dtype;
- the ``comm.collective_*`` series and their labels, the watchdog's
  four ``comm.*`` series and its ``watchdog_timeout`` flight dump,
  driven the same way through both packages
  (``tests/test_runtime_telemetry.py``'s cases);
- the refusals: point-to-point, the mesh-axis group, ``mesh=``, the
  names of later parts, the launcher options of part (f);
- ``DataParallel`` at world 1: gradients equal to the plain model's bit
  for bit, the passthrough surface, buckets, unused parameters.
"""
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.observability as jobs
from paddle_tpu.distributed.communication.watchdog import (
    CommTaskManager as JCommTaskManager)

import paddle_tpu_torch
import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.core import place
from paddle_tpu_torch.distributed.communication.watchdog import (
    CommTaskManager)
from paddle_tpu_torch.distributed.store import InMemoryStore, TCPStore

ENV_VARS = ("PADDLE_TRAINER_ID", "RANK", "PADDLE_TRAINERS_NUM",
            "WORLD_SIZE", "PADDLE_MASTER", "PADDLE_RESTART_GEN")


@pytest.fixture
def clean_env(monkeypatch):
    """The launcher's variables unset, and put back as they were after
    the test (set first, so that one a test sets is removed again)."""
    for k in ENV_VARS:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    return monkeypatch


@pytest.fixture
def world1(clean_env):
    """A gloo world of one rank on the CPU (``set_device("cpu")``'s
    choice, restored after)."""
    clean_env.setattr(place, "_expected", torch.device("cpu"))
    group = dist.init_parallel_env()
    yield group
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# environment
# --------------------------------------------------------------------------
@pytest.mark.parametrize("env, want", [
    ({}, (0, 1)),
    ({"PADDLE_TRAINER_ID": "3", "PADDLE_TRAINERS_NUM": "8"}, (3, 8)),
    ({"RANK": "1", "WORLD_SIZE": "2"}, (1, 2)),
    ({"PADDLE_TRAINER_ID": "2", "RANK": "5", "PADDLE_TRAINERS_NUM": "4",
      "WORLD_SIZE": "9"}, (2, 4)),
])
def test_rank_and_world_from_env_as_the_reference(clean_env, env, want):
    for k, v in env.items():
        clean_env.setenv(k, v)
    for pkg in (jdist, dist):
        assert (pkg.get_rank(), pkg.get_world_size()) == want
        pe = pkg.ParallelEnv()
        assert (pe.rank, pe.world_size, pe.nranks, pe.local_rank,
                pe.dev_id) == (want[0], want[1], want[1], want[0], want[0])


def test_gloo_init_validation_as_the_reference(clean_env):
    bad_j = paddle.to_tensor(np.random.rand(2, 3).astype("float32"))
    bad_t = torch.rand(2, 3)
    for pkg, t in ((jdist, bad_j), (dist, bad_t)):
        for bad in (dict(rank_id=0, rank_num=t, server_endpoint="h:1"),
                    dict(rank_id=t, rank_num=2, server_endpoint="h:1"),
                    dict(rank_id=0, rank_num=2, server_endpoint=t),
                    dict(rank_id=5, rank_num=2, server_endpoint="h:1"),
                    dict(rank_id=0, rank_num=0, server_endpoint="h:1")):
            with pytest.raises((TypeError, ValueError)):
                pkg.gloo_init_parallel_env(**bad)
            assert all(k not in os.environ for k in ENV_VARS), bad
    dist.gloo_init_parallel_env(1, 2, "127.0.0.1:1")
    assert (dist.get_rank(), dist.get_world_size()) == (1, 2)
    assert os.environ["PADDLE_MASTER"] == "127.0.0.1:1"


def test_stop_check_timeout_flag_as_the_reference():
    from paddle_tpu.core.flags import get_flag as jget

    from paddle_tpu_torch.core.flags import flags_scope, get_flag

    assert get_flag("stop_check_timeout") == jget("stop_check_timeout") \
        == 900
    with flags_scope(stop_check_timeout="12"):
        assert get_flag("stop_check_timeout") == 12
    assert get_flag("stop_check_timeout") == 900


def test_world1_bring_up(world1):
    assert dist.is_initialized() and torch.distributed.is_initialized()
    assert dist.get_backend() == "gloo" == dist.env.get_backend(world1)
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    assert (world1.rank, world1.ranks, world1.nranks, world1.id) == \
        (0, [0], 1, 0)
    assert world1.process_group is torch.distributed.group.WORLD
    assert dist.get_store() is None       # no TCP store at world 1
    assert dist.init_parallel_env() is world1
    dist.barrier()
    sub = dist.new_group([0])
    assert (sub.rank, sub.ranks, sub.is_member()) == (0, [0], True)
    assert sub.process_group is not None and dist.get_group(sub.id) is sub
    dist.destroy_process_group(sub)


def test_group_rank_outside_and_inside(clean_env):
    from paddle_tpu_torch.distributed.communication.group import Group

    g = Group(-1, 5, [1, 2])
    assert (g.rank, g.is_member(), g.get_group_rank(2),
            g.get_group_rank(0)) == (-1, False, 1, -1)
    clean_env.setenv("PADDLE_TRAINER_ID", "2")
    clean_env.setenv("PADDLE_TRAINERS_NUM", "4")
    h = dist.new_group([2, 3])
    assert (h.rank, h.nranks, h.process_group) == (0, 2, None)
    assert dist.get_rank(h) == 0 and dist.get_world_size(h) == 2


def test_world_size_2_needs_a_master(clean_env):
    clean_env.setattr(place, "_expected", torch.device("cpu"))
    clean_env.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(ValueError, match="PADDLE_MASTER"):
        dist.init_parallel_env()
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# stores
# --------------------------------------------------------------------------
def _store_round(store, other):
    """The same operations through a store and, where given, a second
    handle on it; what they returned."""
    got = []
    store.set("k", "v1")
    got.append(other.get("k"))
    store.set("b", b"\x00raw")
    got.append(other.get("b", timeout_s=1.0))
    got.append(store.add("n", 2))
    got.append(other.add("n", 5))
    got.append(other.add("n", -1))
    store.wait(["k", "n"], timeout_s=1.0)
    t0 = time.time()
    with pytest.raises(TimeoutError):
        other.get("missing", timeout_s=0.2)
    got.append(time.time() - t0 >= 0.15)
    with pytest.raises(TimeoutError):
        store.wait(["k", "missing"], timeout_s=0.2)
    return got


def test_in_memory_store_as_the_reference():
    from paddle_tpu.distributed.store import InMemoryStore as JStore

    a, b = JStore(), InMemoryStore()
    assert _store_round(b, b) == _store_round(a, a) == \
        [b"v1", b"\x00raw", 2, 7, 6, True]


def test_tcp_store_server_and_client():
    server = TCPStore("127.0.0.1", 0, is_master=True, timeout_s=5)
    client = TCPStore("127.0.0.1", server.port, timeout_s=5)
    try:
        assert _store_round(server, client) == \
            [b"v1", b"\x00raw", 2, 7, 6, True]
        with pytest.raises(TimeoutError):        # a look, not a wait
            client.get("missing", timeout_s=0)
        assert client.get("k", timeout_s=0) == b"v1"
    finally:
        client.close()
        server.close()


def test_create_store_never_falls_back():
    assert isinstance(dist.create_store(None, 0, 4), InMemoryStore)
    assert isinstance(dist.create_store("127.0.0.1:1", 0, 1), InMemoryStore)
    s = dist.create_store("127.0.0.1:0", 0, 2, timeout_s=5)
    assert isinstance(s, TCPStore) and s.is_master and s.port > 0
    s.close()
    with pytest.raises(Exception):       # no server there: it raises
        dist.create_store("127.0.0.1:1", 1, 2, timeout_s=0.5)


# --------------------------------------------------------------------------
# collectives at world 1
# --------------------------------------------------------------------------
def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _run(pkg, name, arrays, to_tensor, value_of):
    """One collective through one package at one rank; what it left, as
    numpy arrays (or objects)."""
    t = [to_tensor(a) for a in arrays]
    if name.startswith("all_reduce_"):
        op = getattr(pkg.ReduceOp, name.rsplit("_", 1)[1].upper())
        pkg.all_reduce(t[0], op=op)
        return [value_of(t[0])]
    if name == "reduce":
        pkg.reduce(t[0], dst=0)
        return [value_of(t[0])]
    if name == "broadcast":
        pkg.broadcast(t[0], src=0)
        return [value_of(t[0])]
    if name == "all_gather":
        out = []
        pkg.all_gather(out, t[0])
        return [value_of(o) for o in out]
    if name == "all_to_all":
        out = []
        pkg.all_to_all(out, t)
        return [value_of(o) for o in out]
    if name == "all_to_all_single":
        pkg.all_to_all_single(t[1], t[0])
        return [value_of(t[1])]
    if name == "reduce_scatter":
        pkg.reduce_scatter(t[2], t[:2])
        return [value_of(t[2])]
    if name == "scatter":
        pkg.scatter(t[1], [t[0]], src=0)
        return [value_of(t[1])]
    if name == "gather":
        out = []
        pkg.gather(t[0], out, dst=0)
        return [value_of(o) for o in out]
    if name == "all_gather_object":
        out = []
        pkg.all_gather_object(out, {"a": 1, "b": [2, 3]})
        return out
    if name == "broadcast_object_list":
        objs = ["x", {"y": 1}]
        pkg.broadcast_object_list(objs, src=0)
        return objs
    raise KeyError(name)


WORLD1_CASES = {
    **{f"all_reduce_{op}": [(3, 4)]
       for op in ("sum", "max", "min", "prod", "avg")},
    "reduce": [(5,)], "broadcast": [(2, 3)], "all_gather": [(4,)],
    "all_to_all": [(3,), (3,)], "all_to_all_single": [(4, 2), (4, 2)],
    "reduce_scatter": [(2, 3), (1, 3), (2, 3)], "scatter": [(3,), (3,)],
    "gather": [(2, 2)], "all_gather_object": [],
    "broadcast_object_list": [],
}


@pytest.mark.parametrize("name", sorted(WORLD1_CASES))
def test_world1_collective_is_the_reference_identity(world1, name):
    rng = np.random.default_rng(len(name))
    arrays = [_f32(rng, *s) for s in WORLD1_CASES[name]]
    want = _run(jdist, name, arrays, paddle.to_tensor,
                lambda t: np.asarray(t._value))
    got = _run(dist, name, arrays, torch.from_numpy,
               lambda t: t.detach().numpy())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_world1_integer_avg_and_async(world1):
    t = torch.tensor([7, -7], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.AVG)
    assert t.tolist() == [7, -7]
    f = torch.tensor([1.5])
    task = dist.all_reduce(f, sync_op=False)
    assert task.wait() and task.is_completed() and f.tolist() == [1.5]


def test_collectives_without_a_group_are_the_identity(clean_env):
    """Before ``init_parallel_env`` there is no process group: a
    one-rank world, as the reference's."""
    t = torch.tensor([1.0, 2.0])
    assert dist.all_reduce(t) is t and t.tolist() == [1.0, 2.0]
    out = []
    dist.all_gather(out, t)
    assert len(out) == 1 and out[0].tolist() == [1.0, 2.0]
    dist.barrier()


@pytest.mark.parametrize("name", ["send", "recv", "isend", "irecv"])
def test_point_to_point_raises_as_the_reference(name):
    for pkg in (jdist, dist):
        with pytest.raises(NotImplementedError):
            getattr(pkg, name)(None, 0)
    with pytest.raises(NotImplementedError, match=r"item 4 \(e\)"):
        getattr(dist, name)(torch.zeros(1), 0)


def test_batch_isend_irecv_raises_as_the_reference():
    for pkg in (jdist, dist):
        with pytest.raises(NotImplementedError):
            pkg.batch_isend_irecv([])


@pytest.mark.parametrize("call", [
    lambda: dist.split(None, (4, 4), "linear"),
    lambda: dist.DistAttr(None, []),
    lambda: dist.shard_scaler(None),
    lambda: dist.communication.group.axis_group(None, "dp"),
    lambda: dist.communication.psum(None, "dp"),
    lambda: dist.DataParallel(torch.nn.Linear(2, 2), mesh=object()),
], ids=["split", "DistAttr", "shard_scaler", "axis_group", "psum",
        "DataParallel_mesh"])
def test_later_parts_raise_naming_part_b(call):
    with pytest.raises(NotImplementedError, match=r"item 4 \(b\)"):
        call()


def test_all_to_all_single_splits_over_two_ranks_raise(clean_env):
    clean_env.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(NotImplementedError, match="split"):
        dist.all_to_all_single(torch.zeros(2), torch.zeros(2), [1, 1],
                               [1, 1])


def test_scatter_object_list_as_the_reference(clean_env):
    for pkg in (jdist, dist):
        out = []
        pkg.scatter_object_list(out, ["a", "b"])
        assert out == ["a", "b"]
        with pytest.raises(ValueError):
            pkg.scatter_object_list([], None)


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------
@pytest.fixture
def both_on():
    for pkg in (jobs, obs):
        pkg.reset()
        pkg.enable()
    yield
    for pkg in (jobs, obs):
        pkg.disable()
        pkg.reset()


def _drive_collectives(pkg, dpkg, ones, group_cls):
    dpkg.all_reduce(ones([4, 4]))
    out = []
    dpkg.all_gather(out, ones([2, 2]))
    dpkg.all_reduce(ones([2]), group=group_cls(0, 7, [0, 1],
                                               axis_name="tp"))
    dpkg.broadcast(ones([3]), src=0)
    g = pkg.registry.get
    calls, nbytes, secs = (g("comm.collective_calls"),
                           g("comm.collective_bytes"),
                           g("comm.collective_seconds"))
    labels = [("all_reduce", "world"), ("all_gather", "world"),
              ("all_reduce", "tp"), ("broadcast", "world")]
    evs = [(e.fields["op"], e.fields["group"], e.fields["bytes"])
           for e in pkg.events("comm.collective")]
    return dict(
        calls=[calls.value(op=o, group=gr) for o, gr in labels],
        bytes=[nbytes.value(op=o, group=gr) for o, gr in labels],
        counts=[secs.stats(op=o, group=gr)["count"] for o, gr in labels],
        events=evs)


def test_collective_series_and_labels_as_the_reference(both_on):
    from paddle_tpu.distributed.communication.group import Group as JGroup

    from paddle_tpu_torch.distributed.communication.group import Group

    want = _drive_collectives(jobs, jdist, paddle.ones, JGroup)
    got = _drive_collectives(obs, dist, torch.ones, Group)
    assert got == want
    assert got["calls"] == [1, 1, 1, 1]
    assert got["bytes"] == [64, 16, 8, 12]


def test_disabled_records_nothing():
    for pkg, dpkg, ones in ((jobs, jdist, paddle.ones),
                            (obs, dist, torch.ones)):
        pkg.reset()
        pkg.disable()
        dpkg.all_reduce(ones([2]))
        assert pkg.registry.get("comm.collective_calls").total() == 0


def _overdue(pkg, manager_cls, flight_dir):
    """The reference test's overdue task: what the registry, the events
    and the one flight dump say."""
    m = manager_cls(scan_interval_s=0.02)

    def dumps():
        if not os.path.isdir(flight_dir):
            return []
        return [f for f in os.listdir(flight_dir)
                if f.startswith("flight-") and f.endswith(".json")]

    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tid = m.start_task("probe_rendezvous", timeout_s=0.01)
            deadline = time.time() + 5.0
            while not dumps() and time.time() < deadline:
                time.sleep(0.02)
            m.end_task(tid)
        with m.task("probe_clean", timeout_s=60.0):
            pass
        g = pkg.registry.get
        (ev,) = pkg.events("comm.task_overdue")
        (f,) = dumps()
        d = json.loads(open(os.path.join(flight_dir, f)).read())
        return dict(
            overdue=g("comm.task_overdue").value(name="probe_rendezvous"),
            started=g("comm.tasks_started").value(name="probe_rendezvous"),
            seconds=g("comm.task_seconds").stats(
                name="probe_rendezvous")["count"],
            clean=(g("comm.task_seconds").stats(name="probe_clean")["count"],
                   g("comm.task_overdue").value(name="probe_clean")),
            scans=g("comm.watchdog_scans").total() >= 1,
            warned=any("probe_rendezvous" in str(x.message) for x in w),
            event=(ev.fields["name"], ev.fields["timeout_s"]),
            dump=(d["reason"], d["exception"]["type"],
                  any(e["kind"] == "comm.task_overdue" for e in d["events"]),
                  "device_memory" in d))
    finally:
        m.shutdown()


def test_watchdog_series_and_dump_as_the_reference(both_on, tmp_path,
                                                   monkeypatch):
    out = {}
    for name, pkg, cls in (("ref", jobs, JCommTaskManager),
                           ("port", obs, CommTaskManager)):
        d = str(tmp_path / name)
        monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", d)
        out[name] = _overdue(pkg, cls, d)
    assert out["port"] == out["ref"]
    assert out["port"]["dump"] == ("watchdog_timeout", "TimeoutError", True,
                                   True)
    assert out["port"]["overdue"] == out["port"]["started"] == 1


def test_barrier_registers_a_watchdog_task(both_on, clean_env):
    """A barrier over two ranks waits under the watchdog
    (``barrier#<epoch>``); here the second rank is this process's own
    second add on the store."""
    from paddle_tpu_torch.distributed import env

    server = TCPStore("127.0.0.1", 0, is_master=True, timeout_s=5)
    try:
        gen = dist.store._TorchStoreView(
            torch.distributed.PrefixStore("g0/", server.torch_store), 5)
        clean_env.setattr(env, "_gen_store", gen)
        clean_env.setattr(env, "_barrier_epoch", 0)
        clean_env.setenv("PADDLE_TRAINERS_NUM", "2")
        gen.add("barrier/1", 1)               # the peer arrived first
        env.barrier()
        assert obs.registry.get("comm.tasks_started").value(
            name="barrier#1") == 1
        assert int(gen.get("barrier/1")) == 2
    finally:
        server.close()


# --------------------------------------------------------------------------
# launcher
# --------------------------------------------------------------------------
def test_rank_dump_path_as_the_reference():
    from paddle_tpu.observability.fleet import rank_dump_path as jpath

    from paddle_tpu_torch.distributed.launch_utils import rank_dump_path

    for p in ("m.json", "/a/b/metrics.JSON", "dump", "x.txt"):
        assert rank_dump_path(p, 3) == jpath(p, 3)


@pytest.mark.parametrize("argv", [
    ["--fleet_dir", "f", "t.py"],
    ["--chaos_kill_rank", "1", "--chaos_kill_step", "2", "t.py"],
    ["--chaos_slow_rank", "0", "t.py"],
    ["--nnodes", "1:2", "t.py"],
], ids=["fleet_dir", "chaos_kill", "chaos_slow", "elastic"])
def test_launcher_options_of_part_f_raise(argv):
    from paddle_tpu_torch.distributed.launch.__main__ import main

    with pytest.raises(NotImplementedError, match=r"item 4 \(f\)"):
        main(argv)


def test_spawn_as_the_reference(world1):
    for pkg in (jdist, dist):
        with pytest.raises(ValueError, match="nprocs"):
            pkg.spawn(print, nprocs=2)
    seen = []
    dist.spawn(lambda a: seen.append((a, dist.get_world_size())), args=(5,))
    assert seen == [(5, 1)]


def test_metrics_dump_is_rewritten_per_rank(tmp_path):
    from paddle_tpu_torch.distributed.launch_utils import (
        CollectiveController)

    c = CollectiveController("t.py", [], nnodes=2, node_rank=1,
                             master="127.0.0.1:7000",
                             log_dir=str(tmp_path), flight_dir="fd",
                             metrics_dump=str(tmp_path / "m.json"))
    env = c._build_pod().containers[0].env_vars
    assert env["PADDLE_TPU_METRICS_DUMP"] == str(tmp_path / "m.rank1.json")
    assert env["PADDLE_MASTER"] == "127.0.0.1:7002"
    assert (env["PADDLE_TRAINERS_NUM"], env["PADDLE_TRAINER_ID"],
            env["PADDLE_TPU_FLIGHT_DIR"]) == ("2", "1", "fd")


# --------------------------------------------------------------------------
# DataParallel at world 1
# --------------------------------------------------------------------------
def _mlp(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 3))


def test_data_parallel_world1_equals_the_plain_model(world1):
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
    plain, wrapped = _mlp(), _mlp()
    dp = paddle_tpu_torch.DataParallel(wrapped, comm_buffer_size_MB=0.001,
                                       last_comm_buffer_size_MB=0.0005)
    assert [n for n, _, _ in dp.buckets] and len(dp.buckets) >= 3
    assert sum(nb for _, _, nb in dp.buckets) == 4 * sum(
        p.numel() for p in plain.parameters())
    opt_p = paddle_tpu_torch.optimizer.AdamW(
        learning_rate=1e-2, parameters=plain.parameters())
    opt_w = paddle_tpu_torch.optimizer.AdamW(
        learning_rate=1e-2, parameters=dp.parameters())
    for _ in range(3):
        plain(x).pow(2).mean().backward()
        dp.scale_loss(dp(x).pow(2).mean()).backward()
        dp.apply_collective_grads()
        for a, b in zip(plain.parameters(), dp.parameters()):
            assert torch.equal(a.grad, b.grad)
        opt_p.step()
        opt_p.clear_grad()
        opt_w.step()
        opt_w.clear_grad(set_to_zero=True)   # gradients kept as views
    for a, b in zip(plain.parameters(), dp.parameters()):
        assert torch.equal(a, b)
    assert list(dp.state_dict()) == list(wrapped.state_dict())
    assert [n for n, _ in dp.named_parameters()] == \
        [n for n, _ in wrapped.named_parameters()]
    dp.set_state_dict(plain.state_dict())


def test_data_parallel_unused_parameters(world1):
    class TwoHeads(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Linear(3, 3)
            self.b = torch.nn.Linear(3, 3)

        def forward(self, x):
            return self.a(x)

    x = torch.ones(2, 3)
    dp = dist.DataParallel(TwoHeads(), find_unused_parameters=True)
    dp(x).sum().backward()
    assert torch.equal(dp._layers.b.weight.grad, torch.zeros(3, 3))
    strict = dist.DataParallel(TwoHeads())
    with pytest.raises(RuntimeError, match="find_unused_parameters"):
        strict(x).sum().backward()


def test_data_parallel_without_a_group_reduces_nothing(clean_env):
    m = _mlp()
    dp = dist.DataParallel(m)
    assert dp.buckets == [] and dp._reducer is None
    dp(torch.ones(2, 6)).sum().backward()
    assert all(p.grad is not None for p in m.parameters())
