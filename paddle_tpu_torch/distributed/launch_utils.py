"""The launcher: ``launch`` (and ``python -m
paddle_tpu_torch.distributed.launch``) and ``spawn``.

Counterpart of ``paddle_tpu/distributed/launch_utils.py`` (after
Paddle's ``launch/``: the controller builds a pod of worker processes,
sets their environment, runs the master rendezvous and watches them).
As in the reference a node runs one worker (``Pod`` of one
``Container``) and a job of N nodes runs N launchers, each given
``--nnodes N --node_rank R --master host:port``:

- the node-0 launcher hosts the launcher store on ``port``, every
  launcher registers there and waits for the others;
- each worker gets ``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``,
  ``PADDLE_JOB_ID`` and ``PADDLE_MASTER`` = ``host:port + 2``, where its
  rank 0 hosts the trainers' store (``init_parallel_env``);
- the watch loop restarts a failed worker up to ``max_restarts`` times,
  and a collective job restarts whole: the failed node's launcher bumps
  the shared generation counter, every launcher stops its healthy worker
  and starts it again at the new generation (``PADDLE_RESTART_GEN``,
  which prefixes the workers' rendezvous keys);
- ``flight_dir`` arms the flight recorder in every worker
  (``PADDLE_TPU_FLIGHT_DIR``); ``metrics_dump`` (or an inherited
  ``PADDLE_TPU_METRICS_DUMP``) is rewritten per rank as
  ``<base>.rank<N>.json``.

Fleet telemetry (``fleet_dir``), the chaos options and elastic ``--nnodes
min:max`` wait for ROADMAP queue A item 4 (f) and raise. The reference's
peer-exit code (exit 23 from a surviving elastic worker, whose launcher
waits for the failed node's bump) comes with elastic training too; here
every failure bumps the generation.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

def _part_f(what):
    raise NotImplementedError(
        f"{what} comes with elastic training and fleet telemetry "
        f"(ROADMAP.md queue A item 4 (f))")


def rank_dump_path(path: str, rank: int) -> str:
    """Per-rank metrics dump path: ``metrics.json`` ->
    ``metrics.rank<N>.json`` (the port's copy of the reference's
    ``observability/fleet.py`` helper)."""
    root, ext = os.path.splitext(path)
    if ext.lower() == ".json":
        return f"{root}.rank{rank}{ext}"
    return f"{path}.rank{rank}"


def spawn(func: Callable, args=(), nprocs: int = 1, join: bool = True,
          daemon: bool = False, **options):
    """``paddle.distributed.spawn``: as in the reference, one process a
    node, so ``nprocs`` is 1 and ``func`` runs here after
    ``init_parallel_env``; a job of several ranks goes through the
    launcher on each node."""
    if nprocs not in (1, None):
        raise ValueError(
            "spawn(nprocs>1) is not supported: one process runs a node "
            "(use python -m paddle_tpu_torch.distributed.launch with "
            "--nnodes for several ranks)")
    from . import env

    env.init_parallel_env()
    func(*args)


class Container:
    """One worker OS process."""

    def __init__(self, cmd: List[str], env_vars: dict,
                 log_path: Optional[str]):
        self.cmd = cmd
        self.env_vars = env_vars
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0

    def start(self):
        out = open(self.log_path, "ab") if self.log_path else None
        try:
            self.proc = subprocess.Popen(
                self.cmd, env={**os.environ, **self.env_vars}, stdout=out,
                stderr=subprocess.STDOUT if out else None)
        finally:
            if out is not None:
                out.close()

    def poll(self):
        return None if self.proc is None else self.proc.poll()

    def wait(self, timeout=None):
        return self.proc.wait(timeout)

    def terminate(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class Pod:
    """This node's containers: one."""

    def __init__(self, container: Container):
        self.containers = [container]

    def deploy(self):
        for c in self.containers:
            c.start()

    def join(self):
        return max(c.wait() for c in self.containers)

    def stop(self):
        for c in self.containers:
            c.terminate()


class CollectiveController:
    """Builds the pod's environment, runs the launcher rendezvous,
    deploys and watches (module docstring)."""

    def __init__(self, training_script: str, args: List[str],
                 nnodes: int = 1, node_rank: int = 0,
                 master: Optional[str] = None, log_dir: str = "log",
                 max_restarts: int = 0, job_id: str = "default",
                 flight_dir: Optional[str] = None,
                 fleet_dir: Optional[str] = None,
                 metrics_dump: Optional[str] = None):
        if fleet_dir:
            _part_f("fleet telemetry (fleet_dir)")
        self.training_script = training_script
        self.args = list(args)
        self.nnodes = nnodes
        self.node_rank = node_rank
        self.master = master
        self.log_dir = log_dir
        self.max_restarts = max_restarts
        self.job_id = job_id
        self.flight_dir = flight_dir
        self.metrics_dump = metrics_dump
        self._store = None

    def _rendezvous(self):
        if self.nnodes <= 1 or self.master is None:
            return
        from .store import create_store

        self._store = create_store(self.master, self.node_rank, self.nnodes)
        self._store.set(f"launch/{self.job_id}/node/{self.node_rank}",
                        f"{os.getpid()}")
        self._store.wait(
            [f"launch/{self.job_id}/node/{r}" for r in range(self.nnodes)])

    def _build_pod(self) -> Pod:
        env_vars = {
            "PADDLE_TRAINERS_NUM": str(self.nnodes),
            "PADDLE_TRAINER_ID": str(self.node_rank),
            "PADDLE_JOB_ID": self.job_id,
        }
        if self.master:
            # the launcher's store owns `port`; the trainers' on port + 2
            host, port = self.master.rsplit(":", 1)
            env_vars["PADDLE_MASTER"] = f"{host}:{int(port) + 2}"
        if self.flight_dir:
            env_vars["PADDLE_TPU_FLIGHT_DIR"] = self.flight_dir
        metrics_dump = self.metrics_dump \
            or os.environ.get("PADDLE_TPU_METRICS_DUMP")
        if metrics_dump:
            env_vars["PADDLE_TPU_METRICS_DUMP"] = rank_dump_path(
                metrics_dump, self.node_rank)
        os.makedirs(self.log_dir, exist_ok=True)
        cmd = [sys.executable, self.training_script] + self.args
        log = os.path.join(self.log_dir, f"workerlog.{self.node_rank}")
        return Pod(Container(cmd, env_vars, log))

    def _gen_key(self):
        return f"launch/{self.job_id}/generation"

    def _peer_generation(self) -> int:
        if self._store is None:
            return 0
        try:
            return int(self._store.get(self._gen_key(), timeout_s=0))
        except (TimeoutError, RuntimeError):
            return 0    # no bump yet, or the master's store is gone

    def run(self) -> int:
        """The watch loop (module docstring). Returns the job's exit
        code: 0, or the failing worker's code once the restarts are
        spent."""
        self._rendezvous()
        pod = self._build_pod()
        container = pod.containers[0]
        generation = self._peer_generation()
        container.env_vars["PADDLE_RESTART_GEN"] = str(generation)
        container.start()
        try:
            while True:
                rc = container.poll()
                if rc is None:
                    peer_gen = self._peer_generation()
                    if peer_gen > generation:
                        container.terminate()
                        generation = peer_gen
                        container.restarts += 1
                        if container.restarts > self.max_restarts:
                            self._finalize(1)
                            return 1
                        container.env_vars["PADDLE_RESTART_GEN"] = \
                            str(generation)
                        container.start()
                    time.sleep(0.5)
                    continue
                if rc == 0:
                    self._finalize(0)
                    return 0
                container.restarts += 1
                if container.restarts > self.max_restarts:
                    self._finalize(rc)
                    return rc
                time.sleep(1)
                if self._store is not None:
                    # every other node restarts at the next generation
                    generation = self._store.add(self._gen_key(), 1)
                else:
                    generation += 1
                container.env_vars["PADDLE_RESTART_GEN"] = str(generation)
                container.start()
        finally:
            container.terminate()

    def _finalize(self, rc: int):
        if self._store is None:
            return
        try:
            self._store.set(f"launch/{self.job_id}/done/{self.node_rank}",
                            str(rc))
            if self.node_rank == 0:
                # the master hosts the store: keep it up until every
                # node reported (or a grace timeout)
                self._store.wait(
                    [f"launch/{self.job_id}/done/{r}"
                     for r in range(self.nnodes)], timeout_s=60)
        except (TimeoutError, RuntimeError):
            pass    # a vanished master must not fail the job
        finally:
            self._store.close()


def launch(training_script: str, args: List[str], nnodes: int = 1,
           node_rank: int = 0, master: Optional[str] = None,
           log_dir: str = "log", max_restarts: int = 0,
           job_id: str = "default", flight_dir: Optional[str] = None,
           fleet_dir: Optional[str] = None,
           metrics_dump: Optional[str] = None):
    """Run ``training_script`` as this node's worker and watch it
    (module docstring; the CLI is ``python -m
    paddle_tpu_torch.distributed.launch``)."""
    return CollectiveController(
        training_script, args, nnodes, node_rank, master, log_dir,
        max_restarts, job_id, flight_dir, fleet_dir, metrics_dump,
    ).run()
