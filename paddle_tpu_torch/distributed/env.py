"""Distributed environment bring-up.

Counterpart of ``paddle_tpu/distributed/env.py`` (after Paddle's
``parallel.py`` ``init_parallel_env``: the TCPStore rendezvous, then
the process group). One process a rank, each with its own card
(``core/place.py``: the card unless ``set_device("cpu")``).

- Before ``init_parallel_env``, ``get_rank`` / ``get_world_size`` read
  ``PADDLE_TRAINER_ID`` / ``RANK`` and ``PADDLE_TRAINERS_NUM`` /
  ``WORLD_SIZE``, as the launcher sets them.
- ``init_parallel_env`` at world > 1: rank 0 hosts the ``TCPStore`` on
  ``PADDLE_MASTER`` (host:port; or ``MASTER_ADDR`` and ``MASTER_PORT``),
  every rank registers under the restart generation's prefix
  (``PADDLE_RESTART_GEN``, through ``torch.distributed.PrefixStore``, so
  a restarted world never meets keys of an earlier one) and waits for
  its peers, then ``torch.distributed.init_process_group`` runs on that
  prefixed store with ``timeout=stop_check_timeout``. At world 1 there
  is no TCP store, as in the reference: the group sits on a
  ``HashStore``.
- The backend is NCCL when the port's device is the card and gloo when
  it is the CPU. Nothing falls back from one to the other.
- ``barrier`` is the reference's counter rendezvous through the store,
  watched by the communication watchdog.
"""
from __future__ import annotations

import datetime
import os
import time

_initialized = False
_store = None          # the rendezvous store (world > 1), get_store()
_gen_store = None      # its view under the generation prefix
_barrier_epoch = 0
_key_prefix = "g0/"


def _env_int(*names, default=0):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return default


def get_rank(group=None) -> int:
    """This process's rank: in ``group`` (-1 outside it), else global."""
    if group is not None:
        return group.get_group_rank(get_rank())
    if _initialized:
        import torch.distributed as dist

        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if _initialized:
        import torch.distributed as dist

        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


def device_count() -> int:
    """Cards visible to this process."""
    from ..core.place import device_count as _count

    return _count()



def is_initialized() -> bool:
    return _initialized


def get_store():
    """The process's rendezvous store (the reference's global TCPStore).
    None before ``init_parallel_env`` and at world 1."""
    return _store


def _backend_for_device(device=None) -> str:
    from ..core.place import resolve_device

    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _timeout_s() -> float:
    from ..core.flags import get_flag

    return float(get_flag("stop_check_timeout"))


def init_parallel_env(strategy=None):
    """``paddle.distributed.init_parallel_env`` (module docstring).
    Returns the default group. A second call returns it again."""
    global _initialized, _store, _gen_store, _key_prefix
    if _initialized:
        return _default_group()
    import torch
    import torch.distributed as dist

    from ..core.place import resolve_device
    from .communication.watchdog import get_comm_task_manager
    from .store import _TorchStoreView, create_store

    dev = resolve_device(None)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    nprocs = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    timeout_s = _timeout_s()
    _key_prefix = f"g{os.environ.get('PADDLE_RESTART_GEN', '0')}/"
    if nprocs > 1:
        master = os.environ.get("PADDLE_MASTER") or os.environ.get(
            "MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if master and port and ":" not in master:
            master = f"{master}:{port}"
        if not master or ":" not in master:
            raise ValueError(
                f"init_parallel_env: a world of {nprocs} ranks needs "
                f"PADDLE_MASTER=host:port (or MASTER_ADDR and MASTER_PORT)")
        store = create_store(master, rank, nprocs, timeout_s=timeout_s)
        gen = _TorchStoreView(dist.PrefixStore(_key_prefix,
                                               store.torch_store), timeout_s)
        with get_comm_task_manager().task("rendezvous", timeout_s=timeout_s):
            gen.set(f"worker/{rank}", str(os.getpid()))
            gen.add("worker_count", 1)
            gen.wait([f"worker/{r}" for r in range(nprocs)])
        _store, _gen_store = store, gen
        pg_store = gen.torch_store
    else:
        pg_store = dist.HashStore()
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev       # the communicator comes up now
    dist.init_process_group(backend, store=pg_store, rank=rank,
                            world_size=nprocs,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    _initialized = True
    return _default_group()


def _default_group():
    from .communication.group import _get_or_create_default_group

    return _get_or_create_default_group()


def _shutdown():
    """Tear down what ``init_parallel_env`` made (the torch process
    groups and the store), so it can run again."""
    global _initialized, _store, _gen_store, _barrier_epoch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    if _store is not None:
        _store.close()
    _initialized, _store, _gen_store, _barrier_epoch = False, None, None, 0


def barrier(group=None):
    """``paddle.distributed.barrier``: every rank of the world adds to
    the epoch's counter in the store and waits for all of them (the
    reference's rendezvous), under the watchdog. A no-op at world 1."""
    global _barrier_epoch
    nprocs = get_world_size()
    if _gen_store is None or nprocs <= 1:
        return
    from .communication.watchdog import get_comm_task_manager

    _barrier_epoch += 1
    key = f"barrier/{_barrier_epoch}"
    deadline = _timeout_s()
    with get_comm_task_manager().task(f"barrier#{_barrier_epoch}",
                                      timeout_s=deadline):
        _gen_store.add(key, 1)
        t0 = time.time()
        while int(_gen_store.get(key)) < nprocs:
            if time.time() - t0 > deadline:
                raise TimeoutError("barrier timed out")
            time.sleep(0.01)


def get_backend(group=None) -> str:
    from .communication.group import get_backend as _gb

    return _gb(group)


__all__ = ["get_rank", "get_world_size", "device_count",
           "is_initialized", "get_store",
           "init_parallel_env", "barrier", "get_backend"]
