"""Communication groups.

Counterpart of ``paddle_tpu/distributed/communication/group.py``. A
:class:`Group` names a set of global ranks and wraps the
``torch.distributed`` process group the collectives run on (NCCL on the
card, gloo on the CPU; ``env.init_parallel_env`` chooses). Before
``init_parallel_env`` the default group is the world of
``get_world_size()`` ranks with no process group, and every collective
over it is the identity of a one-rank world.

What differs from the reference, where a group names mesh devices in
one process: the default group has ``world_size`` ranks (the
reference's has one a device); ``Group.rank`` is this process's rank in
the group and -1 outside it (the reference's is always 0 and its
``is_member`` always True); ``get_backend`` names the torch backend.
Groups over one axis of a mesh (``axis_group``) wait for ROADMAP queue
A item 4 (b).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["Group", "new_group", "get_group", "axis_group",
           "is_initialized", "destroy_process_group", "get_backend"]


class Group:
    """Global ranks ``ranks`` with this process at ``rank_in_group`` (-1
    outside), over the torch process group ``process_group`` (None
    before ``init_parallel_env``)."""

    def __init__(self, rank_in_group: int, group_id: int, ranks: List[int],
                 mesh=None, axis_name: Optional[str] = None,
                 process_group=None):
        self._rank_in_group = rank_in_group
        self._id = group_id
        self._ranks = list(ranks)
        self.mesh = mesh
        self.axis_name = axis_name
        self._pg = process_group

    @property
    def rank(self) -> int:
        return self._rank_in_group

    @property
    def ranks(self) -> List[int]:
        return self._ranks

    @property
    def nranks(self) -> int:
        return len(self._ranks)

    world_size = nranks

    @property
    def id(self) -> int:
        return self._id

    @property
    def process_group(self):
        """The torch process group (None before ``init_parallel_env``)."""
        return self._pg

    def get_group_rank(self, rank: int) -> int:
        return self._ranks.index(rank) if rank in self._ranks else -1

    def is_member(self) -> bool:
        return self._rank_in_group >= 0

    def __repr__(self):
        return (f"Group(id={self._id}, ranks={self._ranks}, "
                f"rank={self._rank_in_group})")


_groups: dict = {}
_group_counter = [0]


def _torch_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _get_or_create_default_group() -> Group:
    """The world's group over the default process group; before
    ``init_parallel_env``, the launcher's world as the environment says
    now, with no process group (not kept)."""
    if not _torch_initialized():
        from .. import env

        return Group(env.get_rank(), 0, list(range(env.get_world_size())))
    if 0 not in _groups:
        import torch.distributed as dist

        _groups[0] = Group(dist.get_rank(), 0,
                           list(range(dist.get_world_size())),
                           process_group=dist.group.WORLD)
    return _groups[0]


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout=None) -> Group:
    """``paddle.distributed.new_group``: a group of global ``ranks`` (all
    of them by default). After ``init_parallel_env`` it makes a torch
    process group, which every rank of the world must call for, members
    or not, in the same order (torch's rule for ``new_group``)."""
    from .. import env

    _group_counter[0] += 1
    gid = _group_counter[0]
    world = env.get_world_size()
    ranks = list(range(world)) if ranks is None else sorted(
        int(r) for r in ranks)
    pg = None
    if _torch_initialized():
        import datetime

        import torch.distributed as dist

        kw = {} if timeout is None else dict(
            timeout=datetime.timedelta(seconds=float(timeout)))
        pg = dist.new_group(ranks, backend=backend, **kw)
    g = Group(ranks.index(env.get_rank()) if env.get_rank() in ranks
              else -1, gid, ranks, process_group=pg)
    _groups[gid] = g
    return g


def get_group(gid: int = 0) -> Group:
    return _groups.get(gid) or _get_or_create_default_group()


def axis_group(mesh, axis_name: str) -> Group:
    raise NotImplementedError(
        "axis_group: groups over a mesh axis come with placements and "
        "model parallelism (ROADMAP.md queue A item 4 (b))")


def is_initialized() -> bool:
    from .. import env

    return env.is_initialized()


def destroy_process_group(group=None):
    """``group`` None: every group, the torch process groups and the
    environment ``init_parallel_env`` set up (so it can run again);
    otherwise that group alone."""
    if group is None:
        _groups.clear()
        from .. import env

        env._shutdown()
        return
    _groups.pop(group.id, None)
    if group.process_group is not None and group.is_member() \
            and _torch_initialized():
        import torch.distributed as dist

        if group.process_group is not dist.group.WORLD:
            dist.destroy_process_group(group.process_group)


def get_backend(group=None) -> str:
    """``"nccl"`` or ``"gloo"``: the group's backend after
    ``init_parallel_env``, else the one it would choose."""
    pg = (group or _get_or_create_default_group()).process_group
    if pg is not None:
        import torch.distributed as dist

        return str(dist.get_backend(pg))
    from .. import env

    return env._backend_for_device()
