"""The hybrid-parallel topology: ``CommunicateTopology`` and
``HybridCommunicateGroup``.

Counterpart of ``paddle_tpu/distributed/fleet/topology.py`` (Paddle's
``fleet/base/topology.py``). The topology is a ``ProcessMesh`` with the
axes ``pp, dp, sharding, sep, mp`` over the world's ranks (rank
``r`` at the ``r``-th position of the grid, mp fastest, as in Paddle);
each axis's communicate group is this rank's line along it
(``communication.group.axis_group``), and the ranks and sizes are this
process's, where the reference, one process over a device mesh, reports
rank 0 on every axis.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..auto_parallel.placement import ProcessMesh
from ..communication.group import Group, axis_group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "set_hybrid_communicate_group", "get_hybrid_communicate_group",
           "HYBRID_ORDER"]

# Paddle's hybrid order (topology.py:188)
HYBRID_ORDER = ["pp", "dp", "sharding", "sep", "mp"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(hybrid_group_names or HYBRID_ORDER)
        self._dims = list(dims or [1] * len(self._parallel_names))
        self._world = np.arange(int(np.prod(self._dims))).reshape(self._dims)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(self._world.size)

    def get_rank(self, **kwargs):
        coord = [kwargs[n] for n in self._parallel_names]
        return int(self._world[tuple(coord)])

    def get_coord(self, rank):
        return tuple(int(c) for c in np.argwhere(self._world == rank)[0])

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return sorted(self._world[tuple(sl)].reshape(-1).tolist())

    def get_comm_list(self, axis_name):
        axis = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._world, axis, -1)
        return moved.reshape(-1, self._dims[axis]).tolist()


class HybridCommunicateGroup:
    """The mesh of a topology over the world and a group per axis. The
    topology must cover the world exactly."""

    def __init__(self, topology: CommunicateTopology):
        from .. import env

        self._topo = topology
        names = topology.get_hybrid_group_names()
        dims = [topology.get_dim(n) for n in names]
        n_needed = int(np.prod(dims))
        world = env.get_world_size()
        if n_needed != world:
            raise ValueError(
                f"hybrid topology {dict(zip(names, dims))} needs {n_needed} "
                f"rank(s), the world has {world}")
        self._mesh = ProcessMesh(np.arange(n_needed).reshape(dims), names)
        self._groups: Dict[str, Group] = {
            n: axis_group(self._mesh, n) for n in names}
        self.global_rank = env.get_rank()
        self._coord = dict(zip(names, topology.get_coord(self.global_rank)))

    @property
    def topology(self):
        return self._topo

    @property
    def mesh(self) -> ProcessMesh:
        return self._mesh

    def _size(self, name) -> int:
        names = self._topo.get_hybrid_group_names()
        return self._topo.get_dim(name) if name in names else 1

    def get_global_rank(self) -> int:
        return self.global_rank

    # world sizes
    def get_model_parallel_world_size(self) -> int:
        return self._size("mp")

    def get_data_parallel_world_size(self) -> int:
        return self._size("dp")

    def get_pipe_parallel_world_size(self) -> int:
        return self._size("pp")

    def get_sharding_parallel_world_size(self) -> int:
        return self._size("sharding")

    def get_sep_parallel_world_size(self) -> int:
        return self._size("sep")

    # this process's ranks
    def get_model_parallel_rank(self) -> int:
        return self._coord.get("mp", 0)

    def get_data_parallel_rank(self) -> int:
        return self._coord.get("dp", 0)

    def get_stage_id(self) -> int:
        return self._coord.get("pp", 0)

    def get_sharding_parallel_rank(self) -> int:
        return self._coord.get("sharding", 0)

    def get_sep_parallel_rank(self) -> int:
        return self._coord.get("sep", 0)

    # groups
    def get_model_parallel_group(self) -> Group:
        return self._groups["mp"]

    def get_data_parallel_group(self) -> Group:
        return self._groups["dp"]

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pp"]

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    def get_check_parallel_group(self, *a, **k) -> Group:
        return self._groups["mp"]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    def get_p2p_groups(self):
        return None

    def topology_order(self):
        return self._topo.get_hybrid_group_names()


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
