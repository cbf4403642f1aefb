"""Placements and ``ProcessMesh``.

Counterpart of ``paddle_tpu/distributed/auto_parallel/placement.py``.
``Shard`` / ``Replicate`` / ``Partial`` say, per mesh dimension, what that
dimension does to a tensor, as Paddle's do. ``ProcessMesh`` is metadata
(shape, dimension names, process ids), as the reference's is: it can be
built, compared and printed at any shape without a process group. A
process id is a rank of ``torch.distributed``, one process a rank; the
reference's is a jax device of one process.

The first placement that needs communication asks for
:attr:`ProcessMesh.device_mesh`, a ``torch.distributed.DeviceMesh`` over
the same ranks (built once per distinct mesh, on every rank in one
order, as torch requires). A mesh whose ids reach past the world raises
there, naming both sizes. Where the reference returns jax
``PartitionSpec``\\ s, :func:`placements_to_spec` returns the same tuples
of axis names.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["Placement", "Replicate", "Shard", "Partial", "ProcessMesh",
           "get_current_mesh", "auto_mesh", "dp_mp_mesh_candidates",
           "placements_to_spec", "spec_to_placements", "to_torch_placements"]


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return False

    def is_partial(self):
        return False


class Replicate(Placement):
    def is_replicated(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("Replicate")


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))


class Partial(Placement):
    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("Partial", self.reduce_type))


_PARTIAL_OPS = {"sum": "sum", "avg": "avg", "mean": "avg", "max": "max",
                "min": "min"}


def to_torch_placements(placements: Sequence[Placement]):
    """The ``torch.distributed.tensor`` placements of ``placements``
    (torch placements pass through)."""
    from torch.distributed import tensor as tdt

    out = []
    for p in placements:
        if isinstance(p, Shard):
            out.append(tdt.Shard(p.dim))
        elif isinstance(p, Replicate):
            out.append(tdt.Replicate())
        elif isinstance(p, Partial):
            op = _PARTIAL_OPS.get(str(p.reduce_type).lower())
            if op is None:
                raise ValueError(
                    f"Partial({p.reduce_type!r}): reduce types are "
                    f"{sorted(_PARTIAL_OPS)}")
            out.append(tdt.Partial(op))
        elif isinstance(p, tdt.Placement):
            out.append(p)
        else:
            raise TypeError(f"not a placement: {p!r}")
    return out


_device_meshes: dict = {}


class ProcessMesh:
    """An N-D grid of ranks with named dimensions (Paddle's
    ``ProcessMesh(mesh, dim_names)``)."""

    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None,
                 process_ids=None):
        arr = np.asarray(mesh)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(f"{len(dim_names)} dim_names for a mesh of "
                             f"{arr.ndim} dimensions")
        self._shape = list(arr.shape)
        self._dim_names = list(dim_names)
        self._process_ids = [int(i) for i in arr.reshape(-1).tolist()]

    @property
    def shape(self) -> List[int]:
        return list(self._shape)

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def process_ids(self) -> List[int]:
        return list(self._process_ids)

    @property
    def mesh(self):
        return np.asarray(self._process_ids).reshape(self._shape)

    def get_dim_size(self, name: str) -> int:
        return self._shape[self._dim_names.index(name)]

    def get_rank_by_dim_and_process_id(self, dim, pid):
        idx = self._process_ids.index(pid)
        coord = np.unravel_index(idx, self._shape)
        return int(coord[self._dim_names.index(dim)
                         if isinstance(dim, str) else dim])

    def get_coordinate(self, pid=None):
        """This rank's (or ``pid``'s) coordinate in the mesh, None outside
        it."""
        if pid is None:
            from .. import env

            pid = env.get_rank()
        if pid not in self._process_ids:
            return None
        return [int(c) for c in np.unravel_index(
            self._process_ids.index(pid), self._shape)]

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over these ranks, on the port's device type
        (the card, or the CPU after ``set_device("cpu")``), over the
        default group's backend. It brings the process group up first
        when none is (``init_parallel_env``) and is made once per distinct
        mesh: torch makes a group per dimension, on every rank in one
        order."""
        import torch.distributed as tdist

        from .. import env

        world = env.get_world_size()
        if max(self._process_ids) >= world:
            raise ValueError(
                f"ProcessMesh {self._shape} names rank "
                f"{max(self._process_ids)}, but the world has {world} "
                f"rank(s)")
        if not (tdist.is_available() and tdist.is_initialized()):
            env.init_parallel_env()
        from ...core.place import resolve_device

        device_type = resolve_device(None).type
        key = (tuple(self._shape), tuple(self._dim_names),
               tuple(self._process_ids), device_type, id(tdist.group.WORLD))
        dm = _device_meshes.get(key)
        if dm is None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh

            dm = DeviceMesh(device_type,
                            torch.tensor(self.mesh, dtype=torch.int64),
                            mesh_dim_names=tuple(self._dim_names))
            _device_meshes[key] = dm
        return dm

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._dim_names == other._dim_names
                and self._process_ids == other._process_ids)

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._dim_names),
                     tuple(self._process_ids)))

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dim_names={self._dim_names})"

    def __enter__(self):
        _mesh_stack.append(self)
        return self

    def __exit__(self, *exc):
        _mesh_stack.pop()
        return False


_mesh_stack: List[ProcessMesh] = []


def _forget_device_meshes():
    """Drop the cached ``DeviceMesh``\\ es (their groups die with the
    process group)."""
    _device_meshes.clear()


def get_current_mesh() -> Optional[ProcessMesh]:
    return _mesh_stack[-1] if _mesh_stack else None


def auto_mesh(*dim_sizes, dim_names=None) -> ProcessMesh:
    """A mesh over the first ``prod(dim_sizes)`` ranks."""
    n = int(np.prod(dim_sizes))
    return ProcessMesh(np.arange(n).reshape(dim_sizes), dim_names)


def dp_mp_mesh_candidates(n_devices: int, dp_axis: str = "dp",
                          mp_axis: str = "mp"):
    """Every ``dp x mp`` factorization of ``n_devices`` as a ``(label,
    ProcessMesh)`` list, dp-major (pure data-parallel first)."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    out = []
    for dp in range(n, 0, -1):
        if n % dp:
            continue
        mp = n // dp
        out.append((f"{dp_axis}{dp}x{mp_axis}{mp}",
                    ProcessMesh(np.arange(n).reshape(dp, mp),
                                [dp_axis, mp_axis])))
    return out


def placements_to_spec(placements: Sequence[Placement], mesh: ProcessMesh,
                       ndim: int) -> tuple:
    """Placements (one per MESH dim) as a spec (one entry per TENSOR dim:
    an axis name, a tuple of names, or None; trailing Nones dropped), the
    entries of the reference's ``PartitionSpec``."""
    entries: List[Optional[tuple]] = [None] * ndim
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim
            name = mesh.dim_names[mesh_dim]
            entries[d] = (name,) if entries[d] is None else entries[d] + (name,)
    spec = [e if e is None else (e[0] if len(e) == 1 else e) for e in entries]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def spec_to_placements(spec, mesh: ProcessMesh, ndim: int):
    placements: List[Placement] = [Replicate() for _ in range(mesh.ndim)]
    for tensor_dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            placements[mesh.dim_names.index(name)] = Shard(tensor_dim)
    return placements
