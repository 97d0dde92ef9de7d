"""ProcessMesh — the named mesh of ranks (port of
``paddle_tpu/distributed/process_mesh.py``).

In the reference a ProcessMesh is a ``jax.sharding.Mesh`` over devices;
here its ``process_ids`` are ranks of the default ``torch.distributed``
group. :func:`set_mesh` (or ``with mesh:``) builds, on every rank and in
the same order, one process group per line of each axis (a ``["dp",
"sep"]`` mesh has one ``sep`` group per ``dp`` row) and keeps the ones
this rank belongs to: :meth:`ProcessMesh.group` and
:meth:`ProcessMesh.axis_index` then serve the collectives.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from paddle_tpu_torch.distributed.env import get_rank, get_world_size

__all__ = ["ProcessMesh", "get_mesh", "set_mesh"]

_global_mesh: List[Optional["ProcessMesh"]] = [None]


class ProcessMesh:
    def __init__(self, mesh: Sequence, dim_names: Optional[Sequence[str]]
                 = None, shape: Optional[Sequence[int]] = None,
                 process_ids: Optional[Sequence[int]] = None):
        if shape is not None and process_ids is not None:
            ids = np.asarray(process_ids).reshape(shape)
        else:
            ids = np.asarray(mesh)
        if ids.ndim == 0:
            ids = ids.reshape(1)
        self._ids = ids.astype(np.int64)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(self._ids.ndim)]
        if len(dim_names) != self._ids.ndim:
            raise ValueError(
                f"dim_names {dim_names} rank != mesh rank {self._ids.ndim}")
        self._dim_names = list(dim_names)
        # axis -> this rank's group along it (None: a world of one rank)
        self._groups: Optional[Dict[str, object]] = None

    # -- reference-parity surface -------------------------------------------
    @property
    def shape(self) -> List[int]:
        return list(self._ids.shape)

    @property
    def ndim(self) -> int:
        return self._ids.ndim

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def process_ids(self) -> List[int]:
        return [int(i) for i in self._ids.flatten()]

    def get_dim_size(self, dim_name: str) -> int:
        return self._ids.shape[self._dim_names.index(dim_name)]

    def get_rank_by_dim_and_process_id(self, dim_name: str,
                                       process_id: int) -> int:
        axis = self._dim_names.index(dim_name)
        where = np.argwhere(self._ids == process_id)
        if where.size == 0:
            return -1
        return int(where[0][axis])

    def get_mesh_with_dim(self, dim_name: str, index=None) -> "ProcessMesh":
        """Reorder so ``dim_name`` is first; optionally index into it,
        producing the (n-1)-d sub-mesh (reference API)."""
        axis = self._dim_names.index(dim_name)
        order = [axis] + [i for i in range(self.ndim) if i != axis]
        ids = np.transpose(self._ids, order)
        names = [self._dim_names[i] for i in order]
        if index is None:
            return ProcessMesh(ids, names)
        return ProcessMesh(ids[index], names[1:])

    # -- torch.distributed surface -------------------------------------------
    def _build_groups(self) -> None:
        """One group per line of each axis, created by every rank of the
        world in the same order (``new_group`` is collective); this rank
        keeps the groups of its own lines."""
        if self._groups is not None:
            return
        world = get_world_size()
        bad = [i for i in self.process_ids if not 0 <= i < world]
        if bad:
            raise ValueError(f"{self} names ranks {bad} outside the world of "
                             f"{world} (init_parallel_env() first)")
        groups: Dict[str, object] = {}
        if dist.is_initialized():
            me = get_rank()
            for axis in range(self.ndim):
                lines = np.moveaxis(self._ids, axis, -1).reshape(
                    -1, self._ids.shape[axis])
                for line in lines:
                    ranks = [int(r) for r in line]
                    g = dist.new_group(ranks=ranks)
                    if me in ranks:
                        groups[self._dim_names[axis]] = g
        else:
            groups = {name: None for name in self._dim_names}
        self._groups = groups

    def group(self, dim_name: str):
        """This rank's process group along ``dim_name`` (None in a world
        of one rank); the mesh must have been set (:func:`set_mesh`)."""
        if self._groups is None:
            raise RuntimeError(f"{self} has no process groups yet: "
                               f"set_mesh(mesh) or `with mesh:` first")
        if dim_name not in self._groups:
            raise ValueError(f"rank {get_rank()} is not in {self}")
        return self._groups[dim_name]

    def axis_index(self, dim_name: str) -> int:
        """This rank's coordinate along ``dim_name``."""
        idx = self.get_rank_by_dim_and_process_id(dim_name, get_rank())
        if idx < 0:
            raise ValueError(f"rank {get_rank()} is not in {self}")
        return idx

    def __enter__(self):
        self._prev = _global_mesh[0]
        set_mesh(self)
        return self

    def __exit__(self, *exc):
        _global_mesh[0] = self._prev
        return False

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._dim_names == other._dim_names
                and np.array_equal(self._ids, other._ids))

    def __hash__(self):
        return hash((tuple(self._dim_names), self._ids.tobytes()))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={self._dim_names})")


def set_mesh(mesh: Optional[ProcessMesh]) -> None:
    """Make ``mesh`` the global mesh, building its process groups (every
    rank of the world calls this, in the same order)."""
    if mesh is not None:
        mesh._build_groups()
    _global_mesh[0] = mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh[0]
