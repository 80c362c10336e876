"""Device meshes (the reference package's ``launch/mesh.py``) as torch
``DeviceMesh``es over a process group the caller has already made
(``torch.distributed.init_process_group``: its backend, gloo or NCCL, is
the mesh's).

Functions, never module-level constants, so importing this module makes
no group.  :class:`Mesh` is a ``DeviceMesh`` that also exposes what
``partitioning.resolve_spec`` reads of a mesh (``axis_names`` and
``devices.shape``, as a JAX mesh does); a rank's coordinate and group
along an axis are the ``DeviceMesh``'s ``get_local_rank(axis)`` and
``get_group(axis)``."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class Mesh(DeviceMesh):
    """A ``DeviceMesh`` named like a JAX mesh."""

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh_dim_names)

    @property
    def devices(self) -> torch.Tensor:
        """The ranks laid out on the mesh; its ``.shape`` is the extents."""
        return self.mesh


def _mesh(shape: Sequence[int], axes: Sequence[str], device_type: str
          ) -> Mesh:
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for {tuple(shape)}; have {have} — start "
            f"{n} processes and init_process_group first")
    ranks = torch.arange(n).reshape(tuple(shape))
    return Mesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """16 x 16 = 256 ranks (data, model); 2 x 16 x 16 = 512 with a pod
    axis.  Raises ``RuntimeError`` with fewer ranks in the group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cpu") -> Mesh:
    """A small mesh over the first ``prod(shape)`` ranks of the group
    (every rank of the group calls it).  Raises ``RuntimeError`` with
    fewer ranks."""
    return _mesh(shape, axes, device_type)
