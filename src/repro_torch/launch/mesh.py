"""Production mesh builders over ``torch.distributed``.

Defined as FUNCTIONS (not module-level constants) so that importing this
module touches no process group: a mesh is built only inside a group of
the right world size — a real one, or the fake group of a dry run
(``launch/dryrun.py``), which traces 256 or 512 ranks from one process.
A mesh is on CUDA where there is a card, else on the CPU, unless the
caller names a device type.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["PRODUCTION", "make_production_mesh", "make_host_mesh", "data_axes"]

#: multi_pod -> (shape, axis names)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device_type: str | None) -> str:
    return device_type or ("cuda" if torch.cuda.is_available() else "cpu")


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None
                         ) -> DeviceMesh:
    """Single pod: (16, 16) ("data", "model") = 256 ranks.
    Multi-pod:  (2, 16, 16) ("pod", "data", "model") = 512 ranks.
    The process group must already have that world size."""
    shape, axes = PRODUCTION[multi_pod]
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_host_mesh(n: int | None = None, axis: str = "data",
                   device_type: str | None = None) -> DeviceMesh:
    """A one-axis mesh over the ``n`` ranks present (every rank of the
    group by default)."""
    n = n or dist.get_world_size()
    return init_device_mesh(_device_type(device_type), (n,), mesh_dim_names=(axis,))


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
