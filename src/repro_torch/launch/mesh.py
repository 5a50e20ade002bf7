"""Device meshes for the sharded train step and the server.

The port's counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed`` ``DeviceMesh`` whose dims carry the reference's axis
names: single pod (data=16, model=16) = 256 cards, multi-pod (pod=2,
data=16, model=16) = 512, the ``pod`` axis carrying pure data parallelism.
Each process drives one card, so the world size is the mesh size.

A process with no process group (one card, a laptop, a test) gets a
one-rank group from :func:`make_mesh` itself, over a
``torch.distributed.HashStore`` and with no ``MASTER_ADDR``: gloo for CPU
tensors and, where there is a card, nccl for CUDA ones.  A mesh refuses a
group whose backend does not suit its device type (:data:`BACKENDS`); a
world of fake ranks (:data:`FAKE_BACKEND`, the dry run's) suits any.  One
card is a mesh of 1, and runs the same sharded code path as 256.  :class:`MeshShape` is a mesh's shape and names without
devices: the spec rules (:mod:`repro_torch.launch.shardings`,
``steps.shardings_for``) read only those, so they can be held at the
production sizes on a machine with one CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim sizes and names, with the accessors of a
    ``DeviceMesh`` that the spec rules use (``mesh_dim_names``,
    ``size``, ``ndim``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.mesh_dim_names} differ in length")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return (math.prod(self.shape) if mesh_dim is None
                else self.shape[mesh_dim])


# the collectives a mesh of each device type needs
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# torch's fake process group (``torch.testing._internal.distributed.
# fake_pg``): ranks that exist only in name, whose collectives move
# nothing.  The dry run (``launch.dryrun``) builds its meshes on one.
FAKE_BACKEND = "fake"


def group_backend(device_type: str) -> Optional[str]:
    """The default process group's backend for `device_type` tensors:
    its one backend (``"gloo"``, ``"nccl"``), or its entry for the device
    in a per-device pair (``"cpu:gloo,cuda:nccl"``), None where it has
    none."""
    b = str(dist.get_backend())
    if ":" not in b:
        return b
    return dict(p.split(":", 1) for p in b.split(",")).get(device_type)


def _ensure_group(device_type: str, world: int) -> None:
    """The default process group: the caller's, which must span `world`
    ranks, or a one-rank group started here when there is none (gloo for
    CPU tensors and, where the process sees a card, nccl for CUDA ones, so
    that one process may build meshes of both kinds).  Either way its
    backend for `device_type` must be ``BACKENDS[device_type]``."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"a mesh of {world} devices needs a world of "
                             f"{world} processes; this one has "
                             f"{dist.get_world_size()}")
    elif world != 1:
        raise ValueError(
            f"a mesh of {world} devices needs one process per device: start "
            f"them with torch.distributed.init_process_group (address, world "
            f"size {world} and rank) before building the mesh")
    else:
        both = torch.cuda.is_available() and dist.is_nccl_available()
        dist.init_process_group("cpu:gloo,cuda:nccl" if both else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    want = BACKENDS[device_type]
    if group_backend(device_type) not in (want, FAKE_BACKEND):
        raise ValueError(
            f"a {device_type} mesh needs {want} collectives; the process "
            f"group's backend is {dist.get_backend()!r}: start it with "
            f"{want!r} (or 'cpu:gloo,cuda:nccl') before building the mesh")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = None):
    """A ``DeviceMesh`` of `shape` with dims named `axes` over the ranks
    of the default process group (started here, one rank, when there is
    none).  `device` None means the CUDA device, and raises without one;
    the CPU (gloo) only when the caller asks for it."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes}: need one "
                         f"distinct name per dim")
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev.type}")
    _ensure_group(dev.type, math.prod(shape))
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``: the world must hold 256 or 512 processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def activate_mesh(mesh):
    """Context manager installing `mesh` as the ambient mesh: the
    ``DeviceMesh``'s own context, which ``torch.distributed.tensor``'s
    factories (``zeros``, ``distribute_tensor``, ...) default to."""
    return mesh


def data_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh (('pod', 'data') when multi-pod),
    in mesh order."""
    return tuple(n for n in mesh.mesh_dim_names if n in DATA_AXES)


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dim `name`, 1 where the mesh has none."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.size(names.index(name))) if name in names else 1


def mesh_devices(mesh) -> int:
    return int(mesh.size())
