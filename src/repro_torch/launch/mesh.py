"""Mesh construction for the LM placement rules (twin of `repro.launch.mesh`).

`make_production_mesh` returns a shape-only mesh: the JAX code's 16x16
single-pod or 2x16x16 multi-pod shape and axis names, with ``.shape`` (axis
name -> size, as a JAX `Mesh` has it) and ``.axis_names``, so the rules of
`repro_torch.launch.sharding` run with no ranks.  `device_mesh` builds a
`torch.distributed.device_mesh.DeviceMesh` of the same names over the running
process group, for DTensor placement.  Importing this module touches no
device or process-group state.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.placed import BATCH_AXES, MODEL_AXIS

__all__ = ["BATCH_AXES", "MODEL_AXIS", "ShapeMesh", "make_production_mesh", "batch_axes",
           "axis_names", "axis_sizes", "device_mesh"]

@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh's shape and axis names, and no devices."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), shape only."""
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


def axis_names(mesh) -> tuple:
    """A shape-only mesh's, a `DeviceMesh`'s or a JAX-style mesh's axis names."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name -> size, for any mesh `axis_names` reads."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def batch_axes(mesh) -> tuple:
    """The subset of (pod, data) present in this mesh, for batch sharding."""
    names = axis_names(mesh)
    return tuple(a for a in BATCH_AXES if a in names)


def device_mesh(shape: tuple, axes: tuple, device="cuda"):
    """A `DeviceMesh` of ``shape`` named ``axes`` over the running process
    group (rank r at the row-major position r), on ``device``'s type.

    Ranks that share one card each pass its index (``cuda:0``): the mesh
    then binds every rank to that card.  Raises where no group is up or its
    world size is not the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import _launcher_hint

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ in length")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise ValueError(f"a {shape} mesh needs a process group of {n} ranks and none is "
                         "initialized; " + _launcher_hint(n))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process group has {world}; "
                         + _launcher_hint(n))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else dist.get_rank())
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=axes)
