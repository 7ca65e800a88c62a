"""Mesh construction: the production meshes' descriptions and a host mesh
over the initialised process group (the port of ``repro/launch/mesh.py``).

A ``Mesh`` is an ordered mapping of axis names to sizes (the reference's
``mesh.shape``) and, for execution, an optional torch ``DeviceMesh`` over
the same axes. A mesh without one is a description: the sharding rules
resolve against it (``launch/sharding.py``) and the dry-run sizes every
cell's tensors per device on it, but nothing is placed on it.

Functions, not module constants, so that importing this module touches no
process group and no device.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch

from repro_torch.device import resolve_device


class Mesh:
    """Named mesh axes in order (``shape``) and the ``DeviceMesh`` over
    them, or None for a description."""

    def __init__(self, shape: Mapping[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        if device_mesh is not None and (
                tuple(device_mesh.mesh_dim_names or ()) != tuple(self.shape)
                or tuple(device_mesh.shape) != tuple(self.shape.values())):
            raise ValueError(f"device mesh {device_mesh} is not {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        kind = "description" if self.device_mesh is None else \
            self.device_mesh.device_type
        return f"Mesh({self.shape}, {kind})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, (16, 16) ``("data", "model")`` or
    (2, 16, 16) ``("pod", "data", "model")``, as a description. The port
    has no pod: the description stands where the reference puts 256 or
    512 placeholder CPU devices, and sizes each cell per device."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh(model: int = 1, device: str | torch.device | None = None
                   ) -> Mesh:
    """A ``("data", "model")`` mesh of (world // model, model) over the
    initialised process group's ranks, its ``DeviceMesh`` on the CUDA card
    unless ``device`` asks for the CPU. Without a process group there is
    one rank, and the mesh is the (1, 1) description."""
    import torch.distributed as dist
    group = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if group else 1
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide {world} ranks")
    shape = {"data": world // model, "model": model}
    if not group:
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh
    kind = resolve_device(device).type
    return Mesh(shape, init_device_mesh(kind, tuple(shape.values()),
                                        mesh_dim_names=tuple(shape)))
