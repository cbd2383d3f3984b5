"""Meshes over ``torch.distributed``'s ranks: functions, not module
constants, so importing this module touches no process group.

A mesh is a ``DeviceMesh`` with dim names over the default process group's
ranks, in rank order (the reference's ``jax.make_mesh`` over its devices).
Each rank's device type is the one its process group runs ("cuda" where
CUDA is available, else "cpu"), or ``device_type``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def _mesh(shape: Sequence[int], names: Sequence[str], device_type: Optional[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the world has {world}")
    dt = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    return DeviceMesh(dt, torch.arange(world).reshape(*shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``: built only where that many ranks exist."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_host_mesh(model_axis: int = 1, device_type: Optional[str] = None):
    """A ("data", "model") mesh over the world's ranks, ``model_axis`` wide."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the world's {n} ranks")
    return _mesh((n // model_axis, model_axis), ("data", "model"), device_type)


def batch_axes(mesh) -> tuple:
    """Mesh axes the batch / token dims shard over (pod composes with data)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
