"""Production meshes and mesh axis names (port of ``repro.launch.mesh``).

Import never touches device or process-group state: meshes are built by
functions only, through ``torch.distributed.device_mesh.init_device_mesh``
in a process group the caller has initialised (``torch.distributed.
init_process_group``, world size = the mesh's size; otherwise they raise a
clear error). The axis helpers take any mesh with
``axis_names`` and a ``shape`` mapping names to sizes (the persistence
tier's ``MeshMeta``, a test's stand-in) or a ``DeviceMesh``.
"""

from __future__ import annotations

import math


def _device_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                 device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} {axes} mesh needs an initialised process group of "
            f"{math.prod(shape)} ranks (torch.distributed."
            "init_process_group); none is initialised")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} {axes} mesh needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (16, 16) = (data, model) — 256 devices.
    Multi-pod: (2, 16, 16) = (pod, data, model) — 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_debug_mesh(devices: int = 8, model: int = 2,
                    device_type: str = "cuda"):
    """Small (data, model) mesh, e.g. over gloo ranks on the CPU
    (``device_type="cpu"``) in the tests."""
    return _device_mesh((devices // model, model), ("data", "model"),
                        device_type)


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of any mesh this module takes."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def mp_axis(mesh) -> str:
    return "model"
