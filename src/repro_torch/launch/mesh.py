"""Mesh axis names (port of ``repro.launch.mesh``'s ``dp_axes`` and
``mp_axis``).

Only the pure functions of a mesh's axis names come over: the persistence
tier stamps them onto page-range exports (``placement/persist.py``). They
take any object with ``axis_names`` — a :class:`~repro_torch.placement.
persist.MeshMeta` here. The device mesh builders wait for training
(``ROADMAP.md`` queue 1 item 10).
"""

from __future__ import annotations


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mp_axis(mesh) -> str:
    return "model"
