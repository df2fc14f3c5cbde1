"""Static mesh asset loader (``*.static.json``).

The port's copy of swift_game_engine_tpu/assets/static_mesh.py.

Schema per the reference loader (reference: Game/StaticMeshLoader.swift:29-197):
``{version, meshes[{name, transform[16] (row-major), mesh{positions, normals,
uvs, indices, submeshes[{start, count, material}]}, collisionHulls[{positions,
indices}]}]}``. Render mesh parts keep their per-part transform; collision
hulls are separate position-only triangle meshes (decimated convex hulls from
the FBX toolchain).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .mesh_api import MeshDescriptor


@dataclass(frozen=True)
class StaticSubmesh:
    start: int
    count: int
    material: str


@dataclass(frozen=True)
class StaticMeshPart:
    name: str
    transform: np.ndarray            # (4,4) float32
    mesh: MeshDescriptor
    submeshes: tuple[StaticSubmesh, ...]
    collision_hulls: tuple[MeshDescriptor, ...]


@dataclass(frozen=True)
class StaticMeshAsset:
    parts: tuple[StaticMeshPart, ...]


def load_static_mesh(path: str) -> StaticMeshAsset:
    with open(path) as f:
        data = json.load(f)
    parts = []
    for entry in data.get("meshes", []):
        mesh = entry["mesh"]
        positions = np.asarray(mesh["positions"], np.float32).reshape(-1, 3)
        if len(positions) == 0 or not mesh.get("indices"):
            print(f"static_mesh: skipping invalid mesh {entry.get('name')}")
            continue
        v = len(positions)
        normals = None
        uvs = None
        if mesh.get("normals") and len(mesh["normals"]) == v * 3:
            normals = np.asarray(mesh["normals"], np.float32).reshape(v, 3)
        if mesh.get("uvs") and len(mesh["uvs"]) == v * 2:
            uvs = np.asarray(mesh["uvs"], np.float32).reshape(v, 2)
        indices = np.asarray(mesh["indices"], np.int64).astype(np.int32)

        desc = MeshDescriptor(positions=positions, indices=indices,
                              normals=normals, uvs=uvs, name=entry.get("name", "static"))

        subs = mesh.get("submeshes") or [{"start": 0, "count": len(indices),
                                          "material": "Default"}]
        submeshes = tuple(StaticSubmesh(int(s["start"]), int(s["count"]),
                                        s.get("material", "Default")) for s in subs)

        hulls = []
        for hull in entry.get("collisionHulls") or []:
            hp = np.asarray(hull.get("positions", []), np.float32).reshape(-1, 3)
            hi = np.asarray(hull.get("indices", []), np.int64).astype(np.int32)
            if len(hp) == 0 or len(hi) == 0:
                continue
            hulls.append(MeshDescriptor(positions=hp, indices=hi, name="CollisionHull"))

        tf = entry.get("transform", [])
        transform = (np.asarray(tf, np.float32).reshape(4, 4)
                     if len(tf) == 16 else np.eye(4, dtype=np.float32))

        parts.append(StaticMeshPart(name=entry.get("name", "part"),
                                    transform=transform, mesh=desc,
                                    submeshes=submeshes,
                                    collision_hulls=tuple(hulls)))
    return StaticMeshAsset(parts=tuple(parts))
