"""Skinned mesh asset loader (``*.skinned.json``).

The port's copy of swift_game_engine_tpu/assets/skinned_mesh.py.

Schema and semantics follow the reference loader
(reference: Game/SkinnedMeshLoader.swift:16-220):
  * positions scaled by the skeleton's ``unitScale``
  * bone names remapped to skeleton indices, case-insensitive, with an
    ``ns:name`` short-name fallback in both directions
  * weights of unmapped bones dropped and the remainder renormalized
  * per-bone inverse bind matrices from the JSON (row-major, translation
    scaled by unitScale) override the skeleton's bind-pose-derived ones
  * submeshes become (start, count, material) ranges over one index buffer

TPU-native addition: ``dense_weights`` — the (V, 4) sparse joints/weights are
expanded into a dense (V, B) matrix at load so skinning runs as one
(V, B) x (B, 16) MXU matmul instead of a gather loop.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .skeleton import Skeleton


@dataclass(frozen=True)
class SkinnedSubmesh:
    start: int
    count: int
    material: str


@dataclass(frozen=True)
class SkinnedMeshAsset:
    """One skinned mesh with shared vertex streams and submesh ranges."""

    positions: np.ndarray      # (V,3) float32, unit-scaled
    normals: np.ndarray        # (V,3)
    uvs: np.ndarray            # (V,2)
    joints: np.ndarray         # (V,4) int32, remapped to skeleton indices
    weights: np.ndarray        # (V,4) float32, renormalized
    indices: np.ndarray        # (I,) int32
    submeshes: tuple[SkinnedSubmesh, ...]
    inv_bind_model: np.ndarray  # (B,4,4) skeleton invBind with JSON overrides
    dense_weights: np.ndarray  # (V,B) float32 — for MXU skinning

    @property
    def vertex_count(self) -> int:
        return len(self.positions)

    @property
    def material_names(self) -> tuple[str, ...]:
        return tuple(s.material for s in self.submeshes)


def _bone_remap(skin_bone_names: list[str], skeleton: Skeleton) -> list[Optional[int]]:
    """reference: Game/SkinnedMeshLoader.swift:139-163."""
    lookup: dict[str, int] = {}
    for i, name in enumerate(skeleton.names):
        key = name.lower()
        lookup.setdefault(key, i)
        short = key.split(":")[-1]
        lookup.setdefault(short, i)
    out: list[Optional[int]] = []
    for name in skin_bone_names:
        key = name.lower()
        idx = lookup.get(key)
        if idx is None and ":" in key:
            idx = lookup.get(key.split(":")[-1])
        out.append(idx)
    return out


def load_skinned_mesh(path: str, skeleton: Skeleton) -> SkinnedMeshAsset:
    with open(path) as f:
        data = json.load(f)
    mesh = data["mesh"]
    positions = np.asarray(mesh["positions"], np.float32).reshape(-1, 3)
    v = len(positions)
    normals = np.asarray(mesh["normals"], np.float32).reshape(v, 3)
    uvs = np.asarray(mesh["uvs"], np.float32).reshape(v, 2)
    joints_src = np.asarray(mesh["joints"], np.int64).reshape(v, 4)
    weights = np.asarray(mesh["weights"], np.float32).reshape(v, 4).copy()
    indices = np.asarray(mesh["indices"], np.int64).astype(np.int32)

    positions = positions * np.float32(skeleton.unit_scale)

    skin_bones = data.get("skin", {}).get("bones", [])
    remap = _bone_remap([b["name"] for b in skin_bones], skeleton)

    # Remap joints; drop weights of unmapped bones, renormalize (vectorized:
    # remap table -> one gather over the (V,4) joint matrix).
    n_skin = len(remap)
    table = np.full(n_skin + 1, -1, np.int64)
    for i, m in enumerate(remap):
        if m is not None:
            table[i] = m
    src = np.clip(joints_src, 0, n_skin)      # out-of-range -> sentinel row
    src[joints_src >= n_skin] = n_skin
    mapped = table[src]                        # (V,4)
    ok = mapped >= 0
    joints = np.where(ok, mapped, 0).astype(np.int32)
    weights = np.where(ok, weights, 0.0).astype(np.float32)
    wsum = weights.sum(axis=1, keepdims=True)
    weights = np.where(wsum > 0, weights / np.maximum(wsum, 1e-20), weights)

    # Inverse bind overrides (row-major JSON, translation scaled).
    inv_bind = skeleton.inv_bind_model.copy()
    scale = np.float32(skeleton.unit_scale)
    for i, bone in enumerate(skin_bones):
        dst = remap[i]
        ibm = bone.get("inverseBindMatrix")
        if dst is None or ibm is None or len(ibm) != 16:
            continue
        m = np.asarray(ibm, np.float32).reshape(4, 4)
        m[:3, 3] *= scale
        inv_bind[dst] = m

    subs = mesh.get("submeshes") or [{"start": 0, "count": len(indices), "material": "Default"}]
    submeshes = []
    for s in subs:
        start = max(int(s["start"]), 0)
        end = min(start + int(s["count"]), len(indices))
        if start >= end:
            continue
        submeshes.append(SkinnedSubmesh(start=start, count=end - start,
                                        material=s.get("material", "Default")))

    dense = dense_weight_matrix(joints, weights, skeleton.bone_count)
    return SkinnedMeshAsset(
        positions=positions, normals=normals, uvs=uvs,
        joints=joints, weights=weights.astype(np.float32), indices=indices,
        submeshes=tuple(submeshes), inv_bind_model=inv_bind,
        dense_weights=dense,
    )


def dense_weight_matrix(joints: np.ndarray, weights: np.ndarray, bone_count: int) -> np.ndarray:
    """(V,4) sparse LBS weights -> dense (V, B) matrix (duplicate joints sum)."""
    v = len(joints)
    dense = np.zeros((v, bone_count), np.float32)
    rows = np.repeat(np.arange(v), 4)
    np.add.at(dense, (rows, joints.reshape(-1)), weights.reshape(-1))
    return dense
