"""Collision world: port of swift_game_engine_tpu/physics/collision_world.py.

Triangles are stored in local space with a per-triangle entity index
(``LocalTriangles``, built on the host by ``CollisionWorldBuilder`` and
padded to a multiple of 128 with invalid rows); ``transform_soup`` bakes
them to world space from the entity transforms every substep, which stands
in for the reference's static/dynamic sets and BVH refit
(Game/CollisionQuery.swift:320-470). Queries then test (agents x
triangles) pairs in bulk (``physics.queries``).

Layer masks are uint32 in the reference; here they are int64 tensors
holding the same bit patterns (``LAYER_ALL`` = 0xFFFFFFFF).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .primitives import triangle_normal

LAYER_ALL = 0xFFFFFFFF
LAYER_DEFAULT = 1


class TriangleSoup(NamedTuple):
    """World-space triangles (T padded; per-agent candidate sub-soups have
    leading batch dims). ``tri_id`` is the global triangle id: the full
    soup's arange, a sub-soup's gathered ids, so query results name the
    same triangle whichever rows were gathered."""

    v0: torch.Tensor       # (..., T, 3)
    v1: torch.Tensor
    v2: torch.Tensor
    normal: torch.Tensor   # (..., T, 3) geometric normal
    mu_s: torch.Tensor     # (..., T)
    mu_k: torch.Tensor
    flatten: torch.Tensor  # (..., T) bool
    layer: torch.Tensor    # (..., T) int64 (uint32 bit pattern)
    valid: torch.Tensor    # (..., T) bool
    tri_id: torch.Tensor   # (..., T) int32

    @property
    def aabb(self):
        return (torch.minimum(torch.minimum(self.v0, self.v1), self.v2),
                torch.maximum(torch.maximum(self.v0, self.v1), self.v2))

    def unsqueeze(self, dim: int) -> "TriangleSoup":
        """Every field with a new batch axis at ``dim`` (counted from the
        front), e.g. (N, T) -> (N, 1, T) to broadcast against (N, P)
        queries."""
        return TriangleSoup(*(f.unsqueeze(dim) for f in self))


class LocalTriangles(NamedTuple):
    """Local-space triangles + per-triangle entity binding."""

    p0: torch.Tensor       # (T,3)
    p1: torch.Tensor
    p2: torch.Tensor
    entity: torch.Tensor   # (T,) int64 index into the transform array
    mu_s: torch.Tensor
    mu_k: torch.Tensor
    flatten: torch.Tensor  # bool
    layer: torch.Tensor    # int64
    valid: torch.Tensor    # bool


class CollisionWorldBuilder:
    """Host-side accumulation of collision meshes into padded arrays. The
    staged meshes stay readable as numpy (``meshes``: one dict per mesh)."""

    def __init__(self):
        self.meshes = []

    def add_mesh(self, positions, indices, entity: int, mu_s: float = 0.8,
                 mu_k: float = 0.6, flatten: bool = False,
                 layer: int = LAYER_DEFAULT, per_tri_materials=None):
        """Add a triangle mesh bound to transform slot ``entity``;
        degenerate triangles (squared cross length <= 1e-10) are culled
        (CollisionQuery.swift:341-389)."""
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        tri = np.asarray(indices, np.int64).reshape(-1, 3)
        p0, p1, p2 = positions[tri[:, 0]], positions[tri[:, 1]], \
            positions[tri[:, 2]]
        keep = np.sum(np.cross(p1 - p0, p2 - p0) ** 2, axis=1) > 1e-10
        n = int(keep.sum())
        if n == 0:
            return
        if per_tri_materials is not None and \
                len(per_tri_materials) == len(tri):
            mats = np.asarray(per_tri_materials, np.float32)[keep]
            mu_s_arr, mu_k_arr, flat_arr = mats[:, 0], mats[:, 1], \
                mats[:, 2] > 0.5
        else:
            mu_s_arr = np.full(n, mu_s, np.float32)
            mu_k_arr = np.full(n, mu_k, np.float32)
            flat_arr = np.full(n, flatten, bool)
        self.meshes.append(dict(
            p0=p0[keep], p1=p1[keep], p2=p2[keep],
            entity=np.full(n, entity, np.int32), mu_s=mu_s_arr,
            mu_k=mu_k_arr, flatten=flat_arr,
            layer=np.full(n, layer, np.uint32)))

    def build(self, pad_to: int = 128, device="cuda") -> LocalTriangles:
        """The padded local triangles on ``device`` (the card unless the
        caller names another)."""
        from .. import resolve_device
        device = resolve_device(device)
        t = sum(len(m["p0"]) for m in self.meshes)
        padded = max(pad_to, ((t + pad_to - 1) // pad_to) * pad_to)

        def cat(key, dtype, vec=False):
            out = np.zeros((padded, 3) if vec else (padded,), dtype)
            if t:
                out[:t] = np.concatenate([m[key] for m in self.meshes])
            return out

        valid = np.zeros(padded, bool)
        valid[:t] = True

        def tt(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return LocalTriangles(
            p0=tt(cat("p0", np.float32, True)),
            p1=tt(cat("p1", np.float32, True)),
            p2=tt(cat("p2", np.float32, True)),
            entity=tt(cat("entity", np.int64)),
            mu_s=tt(cat("mu_s", np.float32)), mu_k=tt(cat("mu_k", np.float32)),
            flatten=tt(cat("flatten", bool)),
            layer=tt(cat("layer", np.int64)),
            valid=tt(valid))


def transform_soup(local: LocalTriangles, transforms,
                   entity_alive=None) -> TriangleSoup:
    """Bake local triangles to world space from per-entity (E,4,4)
    transforms; ``entity_alive`` ((E,) bool) invalidates the triangles of
    despawned entities."""
    m = transforms[local.entity]
    rot, t = m[..., :3, :3], m[..., :3, 3]

    def xf(p):
        return torch.einsum("tij,tj->ti", rot, p) + t

    v0, v1, v2 = xf(local.p0), xf(local.p1), xf(local.p2)
    valid = local.valid
    if entity_alive is not None:
        valid = valid & entity_alive[local.entity]
    return TriangleSoup(
        v0=v0, v1=v1, v2=v2, normal=triangle_normal(v0, v1, v2),
        mu_s=local.mu_s, mu_k=local.mu_k, flatten=local.flatten,
        layer=local.layer, valid=valid,
        tri_id=torch.arange(v0.shape[0], dtype=torch.int32,
                            device=v0.device))
