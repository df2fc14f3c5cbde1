"""Skeleton: the packed bind pose a skinned mesh is loaded against.

The port's copy of ``build_skeleton`` from swift_game_engine_tpu/assets/
skeleton.py (reference: Game/SkeletonLoader.swift:28-87,
Game/Skeleton.swift:10-226), reduced to the fields the render world reads:
bone names and parents, the bind-local transforms and the inverse bind
palette. The pose engine's extras (semantic aliases, FK levels) and the
``*.skeleton.json`` loader are not ported: the repository has no skeleton
file, and the DemoScene builds a stand-in skeleton from the skin's names.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import nputil


@dataclass(frozen=True)
class Skeleton:
    """Packed skeleton. All arrays are float32/int32 numpy, B = bone count."""

    names: tuple[str, ...]
    parent: np.ndarray                 # (B,) int32, -1 for root
    bind_local: np.ndarray             # (B,4,4)
    inv_bind_model: np.ndarray         # (B,4,4)
    unit_scale: float

    @property
    def bone_count(self) -> int:
        return len(self.parent)


def build_skeleton(names, parent, raw_translations, pre_rotation_degrees,
                   unit_scale=1.0, root_rule="keep",
                   root_fix_degrees=(0, 0, 0)) -> Skeleton:
    """Assemble a packed skeleton from raw schema fields.

    Semantics follow Game/SkeletonLoader.swift:28-87: the root translation is
    zeroed under the ``zero_root`` rule, translations are scaled by
    ``unitScale``, bind-local = T(rest_scaled) @ [rootFix @] preRot, and the
    inverse bind palette comes from FK of the bind pose.
    """
    b = len(names)
    parent = np.asarray(parent, np.int32)
    raw = np.asarray(raw_translations, np.float32).reshape(b, 3)
    pre = np.asarray(pre_rotation_degrees, np.float32).reshape(b, 3) \
        if len(pre_rotation_degrees) else np.zeros((b, 3), np.float32)

    rest = raw.copy()
    if root_rule == "zero_root" and b > 0:
        rest[0] = 0.0
    rest = rest * np.float32(unit_scale)

    root_fix = nputil.rotation_xyz_degrees(np.asarray(root_fix_degrees, np.float32))
    pre_rot = nputil.rotation_xyz_degrees(pre)        # (B,4,4)
    if b > 0:
        pre_rot[0] = root_fix @ pre_rot[0]
    bind_local = nputil.translation_mat(rest) @ pre_rot

    model = nputil.fk_model_transforms(parent, bind_local)
    inv_bind = np.linalg.inv(model).astype(np.float32)
    return Skeleton(names=tuple(names), parent=parent,
                    bind_local=bind_local.astype(np.float32),
                    inv_bind_model=inv_bind, unit_scale=float(unit_scale))
