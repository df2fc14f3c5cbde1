"""Level-parallel forward kinematics in translation/quaternion form: port
of swift_game_engine_tpu/anim/fk.py (reference: Game/Skeleton.swift:175-203).

Rigid transforms are ``(t, q)`` pairs, (..., B, 3) and (..., B, 4), with a
leading character axis. Bones are permuted into level order once, so a
level is a contiguous block whose parents sit in earlier blocks: each level
is one batch of quaternion products over parents gathered by static index,
appended out of place. 4x4 matrices are built once, at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math3d as m3
from .. import resolve_device


def compose_tq(t, q):
    """The matrices T(t) @ R(q): (..., 3), (..., 4) -> (..., 4, 4)."""
    m = m3.mat4_from_quat(q)
    m[..., :3, 3] = t
    return m


class FKSolver:
    """The FK plan of one skeleton: the level-order permutation, its
    inverse and each level's range and (permuted) parent indices, all
    static; the index tensors live on ``device``, the card unless the
    caller names another (raises where CUDA is asked for and absent)."""

    def __init__(self, parent, levels, device="cuda"):
        device = resolve_device(device)
        parent = np.asarray(parent, np.int64)
        b = len(parent)
        perm = np.concatenate([np.asarray(lv, np.int64) for lv in levels]) \
            if b else np.zeros(0, np.int64)
        inv_perm = np.empty(b, np.int64)
        inv_perm[perm] = np.arange(b)
        self.perm = torch.as_tensor(perm, device=device)
        self.inv_perm = torch.as_tensor(inv_perm, device=device)
        self.ranges = []          # (start, n, permuted parents) per level > 0
        pos = 0
        for li, lv in enumerate(levels):
            n = len(lv)
            if li > 0 and n > 0:
                pp = inv_perm[parent[np.asarray(lv, np.int64)]]
                self.ranges.append((pos, n, torch.as_tensor(pp,
                                                            device=device)))
            pos += n
        self.root_count = len(levels[0]) if len(levels) else 0
        self.bone_count = b

    def model_tq(self, t_local, q_local):
        """FK over (t, q) locals (..., B, 3/4) -> model-space (t, q)."""
        t_p = t_local[..., self.perm, :]
        q_p = q_local[..., self.perm, :]
        t_m = t_p[..., :self.root_count, :]
        q_m = q_p[..., :self.root_count, :]
        for start, n, pp in self.ranges:
            pt, pq = t_m[..., pp, :], q_m[..., pp, :]
            lt = t_p[..., start:start + n, :]
            lq = q_p[..., start:start + n, :]
            t_m = torch.cat([t_m, pt + m3.quat_act(pq, lt)], -2)
            q_m = torch.cat([q_m, m3.quat_mul(pq, lq)], -2)
        return t_m[..., self.inv_perm, :], q_m[..., self.inv_perm, :]

    def model_matrices(self, t_local, q_local):
        """FK, then the (..., B, 4, 4) model matrices."""
        return compose_tq(*self.model_tq(t_local, q_local))


def palette_from_model(model, inv_bind_model):
    """Skinning palette = model @ invBind
    (Game/ProceduralPoseSystem.swift:400-402)."""
    return torch.matmul(model, inv_bind_model)
