"""Linear-blend skinning as one matrix product.

Port of swift_game_engine_tpu/anim/skinning.py (reference:
Game/RayTracing.metalinc:737-776 skinningKernel): the (V, 4) sparse weights
are pre-expanded to a dense (V, B) matrix, so the per-vertex skinning
matrices are one (V, B) @ (B, 16) ``torch.matmul`` — a plain product the
reference also leaves to its compiler, not a kernel of this port.
"""

from __future__ import annotations

import torch


def skin_matrices(dense_weights, palette):
    """(V, B) weights x (..., B, 4, 4) palette -> (..., V, 4, 4)."""
    b = palette.shape[-3]
    flat = palette.reshape(*palette.shape[:-3], b, 16)
    return torch.matmul(dense_weights, flat).reshape(
        *palette.shape[:-3], dense_weights.shape[0], 4, 4)


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def skin_vertices(dense_weights, palette, positions, normals=None,
                  tangents=None):
    """Positions through the full affine matrix; normals and tangent.xyz
    through the 3x3 block (no inverse transpose), renormalized; tangent.w
    passed through. Returns a dict like the reference."""
    mats = skin_matrices(dense_weights, palette)
    rot = mats[..., :3, :3]
    pos = (rot * positions[..., None, :]).sum(-1) + mats[..., :3, 3]
    out = {"positions": pos}
    if normals is not None:
        out["normals"] = _unit((rot * normals[..., None, :]).sum(-1))
    if tangents is not None:
        txyz = _unit((rot * tangents[..., None, :3]).sum(-1))
        out["tangents"] = torch.cat(
            [txyz, tangents[..., 3:].expand(*txyz.shape[:-1], 1)], -1)
    return out
