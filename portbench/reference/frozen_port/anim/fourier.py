"""Fourier motion-profile evaluation: port of swift_game_engine_tpu/anim/
fourier.py (reference: Game/Animation.swift:65-89).

A profile's values at a phase are one product of its packed coefficients
with the basis: ``values[..., B, 6] = coeffs[..., B, 6, C] @ basis[..., C]``,
batched over a leading character axis.
"""

from __future__ import annotations

import math

import torch


def fourier_basis(phase, order: int):
    """``[1, cos(2 pi k p), sin(2 pi k p) for k = 1..order]`` with p = phase
    clamped to [0, 1]. ``phase`` (...,) -> (..., 2 * order + 1)."""
    p = torch.clamp(phase, 0.0, 1.0)
    ks = torch.arange(1, order + 1, dtype=torch.float32, device=p.device)
    ang = 2.0 * math.pi * ks * p[..., None]
    inter = torch.stack([torch.cos(ang), torch.sin(ang)], -1).reshape(
        *p.shape, 2 * order)
    return torch.cat([torch.ones((*p.shape, 1), device=p.device), inter], -1)


def evaluate_packed(coeffs, has_channel, phase, order: int, default_trans):
    """A packed profile at ``phase`` (N,).

    ``coeffs`` (N, B, 6, C) or (B, 6, C) (one profile for every character),
    ``has_channel`` (N, B, 6) or (B, 6) bool: an absent channel takes the
    raw rest translation ``default_trans`` (B, 3) or a zero rotation.
    Returns (trans_raw (N, B, 3) in FBX-local units, rot_deg (N, B, 3)
    Euler degrees)."""
    basis = fourier_basis(phase, order)                  # (N, C)
    values = torch.matmul(coeffs, basis[:, None, :, None])[..., 0]
    trans_raw = torch.where(has_channel[..., :3], values[..., :3],
                            default_trans)
    rot_deg = torch.where(has_channel[..., 3:], values[..., 3:], 0.0)
    return trans_raw, rot_deg
