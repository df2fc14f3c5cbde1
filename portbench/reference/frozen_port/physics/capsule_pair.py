"""Moving capsule vs capsule sweep: port of swift_game_engine_tpu/physics/
capsule_pair.py.

The reference's quadratic-root solver (Game/Systems.swift:1417-1590): in
the relative frame the moving capsule hits the other when the XZ distance
to the Y-clamped core reaches the radius sum, solved over three Y bands
(above both caps, below, the overlapping cylinder band), earliest root
first. Everything broadcasts; the mover uses (agents x agents) matrices.
"""

from __future__ import annotations

import torch

_EPS = 1e-6
BIG = 3.0e38


def _earliest_root(A, B, C, t_min, t_max):
    """Earliest t in [t_min, t_max] where A t^2 + B t + C crosses to <= 0
    (Systems.swift:1450-1472) -> (t, valid)."""
    A, B, C, t_min, t_max = torch.broadcast_tensors(A, B, C, t_min, t_max)
    one = torch.ones_like(A)
    lin = A.abs() < _EPS
    const = lin & (B.abs() < _EPS)
    v_const = C <= 0
    t_lin = -C / torch.where(B.abs() < _EPS, one, B)
    v_lin = (t_lin >= t_min) & (t_lin <= t_max)
    disc = B * B - 4 * A * C
    v_quad = disc >= 0
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 1.0 / torch.where(A.abs() < _EPS, one, 2.0 * A)
    r0 = (-B - sqrt_d) * inv2a
    r1 = (-B + sqrt_d) * inv2a
    s = torch.maximum(torch.minimum(r0, r1), t_min)
    e = torch.minimum(torch.maximum(r0, r1), t_max)
    v_quad = v_quad & (e >= s)
    t = torch.where(const, t_min, torch.where(lin, t_lin, s))
    v = torch.where(const, v_const, torch.where(lin, v_lin, v_quad)) & \
        (t_max >= t_min)
    return t, v


def _band(y0, vy, threshold, above: bool):
    """t-interval within [0,1] where y0 + vy t >= threshold (``above``) or
    <= threshold -> (lo, hi, valid)."""
    still = vy.abs() < _EPS
    one, zero = torch.ones_like(y0), torch.zeros_like(y0)
    t = (threshold - y0) / torch.where(still, one, vy)
    rising = vy > 0
    if above:
        lo = torch.where(rising, torch.clamp(t, min=0.0), zero)
        hi = torch.where(rising, one, torch.clamp(t, max=1.0))
        held = y0 >= threshold
    else:
        lo = torch.where(rising, zero, torch.clamp(t, min=0.0))
        hi = torch.where(rising, torch.clamp(t, max=1.0), one)
        held = y0 <= threshold
    lo = torch.where(still, zero, lo)
    hi = torch.where(still, one, hi)
    return lo, hi, torch.where(still, held, hi >= lo)


def _sep_y(y_rel, h_sum):
    return torch.where(y_rel > h_sum, y_rel - h_sum,
                       torch.where(y_rel < -h_sum, y_rel + h_sum,
                                   torch.zeros_like(y_rel)))


def capsule_pair_normal(rel, h_sum):
    """Contact normal from the relative offset (Systems.swift:1484-1497)."""
    sep = torch.stack([rel[..., 0], _sep_y(rel[..., 1], h_sum),
                       rel[..., 2]], -1)
    len_sq = (sep * sep).sum(-1, keepdim=True)
    lateral = sep.clone()
    lateral[..., 1] = 0.0
    lat_sq = (lateral * lateral).sum(-1, keepdim=True)
    fallback = torch.zeros_like(sep)
    fallback[..., 0] = 1.0
    return torch.where(
        len_sq > 1e-8, sep / torch.sqrt(torch.clamp(len_sq, min=1e-20)),
        torch.where(lat_sq > 1e-8,
                    lateral / torch.sqrt(torch.clamp(lat_sq, min=1e-20)),
                    fallback))


def capsule_capsule_sweep(from_pos, delta, radius, half_height,
                          other_pos, other_delta, other_radius,
                          other_half_height):
    """Sweep TOI between moving Y-capsules (broadcasting) ->
    (toi, normal, hit), toi in distance along ``delta`` (t_hit * |delta|,
    Systems.swift:1505-1590)."""
    rel_start = from_pos - other_pos
    rel_delta = delta - other_delta
    r_sum = radius + other_radius
    h_sum = half_height + other_half_height
    rel_len = torch.sqrt((rel_delta * rel_delta).sum(-1))
    move_len = torch.sqrt((delta * delta).sum(-1))

    y0, vy = rel_start[..., 1], rel_delta[..., 1]
    vx, vz = rel_delta[..., 0], rel_delta[..., 2]
    r0x, r0z = rel_start[..., 0], rel_start[..., 2]
    y0, vy, vx, vz, r0x, r0z, h_sum, r_sum = torch.broadcast_tensors(
        y0, vy, vx, vz, r0x, r0z, h_sum, r_sum)

    static_rel = rel_len < _EPS
    sep_y0 = _sep_y(y0, h_sum)
    overlap0 = (r0x * r0x + r0z * r0z + sep_y0 * sep_y0) <= r_sum * r_sum

    best_t = torch.full_like(y0, BIG)
    A = vx * vx + vz * vz + vy * vy
    # Upper cap band (y_rel >= h_sum): sphere at y-offset -h_sum.
    lo, hi, v = _band(y0, vy, h_sum, above=True)
    B = 2 * (r0x * vx + r0z * vz + (y0 - h_sum) * vy)
    C = r0x * r0x + r0z * r0z + (y0 - h_sum) ** 2 - r_sum * r_sum
    t, tv = _earliest_root(A, B, C, lo, hi)
    best_t = torch.where(v & tv & (t < best_t), t, best_t)
    # Lower cap band.
    lo, hi, v = _band(y0, vy, -h_sum, above=False)
    B2 = 2 * (r0x * vx + r0z * vz + (y0 + h_sum) * vy)
    C2 = r0x * r0x + r0z * r0z + (y0 + h_sum) ** 2 - r_sum * r_sum
    t, tv = _earliest_root(A, B2, C2, lo, hi)
    best_t = torch.where(v & tv & (t < best_t), t, best_t)
    # Cylinder band (|y_rel| <= h_sum): XZ circle.
    A3 = vx * vx + vz * vz
    B3 = 2 * (r0x * vx + r0z * vz)
    C3 = r0x * r0x + r0z * r0z - r_sum * r_sum
    still = vy.abs() < _EPS
    one = torch.ones_like(vy)
    t1 = (h_sum - y0) / torch.where(still, one, vy)
    t2 = (-h_sum - y0) / torch.where(still, one, vy)
    blo = torch.clamp(torch.minimum(t1, t2), min=0.0)
    bhi = torch.clamp(torch.maximum(t1, t2), max=1.0)
    lo3 = torch.where(still, torch.zeros_like(blo), blo)
    hi3 = torch.where(still, one, bhi)
    v3 = torch.where(still, y0.abs() <= h_sum, bhi >= blo)
    t, tv = _earliest_root(A3, B3, C3, lo3, hi3)
    best_t = torch.where(v3 & tv & (t < best_t), t, best_t)

    hit_moving = best_t < BIG
    t_hit = torch.where(hit_moving, best_t, torch.zeros_like(best_t))
    n_moving = capsule_pair_normal(rel_start + rel_delta * t_hit[..., None],
                                   h_sum)
    n_static = capsule_pair_normal(rel_start.expand_as(n_moving), h_sum)
    hit = torch.where(static_rel, overlap0, hit_moving)
    toi = torch.where(static_rel, torch.zeros_like(t_hit), t_hit * move_len)
    normal = torch.where(static_rel[..., None], n_static, n_moving)
    return torch.where(hit, toi, torch.full_like(toi, BIG)), normal, hit
