"""Collision geometry primitives: port of swift_game_engine_tpu/physics/
primitives.py.

Branchless tensor forms of the reference's scalar routines
(Game/CollisionQuery.swift:1396-1631): closest point on a triangle,
segment-segment closest points, Moller-Trumbore segment/ray-triangle, and
the capsule-core segment-triangle distance that drives the capsule sweep.
Every function broadcasts over leading batch dims, so (agents x triangles)
pairs evaluate as one set of elementwise ops. The capsule-core distance
runs on per-axis columns (``_cpt_cols``, ``_seg_seg_cols``) in the
reference's operation order.
"""

from __future__ import annotations

import torch

from ..math3d import cross, dot

_EPS = 1e-6


def _safe_div(num, den):
    return num / torch.where(den.abs() < 1e-20, torch.full_like(den, 1e-20),
                             den)


def closest_point_on_triangle(p, a, b, c):
    """Closest point on triangle abc to p -> (dist_sq, point), the
    Voronoi-region method (CollisionQuery.swift:1464-1517) as a priority
    chain of masks."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = dot(ab, ap), dot(ac, ap)
    bp = p - b
    d3, d4 = dot(ab, bp), dot(ac, bp)
    cp = p - c
    d5, d6 = dot(ab, cp), dot(ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    m_a = (d1 <= 0) & (d2 <= 0)
    m_b = (d3 >= 0) & (d4 <= d3)
    m_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    m_c = (d6 >= 0) & (d5 <= d6)
    m_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    m_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    p_ab = a + ab * _safe_div(d1, d1 - d3)[..., None]
    p_ac = a + ac * _safe_div(d2, d2 - d6)[..., None]
    w_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    p_bc = b + (c - b) * w_bc[..., None]
    denom = _safe_div(torch.ones_like(va), va + vb + vc)
    p_in = a + ab * (vb * denom)[..., None] + ac * (vc * denom)[..., None]

    point = p_in
    for m, q in ((m_bc, p_bc), (m_ac, p_ac), (m_c, c), (m_ab, p_ab),
                 (m_b, b), (m_a, a)):
        point = torch.where(m[..., None], q, point)
    diff = p - point
    return dot(diff, diff), point


def segment_segment_closest(p1, q1, p2, q2):
    """Closest points between [p1,q1] and [p2,q2] ->
    (dist_sq, point_on_1, point_on_2) (CollisionQuery.swift:1519-1569)."""
    out = _seg_seg_cols(*_cols(p1), *_cols(q1), *_cols(p2), *_cols(q2))
    return (out[0], torch.stack(out[1:4], -1), torch.stack(out[4:7], -1))


def segment_triangle_intersect(a, b, v0, v1, v2):
    """Segment [a,b] vs triangle -> (hit, point), Moller-Trumbore with t in
    [0,1] (CollisionQuery.swift:1440-1462)."""
    d = b - a
    e1, e2 = v1 - v0, v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = det.abs() >= _EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = a - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv
    t = dot(e2, qvec) * inv
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0) & \
        (t <= 1)
    return hit, a + d * t[..., None]


def _cols(v):
    return v[..., 0], v[..., 1], v[..., 2]


def _cpt_cols(px, py, pz, ax, ay, az, bx, by, bz, cx, cy, cz):
    """closest_point_on_triangle, column form -> (dist_sq, qx, qy, qz)."""
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    apx, apy, apz = px - ax, py - ay, pz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz

    bpx, bpy, bpz = px - bx, py - by, pz - bz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz

    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    m_a = (d1 <= 0) & (d2 <= 0)
    m_b = (d3 >= 0) & (d4 <= d3)
    m_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    m_c = (d6 >= 0) & (d5 <= d6)
    m_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    m_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    w_ab = _safe_div(d1, d1 - d3)
    w_ac = _safe_div(d2, d2 - d6)
    w_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = _safe_div(torch.ones_like(va), va + vb + vc)
    wv = vb * denom
    wc = vc * denom

    def pick(axis_a, ab_c, ac_c, b_c, c_c, cb_c):
        q = axis_a + ab_c * wv + ac_c * wc
        q = torch.where(m_bc, b_c + cb_c * w_bc, q)
        q = torch.where(m_ac, axis_a + ac_c * w_ac, q)
        q = torch.where(m_c, c_c, q)
        q = torch.where(m_ab, axis_a + ab_c * w_ab, q)
        q = torch.where(m_b, b_c, q)
        return torch.where(m_a, axis_a, q)

    qx = pick(ax, abx, acx, bx, cx, cx - bx)
    qy = pick(ay, aby, acy, by, cy, cy - by)
    qz = pick(az, abz, acz, bz, cz, cz - bz)
    dx, dy, dz = px - qx, py - qy, pz - qz
    return dx * dx + dy * dy + dz * dz, qx, qy, qz


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


def _seg_seg_cols(p1x, p1y, p1z, q1x, q1y, q1z,
                  p2x, p2y, p2z, q2x, q2y, q2z):
    """segment_segment_closest, column form ->
    (dist_sq, c1x, c1y, c1z, c2x, c2y, c2z)."""
    d1x, d1y, d1z = q1x - p1x, q1y - p1y, q1z - p1z
    d2x, d2y, d2z = q2x - p2x, q2y - p2y, q2z - p2z
    rx, ry, rz = p1x - p2x, p1y - p2y, p1z - p2z
    a = d1x * d1x + d1y * d1y + d1z * d1z
    e = d2x * d2x + d2y * d2y + d2z * d2z
    f = d2x * rx + d2y * ry + d2z * rz
    c = d1x * rx + d1y * ry + d1z * rz
    b = d1x * d2x + d1y * d2y + d1z * d2z
    a, e, f, c, b = torch.broadcast_tensors(a, e, f, c, b)
    zero, one = torch.zeros_like(a), torch.ones_like(a)

    denom = a * e - b * b
    s_general = _clip01(torch.where(
        denom.abs() > 0, (b * f - c * e) / torch.where(denom == 0, one, denom),
        zero))

    t_nom = b * s_general + f
    e_safe = torch.where(e < _EPS, one, e)
    a_safe = torch.where(a < _EPS, one, a)

    s = s_general
    t = t_nom / e_safe
    s = torch.where(t_nom < 0, _clip01(-c / a_safe), s)
    t = torch.where(t_nom < 0, zero, t)
    s = torch.where(t_nom > e, _clip01((b - c) / a_safe), s)
    t = torch.where(t_nom > e, one, t)

    both_pts = (a <= _EPS) & (e <= _EPS)
    seg1_pt = (a <= _EPS) & ~both_pts
    seg2_pt = (e <= _EPS) & ~both_pts
    s = torch.where(both_pts | seg1_pt, zero, s)
    t = torch.where(both_pts, zero,
                    torch.where(seg1_pt, _clip01(f / e_safe), t))
    s = torch.where(seg2_pt, _clip01(-c / a_safe), s)
    t = torch.where(seg2_pt, zero, t)

    c1x, c1y, c1z = p1x + d1x * s, p1y + d1y * s, p1z + d1z * s
    c2x, c2y, c2z = p2x + d2x * t, p2y + d2y * t, p2z + d2z * t
    dx, dy, dz = c1x - c2x, c1y - c2y, c1z - c2z
    return dx * dx + dy * dy + dz * dz, c1x, c1y, c1z, c2x, c2y, c2z


def segment_triangle_distance(center, half_height, v0, v1, v2):
    """Distance from a Y-axis capsule core segment [center +- (0,h,0)] to a
    triangle -> (dist, seg_point, tri_point); dist == 0 with coincident
    points when the segment pierces the triangle
    (CollisionQuery.swift:1396-1438). ``half_height`` broadcasts against
    ``center[..., 0]``."""
    cxp, cyp, czp = _cols(center)
    ax, ay, az = cxp, cyp + half_height, czp
    bx, by, bz = cxp, cyp - half_height, czp
    v0x, v0y, v0z = _cols(v0)
    v1x, v1y, v1z = _cols(v1)
    v2x, v2y, v2z = _cols(v2)

    # Moller-Trumbore segment pierce (d = b - a = (0, -2h, 0))
    dx, dy, dz = ax - bx, ay - by, az - bz
    dx, dy, dz = -dx, -dy, -dz
    e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det.abs() >= _EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvx, tvy, tvz = ax - v0x, ay - v0y, az - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & \
        (t >= 0) & (t <= 1)
    pix, piy, piz = ax + dx * t, ay + dy * t, az + dz * t

    d0, p0x, p0y, p0z = _cpt_cols(ax, ay, az, v0x, v0y, v0z,
                                  v1x, v1y, v1z, v2x, v2y, v2z)
    d1, p1x, p1y, p1z = _cpt_cols(bx, by, bz, v0x, v0y, v0z,
                                  v1x, v1y, v1z, v2x, v2y, v2z)
    de0, s0x, s0y, s0z, t0x, t0y, t0z = _seg_seg_cols(
        ax, ay, az, bx, by, bz, v0x, v0y, v0z, v1x, v1y, v1z)
    de1, s1x, s1y, s1z, t1x, t1y, t1z = _seg_seg_cols(
        ax, ay, az, bx, by, bz, v1x, v1y, v1z, v2x, v2y, v2z)
    de2, s2x, s2y, s2z, t2x, t2y, t2z = _seg_seg_cols(
        ax, ay, az, bx, by, bz, v2x, v2y, v2z, v0x, v0y, v0z)

    # Nearest of the 5 feature candidates; strict < keeps the first
    # minimum on ties, as argmin does.
    z = torch.zeros_like(d0)
    bd = d0
    bsx, bsy, bsz = ax + z, ay + z, az + z
    btx, bty, btz = p0x, p0y, p0z
    for dk, sxk, syk, szk, txk, tyk, tzk in (
            (d1, bx + z, by + z, bz + z, p1x, p1y, p1z),
            (de0, s0x, s0y, s0z, t0x, t0y, t0z),
            (de1, s1x, s1y, s1z, t1x, t1y, t1z),
            (de2, s2x, s2y, s2z, t2x, t2y, t2z)):
        win = dk < bd
        bd = torch.where(win, dk, bd)
        bsx = torch.where(win, sxk, bsx)
        bsy = torch.where(win, syk, bsy)
        bsz = torch.where(win, szk, bsz)
        btx = torch.where(win, txk, btx)
        bty = torch.where(win, tyk, bty)
        btz = torch.where(win, tzk, btz)

    dist = torch.sqrt(torch.clamp(bd, min=0.0))
    dist = torch.where(hit, z, dist)
    seg_point = torch.stack([torch.where(hit, pix, bsx),
                             torch.where(hit, piy, bsy),
                             torch.where(hit, piz, bsz)], -1)
    tri_point = torch.stack([torch.where(hit, pix, btx),
                             torch.where(hit, piy, bty),
                             torch.where(hit, piz, btz)], -1)
    return dist, seg_point, tri_point


def ray_triangle(origin, direction, v0, v1, v2):
    """Ray-triangle -> (hit, t) (CollisionQuery.swift:1575-1601)."""
    e1, e2 = v1 - v0, v2 - v0
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    ok = det.abs() >= _EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = origin - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv
    t = dot(e2, qvec) * inv
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return hit, t


def ray_aabb(origin, inv_dir, bmin, bmax):
    """Slab test -> (tmin, tmax, hit) (CollisionQuery.swift:1603-1631)."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    return tmin, tmax, tmax >= tmin


def triangle_normal(v0, v1, v2, eps: float = 1e-12):
    n = cross(v1 - v0, v2 - v0)
    ln = torch.sqrt((n * n).sum(-1, keepdim=True))
    return n / torch.clamp(ln, min=eps)


def aabb_overlap(amin, amax, bmin, bmax):
    return ((amax >= bmin) & (amin <= bmax)).all(-1)
