"""Collision queries: port of swift_game_engine_tpu/physics/queries.py.

Capsule sweep (CCD), overlap and raycast against a ``TriangleSoup``,
batched over queries: a query's tensors have leading dims ``B`` (agents,
or agents x probes), the soup's fields leading dims that broadcast against
``B`` (none for the shared soup, ``(N,)`` or ``(N, 1)`` for per-agent
candidate sub-soups), and every (query, triangle) pair is evaluated at
once; reductions run over the triangle axis.

``capsule_cast`` computes the time of impact analytically (the production
path: feature events validated by region checks, then the first valid
one, queries.py:386-407); ``capsule_cast_ca`` is the conservative
advancement twin that follows the reference's schedule
(Game/CollisionQuery.swift:1285-1394) and serves as its parity oracle.
Its loops run their fixed maximum counts with done-masks (a finished lane
keeps its carry, as a batched while loop's select does), so nothing here
reads a value back to the host.

``gather_candidates`` is the broadphase: per-agent nearest-first lists of
``cap`` triangles. ``jax.lax.top_k`` puts equal keys lowest index first;
a stable descending sort gives the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math3d import cross, dot, norm, xz
from .collision_world import LAYER_ALL, TriangleSoup
from .primitives import aabb_overlap, ray_triangle, segment_triangle_distance

CONTACT_EPS = 1e-5
DEFAULT_CA_ITERS = 48
REFINE_ITERS = 10
BIG = 3.0e38


class CapsuleCastHit(NamedTuple):
    hit: torch.Tensor          # (*B,) bool
    toi: torch.Tensor          # (*B,)
    normal: torch.Tensor       # (*B,3)
    tri_normal: torch.Tensor   # (*B,3)
    position: torch.Tensor     # (*B,3) contact point on the triangle
    tri_index: torch.Tensor    # (*B,) int32, -1 without a hit
    mu_s: torch.Tensor
    mu_k: torch.Tensor
    flatten: torch.Tensor      # (*B,) bool
    iterations: torch.Tensor   # (*B,) int: analytic path: prefilter
    # candidates; CA path: iterations (the per-query work counter)


class CapsuleOverlapHits(NamedTuple):
    """The deepest K overlaps of each query."""

    depth: torch.Tensor        # (*B,K) 0 where no hit
    normal: torch.Tensor       # (*B,K,3)
    tri_normal: torch.Tensor
    position: torch.Tensor
    tri_index: torch.Tensor    # (*B,K) int32, -1 where no hit
    valid: torch.Tensor        # (*B,K) bool
    candidates: torch.Tensor   # (*B,) int


class RaycastHit(NamedTuple):
    hit: torch.Tensor
    distance: torch.Tensor
    position: torch.Tensor
    normal: torch.Tensor
    tri_index: torch.Tensor
    mu_s: torch.Tensor
    mu_k: torch.Tensor


def _tri_axis(x):
    """A per-query tensor given the triangle axis."""
    return x.unsqueeze(-1)


def _per_query(like, *xs, dtype=torch.float32):
    """Floats or ints as (*B,) tensors on ``like``'s device (*B =
    like.shape[:-1]); tensors pass through."""
    return [x if isinstance(x, torch.Tensor) or x is None else
            torch.full(like.shape[:-1], x, dtype=dtype, device=like.device)
            for x in xs]


def _layer_mask(soup: TriangleSoup, mask):
    return soup.valid & ((soup.layer & _tri_axis(mask)) != 0)


def _top_k(key, k: int):
    """(values, indices) of the k largest along the last axis, equal keys
    lowest index first (``jax.lax.top_k``'s order)."""
    val, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def gather_candidates(soup: TriangleSoup, center, half_height, radius,
                      reach, cap: int):
    """Per-agent candidate sub-soups of ``cap`` rows: the triangles whose
    AABB overlaps the agent's capsule AABB grown by ``reach``, nearest
    centroid first (on overflow the farthest drop out). ``center`` (N,3);
    ``half_height``, ``radius``, ``reach`` (N,). Returns (sub-soup with
    fields (N, cap, ...), overlap count (N,))."""
    tmin, tmax = soup.aabb
    ext = torch.stack([radius + reach, half_height + radius + reach,
                       radius + reach], -1)
    qmin, qmax = center - ext, center + ext
    overlap = ((qmin[:, None, :] <= tmax[None]) &
               (qmax[:, None, :] >= tmin[None])).all(-1)
    overlap = overlap & soup.valid[None]
    centroid = (soup.v0 + soup.v1 + soup.v2) * (1.0 / 3.0)
    d2 = ((center[:, None, :] - centroid[None]) ** 2).sum(-1)
    key = torch.where(overlap, -d2, torch.full_like(d2, -BIG))
    _, idx = _top_k(key, cap)
    keep = torch.gather(overlap, 1, idx)
    sub = TriangleSoup(*(f[idx] for f in soup))._replace(valid=keep)
    return sub, overlap.sum(1, dtype=torch.int32)


def _cast_prefilter(soup, from_pos, delta, radius, half_height, mask):
    """Swept-AABB prefilter (CollisionQuery.swift:1025-1065)."""
    length = norm(delta)
    nonzero = length >= 1e-6
    dir_ = delta / torch.where(nonzero, length,
                               torch.ones_like(length))[..., None]
    top, bot = from_pos.clone(), from_pos.clone()
    top[..., 1] += half_height
    bot[..., 1] -= half_height
    ends = torch.stack([top, bot, top + delta, bot + delta])
    qmin = ends.amin(0) - radius[..., None]
    qmax = ends.amax(0) + radius[..., None]
    tmin, tmax = soup.aabb
    cand = _layer_mask(soup, mask) & \
        aabb_overlap(qmin[..., None, :], qmax[..., None, :], tmin, tmax) & \
        nonzero[..., None]
    return length, dir_, cand


def _cast_select(soup, from_pos, delta, dir_, toi, contact, iters,
                 radius, half_height, blocking, min_normal_y):
    """Hit attributes at each triangle's TOI and the first-minimum select
    (CollisionQuery.swift:1087-1117, 1331-1340)."""
    center = from_pos[..., None, :] + dir_[..., None, :] * toi[..., None]
    dist, seg_p, tri_p = segment_triangle_distance(
        center, _tri_axis(half_height), soup.v0, soup.v1, soup.v2)
    tnx, tny, tnz = soup.normal[..., 0], soup.normal[..., 1], \
        soup.normal[..., 2]
    axx = seg_p[..., 0] - tri_p[..., 0]
    axy = seg_p[..., 1] - tri_p[..., 1]
    axz = seg_p[..., 2] - tri_p[..., 2]
    alen = torch.clamp(torch.sqrt(axx * axx + axy * axy + axz * axz),
                       min=1e-20)
    dirx, diry, dirz = (dir_[..., i, None] for i in range(3))
    one = torch.ones_like(dist)
    tflip = torch.where(tnx * dirx + tny * diry + tnz * dirz > 0, -one, one)
    is_pen = dist < 1e-6
    nx = torch.where(is_pen, tnx * tflip, axx / alen)
    ny = torch.where(is_pen, tny * tflip, axy / alen)
    nz = torch.where(is_pen, tnz * tflip, axz / alen)
    nflip = torch.where(tnx * nx + tny * ny + tnz * nz < 0, -one, one)
    tri_nx, tri_ny, tri_nz = tnx * nflip, tny * nflip, tnz * nflip

    ok = contact
    if blocking:
        dlx, dly, dlz = (delta[..., i, None] for i in range(3))
        ok = ok & (dlx * nx + dly * ny + dlz * nz < 0) & \
            (dlx * tri_nx + dly * tri_ny + dlz * tri_nz < 0)
    if min_normal_y is not None:
        ok = ok & (tri_ny >= _tri_axis(min_normal_y))

    toi_masked = torch.where(ok, toi, torch.full_like(toi, BIG))
    best_toi = toi_masked.amin(-1)
    best_ok = best_toi < BIG
    is_best = toi_masked == best_toi[..., None]
    sel = is_best & (torch.cumsum(is_best.to(torch.int32), -1) == 1)
    first = torch.arange(toi.shape[-1], device=toi.device) == 0
    sel = torch.where(is_best.any(-1, keepdim=True), sel, first)

    def pick(x):
        return torch.where(sel, x, torch.zeros_like(x)).sum(-1, dtype=x.dtype)

    def pick_vec(x, y, z):
        return torch.stack([pick(x), pick(y), pick(z)], -1)

    tri_id = pick(soup.tri_id.expand_as(sel))
    return CapsuleCastHit(
        hit=best_ok,
        toi=torch.where(best_ok, pick(toi), torch.full_like(best_toi, BIG)),
        normal=pick_vec(nx, ny, nz),
        tri_normal=pick_vec(tri_nx, tri_ny, tri_nz),
        position=pick_vec(tri_p[..., 0], tri_p[..., 1], tri_p[..., 2]),
        tri_index=torch.where(best_ok, tri_id, torch.full_like(tri_id, -1)),
        mu_s=pick(soup.mu_s.expand_as(sel)),
        mu_k=pick(soup.mu_k.expand_as(sel)),
        flatten=pick(soup.flatten.expand_as(sel).to(torch.int32)).bool() &
        best_ok,
        iterations=iters,
    )


def _first_quad_root(A, B, C):
    """Smallest real root of A t^2 + B t + C = 0 (A >= 0), or BIG; the
    linear root when A ~ 0."""
    lin = A.abs() < 1e-12
    disc = B * B - 4.0 * A * C
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(lin, torch.ones_like(A), A)
    quad_root = (-B - sq) / (2.0 * a_safe)
    b_small = B.abs() < 1e-12
    lin_root = -C / torch.where(b_small, torch.ones_like(B), B)
    big = torch.full_like(quad_root, BIG)
    root = torch.where(lin, torch.where(b_small, big, lin_root), quad_root)
    return torch.where(lin | (disc >= 0), root, big)


def _toward_root(c0, c1, r):
    """First t with |c0 + c1 t| = r for a linear feature distance, or BIG."""
    one = torch.ones_like(c0)
    sgn = torch.where(c0 >= 0, one, -one)
    small = c1.abs() < 1e-12
    t = (sgn * r - c0) / torch.where(small, torch.ones_like(c1), c1)
    return torch.where(small, torch.full_like(t, BIG), t)


def _analytic_toi(soup: TriangleSoup, from_pos, dir_, length, radius,
                  half_height, cand):
    """Exact per-triangle first-contact distance along ``dir_`` ->
    (contact, toi), both (*B, T): every feature event's first root,
    accepted when its feature pair lies within both objects (queries.py
    :271-383); the least accepted root is the TOI."""
    fp = from_pos[..., None, :]
    d = dir_[..., None, :]
    L = length[..., None]
    r = _tri_axis(radius)
    hh = _tri_axis(half_height)
    e0, e1 = fp.clone(), fp.clone()
    e0[..., 1] += hh
    e1[..., 1] -= hh
    v0, v1, v2 = soup.v0, soup.v1, soup.v2
    v = (v0, v1, v2)
    edges = ((v0, v1), (v1, v2), (v2, v0))
    EPS_R = 1e-4

    best = torch.full(cand.shape, BIG, device=cand.device)

    def consider(t, valid, best):
        return torch.minimum(torch.where(valid & (t >= 0.0) & (t <= L), t,
                                         torch.full_like(t, BIG)), best)

    # Face events: endpoint sphere vs the triangle's plane (linear).
    n = soup.normal
    ndot = dot(n, d)
    e10, e21, e02 = v1 - v0, v2 - v1, v0 - v2
    two_area = dot(cross(e10, -e02), n)
    a_eps = EPS_R * two_area.abs()
    for e in (e0, e1):
        phi0 = dot(n, e - v0)
        t = _toward_root(phi0, ndot, r)
        p_at = e + d * t[..., None]
        proj = p_at - n * dot(n, p_at - v0)[..., None]
        c0 = dot(cross(e10, proj - v0), n)
        c1 = dot(cross(e21, proj - v1), n)
        c2 = dot(cross(e02, proj - v2), n)
        inside = (c0 >= -a_eps) & (c1 >= -a_eps) & (c2 >= -a_eps)
        best = consider(t, inside, best)

    # Core line vs edge line (linear: both directions fixed, core = +Y).
    h_eps = EPS_R * torch.maximum(hh, r)
    for p, q in edges:
        ed = q - p
        el = norm(ed)
        e_n = ed / torch.clamp(el, min=1e-20)[..., None]
        m = torch.stack([e_n[..., 2], torch.zeros_like(el), -e_n[..., 0]], -1)
        mlen2 = (m * m).sum(-1)
        m_n = m / torch.clamp(torch.sqrt(mlen2), min=1e-20)[..., None]
        c0 = dot(fp - p, m_n)
        c1 = dot(d, m_n)
        t = _toward_root(c0, c1, r)
        r0 = (fp + d * t[..., None]) - p
        b = e_n[..., 1]
        cc = r0[..., 1]
        f = dot(e_n, r0)
        denom = torch.clamp(mlen2, min=1e-12)
        u_core = (b * f - cc) / denom
        s_edge = (f - b * cc) / denom
        ok = (mlen2 > 1e-9) & (u_core >= -hh - h_eps) & \
            (u_core <= hh + h_eps) & (s_edge >= -EPS_R * el) & \
            (s_edge <= el * (1.0 + EPS_R))
        best = consider(t, ok, best)

    # Endpoint sphere vs vertex (quadratic, |dir| = 1).
    for e in (e0, e1):
        for vv in v:
            u0 = e - vv
            B = 2.0 * dot(u0, d)
            C = dot(u0, u0) - r * r
            best = consider(_first_quad_root(torch.ones_like(B), B, C),
                            torch.ones_like(B, dtype=torch.bool), best)

    # Endpoint sphere vs edge line (quadratic), foot within the edge.
    for e in (e0, e1):
        for p, q in edges:
            ed = q - p
            el = norm(ed)
            e_n = ed / torch.clamp(el, min=1e-20)[..., None]
            u0 = e - p
            dd = dot(d, e_n)
            u0e = dot(u0, e_n)
            A = 1.0 - dd * dd
            B = 2.0 * (dot(u0, d) - u0e * dd)
            C = dot(u0, u0) - u0e * u0e - r * r
            t = _first_quad_root(A, B, C)
            s = u0e + dd * t
            ok = (el > 1e-9) & (s >= -EPS_R * el) & \
                (s <= el * (1.0 + EPS_R))
            best = consider(t, ok, best)

    # Vertex vs core cylinder (quadratic in XZ), vertex Y within the core.
    dxz = xz(d)
    A_c = dot(dxz, dxz)
    for vv in v:
        w = xz(vv - fp)
        B = -2.0 * dot(w, dxz)
        C = dot(w, w) - r * r
        t = _first_quad_root(A_c.expand_as(B), B, C)
        u = vv[..., 1] - (fp[..., 1] + d[..., 1] * t)
        ok = (u >= -hh - h_eps) & (u <= hh + h_eps)
        best = consider(t, ok, best)

    # Start penetration: contact at t = 0.
    dist0, _, _ = segment_triangle_distance(fp, hh, v0, v1, v2)
    pen0 = cand & (dist0 <= r + CONTACT_EPS)

    big = torch.full_like(best, BIG)
    toi = torch.where(cand, best, big)
    toi = torch.where(pen0, torch.zeros_like(toi), toi)
    contact = pen0 | (toi < BIG)
    return contact, torch.where(contact, toi, big)


def capsule_cast(soup: TriangleSoup, from_pos, delta, radius, half_height,
                 mask=LAYER_ALL, blocking: bool = False,
                 min_normal_y=None) -> CapsuleCastHit:
    """Sweep Y-axis capsules along ``delta`` against the soup, analytic
    TOI. ``from_pos``/``delta`` (*B,3); ``radius``, ``half_height``,
    ``mask`` and ``min_normal_y`` (None: no ground filter) floats or
    (*B,) tensors."""
    radius, half_height, min_normal_y = _per_query(
        from_pos, radius, half_height, min_normal_y)
    (mask,) = _per_query(from_pos, mask, dtype=torch.int64)
    length, dir_, cand = _cast_prefilter(soup, from_pos, delta, radius,
                                         half_height, mask)
    contact, toi = _analytic_toi(soup, from_pos, dir_, length, radius,
                                 half_height, cand)
    toi = torch.where(contact, toi, torch.zeros_like(toi))
    return _cast_select(soup, from_pos, delta, dir_, toi, contact,
                        cand.sum(-1, dtype=torch.int32), radius, half_height,
                        blocking, min_normal_y)


def capsule_cast_ca(soup: TriangleSoup, from_pos, delta, radius,
                    half_height, mask=LAYER_ALL, blocking: bool = False,
                    min_normal_y=None,
                    max_iters: int = DEFAULT_CA_ITERS) -> CapsuleCastHit:
    """Conservative-advancement cast with the reference's schedule
    (CollisionQuery.swift:1285-1394): advance max(dist - r, max(0.02 r,
    1e-4)), contact at dist <= r + 1e-5, the over-length test before the
    distance test, the last safe t advanced only on non-contact steps, and
    a 10-step bisection that keeps hi when the bracket is under 1e-5."""
    radius, half_height, min_normal_y = _per_query(
        from_pos, radius, half_height, min_normal_y)
    (mask,) = _per_query(from_pos, mask, dtype=torch.int64)
    length, dir_, cand = _cast_prefilter(soup, from_pos, delta, radius,
                                         half_height, mask)
    fp = from_pos[..., None, :]
    d = dir_[..., None, :]
    L = length[..., None]
    r = _tri_axis(radius)
    hh = _tri_axis(half_height)
    min_adv = torch.clamp(r * 0.02, min=1e-4)

    # status: 0 advancing, 1 contact, 2 missed. A finished lane's carry is
    # unchanged by the body, so the fixed count gives the early-exit loop's
    # records.
    t = torch.zeros(cand.shape, device=cand.device)
    last_safe = t
    status = torch.where(cand, 0, 2).to(torch.int32)
    iters = torch.zeros_like(status)
    for _ in range(max_iters):
        advancing = status == 0
        iters = iters + advancing.to(torch.int32)
        over = t > L
        dist, _, _ = segment_triangle_distance(fp + d * t[..., None], hh,
                                               soup.v0, soup.v1, soup.v2)
        contact = dist <= r + CONTACT_EPS
        status = torch.where(advancing, torch.where(
            over, 2, torch.where(contact, 1, 0)).to(torch.int32), status)
        still = status == 0
        last_safe = torch.where(still, t, last_safe)
        t = torch.where(still, t + torch.maximum(dist - r, min_adv), t)
    contact = status == 1

    # Bisection on contact lanes, while any lane of the query still has a
    # wide bracket (per query, as the reference's loop runs per cast).
    zero = torch.zeros_like(t)
    ls = torch.minimum(torch.maximum(last_safe, zero), L)
    tc = torch.minimum(torch.maximum(t, zero), L)
    lo, hi = torch.minimum(ls, tc), torch.maximum(ls, tc)
    tiny = (hi - lo) < 1e-5
    lo_r, hi_r = lo, hi
    for _ in range(REFINE_ITERS):
        run = (contact & ((hi_r - lo_r) >= 1e-5)).any(-1, keepdim=True)
        mid = 0.5 * (lo_r + hi_r)
        dist, _, _ = segment_triangle_distance(fp + d * mid[..., None], hh,
                                               soup.v0, soup.v1, soup.v2)
        inside = dist <= r
        lo_r = torch.where(run & ~inside, mid, lo_r)
        hi_r = torch.where(run & inside, mid, hi_r)
    toi = torch.where(tiny, hi, hi_r)
    return _cast_select(soup, from_pos, delta, dir_, toi, contact,
                        iters.sum(-1), radius, half_height, blocking,
                        min_normal_y)


def capsule_overlap_all(soup: TriangleSoup, center, radius, half_height,
                        mask=LAYER_ALL, k: int = 8) -> CapsuleOverlapHits:
    """The K deepest penetrating triangles of each capsule, deepest first
    (the reference returns the first 8 in traversal order and its caller
    sorts by depth, Systems.swift:759)."""
    radius, half_height = _per_query(center, radius, half_height)
    (mask,) = _per_query(center, mask, dtype=torch.int64)
    dist, seg_p, tri_p = segment_triangle_distance(
        center[..., None, :], _tri_axis(half_height), soup.v0, soup.v1,
        soup.v2)
    r = _tri_axis(radius)
    ok = _layer_mask(soup, mask) & (dist < r)
    depth = torch.where(ok, r - dist, torch.zeros_like(dist))
    tn = soup.normal
    axis = seg_p - tri_p
    axis_n = axis / torch.clamp(torch.sqrt((axis * axis).sum(-1, keepdim=True)),
                                min=1e-20)
    normal = torch.where((dist < 1e-6)[..., None], tn, axis_n)
    tri_n = torch.where((tn * normal).sum(-1, keepdim=True) < 0, -tn, tn)

    top_depth, top_idx = _top_k(depth, k)
    valid = top_depth > 0

    def take(x):
        x = x.expand(*depth.shape, *x.shape[depth.dim():])
        if x.dim() == depth.dim():
            return torch.gather(x, -1, top_idx)
        return torch.gather(x, -2, top_idx[..., None].expand(
            *top_idx.shape, x.shape[-1]))

    tri_id = take(soup.tri_id)
    return CapsuleOverlapHits(
        depth=top_depth, normal=take(normal), tri_normal=take(tri_n),
        position=take(tri_p),
        tri_index=torch.where(valid, tri_id, torch.full_like(tri_id, -1)),
        valid=valid, candidates=ok.sum(-1, dtype=torch.int32))


def raycast(soup: TriangleSoup, origin, direction, max_distance,
            mask=LAYER_ALL) -> RaycastHit:
    """The nearest hit of each ray (origin/direction (*B,3)) within
    ``max_distance``."""
    (max_distance,) = _per_query(origin, max_distance)
    (mask,) = _per_query(origin, mask, dtype=torch.int64)
    hit, t = ray_triangle(origin[..., None, :], direction[..., None, :],
                          soup.v0, soup.v1, soup.v2)
    ok = hit & _layer_mask(soup, mask) & (t < _tri_axis(max_distance))
    t_masked = torch.where(ok, t, torch.full_like(t, BIG))
    best = t_masked.argmin(-1, keepdim=True)

    def take(x, vec=False):
        if vec:
            return torch.gather(x.expand(*t.shape, 3), -2, best[..., None]
                                .expand(*best.shape, 3))[..., 0, :]
        return torch.gather(x.expand(t.shape), -1, best)[..., 0]

    t_best = take(t)
    best_ok = take(t_masked) < BIG
    tn = take(soup.normal, vec=True)
    n = torch.where((tn * direction).sum(-1, keepdim=True) > 0, -tn, tn)
    tri_id = take(soup.tri_id)
    return RaycastHit(
        hit=best_ok,
        distance=torch.where(best_ok, t_best, torch.full_like(t_best, BIG)),
        position=origin + direction * t_best[..., None], normal=n,
        tri_index=torch.where(best_ok, tri_id, torch.full_like(tri_id, -1)),
        mu_s=take(soup.mu_s), mu_k=take(soup.mu_k))
