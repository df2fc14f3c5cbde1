"""Kinematic character controller: port of swift_game_engine_tpu/physics/
character.py.

Move-and-slide with ground snap for all N agents at once (reference:
Game/Systems.swift:1402-1903 KinematicMoveStopSystem and its resolvers at
:644-1399). The reference runs one agent's pipeline under ``vmap``; here
every stage is written over the agent axis: per-agent scalars are (N,)
tensors, vectors (N,3), the collision soup is shared (T,) or per agent
(N, cap) from the broadphase. The reference's ``lax.while_loop``s
(depenetration, the slide loop) run their fixed maximum counts with
done-masks: a finished agent's carry is left as it is, as the batched
while loop's select leaves it, so the records are the same and nothing is
read back to the host. Agent-agent sweeps use the start-of-substep
snapshot of all agents (Systems.swift:1592-1611,1837).

Stage order (Systems.swift:1842-1901): contact-cache decay -> platform
carry -> velocity gate -> depenetration (<= 4) -> slide loop (<= 4:
blocking static cast + agent sweep + slide resolve + crease clamp) ->
ground probe / snap / slope friction -> writeback.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import math3d as m3
from ..math3d import where_rows as _sel, xz as _xz
from . import queries as Q
from .capsule_pair import capsule_capsule_sweep
from .collision_world import LAYER_ALL, TriangleSoup

BIG = 3.0e38
MANIFOLD_SLOTS = 4          # ContactManifoldCache.maxCount
MANIFOLD_FRAMES = 8         # ContactManifoldCache.maxFrames
SIDE_FRAMES = 3


def _down(dist):
    """(0, -dist, 0) for (N,) or (...,) distances."""
    z = torch.zeros_like(dist)
    return torch.stack([z, -dist, z], -1)


class ControllerParams(NamedTuple):
    """Per-agent tuning (Components.swift:353-431 defaults)."""

    radius: torch.Tensor
    half_height: torch.Tensor
    skin_width: torch.Tensor
    ground_snap_skin: torch.Tensor
    snap_distance: torch.Tensor
    fall_probe_distance: torch.Tensor
    ground_snap_max_speed: torch.Tensor
    ground_snap_max_toi: torch.Tensor
    ground_snap_max_step: torch.Tensor
    ground_sweep_max_step: torch.Tensor
    min_ground_dot: torch.Tensor
    collision_mask: torch.Tensor     # int64 (uint32 bit pattern)
    agent_radius: torch.Tensor       # radiusOverride ?? radius
    agent_mass_weight: torch.Tensor
    agent_solid: torch.Tensor        # bool
    active: torch.Tensor             # bool: inactive agents are skipped

    @staticmethod
    def defaults(n: int) -> dict:
        """The default tuning of ``n`` agents as numpy arrays by field."""
        def f(v):
            return np.full((n,), v, np.float32)
        return dict(
            radius=f(1.5), half_height=f(1.0), skin_width=f(0.3),
            ground_snap_skin=f(0.05), snap_distance=f(0.8),
            fall_probe_distance=f(200.0), ground_snap_max_speed=f(5.0),
            ground_snap_max_toi=f(0.1), ground_snap_max_step=f(0.1),
            ground_sweep_max_step=f(0.1), min_ground_dot=f(0.5),
            collision_mask=np.full((n,), LAYER_ALL, np.int64),
            agent_radius=f(1.5), agent_mass_weight=f(1.0),
            agent_solid=np.ones((n,), bool), active=np.ones((n,), bool))


class ControllerState(NamedTuple):
    """Mutable per-agent contact state."""

    grounded: torch.Tensor            # (N,) bool
    grounded_near: torch.Tensor       # (N,) bool
    ground_normal: torch.Tensor       # (N,3)
    ground_tri: torch.Tensor          # (N,) int32
    ground_sliding: torch.Tensor      # (N,) bool
    ground_transition_frames: torch.Tensor  # (N,) int32
    ground_distance: torch.Tensor     # (N,)
    side_normal: torch.Tensor         # (N,3)
    side_frames: torch.Tensor         # (N,) int32
    manifold_tri: torch.Tensor        # (N,4) int32 (-1 empty)
    manifold_normal: torch.Tensor     # (N,4,3)
    manifold_frames: torch.Tensor     # (N,) int32
    # Per-substep query stats (CollisionQuery.swift:280-318, reset each
    # substep, Systems.swift:176).
    query_candidates: torch.Tensor    # (N,) int32 prefilter-passing tris
    query_casts: torch.Tensor         # (N,) int32 casts + overlap tests

    @staticmethod
    def initial(n: int, device=None):
        def i32(v, shape=(n,)):
            return torch.full(shape, v, dtype=torch.int32, device=device)
        up = torch.zeros((n, 3), device=device)
        up[:, 1] = 1.0
        false = torch.zeros((n,), dtype=torch.bool, device=device)
        return ControllerState(
            grounded=false, grounded_near=false.clone(), ground_normal=up,
            ground_tri=i32(-1), ground_sliding=false.clone(),
            ground_transition_frames=i32(0),
            ground_distance=torch.full((n,), BIG, device=device),
            side_normal=torch.zeros((n, 3), device=device),
            side_frames=i32(0),
            manifold_tri=i32(-1, (n, MANIFOLD_SLOTS)),
            manifold_normal=torch.zeros((n, MANIFOLD_SLOTS, 3),
                                        device=device),
            manifold_frames=i32(0), query_candidates=i32(0),
            query_casts=i32(0))


class PlatformSet(NamedTuple):
    """Kinematic platform AABBs + per-substep deltas (world space)."""

    aabb_min: torch.Tensor  # (P,3)
    aabb_max: torch.Tensor  # (P,3)
    delta: torch.Tensor     # (P,3) position - prev position
    valid: torch.Tensor     # (P,) bool


class AgentSnapshot(NamedTuple):
    """Start-of-substep view of all agents for agent-agent sweeps."""

    position: torch.Tensor     # (N,3)
    velocity: torch.Tensor     # (N,3)
    radius: torch.Tensor       # (N,)
    half_height: torch.Tensor  # (N,)
    solid: torch.Tensor        # (N,) bool


# ---------------------------------------------------------------------------
# Contact manifold cache (Systems.swift:1093-1205)


def _manifold_lookup(tri, m_tri, m_normal):
    """Cached normal of ``tri`` (N,) -> (normal (N,3) or zeros, found)."""
    match = (m_tri == tri[:, None]) & (m_tri >= 0)
    found = match.any(1)
    idx = match.to(torch.int32).argmax(1)
    cached = torch.gather(m_normal, 1, idx[:, None, None].expand(-1, 1, 3))
    return _sel(found, cached[:, 0], torch.zeros_like(cached[:, 0])), found


def _manifold_update(tri, normal, m_tri, m_normal, m_frames, side_normal):
    """ContactManifoldCache.update (Systems.swift:1177-1204)."""
    n_ok = (normal * normal).sum(-1) >= 1e-8
    frames = torch.where(n_ok, MANIFOLD_FRAMES, m_frames).to(m_frames.dtype)
    match = (m_tri == tri[:, None]) & (m_tri >= 0)
    found = match.any(1)
    idx = match.to(torch.int32).argmax(1)
    slot = torch.arange(m_tri.shape[1], device=m_tri.device) == idx[:, None]
    cached = torch.gather(m_normal, 1,
                          idx[:, None, None].expand(-1, 1, 3))[:, 0]
    n_aligned = _sel((cached * normal).sum(-1) < 0, -normal, normal)
    combined = m3.normalize(cached * 0.75 + n_aligned * 0.25)

    blend = found & n_ok
    m_normal_upd = torch.where((slot & blend[:, None])[..., None],
                               combined[:, None, :], m_normal)
    side_upd = _sel(blend, combined, side_normal)
    shifted_tri = torch.cat([tri[:, None].to(m_tri.dtype), m_tri[:, :-1]], 1)
    n_unit = m3.normalize(normal)
    shifted_nrm = torch.cat([n_unit[:, None], m_normal[:, :-1]], 1)
    insert = ~found & n_ok
    return (_sel(insert, shifted_tri, m_tri),
            _sel(insert, shifted_nrm, m_normal_upd), frames,
            _sel(insert, n_unit, side_upd))


def _cache_record(tri, normal, is_side, m_tri, m_normal, m_frames,
                  side_normal, side_frames, enable):
    """DefaultContactCachePolicy.record (Systems.swift:1122-1133), masked
    by ``enable`` (N,)."""
    nt, nn, nf, ns = _manifold_update(tri, normal, m_tri, m_normal, m_frames,
                                      side_normal)
    side = enable & is_side
    side_normal = _sel(enable, ns, side_normal)
    return (_sel(enable, nt, m_tri), _sel(enable, nn, m_normal),
            _sel(enable, nf, m_frames),
            _sel(side, m3.normalize(normal), side_normal),
            torch.where(side, SIDE_FRAMES, side_frames).to(side_frames.dtype))


# ---------------------------------------------------------------------------
# Platform carry (Systems.swift:644-731)


def _platform_carry(position, radius, half_height, skin_width,
                    ground_snap_skin, snap_distance, platforms: PlatformSet):
    """Carry (N,3) of each agent: the largest moving platform it stands on,
    else the summed XZ push of platforms moving into its side."""
    px, py, pz = (position[:, i, None] for i in range(3))
    r, hh = radius[:, None], half_height[:, None]
    cap_half = hh + r
    base_y = py - cap_half
    side_tol = torch.maximum(skin_width, ground_snap_skin)[:, None]
    amin, amax, delta = platforms.aabb_min, platforms.aabb_max, \
        platforms.delta
    dsq = (delta * delta).sum(-1)
    moving = platforms.valid & (dsq >= 1e-8)
    cap_min = torch.stack([px - r, py - cap_half, pz - r], -1)
    cap_max = torch.stack([px + r, py + cap_half, pz + r], -1)
    overlap = ((cap_min <= amax + side_tol[..., None]) &
               (cap_max >= amin - side_tol[..., None])).all(-1)   # (N,P)
    within_xz = (px >= amin[:, 0] - r) & (px <= amax[:, 0] + r) & \
        (pz >= amin[:, 2] - r) & (pz <= amax[:, 2] + r)
    top_y = amax[:, 1]
    top_tol = snap_distance[:, None] + side_tol + 0.05
    on_top = within_xz & (base_y >= top_y - top_tol) & \
        (base_y <= top_y + top_tol)

    carry_cand = moving & overlap & on_top
    carry_len = torch.where(carry_cand, dsq, torch.full_like(carry_cand,
                                                             -1.0, dtype=dsq.dtype))
    best = carry_len.argmax(1)
    best_len = torch.gather(carry_len, 1, best[:, None])[:, 0]
    best_carry = _sel(best_len > 1e-8, delta[best], torch.zeros_like(position))

    y_ok = (py >= amin[:, 1] - cap_half) & (py <= amax[:, 1] + cap_half)
    outside_x = (px < amin[:, 0] - r) | (px > amax[:, 0] + r)
    outside_z = (pz < amin[:, 2] - r) | (pz > amax[:, 2] + r)
    cx = torch.minimum(torch.maximum(px, amin[:, 0]), amax[:, 0])
    cz = torch.minimum(torch.maximum(pz, amin[:, 2]), amax[:, 2])
    dx, dz = px - cx, pz - cz
    side_dist_sq = dx * dx + dz * dz
    side_push_tol = r + side_tol
    dir_len = torch.sqrt(torch.clamp(side_dist_sq, min=0.0))
    safe_len = torch.where(dir_len > 1e-5, dir_len, torch.ones_like(dir_len))
    move_toward = (delta[:, 0] * dx + delta[:, 2] * dz) / safe_len
    push_cand = moving & overlap & ~on_top & y_ok & (outside_x | outside_z) & \
        (side_dist_sq <= side_push_tol * side_push_tol) & (dir_len > 1e-5) & \
        (move_toward > 0)
    push = torch.where(push_cand[..., None], _xz(delta),
                       torch.zeros((), device=delta.device)).sum(1)

    use_carry = (best_carry * best_carry).sum(-1) > 1e-8
    use_push = (push * push).sum(-1) > 1e-8
    return _sel(use_carry, best_carry,
                _sel(use_push, push, torch.zeros_like(push)))


# ---------------------------------------------------------------------------
# Slide resolve (Systems.swift:1207-1375)


class SlideOptions(NamedTuple):
    allow_horizontal_ground_pass: bool
    adjust_velocity: bool
    use_ground_snap_skin_for_static: bool
    allow_triangle_normal_ground_like: bool


KINEMATIC_MOVE = SlideOptions(False, True, True, True)
AGENT_SEPARATION = SlideOptions(True, False, False, False)


def _resolve_hit(remaining, length, position, velocity, hit_toi, hit_normal,
                 hit_tri_normal, hit_is_static, min_ground_dot, skin_width,
                 ground_snap_skin, ground_sweep_max_step, was_grounded,
                 was_grounded_near, side_frames, cached_side_normal,
                 cached_side_found, fallback_side_normal,
                 options: SlideOptions):
    """One slide-hit response per agent -> (position, remaining, velocity,
    done, slide_normal): SlideResolver.resolveHit (Systems.swift:1229-1375)
    with its branches as masks; the two unreachable early-outs after
    ``into < -eps`` (:1332-1341) are left out. ``cached_side_normal/found``
    is the manifold-cache entry of the hit triangle;
    ``fallback_side_normal`` the controller's last side normal, applied by
    the |dot| > 0.5 rule when there is no cache entry."""
    zero = torch.zeros_like(hit_toi)
    hit_is_ground_like = hit_is_static & (hit_tri_normal[:, 1] >= min_ground_dot)
    snap_skin_ok = hit_is_ground_like & options.use_ground_snap_skin_for_static
    contact_skin = torch.where(hit_is_static, torch.where(
        snap_skin_ok, ground_snap_skin, skin_width), zero)

    slide_normal = hit_normal
    side_eligible = hit_is_static & (slide_normal[:, 1] < min_ground_dot) & \
        (side_frames > 0)
    cached_flipped = _sel((cached_side_normal * slide_normal).sum(-1) < 0,
                          -cached_side_normal, cached_side_normal)
    fb_len_sq = (fallback_side_normal * fallback_side_normal).sum(-1)
    fb_n = fallback_side_normal / torch.sqrt(
        torch.clamp(fb_len_sq, min=1e-20))[:, None]
    fb_dot = (fb_n * slide_normal).sum(-1)
    fb_apply = side_eligible & ~cached_side_found & (fb_len_sq > 1e-6) & \
        (fb_dot.abs() > 0.5)
    slide_normal = _sel(fb_apply, _sel(fb_dot >= 0, fb_n, -fb_n), slide_normal)
    slide_normal = _sel(side_eligible & cached_side_found, cached_flipped,
                        slide_normal)

    # Wall-ify below min_ground_dot.
    below = slide_normal[:, 1] < min_ground_dot
    use_tri = below & hit_is_ground_like & \
        options.allow_triangle_normal_ground_like
    slide_normal = _sel(use_tri, hit_tri_normal, slide_normal)
    below2 = slide_normal[:, 1] < min_ground_dot
    flat = _xz(slide_normal)
    flat_len = m3.norm(flat)
    degenerate = below2 & (flat_len <= 1e-5)
    slide_normal = _sel(below2 & ~degenerate,
                        flat / torch.clamp(flat_len, min=1e-20)[:, None],
                        slide_normal)

    into = (remaining * slide_normal).sum(-1)
    into_eps = 1e-4 * length
    effective_skin = torch.where((hit_toi <= contact_skin) & (into < -into_eps),
                                 torch.minimum(contact_skin, hit_toi * 0.5),
                                 contact_skin)
    sticky = contact_skin * 0.1

    flat_rem = remaining[:, 1].abs() < 1e-5
    case_pass_h = hit_is_static & flat_rem & \
        (hit_normal[:, 1] >= min_ground_dot) & \
        options.allow_horizontal_ground_pass
    case_degen = degenerate
    case_sticky = (hit_toi <= sticky) & (into < -into_eps)
    case_not_into = into >= -into_eps

    dir_ = remaining / torch.clamp(length, min=1e-20)[:, None]
    raw_move = torch.clamp(hit_toi - effective_skin, min=0.0)
    ground_clamp = (slide_normal[:, 1] >= min_ground_dot) & \
        (remaining[:, 1] < 0) & (raw_move > ground_sweep_max_step)
    move_dist = torch.where(ground_clamp, ground_sweep_max_step, raw_move)
    pos_slide = position + dir_ * move_dist[:, None]
    leftover = remaining - dir_ * move_dist[:, None]
    leftover = leftover - slide_normal * (leftover * slide_normal).sum(
        -1, keepdim=True)
    gate_y = was_grounded & was_grounded_near & (leftover[:, 1] < 0)
    leftover = _sel(gate_y, _xz(leftover), leftover)
    residual = (leftover * slide_normal).sum(-1)
    leftover = _sel(residual.abs() < 1e-5,
                    leftover - slide_normal * residual[:, None], leftover)
    slide_done = (leftover * leftover).sum(-1) < 1e-8
    v_into = (velocity * slide_normal).sum(-1)
    if options.adjust_velocity:
        vel_slide = _sel(v_into < 0, velocity - slide_normal * v_into[:, None],
                         velocity)
    else:
        vel_slide = velocity

    gate_pass = case_not_into & was_grounded_near & hit_is_static & \
        ~hit_is_ground_like & (remaining[:, 1] < 0)
    rem_pass = _sel(gate_pass, _xz(remaining), remaining)
    rem_sticky = remaining - slide_normal * into[:, None]

    def sel(ph, dg, st, ni, sl):
        """Priority: pass_h > degen > sticky > not_into > slide."""
        out = _sel(case_not_into, ni, sl)
        out = _sel(case_sticky, st, out)
        out = _sel(case_degen, dg, out)
        return _sel(case_pass_h, ph, out)

    zero3 = torch.zeros_like(remaining)
    true = torch.ones_like(slide_done)
    new_position = sel(position + remaining, position + remaining, position,
                       position + rem_pass, pos_slide)
    new_remaining = sel(zero3, zero3, rem_sticky, zero3,
                        _sel(slide_done, zero3, leftover))
    new_velocity = sel(velocity, velocity, velocity, velocity, vel_slide)
    done = sel(true, true, ~true, true, slide_done)
    return new_position, new_remaining, new_velocity, done, slide_normal


# ---------------------------------------------------------------------------
# Depenetration (Systems.swift:734-808)


def _depenetrate(soup, position, velocity, p, cache, iterations: int):
    """Iterative capsule depenetration. ``cache`` = (m_tri, m_normal,
    m_frames, side_normal, side_frames). Returns (position, velocity,
    cache, depen_normal, resolved, q_cand, q_casts)."""
    mgd = p.min_ground_dot
    slop = torch.clamp(p.skin_width * 0.5, min=0.001)
    n = position.shape[0]
    dev = position.device
    normal_sum = torch.zeros((n, 3), device=dev)
    normal_weight = torch.zeros((n,), device=dev)
    did = torch.zeros((n,), dtype=torch.bool, device=dev)
    stop = torch.zeros_like(did)
    q_cand = torch.zeros((n,), dtype=torch.int32, device=dev)
    q_casts = torch.zeros_like(q_cand)
    for _ in range(iterations):
        ran = ~stop
        hits = Q.capsule_overlap_all(soup, position, p.radius, p.half_height,
                                     p.collision_mask, k=8)
        q_cand = q_cand + torch.where(ran, hits.candidates, 0)
        q_casts = q_casts + ran.to(torch.int32)
        stop = stop | ~hits.valid[:, 0]
        act = ~stop

        deepest_n = hits.normal[:, 0]
        side_contact = deepest_n[:, 1] < mgd
        use2 = ~side_contact & hits.valid[:, 1]
        max_depth = hits.depth[:, 0]

        frame_normal = torch.zeros_like(position)
        for h in range(2):
            use = act & hits.valid[:, h]
            if h == 1:
                use = use & use2
            n_h = hits.normal[:, h]
            cached, found = _manifold_lookup(hits.tri_index[:, h], cache[0],
                                             cache[1])
            n_eff = _sel(found, cached, n_h)
            frame_normal = frame_normal + _sel(
                use, n_eff * hits.depth[:, h, None], torch.zeros_like(n_eff))
            cache = _cache_record(hits.tri_index[:, h], n_eff,
                                  n_h[:, 1] < mgd, *cache, use)

        fn_len = m3.norm(frame_normal)
        depen_n = _sel(fn_len > 1e-6,
                       frame_normal / torch.clamp(fn_len, min=1e-20)[:, None],
                       frame_normal)
        push = torch.where(side_contact,
                           torch.minimum(torch.clamp(max_depth, min=0.0),
                                         p.skin_width),
                           torch.clamp(max_depth + slop, min=0.0))
        stop = stop | (act & (push <= 1e-6))
        act = act & (push > 1e-6)

        position = _sel(act, position + depen_n * push[:, None], position)
        v_into = (velocity * depen_n).sum(-1)
        velocity = _sel(act & (v_into < 0),
                        velocity - depen_n * v_into[:, None], velocity)
        did = did | act
        normal_sum = normal_sum + _sel(act, depen_n * max_depth[:, None],
                                       torch.zeros_like(depen_n))
        normal_weight = normal_weight + torch.where(act, max_depth,
                                                    torch.zeros_like(max_depth))

    avg = _sel(normal_weight > 1e-6,
               normal_sum / torch.clamp(normal_weight, min=1e-20)[:, None],
               normal_sum)
    avg_len = m3.norm(avg)
    depen_normal = avg / torch.clamp(avg_len, min=1e-20)[:, None]
    return (position, velocity, cache, depen_normal, did & (avg_len > 1e-20),
            q_cand, q_casts)


# ---------------------------------------------------------------------------
# Ground probe / snap / slope friction (Systems.swift:810-1021)


def _ground_contact(soup, position, velocity, p, was_grounded,
                    was_grounded_near, prev_normal, prev_tri, ground_sliding,
                    transition_frames, gravity, dt):
    """The six ground probes (center snap, long fall probe, 4 normal
    samples at 0.6 r) as one (N, 6) cast, then snap, ground normal,
    transition frames and slope friction."""
    mgd = p.min_ground_dot
    gss, skin = p.ground_snap_skin, p.skin_width
    snap_dist = p.snap_distance
    n = position.shape[0]
    eye = torch.eye(3, device=position.device)
    offs = torch.stack([eye[1] * 0.0, eye[1] * 0.0, eye[0], -eye[0], eye[2],
                        -eye[2]])
    origins = position[:, None, :] + offs * (p.radius * 0.6)[:, None, None]
    dist = torch.stack([snap_dist, p.fall_probe_distance] + [snap_dist] * 4,
                       1)
    deltas = _down(dist)

    def per_probe(x):
        return x[:, None].expand(n, 6)

    psoup = soup.unsqueeze(1) if soup.v0.dim() == 3 else soup
    probes = Q.capsule_cast(psoup, origins, deltas, per_probe(p.radius),
                            per_probe(p.half_height),
                            mask=per_probe(p.collision_mask),
                            min_normal_y=per_probe(mgd))
    c = Q.CapsuleCastHit(*(f[:, 0] for f in probes))
    fall = Q.CapsuleCastHit(*(f[:, 1] for f in probes))

    big = torch.full_like(c.toi, BIG)
    center_ok = c.hit & (snap_dist > 0) & (c.toi <= snap_dist)
    distance = torch.where(fall.hit & (p.fall_probe_distance > 0), fall.toi,
                           big)
    bottom_y = position[:, 1] - p.half_height - p.radius
    ground_tol = torch.maximum(skin, gss)
    valid_point = c.position[:, 1] <= bottom_y + ground_tol
    near = c.toi <= torch.maximum(gss, skin)
    distance = torch.where(center_ok, c.toi, distance)

    gate_vel = velocity[:, 1] <= 0
    v_into = (velocity * c.normal).sum(-1)
    gate_speed = v_into >= -p.ground_snap_max_speed
    gate_toi = c.toi <= p.ground_snap_max_toi
    can_snap = valid_point & gate_vel & (near | gate_speed | gate_toi)
    can_snap = torch.where(was_grounded_near & center_ok, valid_point,
                           can_snap)
    can_snap = can_snap & center_ok
    grounded = center_ok & valid_point & (near | can_snap)

    # Normal averaging on non-flat ground (Systems.swift:895-924).
    do_samples = grounded & (c.tri_normal[:, 1] < 0.98) & \
        (was_grounded_near | near)
    combine_tol = torch.clamp(torch.maximum(gss, skin), min=0.05)
    s_tn = probes.tri_normal[:, 2:]
    s_ok = do_samples[:, None] & probes.hit[:, 2:] & \
        (probes.toi[:, 2:] <= (c.toi + combine_tol)[:, None]) & \
        ((s_tn * c.tri_normal[:, None]).sum(-1) > 0.98)
    normal_sum = c.tri_normal + torch.where(s_ok[..., None], s_tn,
                                            torch.zeros_like(s_tn)).sum(1)
    n_len = m3.norm(normal_sum)
    normal = _sel(n_len > 1e-6,
                  normal_sum / torch.clamp(n_len, min=1e-20)[:, None],
                  c.tri_normal)

    up = torch.zeros_like(normal)
    up[:, 1] = 1.0
    smooth_ok = grounded & was_grounded_near & \
        ((prev_normal * normal).sum(-1) > 0.9)
    normal = _sel(smooth_ok, m3.normalize(prev_normal * 0.8 + normal * 0.2),
                  normal)
    normal = _sel(grounded & c.flatten, up, normal)
    normal = _sel(grounded, normal, up)

    # GroundSnap (:945-963).
    raw_move = torch.clamp(c.toi - gss, min=0.0)
    move = torch.where(near & (raw_move > p.ground_snap_max_step),
                       p.ground_snap_max_step, raw_move)
    position = _sel(can_snap, position + _down(move), position)
    v_into_snap = (velocity * c.normal).sum(-1)
    velocity = _sel(can_snap & (v_into_snap < 0),
                    velocity - c.normal * v_into_snap[:, None], velocity)

    tri = torch.where(grounded, c.tri_index, prev_tri)
    transition_frames = torch.where(
        grounded & (c.tri_index != prev_tri) &
        (normal[:, 1] - prev_normal[:, 1] > 0.02),
        3, transition_frames).to(transition_frames.dtype)

    # SlopeFriction (:965-1021).
    nn = m3.normalize(normal)
    flat_exit = nn[:, 1] > 0.98
    in_transition = transition_frames > 0
    tf_out = torch.where(grounded & ~flat_exit & in_transition,
                         transition_frames - 1, transition_frames)
    tf_out = torch.where(grounded & flat_exit, 0, tf_out).to(tf_out.dtype)

    g_n = (gravity * nn).sum(-1)
    g_tan = gravity - nn * g_n[:, None]
    g_tan_len = m3.norm(g_tan)
    slope_active = grounded & ~flat_exit & ~in_transition & (g_tan_len > 0.5)
    g_tan_dir = g_tan / torch.clamp(g_tan_len, min=1e-20)[:, None]
    stick_limit = c.mu_s * g_n.abs()
    enter_slide = g_tan_len > stick_limit * 1.05
    exit_slide = g_tan_len < stick_limit * 0.9
    sliding = torch.where(
        slope_active, torch.where(ground_sliding, ~exit_slide, enter_slide),
        ~(grounded & ~flat_exit & in_transition) & grounded & ground_sliding)
    sliding = sliding & ~(grounded & flat_exit)

    stick = slope_active & ~sliding & (g_tan_len <= stick_limit)
    v_tan = velocity - nn * (velocity * nn).sum(-1, keepdim=True)
    downhill = (v_tan * g_tan_dir).sum(-1)
    velocity = _sel(stick & (downhill > 0),
                    velocity - g_tan_dir * downhill[:, None], velocity)
    slide_mag = torch.clamp(g_tan_len - c.mu_k * g_n.abs(), min=0.0)
    do_slide = slope_active & ~stick & (slide_mag > 0)
    velocity = _sel(do_slide, velocity + g_tan_dir * (slide_mag * dt)[:, None],
                    velocity)

    # groundedNear is the raw proximity flag (Systems.swift:879).
    return dict(position=position, velocity=velocity, grounded=grounded,
                grounded_near=near & center_ok, normal=normal, tri=tri,
                distance=distance, sliding=sliding, transition_frames=tf_out,
                q_cand=probes.iterations.sum(1, dtype=torch.int32),
                q_casts=torch.full_like(tri, 6))


# ---------------------------------------------------------------------------
# The substep of all agents


def _agent_sweep(position, remaining, remaining_len, base_move_len, dt,
                 p: ControllerParams, snapshot: AgentSnapshot, rows=None):
    """Earliest agent-agent hit of each agent (Systems.swift:1053-1091) ->
    (toi, normal, hit). ``rows``: the moving agents' indices into the
    snapshot (all of them if None)."""
    time_scale = torch.where(
        base_move_len > 1e-6,
        torch.clamp(remaining_len / torch.clamp(base_move_len, min=1e-20),
                    max=1.0), torch.ones_like(base_move_len))
    seg_dt = dt * time_scale
    other_delta = snapshot.velocity[None] * seg_dt[:, None, None]
    toi, normal, hit = capsule_capsule_sweep(
        position[:, None, :], remaining[:, None, :], p.agent_radius[:, None],
        p.half_height[:, None], snapshot.position[None], other_delta,
        snapshot.radius[None], snapshot.half_height[None])
    n = snapshot.position.shape[0]
    idx = torch.arange(n, device=position.device)
    own = idx if rows is None else rows
    others = snapshot.solid[None] & (idx[None] != own[:, None]) & \
        p.agent_solid[:, None]
    toi = torch.where(hit & others, toi, torch.full_like(toi, BIG))
    best = toi.argmin(1, keepdim=True)
    t = torch.gather(toi, 1, best)[:, 0]
    nrm = torch.gather(normal, 1, best[..., None].expand(-1, 1, 3))[:, 0]
    return t, nrm, t < BIG


class CharacterPipeline:
    """Batched kinematic character mover."""

    def __init__(self, gravity=(0.0, -98.0, 0.0),
                 max_slide_iterations: int = 4, depen_iterations: int = 4,
                 broadphase_cap: int = 256):
        self.gravity = tuple(float(g) for g in gravity)
        self.max_slide_iterations = max_slide_iterations
        self.depen_iterations = depen_iterations
        # Broadphase (CollisionQuery.swift:496-707 analog): above this many
        # soup rows each agent queries its nearest ``cap`` candidates
        # (Q.gather_candidates); <= 0 disables.
        self.broadphase_cap = broadphase_cap

    def step(self, soup: TriangleSoup, position, velocity,
             state: ControllerState, params: ControllerParams,
             platforms: PlatformSet, dt: float, rows=None):
        """Advance all agents one fixed substep -> (position, velocity,
        ControllerState). ``rows`` (lo, hi): move only agents lo..hi-1 and
        return theirs; the inputs still hold every agent, since the
        agent-agent sweep reads all of them as they were at the start of
        the substep (an entity-sharded substep, parallel/sharding.py)."""
        p = params
        # fills, not element assignments: setting one element of a CUDA
        # tensor from a Python number copies it from the host and syncs
        gravity = torch.stack([torch.full((), g, device=position.device)
                               for g in self.gravity])
        snapshot = AgentSnapshot(position=position, velocity=velocity,
                                 radius=p.agent_radius,
                                 half_height=p.half_height,
                                 solid=p.agent_solid & p.active)
        own = None
        if rows is not None:
            lo, hi = rows
            position, velocity = position[lo:hi], velocity[lo:hi]
            state = ControllerState(*(x[lo:hi] for x in state))
            p = ControllerParams(*(x[lo:hi] for x in p))
            own = torch.arange(lo, hi, device=position.device)
        n = position.shape[0]
        cap = self.broadphase_cap
        if 0 < cap < soup.v0.shape[0]:
            # Conservative per-substep reach: integrate + slide move at most
            # |v + g dt| dt; the ground probes reach the snap/fall distances
            # below and the sweep step above; + skin and a platform margin.
            speed = m3.norm(velocity + gravity[None] * dt)
            reach = speed * dt + torch.maximum(p.snap_distance,
                                               p.fall_probe_distance) + \
                p.ground_sweep_max_step + p.skin_width + 1.0
            soup, _ = Q.gather_candidates(soup, position, p.half_height,
                                          p.radius, reach, cap)
        position0, velocity0 = position, velocity

        # 1. Contact cache decay (Systems.swift:1105-1116).
        side_frames = torch.clamp(state.side_frames - 1, min=0)
        m_frames = torch.clamp(state.manifold_frames - 1, min=0)
        expired = (state.manifold_frames > 0) & (m_frames == 0)
        m_tri = _sel(expired, -1, state.manifold_tri).to(torch.int32)
        m_normal = _sel(expired, 0.0, state.manifold_normal)
        side_normal = _sel(expired, 0.0, state.side_normal)

        # 2. Platform carry/push.
        position = position + _platform_carry(
            position, p.radius, p.half_height, p.skin_width,
            p.ground_snap_skin, p.snap_distance, platforms)
        was_grounded, was_near = state.grounded, state.grounded_near

        # 3. Velocity gate (Systems.swift:1037-1051).
        held = was_grounded & was_near
        velocity = _sel(held & (velocity[:, 1] < 0), _xz(velocity), velocity)
        remaining = velocity * dt
        remaining = _sel(held & (remaining[:, 1] < 0), _xz(remaining),
                         remaining)

        # 4. Depenetration.
        (position, velocity, cache, depen_normal, depen_ok, q_cand,
         q_casts) = _depenetrate(
            soup, position, velocity, p,
            (m_tri, m_normal, m_frames, side_normal, side_frames),
            self.depen_iterations)
        into = (remaining * depen_normal).sum(-1)
        remaining = _sel(depen_ok & (into < 0),
                         remaining - depen_normal * into[:, None], remaining)

        # 5. Slide loop.
        base_move_len = m3.norm(velocity * dt)
        last_slide_normal = torch.zeros_like(position)
        have_last = torch.zeros((n,), dtype=torch.bool,
                                device=position.device)
        loop_done = torch.zeros_like(have_last)
        for _ in range(self.max_slide_iterations):
            length = m3.norm(remaining)
            it_active = ~loop_done & (length >= 1e-6)
            s_hit = Q.capsule_cast(soup, position, remaining, p.radius,
                                   p.half_height, mask=p.collision_mask,
                                   blocking=True)
            q_cand = q_cand + torch.where(it_active, s_hit.iterations, 0)
            q_casts = q_casts + it_active.to(torch.int32)
            # Cached side-normal substitution (Systems.swift:1683-1694).
            cached_n, cached_found = _manifold_lookup(s_hit.tri_index,
                                                      cache[0], cache[1])
            sub_ok = s_hit.hit & (s_hit.normal[:, 1] < p.min_ground_dot) & \
                (cache[4] > 0) & cached_found
            cached_aligned = _sel((cached_n * s_hit.normal).sum(-1) < 0,
                                  -cached_n, cached_n)
            s_normal = _sel(sub_ok, cached_aligned, s_hit.normal)

            a_toi, a_normal, a_hit = _agent_sweep(
                position, remaining, length, base_move_len, dt, p, snapshot,
                own)

            # Best-hit select (Systems.swift:1378-1398).
            static_skin = torch.where(s_normal[:, 1] >= p.min_ground_dot,
                                      p.ground_snap_skin, p.skin_width)
            static_stop = torch.clamp(s_hit.toi - static_skin, min=0.0)
            agent_stop = torch.clamp(a_toi, min=0.0)
            pick_static = s_hit.hit & (~a_hit | (static_stop <= agent_stop))
            any_hit = s_hit.hit | a_hit
            hit_toi = torch.where(pick_static, s_hit.toi, a_toi)
            hit_normal = _sel(pick_static, s_normal, a_normal)
            hit_tri_normal = _sel(pick_static, s_hit.tri_normal,
                                  torch.zeros_like(a_normal))

            new_pos, new_rem, new_vel, done, _ = _resolve_hit(
                remaining, length, position, velocity, hit_toi, hit_normal,
                hit_tri_normal, pick_static, p.min_ground_dot, p.skin_width,
                p.ground_snap_skin, p.ground_sweep_max_step, was_grounded,
                was_near, cache[4], cached_n, sub_ok, cache[3],
                KINEMATIC_MOVE)

            # Record side contacts (Systems.swift:1738-1743).
            rec = it_active & any_hit & pick_static & \
                (s_normal[:, 1] < p.min_ground_dot)
            cache = _cache_record(s_hit.tri_index, s_normal,
                                  torch.ones_like(rec), *cache, rec)

            # Crease clamp (Systems.swift:1744-1754).
            crease = it_active & any_hit & have_last & \
                ((last_slide_normal * hit_normal).sum(-1).abs() < 0.98)
            axis = m3.cross(last_slide_normal, hit_normal)
            axis_len = m3.norm(axis)
            axis_n = axis / torch.clamp(axis_len, min=1e-20)[:, None]
            new_rem = _sel(crease & (axis_len > 1e-5),
                           axis_n * (new_rem * axis_n).sum(-1, keepdim=True),
                           new_rem)

            hit_now = it_active & any_hit
            position = _sel(it_active, _sel(any_hit, new_pos,
                                            position + remaining), position)
            remaining = _sel(it_active, _sel(any_hit, new_rem,
                                             torch.zeros_like(new_rem)),
                             remaining)
            velocity = _sel(hit_now, new_vel, velocity)
            last_slide_normal = _sel(hit_now, hit_normal, last_slide_normal)
            have_last = have_last | hit_now
            loop_done = loop_done | (it_active & (~any_hit | done))

        # 6. Ground contact.
        g = _ground_contact(soup, position, velocity, p, was_grounded,
                            was_near, state.ground_normal, state.ground_tri,
                            state.ground_sliding,
                            state.ground_transition_frames, gravity, dt)

        act = p.active
        m_tri, m_normal, m_frames, side_normal, side_frames = cache
        zero_i = torch.zeros_like(q_cand)
        new_state = ControllerState(
            grounded=_sel(act, g["grounded"], state.grounded),
            grounded_near=_sel(act, g["grounded_near"], state.grounded_near),
            ground_normal=_sel(act, g["normal"], state.ground_normal),
            ground_tri=_sel(act, g["tri"], state.ground_tri),
            ground_sliding=_sel(act, g["sliding"], state.ground_sliding),
            ground_transition_frames=_sel(act, g["transition_frames"],
                                          state.ground_transition_frames),
            ground_distance=_sel(act, g["distance"], state.ground_distance),
            side_normal=_sel(act, side_normal, state.side_normal),
            side_frames=_sel(act, side_frames, state.side_frames),
            manifold_tri=_sel(act, m_tri, state.manifold_tri),
            manifold_normal=_sel(act, m_normal, state.manifold_normal),
            manifold_frames=_sel(act, m_frames, state.manifold_frames),
            query_candidates=torch.where(act, q_cand + g["q_cand"], zero_i),
            query_casts=torch.where(act, q_casts + g["q_casts"], zero_i))
        return (_sel(act, g["position"], position0),
                _sel(act, g["velocity"], velocity0), new_state)
