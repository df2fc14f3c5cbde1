"""Agent-agent separation after move-and-slide: port of
swift_game_engine_tpu/physics/separation.py.

The reference's XZ hash-grid Gauss-Seidel pass (Game/Systems.swift:
1906-2210) with the same per-pair position/impulse math (inverse-mass
weighted XZ push + approach-velocity cancellation), Jacobi-accumulated per
iteration. Up to ``GRID_MIN_N`` agents every pair is tested in an (N, N)
matrix; above it agents sort by integer XZ cell key (``torch.argsort``
stable, as ``jnp.argsort``: the pair sums follow that order) and each
gathers ``CELL_CAP`` sorted entries from each of its 9 neighbour cells.
Then every agent's accumulated correction is re-run through the
move-and-slide resolver against the static world and re-snapped to the
ground (Systems.swift:2048-2123), batched over agents.

An entity-sharded substep (parallel/sharding.py) passes ``rows``: the pair
passes still run over every agent, since each pass reads every partner's
position after the pass before it (the dense/grid choice and the sorted
cell order follow the whole set), and the re-slide and re-snap, the
pass's capsule casts, run over the rows alone. Each row's result is then
the unsharded pass's.
"""

from __future__ import annotations

import torch

from .. import math3d as m3
from . import queries as Q
from ..math3d import where_rows as _sel
from .character import (AGENT_SEPARATION, ControllerParams, ControllerState,
                        _down, _resolve_hit)
from .collision_world import TriangleSoup

# Dense-matrix cutoff and per-cell candidate cap (the reference's
# production defaults, config.py:91-92).
GRID_MIN_N = 64
CELL_CAP = 12


def _pair_accumulate(position, velocity, pj, vj, rj, hj, skinj, wj, pair_ok,
                     params, inv_w, separation_margin, height_margin):
    """The per-pair math, partner attributes given as (N, K) tensors:
    ``pj`` (N,K,3) positions, ``vj`` (N,K,2) XZ velocities, radius, half
    height, skin and inverse weight. Returns (d_position, d_velocity)."""
    px, py, pz = position[:, 0], position[:, 1], position[:, 2]
    dx = px[:, None] - pj[..., 0]
    dz = pz[:, None] - pj[..., 2]
    dist_sq = dx * dx + dz * dz

    skin_allow = torch.minimum(params.skin_width[:, None], skinj)
    margin = torch.clamp(skin_allow, max=separation_margin)
    min_dist = params.agent_radius[:, None] + rj + margin

    a_min = py - params.half_height
    a_max = py + params.half_height
    height_sep = (a_max[:, None] < (pj[..., 1] - hj) - height_margin) | \
        (a_min[:, None] > (pj[..., 1] + hj) + height_margin)

    w_sum = inv_w[:, None] + wj
    overlap = pair_ok & ~height_sep & (dist_sq < min_dist * min_dist) & \
        (w_sum > 0)
    dist = torch.sqrt(torch.clamp(dist_sq, min=1e-8))
    nx, nz = dx / dist, dz / dist
    pen = min_dist - dist
    zero = torch.zeros_like(pen)
    corr = torch.where(overlap, pen / torch.clamp(w_sum, min=1e-20), zero)
    move_x = (nx * corr).sum(1) * inv_w
    move_z = (nz * corr).sum(1) * inv_w
    zeros = torch.zeros_like(move_x)
    d_pos = torch.stack([move_x, zeros, move_z], -1)

    # Approach-velocity impulse (Systems.swift:1991-2001).
    rvx = velocity[:, 0, None] - vj[..., 0]
    rvz = velocity[:, 2, None] - vj[..., 1]
    vn = rvx * nx + rvz * nz
    impulse = torch.where(overlap & (vn < 0), -vn, zero)
    scale = inv_w[:, None] / torch.clamp(w_sum, min=1e-20)
    dvx = (nx * impulse * scale).sum(1)
    dvz = (nz * impulse * scale).sum(1)
    return d_pos, torch.stack([dvx, zeros, dvz], -1)


def _grid_candidates(position, params, separation_margin):
    """XZ-grid candidates -> (partner index (N, 9*CAP), in-cell mask).
    Cell = 2 max r + margin (Systems.swift:2130-2135); agents sort by
    integer cell key and each windows CELL_CAP sorted entries from each of
    its 9 neighbour cells (the count of smaller keys locates a cell)."""
    n = position.shape[0]
    cell = 2.0 * params.agent_radius.amax() + separation_margin
    lim = 1 << 12
    cx = torch.clamp(torch.floor(position[:, 0] / cell), -lim, lim).to(
        torch.int32)
    cz = torch.clamp(torch.floor(position[:, 2] / cell), -lim, lim).to(
        torch.int32)
    cz0 = cz - cz.amin()
    width = cz0.amax() + 3
    key = (cx - cx.amin() + 1) * width + cz0 + 1
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    offs = torch.arange(-1, 2, dtype=torch.int32, device=position.device)
    nk = key[:, None] + (offs[:, None] * width + offs[None, :]).reshape(-1)[None]
    if n <= 4096:   # the count of smaller keys, as the reference counts
        start = (key_sorted[None, None, :] < nk[:, :, None]).sum(
            -1, dtype=torch.int64)                                # (N, 9)
    else:
        start = torch.searchsorted(key_sorted, nk)
    win = start[..., None] + torch.arange(CELL_CAP, device=position.device)
    win_c = torch.clamp(win, max=n - 1)
    ok = (key_sorted[win_c] == nk[..., None]) & (win < n)
    return order[win_c.reshape(n, -1)], ok.reshape(n, -1)


def separate_agents(soup: TriangleSoup, position, velocity,
                    state: ControllerState, params: ControllerParams,
                    iterations: int = 2, separation_margin: float = 0.2,
                    height_margin: float = 0.1, slide_iterations: int = 2,
                   rows=None):
    """Resolve agent-agent overlaps -> (position, velocity, state);
    position/velocity (N,3). ``rows`` (lo, hi): ``position``, ``velocity``
    and ``params`` hold every agent, ``state`` agents lo..hi-1 alone, and
    the result is theirs (see the module docstring)."""
    n = position.shape[0]
    dev = position.device
    solid = params.agent_solid & params.active
    inv_w = torch.where(params.agent_mass_weight > 0,
                        1.0 / torch.clamp(params.agent_mass_weight,
                                          min=1e-20),
                        torch.zeros_like(params.agent_mass_weight))
    idx = torch.arange(n, device=dev)
    start_position, velocity0 = position, velocity

    for _ in range(iterations):
        if n > GRID_MIN_N:
            j, ok = _grid_candidates(position, params, separation_margin)
            pair_ok = ok & (j != idx[:, None]) & solid[:, None] & solid[j]
        else:
            j = idx[None].expand(n, n)
            pair_ok = solid[:, None] & solid[None, :] & \
                ~torch.eye(n, dtype=torch.bool, device=dev)
        d_pos, d_vel = _pair_accumulate(
            position, velocity, position[j], velocity[:, ::2][j],
            params.agent_radius[j], params.half_height[j],
            params.skin_width[j], inv_w[j], pair_ok, params, inv_w,
            separation_margin, height_margin)
        position = position + d_pos
        velocity = velocity + d_vel

    # Post-process: re-run each accumulated delta through move-and-slide vs
    # the static world, then re-snap to the ground (Systems.swift:2048-2123).
    p = params
    if rows is not None:
        lo, hi = rows
        n = hi - lo
        p = ControllerParams(*(x[lo:hi] for x in p))
        position, velocity = position[lo:hi], velocity[lo:hi]
        start_position, velocity0 = start_position[lo:hi], velocity0[lo:hi]
    delta = position - start_position
    moved = m3.norm(delta) > 1e-6
    pos = _sel(moved, start_position, position)
    remaining = _sel(moved, delta, torch.zeros_like(delta))
    done = ~moved
    q_cand = torch.zeros((n,), dtype=torch.int32, device=dev)
    q_casts = torch.zeros_like(q_cand)
    false = torch.zeros_like(done)
    for _ in range(slide_iterations):
        seg = m3.norm(remaining)
        act = ~done & (seg >= 1e-6)
        hit = Q.capsule_cast(soup, pos, remaining, p.agent_radius,
                             p.half_height, mask=p.collision_mask,
                             blocking=True)
        q_cand = q_cand + torch.where(act, hit.iterations, 0)
        q_casts = q_casts + act.to(torch.int32)
        new_pos, new_rem, _, hdone, _ = _resolve_hit(
            remaining, seg, pos, velocity, hit.toi, hit.normal,
            hit.tri_normal, ~false, p.min_ground_dot, p.skin_width,
            p.ground_snap_skin, p.ground_sweep_max_step, false, false,
            torch.zeros_like(q_cand), torch.zeros_like(pos), false,
            torch.zeros_like(pos), AGENT_SEPARATION)
        pos = _sel(act, _sel(hit.hit, new_pos, pos + remaining), pos)
        remaining = _sel(act & hit.hit, new_rem, torch.zeros_like(new_rem))
        done = done | (act & (~hit.hit | hdone))

    # Re-snap (only if moved and not moving upward).
    do_snap = moved & (velocity[:, 1] <= 0) & (p.snap_distance > 0)
    snap = Q.capsule_cast(soup, pos, _down(p.snap_distance), p.agent_radius,
                          p.half_height, mask=p.collision_mask,
                          min_normal_y=p.min_ground_dot)
    q_cand = q_cand + torch.where(do_snap, snap.iterations, 0)
    q_casts = q_casts + do_snap.to(torch.int32)
    snap_ok = do_snap & snap.hit & (snap.toi <= p.snap_distance)
    move = torch.minimum(torch.clamp(snap.toi - p.ground_snap_skin, min=0.0),
                         p.ground_snap_max_step)
    pos = _sel(snap_ok, pos + _down(move), pos)
    up = torch.zeros_like(pos)
    up[:, 1] = 1.0
    st = state
    gr = st.grounded | snap_ok
    gn = torch.where(snap_ok, snap.toi <= torch.maximum(p.ground_snap_skin,
                                                        p.skin_width),
                     st.grounded_near)
    nrm = _sel(snap_ok, _sel(snap.flatten, up, snap.tri_normal),
               st.ground_normal)
    tri = torch.where(snap_ok, snap.tri_index, st.ground_tri)
    active = p.active & p.agent_solid
    zero_i = torch.zeros_like(q_cand)
    new_state = st._replace(
        grounded=torch.where(active, gr, st.grounded),
        grounded_near=torch.where(active, gn, st.grounded_near),
        ground_normal=_sel(active, nrm, st.ground_normal),
        ground_tri=torch.where(active, tri, st.ground_tri),
        query_candidates=st.query_candidates + torch.where(active, q_cand,
                                                           zero_i),
        query_casts=st.query_casts + torch.where(active, q_casts, zero_i))
    return (_sel(active, pos, start_position),
            _sel(active, velocity, velocity0), new_state)
