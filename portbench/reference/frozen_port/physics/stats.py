"""Collision query statistics: port of swift_game_engine_tpu/physics/stats.py
(reference: Game/CollisionQuery.swift:280-318).

The reference counts broadphase candidates, sweep tests and
conservative-advancement iterations per query, reset each substep
(Systems.swift:176). The queries here test every pair in bulk, so the
counts are exact reductions; this probe runs one capsule cast per agent
outside the substep.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import queries as Q
from .collision_world import TriangleSoup
from .primitives import aabb_overlap


class CollisionQueryStats(NamedTuple):
    capsule_candidate_count: torch.Tensor   # broadphase AABB-overlap pairs
    capsule_sweep_count: torch.Tensor       # narrowphase lanes evaluated
    capsule_sweep_iterations: torch.Tensor  # total per-query work counts
    capsule_sweep_max_iterations: torch.Tensor


def capsule_cast_stats(soup: TriangleSoup, positions, deltas, radius,
                       half_height) -> CollisionQueryStats:
    """Stats of one capsule cast per agent (positions/deltas (N,3), radius
    and half_height (N,))."""
    top, bot = positions.clone(), positions.clone()
    top[:, 1] += half_height
    bot[:, 1] -= half_height
    ends = torch.stack([top, bot, top + deltas, bot + deltas])
    qmin = ends.amin(0) - radius[:, None]
    qmax = ends.amax(0) + radius[:, None]
    tmin, tmax = soup.aabb
    cand = soup.valid & aabb_overlap(qmin[:, None], qmax[:, None], tmin, tmax)
    iters = Q.capsule_cast(soup, positions, deltas, radius,
                           half_height).iterations
    n = positions.shape[0]
    return CollisionQueryStats(
        capsule_candidate_count=cand.sum(),
        capsule_sweep_count=soup.valid.sum() * n,
        capsule_sweep_iterations=iters.sum(),
        capsule_sweep_max_iterations=iters.amax())
