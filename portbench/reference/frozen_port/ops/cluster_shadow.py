"""Cluster shadow sweeps: shared-direction shadow records (kernels K2, K3).

Port of swift_game_engine_tpu/ops/cluster_shadow.py. Every shadow ray of a
frame points at light 0, so per frame each triangle becomes constants for
that direction (u = P.g1 - c1, v = P.g2 - c2, t = P.g3 - c3): a triangle
test is three dot products of the ray origin. Triangles are re-ordered by
the light-plane Morton code of their centroid, grouped into clusters with a
light-plane AABB and a depth range along the light, and the clusters are
sorted by min depth.

The split form (``ShadowSplit``) runs an occlusion sweep over all triangles
(K2: nearest opaque t) and the slotted sweep over the translucent subset
only (K3: t_opq plus the n_slots nearest translucent records); the caller
filters translucent records by t < t_opq, so the split records equal the
single sweep's. With ``anyhit`` the translucent sweep runs first and each
lane's nearest translucent t becomes its occlusion settle threshold: the
returned t_opq is then factor-equivalent, not the nearest.

The wrappers launch ``csrc/cluster_shadow.cu`` for CUDA tensors and run the
plain twins (dense lanes x triangles in chunks, ``topk`` for slots) only
for CPU tensors. K2 and K3 are one warp-cooperative kernel template: each
warp of 32 consecutive lanes culls 32 cluster entries at a time against
its lanes' footprint, stages the rows of the clusters its lanes enter in
shared memory, and tests a GROUP of 32 rows only for the lanes whose point
its box holds; both sets of a split are built with their GROUP boxes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constant
from . import _cuda

BIG = 3.0e38
EPS = 1e-6
CLUSTER = 128         # SGE_SHADOW_CLUSTER
TRANS_CLUSTER = 64    # translucent-subset cluster size

OCCL_CHUNK = 64       # K2/K3 stage a cluster's rows in chunks of this many
GROUP = 32            # rows per culling group of K2/K3
occl_launches = 0     # K2 kernel launches since the last reset
slots_launches = 0    # K3 kernel launches since the last reset


class ShadowClusters(NamedTuple):
    rows: torch.Tensor   # (Tp, 16) per-triangle constants, Morton order
    meta: torch.Tensor   # (C, 8) [a0, b0, a1, b1, d0, d1, base_row, 0]
    basis: torch.Tensor  # (3, 3): rows e1, e2, l
    # (C * cluster / GROUP, 8): each GROUP rows' [a0, b0, a1, b1, d0, d1,
    # 0, 0], clusters in meta's order (K2/K3 cull a cluster's groups with
    # it); None for a set built without them, which no kernel sweeps
    groups: torch.Tensor | None

    @property
    def cluster(self) -> int:
        return self.rows.shape[0] // self.meta.shape[0]


class ShadowSplit(NamedTuple):
    full: ShadowClusters          # all triangles (occlusion sweep)
    trans: ShadowClusters | None  # translucent subset (slotted sweep)


def _part1by1(x):
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _ortho_basis(l):
    """Orthonormal (e1, e2) spanning the plane perpendicular to unit l; the
    helper axis is chosen on the device (no host read)."""
    up = torch.where(l[0].abs() < 0.9, constant((1.0, 0.0, 0.0), l.device),
                     constant((0.0, 1.0, 0.0), l.device))
    e1 = torch.linalg.cross(l, up, dim=-1)
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1), min=1e-12)
    return e1, torch.linalg.cross(l, e1, dim=-1)


def build_shadow_clusters(v0, v1, v2, l, translucent, cluster: int = CLUSTER,
                          alpha=None, ids=None,
                          groups: bool = False) -> ShadowClusters:
    """Per-frame constants for unit light direction ``l``. Translucent ids
    are encoded as id + 0.5; with ``alpha``, row lane 13 carries 2 + alpha
    for translucent triangles (-1 otherwise). ``groups``: also the kernels'
    per-GROUP culling boxes (``cluster`` a multiple of GROUP)."""
    lv = l.to(torch.float32)
    e1b, e2b = _ortho_basis(lv)
    x0, y0, z0 = v0.unbind(-1)
    x1, y1, z1 = v1.unbind(-1)
    x2, y2, z2 = v2.unbind(-1)
    e1x, e1y, e1z = x1 - x0, y1 - y0, z1 - z0
    e2x, e2y, e2z = x2 - x0, y2 - y0, z2 - z0
    hx = lv[1] * e2z - lv[2] * e2y
    hy = lv[2] * e2x - lv[0] * e2z
    hz = lv[0] * e2y - lv[1] * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    ok = det.abs() >= EPS
    f = 1.0 / torch.where(ok, det, 1.0)
    g1x, g1y, g1z = hx * f, hy * f, hz * f
    qx = e1y * lv[2] - e1z * lv[1]
    qy = e1z * lv[0] - e1x * lv[2]
    qz = e1x * lv[1] - e1y * lv[0]
    g2x, g2y, g2z = qx * f, qy * f, qz * f
    rx = e1y * e2z - e1z * e2y
    ry = e1z * e2x - e1x * e2z
    rz = e1x * e2y - e1y * e2x
    g3x, g3y, g3z = rx * f, ry * f, rz * f
    c1 = x0 * g1x + y0 * g1y + z0 * g1z
    c2 = x0 * g2x + y0 * g2y + z0 * g2z
    c3 = x0 * g3x + y0 * g3y + z0 * g3z

    tcount = v0.shape[0]
    if ids is None:
        ids = torch.arange(tcount, dtype=torch.float32, device=v0.device)
    ids = ids.to(torch.float32) + 0.5 * translucent.to(torch.float32)
    ids = torch.where(ok, ids, -1.0)
    zero = torch.zeros_like(x0)
    if alpha is not None:
        pay = torch.where(translucent & ok, 2.0 + alpha, -1.0)
    else:
        pay = zero - 1.0
    rows = torch.stack([g1x, g1y, g1z, g2x, g2y, g2z, g3x, g3y, g3z,
                        c1, c2, c3, ids, pay, zero, zero], -1)

    def proj(e):
        a0 = x0 * e[0] + y0 * e[1] + z0 * e[2]
        a1 = x1 * e[0] + y1 * e[1] + z1 * e[2]
        a2 = x2 * e[0] + y2 * e[1] + z2 * e[2]
        lo = torch.minimum(torch.minimum(a0, a1), a2)
        hi = torch.maximum(torch.maximum(a0, a1), a2)
        return torch.where(ok, lo, BIG), torch.where(ok, hi, -BIG)

    a_lo, a_hi = proj(e1b)
    b_lo, b_hi = proj(e2b)
    d_lo, d_hi = proj(lv)

    # light-plane Morton order of valid-triangle centroids (any permutation
    # gives the same records; this one gives compact cluster footprints)
    valid = a_lo <= a_hi
    ca = torch.where(valid, (a_lo + a_hi) * 0.5, 0.0)
    cb = torch.where(valid, (b_lo + b_hi) * 0.5, 0.0)
    qa0 = torch.where(valid, ca, BIG).min()
    qa1 = torch.where(valid, ca, -BIG).max()
    qb0 = torch.where(valid, cb, BIG).min()
    qb1 = torch.where(valid, cb, -BIG).max()
    qa = torch.clamp((ca - qa0) / torch.clamp(qa1 - qa0, min=1e-6) * 1023.0,
                     0.0, 1023.0).to(torch.int32)
    qb = torch.clamp((cb - qb0) / torch.clamp(qb1 - qb0, min=1e-6) * 1023.0,
                     0.0, 1023.0).to(torch.int32)
    code = (_part1by1(qb) << 1) | _part1by1(qa)
    code = torch.where(valid, code, 1 << 30)
    order_m = torch.argsort(code, stable=True)
    rows = rows[order_m]
    a_lo, a_hi, b_lo, b_hi, d_lo, d_hi = (
        x[order_m] for x in (a_lo, a_hi, b_lo, b_hi, d_lo, d_hi))

    pad = (-tcount) % cluster
    if pad:
        rows = torch.cat([rows, rows.new_full((pad, 16), -1.0)])
        fill = rows.new_full((pad,), BIG)
        a_lo, b_lo, d_lo = (torch.cat([x, fill]) for x in (a_lo, b_lo, d_lo))
        a_hi, b_hi, d_hi = (torch.cat([x, -fill]) for x in (a_hi, b_hi, d_hi))
    n_clusters = rows.shape[0] // cluster

    def cmin(a):
        return a.reshape(n_clusters, cluster).amin(1)

    def cmax(a):
        return a.reshape(n_clusters, cluster).amax(1)

    cd0 = cmin(d_lo)
    order = torch.argsort(cd0, stable=True)
    base = (order * (cluster // 8)).to(torch.float32)  # packed-row index
    meta = torch.stack([cmin(a_lo)[order], cmin(b_lo)[order],
                        cmax(a_hi)[order], cmax(b_hi)[order], cd0[order],
                        cmax(d_hi)[order], base, torch.zeros_like(base)], -1)
    sc = ShadowClusters(rows=rows.contiguous(), meta=meta.contiguous(),
                        basis=torch.stack([e1b, e2b, lv]).contiguous(),
                        groups=None)
    if not groups:
        return sc

    def per_group(a, red):
        return red(a.reshape(n_clusters, cluster // GROUP, GROUP), 2)[order]
    g = [per_group(a, red) for a, red in (
        (a_lo, torch.amin), (b_lo, torch.amin), (a_hi, torch.amax),
        (b_hi, torch.amax), (d_lo, torch.amin), (d_hi, torch.amax))]
    return sc._replace(groups=torch.stack(
        g + [torch.zeros_like(g[0])] * 2, -1).reshape(-1, 8).contiguous())


def build_shadow_split(v0, v1, v2, l, translucent, alpha=None,
                       trans_idx=None) -> ShadowSplit:
    """``trans_idx``: the static translucent triangle indices."""
    full = build_shadow_clusters(v0, v1, v2, l, translucent, alpha=alpha,
                                 groups=True)
    trans = None
    if trans_idx is not None and trans_idx.numel() > 0:
        trans = build_shadow_clusters(
            v0[trans_idx], v1[trans_idx], v2[trans_idx], l,
            torch.ones(trans_idx.shape[0], dtype=torch.bool,
                       device=v0.device),
            cluster=min(CLUSTER, TRANS_CLUSTER),
            alpha=None if alpha is None else alpha[trans_idx],
            ids=trans_idx.to(torch.float32), groups=True)
    return ShadowSplit(full=full, trans=trans)


# ---------------------------------------------------------------------------
# plain twins: dense lanes x triangles


def _chunks(device):
    """(lanes, triangles) per dense chunk: larger on the card, where each
    op's launch cost, not memory, sets the pace."""
    return (32768, 4096) if device.type == "cuda" else (8192, 1024)


def _hits(sc: ShadowClusters, o, t_lim, tri_slice):
    """(P, Tc) hit mask and t for triangles ``tri_slice`` of ``sc.rows``."""
    r = sc.rows[tri_slice]
    px, py, pz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    u = px * r[:, 0] + py * r[:, 1] + pz * r[:, 2] - r[:, 9]
    v = px * r[:, 3] + py * r[:, 4] + pz * r[:, 5] - r[:, 10]
    t = px * r[:, 6] + py * r[:, 7] + pz * r[:, 8] - r[:, 11]
    hit = (r[:, 12] >= 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & \
        (t > 1e-4) & (t < t_lim[:, None])
    return hit, t, r


def trace_shadow_clusters_plain(sc: ShadowClusters, o, t_limit, n_slots,
                                alpha_payload=False):
    """Exact t_opq plus the n_slots nearest translucent (t, payload) per
    lane (t_opq 0 and empty slots for dead lanes, which it skips)."""
    live = torch.nonzero(t_limit > 0).squeeze(1)
    if live.numel() < o.shape[0]:
        n = o.shape[0]
        t_opq = torch.zeros(n, device=o.device)
        ts = torch.full((n, n_slots), BIG, device=o.device)
        ids = torch.full((n, n_slots), -1.0, device=o.device)
        if live.numel():
            t_opq[live], ts[live], ids[live] = trace_shadow_clusters_plain(
                sc, o[live], t_limit[live], n_slots, alpha_payload)
        return t_opq, ts, ids
    n, tn = o.shape[0], sc.rows.shape[0]
    t_opq = torch.full((n,), BIG, device=o.device)
    ts = torch.full((n, n_slots), BIG, device=o.device)
    ids = torch.full((n, n_slots), -1.0, device=o.device)
    lane_chunk, tri_chunk = _chunks(o.device)
    for l0 in range(0, n, lane_chunk):
        ls = slice(l0, min(l0 + lane_chunk, n))
        for t0 in range(0, tn, tri_chunk):
            hit, t, r = _hits(sc, o[ls], t_limit[ls],
                              slice(t0, min(t0 + tri_chunk, tn)))
            opaque = r[:, 12] == torch.floor(r[:, 12])
            t_opq[ls] = torch.minimum(
                t_opq[ls], torch.where(hit & opaque, t, BIG).amin(1))
            if n_slots == 0:
                continue
            tr = hit & ~opaque
            pay = (r[:, 13] if alpha_payload else r[:, 12]).expand_as(t)
            all_t = torch.cat([ts[ls], torch.where(tr, t, BIG)], 1)
            all_id = torch.cat([ids[ls], torch.where(tr, pay, -1.0)], 1)
            best, pos = torch.topk(all_t, n_slots, dim=1, largest=False,
                                   sorted=True)
            ts[ls] = best
            ids[ls] = torch.where(best < BIG, torch.gather(all_id, 1, pos),
                                  -1.0)
    dead = t_limit <= 0
    return (torch.where(dead, 0.0, t_opq),
            torch.where(dead[:, None], BIG, ts),
            torch.where(dead[:, None], -1.0, ids))


def trace_shadow_occl_plain(sc: ShadowClusters, o, t_limit):
    """Exact nearest opaque t per lane (0 for dead lanes, BIG unblocked)."""
    return trace_shadow_clusters_plain(sc, o, t_limit, 0)[0]


# ---------------------------------------------------------------------------
# wrappers


def _check_inputs(sc: ShadowClusters, o, t_limit, extra=()):
    dev = o.device
    n = o.shape[0]
    _cuda.require(sc.rows, "rows", (sc.rows.shape[0], 16), device=dev)
    _cuda.require(sc.meta, "meta", (sc.meta.shape[0], 8), device=dev)
    _cuda.require(sc.basis, "basis", (3, 3), device=dev)
    _cuda.require(o, "o", (n, 3), device=dev)
    _cuda.require(t_limit, "t_limit", (n,), device=dev)
    for name, x in extra:
        if x is not None:
            _cuda.require(x, name, (n,), device=dev)
    if sc.cluster % OCCL_CHUNK:
        raise ValueError(f"cluster size {sc.cluster} is no multiple of "
                         f"{OCCL_CHUNK}")
    if sc.groups is None:
        raise ValueError("the sweeps need clusters built with groups=True")
    _cuda.require(sc.groups, "groups",
                  (sc.meta.shape[0] * sc.cluster // GROUP, 8), device=dev)


def _launch_occl(sc: ShadowClusters, o, t_limit, tt, counts):
    _check_inputs(sc, o, t_limit, (("tt", tt),))
    out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    _cuda.check(_cuda.library().sge_shadow_occl(
        sc.rows.data_ptr(), sc.meta.data_ptr(), sc.groups.data_ptr(),
        sc.basis.data_ptr(), o.data_ptr(), t_limit.data_ptr(), _cuda.ptr(tt),
        o.shape[0], sc.meta.shape[0], sc.cluster, _cuda.ptr(counts),
        out.data_ptr(), _cuda.stream_ptr(o)), "sge_shadow_occl")
    return out


def trace_shadow_occl(sc: ShadowClusters, o, t_limit, tt=None):
    """Occlusion sweep (K2) -> (N,) nearest opaque t (BIG when unblocked,
    0 for dead lanes). ``tt``: per-lane settle threshold; a lane whose
    t_opq drops below it stops, returning SOME opaque t < tt. Inactive
    lanes carry t_limit <= 0."""
    if not o.is_cuda:
        return trace_shadow_occl_plain(sc, o, t_limit)
    global occl_launches
    occl_launches += 1
    return _launch_occl(sc, o, t_limit, tt, None)


def trace_shadow_occl_counts(sc: ShadowClusters, o, t_limit, tt=None):
    """K2's counting instantiation, on the card only (a measurement, not a
    launch of the frame) -> (t_opq, counts): per lane "lane_meta" (footprint
    survivors the lane tests itself), "lane_enter" (clusters it enters),
    "lane_tri" (opaque triangle rows it tests); per warp of 32 lanes "warp_meta"
    (metadata entries its ballots test), "warp_surv" (footprint survivors),
    "warp_enter" (clusters staged), "warp_tri" (triangle rows it loops
    over: the GROUPs some lane needs)."""
    n = o.shape[0]
    w = (n + 31) // 32
    counts = torch.zeros(3 * n + 4 * w, dtype=torch.int32, device=o.device)
    out = _launch_occl(sc, o, t_limit, tt, counts)
    return out, _count_fields(counts, n, w)


def _count_fields(counts, n, w):
    lane = counts[:3 * n].reshape(3, n)
    warp = counts[3 * n:].reshape(w, 4).T
    return dict(zip(("lane_meta", "lane_enter", "lane_tri", "warp_meta",
                     "warp_surv", "warp_enter", "warp_tri"), (*lane, *warp)))


def _launch_slots(sc: ShadowClusters, o, t_limit, n_slots, alpha_payload,
                  counts):
    _check_inputs(sc, o, t_limit)
    n = o.shape[0]
    t_opq = torch.empty(n, dtype=torch.float32, device=o.device)
    ts = torch.empty((n, n_slots), dtype=torch.float32, device=o.device)
    ids = torch.empty((n, n_slots), dtype=torch.float32, device=o.device)
    _cuda.check(_cuda.library().sge_shadow_slots(
        sc.rows.data_ptr(), sc.meta.data_ptr(), sc.groups.data_ptr(),
        sc.basis.data_ptr(), o.data_ptr(), t_limit.data_ptr(), n,
        sc.meta.shape[0], sc.cluster, n_slots, int(alpha_payload),
        _cuda.ptr(counts), t_opq.data_ptr(), ts.data_ptr(), ids.data_ptr(),
        _cuda.stream_ptr(o)), "sge_shadow_slots")
    return t_opq, ts, ids


def trace_shadow_clusters(sc: ShadowClusters, o, t_limit, n_slots: int = 4,
                          alpha_payload: bool = False):
    """Slotted sweep (K3) -> (t_opq (N,), ts (N, n_slots), ids (N, n_slots));
    ids carry 2 + alpha with ``alpha_payload``; -1 marks empty slots."""
    if not 1 <= n_slots <= 4:
        raise ValueError(f"n_slots must be 1..4, got {n_slots}")
    if not o.is_cuda:
        return trace_shadow_clusters_plain(sc, o, t_limit, n_slots,
                                           alpha_payload)
    global slots_launches
    slots_launches += 1
    return _launch_slots(sc, o, t_limit, n_slots, alpha_payload, None)


def trace_shadow_clusters_counts(sc: ShadowClusters, o, t_limit,
                                 n_slots: int = 4,
                                 alpha_payload: bool = False):
    """K3's counting instantiation, on the card only (a measurement, not a
    launch of the frame) -> ((t_opq, ts, ids), counts), with the fields of
    ``trace_shadow_occl_counts`` ("lane_tri": every row the lane tests)."""
    n = o.shape[0]
    w = (n + 31) // 32
    counts = torch.zeros(3 * n + 4 * w, dtype=torch.int32, device=o.device)
    out = _launch_slots(sc, o, t_limit, n_slots, alpha_payload, counts)
    return out, _count_fields(counts, n, w)


def trace_shadow_split(split: ShadowSplit, o, t_limit, n_slots: int = 4,
                       alpha_payload: bool = False, anyhit: bool = False):
    """Composed split records — the trace_shadow_clusters contract."""
    n = o.shape[0]
    if split.trans is None:
        ts = torch.full((n, n_slots), BIG, device=o.device)
        ids = torch.full((n, n_slots), -1.0, device=o.device)
        tt = torch.full((n,), BIG, device=o.device) if anyhit else None
        return trace_shadow_occl(split.full, o, t_limit, tt=tt), ts, ids
    _, ts, ids = trace_shadow_clusters(split.trans, o, t_limit, n_slots,
                                       alpha_payload)
    tt = ts[:, 0].contiguous() if anyhit else None
    return trace_shadow_occl(split.full, o, t_limit, tt=tt), ts, ids
