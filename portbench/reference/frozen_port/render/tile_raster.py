"""Tile rasterizers: the cluster raster (K1) of the hybrid RT frame and the
raster path, and the list raster (K9, K10) of the raster path's "lists"
binning.

Port of swift_game_engine_tpu/render/tile_raster.py. The cluster path
(``setup_clusters`` + ``rasterize_clusters``): setup runs as torch ops:
clip-space transform, 2D-homogeneous cofactor rows per triangle (Olano &
Greer 1997 — no near-plane clipping), conservative screen AABBs, and
clusters of ``cluster`` triangles in mesh order sorted front to back by
their min view depth. The kernel keeps the ``layers`` nearest fragments per
pixel; the outputs are in padded tile-major lane order (the order of
camera.generate_rays_tiled), and ``t`` is the raw view depth w — the hybrid
frame converts it to ray t algebraically. Given ``cam_pos``, the records
are in scanline order instead and ``t`` is the ray distance, as the raster
path reads them.

The list path (``setup_lists`` + ``rasterize`` / ``rasterize_peeled``):
per-tile candidate lists of the first ``RASTER_K`` overlapping triangles in
index order, then K9 (the nearest fragment behind an optional per-pixel
depth) or K10 (the ``layers`` nearest in one pass); records in scanline
order with ray t.

The wrappers launch ``csrc/cluster_raster.cu`` and ``csrc/raster_lists.cu``
for CUDA tensors and run the plain twins only for CPU tensors: the cluster
twin tests every pixel against every triangle (dense, in chunks); the list
twins step every pixel through its tile's list in the kernels' order. K1
runs one warp per 8x4 pixel patch: it culls 32 cluster entries at a time
against the patch, then 32 rows at a time by their screen boxes, and
edge-tests only the rows that overlap the patch. K9 and K10 are one kernel
template with two policies, a warp per 8x4 patch too: a block stages its
tile's rows in shared memory, each warp culls each row by a proof that no
pixel of its patch can pass the f32 inside test (``list_patch_cull_plain``
is that cull in plain PyTorch, for the tests), and edge-tests the rest in
list order. The cluster path leaves
out-of-image padding lanes empty; the reference fills them with whatever
projects there, and every caller crops them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import _cuda
from .camera import TILE_H, TILE_W, tiled_pixels, untile_image

BIG = 3.0e38
CLUSTER = 128        # SGE_RASTER_CLUSTER (opaque raster)
TRANS_CLUSTER = 16   # SGE_RASTER_TRANS_CLUSTER (translucent subset)
RASTER_K = 8192      # SGE_RASTER_K: candidates per tile of the list binning

# K1 kernel launches since the last reset, by layer count (index layers - 1)
launches = [0, 0, 0]
list_launches = 0    # K9 kernel launches
peel_launches = 0    # K10 kernel launches


class RasterHits(NamedTuple):
    t: torch.Tensor        # (P,) view depth w or ray t (BIG at misses)
    tri: torch.Tensor      # (P,) int64 (-1 at misses)
    u: torch.Tensor        # (P,)
    v: torch.Tensor        # (P,)
    found: torch.Tensor    # (P,) bool
    w_depth: torch.Tensor  # (P,) view depth (for peeling / prior bounds)
    overflow: object = 0   # tiles whose candidates exceeded K (lists; () int)


def setup_clusters(v0, v1, v2, view_proj, width, height, opaque=None,
                   cluster: int = CLUSTER, ids=None):
    """Per-triangle edge rows + front-to-back sorted cluster metadata.

    Returns (rows (Tp, 16), meta (C, 8), boxes (Tp, 4)). Row: cof0 cof1
    cof2 (9), w (3), id, opaque flag, 0, 0. Meta: [x0, y0, x1, y1, w_min,
    base_row, 0, 0]. Boxes: each row's conservative screen AABB [x0, y0,
    x1, y1] in pixels (empty for culled and padding rows); K1 culls a
    cluster's rows by them, and a cluster's box is the union of its rows'.
    Culled: degenerate, offscreen, and wholly behind the camera (no
    fragment of such a row is ever inside)."""
    vp = view_proj.to(torch.float32)

    def tfc(p):
        x, y, z = p.unbind(-1)
        cx = vp[0, 0] * x + vp[0, 1] * y + vp[0, 2] * z + vp[0, 3]
        cy = vp[1, 0] * x + vp[1, 1] * y + vp[1, 2] * z + vp[1, 3]
        cw = vp[3, 0] * x + vp[3, 1] * y + vp[3, 2] * z + vp[3, 3]
        return cx, cy, cw

    x0c, y0c, w0c = tfc(v0)
    x1c, y1c, w1c = tfc(v1)
    x2c, y2c, w2c = tfc(v2)

    def cross_cols(ax, ay, az, bx, by, bz):
        return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx

    cof0 = cross_cols(x1c, y1c, w1c, x2c, y2c, w2c)
    cof1 = cross_cols(x2c, y2c, w2c, x0c, y0c, w0c)
    cof2 = cross_cols(x0c, y0c, w0c, x1c, y1c, w1c)
    det = x0c * cof0[0] + y0c * cof0[1] + w0c * cof0[2]

    eps_w = 1e-6
    in_front = (w0c > eps_w) & (w1c > eps_w) & (w2c > eps_w)

    def pix(xc, wc, extent, flip_y):
        v = xc / torch.clamp(wc, min=eps_w) * 0.5 + 0.5
        return (1.0 - v if flip_y else v) * extent

    px = [pix(c, w, width, False) for c, w in ((x0c, w0c), (x1c, w1c),
                                               (x2c, w2c))]
    py = [pix(c, w, height, True) for c, w in ((y0c, w0c), (y1c, w1c),
                                               (y2c, w2c))]
    x_min = torch.where(in_front, torch.minimum(torch.minimum(px[0], px[1]),
                                                px[2]), 0.0)
    x_max = torch.where(in_front, torch.maximum(torch.maximum(px[0], px[1]),
                                                px[2]), float(width))
    y_min = torch.where(in_front, torch.minimum(torch.minimum(py[0], py[1]),
                                                py[2]), 0.0)
    y_max = torch.where(in_front, torch.maximum(torch.maximum(py[0], py[1]),
                                                py[2]), float(height))
    degenerate = det.abs() < 1e-18
    offscreen = (x_max < 0) | (x_min > width) | (y_max < 0) | (y_min > height)
    # wholly behind the camera: a fragment's detp is a sum of lam_i >= 0
    # times w_i <= 0, so it is never > 0 and no pixel is inside; the
    # reference gives such a triangle the whole screen's box instead
    behind = (w0c <= 0) & (w1c <= 0) & (w2c <= 0)
    cull = degenerate | offscreen | behind
    x_min = torch.where(cull, BIG, x_min)
    x_max = torch.where(cull, -BIG, x_max)
    y_min = torch.where(cull, BIG, y_min)
    y_max = torch.where(cull, -BIG, y_max)
    w_min = torch.where(cull, BIG, torch.clamp(
        torch.minimum(torch.minimum(w0c, w1c), w2c), min=0.0))

    tcount = v0.shape[0]
    if ids is None:
        ids = torch.arange(tcount, dtype=torch.float32, device=v0.device)
    ids = torch.where(degenerate, -1.0, ids.to(torch.float32))
    opq = torch.zeros_like(x0c) if opaque is None else opaque.to(torch.float32)
    zero = torch.zeros_like(x0c)
    rows = torch.stack([*cof0, *cof1, *cof2, w0c, w1c, w2c, ids, opq, zero,
                        zero], -1)
    pad = (-tcount) % cluster
    if pad:
        rows = torch.cat([rows, rows.new_full((pad, 16), -1.0)])
        fill = rows.new_full((pad,), BIG)
        x_min, y_min, w_min = (torch.cat([a, fill]) for a in (x_min, y_min,
                                                               w_min))
        x_max, y_max = (torch.cat([a, -fill]) for a in (x_max, y_max))
    n_clusters = rows.shape[0] // cluster

    def creduce(a, fn):
        return fn(a.reshape(n_clusters, cluster), 1)

    cw = creduce(w_min, torch.amin)
    order = torch.argsort(cw, stable=True)
    base = (order * (cluster // 8)).to(torch.float32)  # packed-row index
    meta = torch.stack([creduce(x_min, torch.amin)[order],
                        creduce(y_min, torch.amin)[order],
                        creduce(x_max, torch.amax)[order],
                        creduce(y_max, torch.amax)[order], cw[order], base,
                        torch.zeros_like(base), torch.zeros_like(base)], -1)
    boxes = torch.stack([x_min, y_min, x_max, y_max], -1)
    return rows.contiguous(), meta.contiguous(), boxes.contiguous()


def _grid(width, height):
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)
    # pixel steps computed in double like the reference's Python constants
    return tiles_x, tiles_x * tiles_y, float(2.0 / width), float(2.0 / height)


def cluster_raster_plain(rows, width: int, height: int, layers: int,
                         prior_w=None, meta=None):
    """Plain PyTorch twin of the K1 kernel: every in-image pixel against
    every triangle row (chunked), the ``layers`` nearest inside fragments
    by view depth. Of fragments at equal depth the one met first is kept
    first, as the kernel's insertion keeps it: rows are met in row order,
    or, given ``meta``, in the kernel's walk order (clusters in ``meta``'s
    front-to-back order, rows in order within a cluster). Returns (id
    int32, b1, b2, w), each (tiles, layers, TILE_H, TILE_W)."""
    tiles_x, n_tiles, sx, sy = _grid(width, height)
    dev = rows.device
    if meta is not None:
        per = rows.shape[0] // meta.shape[0]
        walk = (meta[:, 5].long() * 8) // per
        rows = rows.reshape(meta.shape[0], per, 16)[walk].reshape(-1, 16)
    px, py = tiled_pixels(width, height, device=dev)
    p = px.shape[0]
    x = (px.to(torch.float32) + 0.5) * sx - 1.0
    y = 1.0 - (py.to(torch.float32) + 0.5) * sy
    ok = (px < width) & (py < height)
    w = torch.full((p, layers), BIG, device=dev)
    tid = torch.full((p, layers), -1.0, device=dev)
    b1 = torch.zeros((p, layers), device=dev)
    b2 = torch.zeros((p, layers), device=dev)
    lanes = torch.nonzero(ok).squeeze(1)
    tn = rows.shape[0]
    lane_chunk, tri_chunk = (16384, 4096) if dev.type == "cuda" else \
        (4096, 1024)
    for l0 in range(0, lanes.numel(), lane_chunk):
        li = lanes[l0:l0 + lane_chunk]
        xl, yl = x[li, None], y[li, None]
        pb = None if prior_w is None else prior_w[li, None]
        cw, ct, c1, c2 = w[li], tid[li], b1[li], b2[li]
        for t0 in range(0, tn, tri_chunk):
            r = rows[t0:t0 + tri_chunk]
            lam0 = r[:, 0] * xl + r[:, 1] * yl + r[:, 2]
            lam1 = r[:, 3] * xl + r[:, 4] * yl + r[:, 5]
            lam2 = r[:, 6] * xl + r[:, 7] * yl + r[:, 8]
            sig = lam0 + lam1 + lam2
            flip = torch.where(sig < 0, -1.0, 1.0)
            lam0, lam1, lam2, sig = lam0 * flip, lam1 * flip, lam2 * flip, \
                sig * flip
            detp = lam0 * r[:, 9] + lam1 * r[:, 10] + lam2 * r[:, 11]
            inside = (torch.minimum(torch.minimum(lam0, lam1), lam2) >= 0) & \
                (sig > 1e-20) & (r[:, 12] >= 0) & (detp > 0)
            if pb is not None:
                inside = inside & (detp < pb * sig)
            inv = 1.0 / sig
            all_w = torch.cat([cw, torch.where(inside, detp * inv, BIG)], 1)
            all_t = torch.cat([ct, torch.where(inside, r[:, 12].expand_as(
                inside), -1.0)], 1)
            all_1 = torch.cat([c1, lam1 * inv], 1)
            all_2 = torch.cat([c2, lam2 * inv], 1)
            # nearest first, ties by position (the kept records, then the
            # chunk's rows in order): w > 0, so its bits order as it does
            key = all_w.view(torch.int32).to(torch.int64) * all_w.shape[1] + \
                torch.arange(all_w.shape[1], device=dev)
            _, pos = torch.topk(key, layers, dim=1, largest=False,
                                sorted=True)
            cw = torch.gather(all_w, 1, pos)
            ct = torch.gather(all_t, 1, pos)
            c1 = torch.where(ct >= 0, torch.gather(all_1, 1, pos), 0.0)
            c2 = torch.where(ct >= 0, torch.gather(all_2, 1, pos), 0.0)
        w[li], tid[li], b1[li], b2[li] = cw, ct, c1, c2

    def tiles(a):   # (P, L) lane-major -> (tiles, L, TILE_H, TILE_W)
        return a.reshape(n_tiles, TILE_H, TILE_W, layers).permute(0, 3, 1, 2)

    return (tiles(tid).to(torch.int32).contiguous(), tiles(b1).contiguous(),
            tiles(b2).contiguous(), tiles(w).contiguous())


def _launch_raster(rows, meta, boxes, width, height, layers, prior_w,
                   counts):
    tiles_x, n_tiles, sx, sy = _grid(width, height)
    dev = rows.device
    _cuda.require(rows, "rows", (rows.shape[0], 16), device=dev)
    _cuda.require(meta, "meta", (meta.shape[0], 8), device=dev)
    _cuda.require(boxes, "boxes", (rows.shape[0], 4), device=dev)
    if rows.shape[0] % meta.shape[0] or (rows.shape[0] // meta.shape[0]) % 8:
        raise ValueError("rows must hold whole clusters of a multiple of 8")
    if prior_w is not None:
        _cuda.require(prior_w, "prior_w", (n_tiles * TILE_H * TILE_W,),
                      device=dev)
    shape = (n_tiles, layers, TILE_H, TILE_W)
    tid = torch.empty(shape, dtype=torch.int32, device=dev)
    b1, b2, w = (torch.empty(shape, dtype=torch.float32, device=dev)
                 for _ in range(3))
    _cuda.check(_cuda.library().sge_cluster_raster(
        rows.data_ptr(), boxes.data_ptr(), meta.data_ptr(),
        _cuda.ptr(prior_w), meta.shape[0], rows.shape[0] // meta.shape[0],
        width, height, sx, sy, tiles_x, n_tiles, layers, _cuda.ptr(counts),
        tid.data_ptr(), b1.data_ptr(), b2.data_ptr(), w.data_ptr(),
        _cuda.stream_ptr(rows)), "sge_cluster_raster")
    return tid, b1, b2, w


def cluster_raster(rows, meta, boxes, width: int, height: int, layers: int,
                   prior_w=None):
    """K1 wrapper over ``setup_clusters``' (rows, meta, boxes): (id int32,
    b1, b2, w), each (tiles, layers, 32, 128)."""
    if not 1 <= layers <= 3:
        raise ValueError(f"layers must be 1..3, got {layers}")
    if not rows.is_cuda:
        return cluster_raster_plain(rows, width, height, layers, prior_w,
                                    meta)
    launches[layers - 1] += 1
    return _launch_raster(rows, meta, boxes, width, height, layers, prior_w,
                          None)


COUNT_FIELDS = ("lane_meta", "lane_enter", "lane_tri", "warp_meta",
                "warp_surv", "warp_enter", "warp_box", "warp_tri")


def cluster_raster_counts(rows, meta, boxes, width: int, height: int,
                          layers: int, prior_w=None):
    """K1's counting instantiation, on the card only (a measurement, not a
    launch of the frame) -> ((id, b1, b2, w), counts). Per pixel, in the
    kernel's thread order (32 a warp: an 8x4 patch of a tile): "lane_meta"
    (metadata entries it tests itself: footprint survivors while it walks),
    "lane_enter" (clusters it enters), "lane_tri" (triangle rows it
    edge-tests); per warp: "warp_meta" (entries its ballots test),
    "warp_surv" (footprint survivors), "warp_enter" (clusters some pixel
    enters), "warp_box" (row boxes its ballots test), "warp_tri" (rows it
    stages and loops over)."""
    _, n_tiles, _, _ = _grid(width, height)
    p = n_tiles * TILE_H * TILE_W
    w = p // 32
    counts = torch.zeros(3 * p + 5 * w, dtype=torch.int32,
                         device=rows.device)
    out = _launch_raster(rows, meta, boxes, width, height, layers, prior_w,
                         counts)
    lane = counts[:3 * p].reshape(3, p)
    warp = counts[3 * p:].reshape(w, 5).T
    return out, dict(zip(COUNT_FIELDS, (*lane, *warp)))


def _scanline_hits(tid, b1, b2, w, width, height, tris, cam_pos,
                   overflow=0, scanline=True):
    """Tile-major (tiles, layers, TILE_H, TILE_W) records -> per layer
    RasterHits with ray t = |p_world - cam| from the barycentrics
    (tile_raster.py:346-369, 429-448, 962-981), in scanline (H*W,) order,
    or with ``scanline=False`` in the padded tile-major lane order.
    ``tris``: the (v0, v1, v2) the ids index."""
    v0, v1, v2 = tris
    cam = torch.as_tensor(cam_pos, dtype=torch.float32, device=v0.device)
    outs = []
    for l in range(tid.shape[1]):
        def untile(a):
            if not scanline:
                return a[:, l].reshape(-1)
            return untile_image(a[:, l].reshape(-1, 1), width,
                                height).reshape(-1)

        tid_l, b1_l, b2_l, w_l = (untile(a) for a in (tid, b1, b2, w))
        tid_l = tid_l.long()
        found = tid_l >= 0
        safe = tid_l.clamp(min=0)
        b0 = 1.0 - b1_l - b2_l
        p_world = b0[:, None] * v0[safe] + b1_l[:, None] * v1[safe] + \
            b2_l[:, None] * v2[safe]
        t = torch.linalg.vector_norm(p_world - cam, dim=-1)
        outs.append(RasterHits(t=torch.where(found, t, BIG),
                               tri=torch.where(found, tid_l, -1), u=b1_l,
                               v=b2_l, found=found, w_depth=w_l,
                               overflow=overflow))
    return outs


def rasterize_clusters(v0, v1, v2, view_proj, width: int, height: int,
                       layers: int = 1, opaque=None, cluster: int = CLUSTER,
                       ids=None, prior_w=None, cam_pos=None,
                       scanline: bool = True):
    """Cluster-binned depth-peeled rasterization -> list of ``layers``
    RasterHits, nearest first. Without ``cam_pos``: padded tile-major lane
    order, ``t`` the view depth w (the reference's ``flat_tiles=True,
    resolve_t=False``). With ``cam_pos`` (3,): ``t`` the ray distance from
    it (``resolve_t=True``; needs ``ids=None``), in scanline order
    (``flat_tiles=False``) or, with ``scanline=False``, in the padded
    tile-major lane order (``flat_tiles=True``: the RT frame's "raster" and
    "peels" primaries).

    ``opaque``: (T,) bool — opaque fragments end their pixel's walk once
    ``layers`` > 1. ``ids``: (T,) original triangle ids baked into the rows
    (subset rasters emit global ids). ``prior_w``: (P,) per-lane view-depth
    bound in tile-major order — fragments at or behind it are rejected."""
    rows, meta, boxes = setup_clusters(v0, v1, v2, view_proj, width, height,
                                       opaque=opaque, cluster=cluster,
                                       ids=ids)
    if prior_w is not None:
        prior_w = prior_w.contiguous()
    tid, b1, b2, w = cluster_raster(rows, meta, boxes, width, height, layers,
                                    prior_w)
    if cam_pos is not None:
        return _scanline_hits(tid, b1, b2, w, width, height, (v0, v1, v2),
                              cam_pos, scanline=scanline)
    outs = []
    for l in range(layers):
        tid_l = tid[:, l].reshape(-1).long()
        w_l = w[:, l].reshape(-1)
        found = tid_l >= 0
        outs.append(RasterHits(t=torch.where(found, w_l, BIG),
                               tri=torch.where(found, tid_l, -1),
                               u=b1[:, l].reshape(-1), v=b2[:, l].reshape(-1),
                               found=found, w_depth=w_l))
    return outs


# ------------------------------------------------------------- list binning


def setup_lists(v0, v1, v2, view_proj, width: int, height: int,
                k: int = RASTER_K):
    """Per-triangle edge rows + per-tile candidate lists (tile_raster.py:
    75-151 ``_setup``) -> (cand_rows (tiles, k, 16), counts (tiles,) int32,
    overflowed () int64).

    Rows: 2D-homogeneous cofactors (9), vertex w's (3), the triangle id,
    zeros. A triangle spans the tiles of its conservative screen AABB (a
    triangle touching w <= 1e-6 spans the whole screen); degenerate and
    offscreen ones are culled. Each tile keeps its first ``k`` overlapping
    triangles in index order, padded with the fill row (id -1);
    ``counts = min(count, k)`` and ``overflowed`` counts the tiles that had
    more."""
    vp = view_proj.to(torch.float32)
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)

    def tf(p):
        return p @ vp[:, :3].T + vp[:, 3]

    c = [tf(v) for v in (v0, v1, v2)]
    r = [torch.stack([ci[:, 0], ci[:, 1], ci[:, 3]], -1) for ci in c]
    cof = [torch.linalg.cross(r[1], r[2], dim=-1),
           torch.linalg.cross(r[2], r[0], dim=-1),
           torch.linalg.cross(r[0], r[1], dim=-1)]
    det = (r[0] * cof[0]).sum(-1)

    eps_w = 1e-6
    w_all = torch.stack([ci[:, 3] for ci in c], -1)
    in_front = (w_all > eps_w).all(-1)
    safe_w = torch.clamp(w_all, min=eps_w)
    xs = torch.stack([ci[:, 0] for ci in c], -1) / safe_w
    ys = torch.stack([ci[:, 1] for ci in c], -1) / safe_w
    px = (xs * 0.5 + 0.5) * width
    py = (1.0 - (ys * 0.5 + 0.5)) * height
    x_min = torch.where(in_front, px.amin(-1), 0.0)
    x_max = torch.where(in_front, px.amax(-1), float(width))
    y_min = torch.where(in_front, py.amin(-1), 0.0)
    y_max = torch.where(in_front, py.amax(-1), float(height))

    def span(lo, hi, tile, n):
        return [torch.clamp(torch.floor(a / tile), 0, n - 1).to(torch.int64)
                for a in (lo, hi)]

    tx0, tx1 = span(x_min, x_max, TILE_W, tiles_x)
    ty0, ty1 = span(y_min, y_max, TILE_H, tiles_y)
    degenerate = det.abs() < 1e-18
    offscreen = (x_max < 0) | (x_min > width) | (y_max < 0) | \
        (y_min > height)
    cull = degenerate | offscreen

    tcount = v0.shape[0]
    dev = v0.device
    rows = torch.cat([*cof, w_all,
                      torch.arange(tcount, dtype=torch.float32,
                                   device=dev)[:, None],
                      torch.zeros((tcount, 3), device=dev)], -1)
    t_ids = torch.arange(tiles_x * tiles_y, device=dev)
    tyi, txi = (t_ids // tiles_x)[:, None], (t_ids % tiles_x)[:, None]
    overlap = (txi >= tx0) & (txi <= tx1) & (tyi >= ty0) & (tyi <= ty1) & \
        ~cull
    counts_full = overlap.sum(1)
    # jnp.nonzero(row, size=k, fill_value=T) keeps the first k set entries
    # of each row: rank them by a running count and drop-scatter each
    # triangle into its rank's column (the rest into column k, cut off)
    rank = torch.cumsum(overlap, 1) - 1
    col = torch.where(overlap & (rank < k), rank, k)
    cands = torch.full((tiles_x * tiles_y, k + 1), tcount, dtype=torch.int64,
                       device=dev).scatter_(
        1, col, torch.arange(tcount, device=dev).expand_as(col))[:, :k]
    rows_pad = torch.cat([rows, rows.new_full((1, 16), -1.0)])
    return (rows_pad[cands].contiguous(),
            torch.clamp(counts_full, max=k).to(torch.int32),
            (counts_full > k).sum())


# The list kernels' warp footprint: an 8x4 pixel patch of a tile, patches
# in tile-major order.
PATCH_H, PATCH_W = 4, 8
N_PATCHES = (TILE_H // PATCH_H) * (TILE_W // PATCH_W)
# The patch cull's rounding margin (csrc/raster_lists.cu: 2^-19 = 32 unit
# roundoffs of f32 times the form's scale, plus a floor for subnormal
# products) and the scale past which a form is never used.
CULL_MARGIN = 2.0 ** -19
CULL_TINY = 1e-30
CULL_SCALE_MAX = 1e38


def _patch_lanes(device):
    """(N_PATCHES, 32) within-tile pixel index of each patch's lanes, in the
    kernels' order (lane % 8 across, lane // 8 down)."""
    p = torch.arange(N_PATCHES, device=device)[:, None]
    lane = torch.arange(32, device=device)
    qx = (p % (TILE_W // PATCH_W)) * PATCH_W + lane % PATCH_W
    qy = (p // (TILE_W // PATCH_W)) * PATCH_H + lane // PATCH_W
    return qy * TILE_W + qx


def _samples(width, height, device):
    """(tiles, TILE_H*TILE_W) f32 NDC sample x, y of every pixel, as the
    kernels compute them."""
    _, n_tiles, sx, sy = _grid(width, height)
    px, py = tiled_pixels(width, height, device=device)
    x = ((px.to(torch.float32) + 0.5) * sx - 1.0).reshape(n_tiles, -1)
    y = (1.0 - (py.to(torch.float32) + 0.5) * sy).reshape(n_tiles, -1)
    return x, y


def list_patch_cull_plain(counts, cand_rows, width: int, height: int):
    """Plain PyTorch version of the list kernels' patch cull, for the tests
    -> keep (tiles, N_PATCHES, K) bool: False where list position j lies
    past the tile's count or where one edge form of row j is proved > 0 and
    another < 0 at every pixel of the patch, so that no pixel there can
    pass the kernels' f32 ``inside`` test. Each form a*x + b*y + c is
    bounded over the patch's sample box from its corner samples and widened
    by ``CULL_MARGIN`` * (|a|*X + |b|*Y + |c|) + ``CULL_TINY`` (X, Y: the
    largest |x|, |y| in the patch), in the kernel's f32 operation order;
    the derivation is in csrc/raster_lists.cu."""
    x, y = _samples(width, height, cand_rows.device)
    lanes = _patch_lanes(cand_rows.device)

    def box(v):                              # (tiles, N_PATCHES, 1) each
        v = v[:, lanes]
        lo, hi = v.amin(-1, keepdim=True), v.amax(-1, keepdim=True)
        return lo, hi, torch.maximum(lo.abs(), hi.abs())

    (x0, x1, ax), (y0, y1, ay) = box(x), box(y)
    pos = neg = torch.zeros((), dtype=torch.bool, device=cand_rows.device)
    for f in range(3):
        a, b, c = (cand_rows[:, None, :, 3 * f + i] for i in range(3))
        a_x0, a_x1, b_y0, b_y1 = a * x0, a * x1, b * y0, b * y1
        lo = (torch.minimum(a_x0, a_x1) + torch.minimum(b_y0, b_y1)) + c
        hi = (torch.maximum(a_x0, a_x1) + torch.maximum(b_y0, b_y1)) + c
        s = (a.abs() * ax + b.abs() * ay) + c.abs()
        m = s * CULL_MARGIN + CULL_TINY
        used = s < CULL_SCALE_MAX
        pos = pos | (used & (lo > m))
        neg = neg | (used & (hi < -m))
    live = torch.arange(cand_rows.shape[1], device=cand_rows.device) < \
        counts.to(torch.int64)[:, None]
    return ~(pos & neg) & live[:, None]


def _list_candidates(counts, cand_rows, width: int, height: int):
    """The candidates of the list rasters in list order, in lockstep over
    every pixel of every tile: yields for each list position j the (tiles,
    TILE_H*TILE_W) terms of the kernels (tile_raster.py:186-202), in their
    f32 operation order: (live: j < the tile's count, inside: edges, sig
    and id, detp, sig, lam1, lam2, id)."""
    x, y = _samples(width, height, cand_rows.device)
    count = counts.to(torch.int64)[:, None]
    for j in range(int(counts.max()) if counts.numel() else 0):
        r = cand_rows[:, j, :, None]                     # (tiles, 16, 1)
        lam0 = r[:, 0] * x + r[:, 1] * y + r[:, 2]
        lam1 = r[:, 3] * x + r[:, 4] * y + r[:, 5]
        lam2 = r[:, 6] * x + r[:, 7] * y + r[:, 8]
        sig = lam0 + lam1 + lam2
        flip = torch.where(sig < 0, -1.0, 1.0)
        lam0, lam1, lam2, sig = lam0 * flip, lam1 * flip, lam2 * flip, \
            sig * flip
        detp = lam0 * r[:, 9] + lam1 * r[:, 10] + lam2 * r[:, 11]
        inside = (torch.minimum(torch.minimum(lam0, lam1), lam2) >= 0) & \
            (sig > 1e-20) & (r[:, 12] >= 0)
        yield j < count, inside, detp, sig, lam1, lam2, r[:, 12]


def _list_records(zn, zd, tid, l1, l2):
    """Kept fragments -> (id int32, b1, b2, w) as the kernels write them."""
    inv = 1.0 / zd
    return (tid.to(torch.int32), l1 * inv, l2 * inv,
            torch.where(tid >= 0, zn * inv, BIG))


def list_raster_plain(counts, cand_rows, width: int, height: int,
                      prev_w=None):
    """Plain PyTorch twin of K9: every pixel steps through its tile's
    candidates in list order, keeping a fragment that is inside, in front,
    strictly nearer (detp*zd < zn*sig: the first of equal depths stays)
    and strictly behind ``prev_w`` (detp > prev_w*sig). Returns (id int32,
    b1, b2, w), each (tiles, TILE_H, TILE_W)."""
    n_tiles = cand_rows.shape[0]
    dev = cand_rows.device
    per = TILE_H * TILE_W
    pw = torch.zeros((n_tiles, per), device=dev) if prev_w is None else \
        prev_w.reshape(n_tiles, per)
    zn = torch.full((n_tiles, per), BIG, device=dev)
    zd = torch.ones((n_tiles, per), device=dev)
    tid = torch.full((n_tiles, per), -1.0, device=dev)
    l1 = torch.zeros((n_tiles, per), device=dev)
    l2 = torch.zeros((n_tiles, per), device=dev)
    for live, inside, detp, sig, lam1, lam2, cid in _list_candidates(
            counts, cand_rows, width, height):
        win = live & inside & (detp > 0) & (detp * zd < zn * sig) & \
            (detp > pw * sig)
        zn, zd = torch.where(win, detp, zn), torch.where(win, sig, zd)
        tid = torch.where(win, cid, tid)
        l1, l2 = torch.where(win, lam1, l1), torch.where(win, lam2, l2)
    return tuple(a.reshape(n_tiles, TILE_H, TILE_W)
                 for a in _list_records(zn, zd, tid, l1, l2))


def list_raster_peeled_plain(counts, cand_rows, width: int, height: int,
                             layers: int):
    """Plain PyTorch twin of K10: every pixel steps through its tile's
    candidates in list order, each inside fragment running the insertion
    network over ``layers`` slots (tile_raster.py:285-298). Returns (id
    int32, b1, b2, w), each (tiles, layers, TILE_H, TILE_W)."""
    n_tiles = cand_rows.shape[0]
    dev = cand_rows.device
    per = TILE_H * TILE_W
    slots = [[torch.full((n_tiles, per), BIG, device=dev),
              torch.ones((n_tiles, per), device=dev),
              torch.full((n_tiles, per), -1.0, device=dev),
              torch.zeros((n_tiles, per), device=dev),
              torch.zeros((n_tiles, per), device=dev)] for _ in range(layers)]
    for live, inside, detp, sig, lam1, lam2, cid in _list_candidates(
            counts, cand_rows, width, height):
        c = [detp, sig, torch.where(live & inside & (detp > 0), cid, -1.0),
             lam1, lam2]
        for l, (zn, zd, tid, *_) in enumerate(slots):
            # the displaced incumbent becomes the candidate for slot l+1
            win = (c[2] >= 0) & ((tid < 0) | (c[0] * zd < zn * c[1]))
            slots[l], c = ([torch.where(win, a, b) for a, b in zip(c, slots[l])],
                           [torch.where(win, b, a) for a, b in zip(c, slots[l])])
    return tuple(torch.stack(a, 1).reshape(n_tiles, layers, TILE_H, TILE_W)
                 for a in zip(*(_list_records(*sl) for sl in slots)))


def _launch_list(counts, cand_rows, width, height, prev_w, layers, work):
    """K9 (``layers`` None) or K10: check, allocate, launch; ``work``: the
    counting instantiation's buffer or None."""
    tiles_x, n_tiles, sx, sy = _grid(width, height)
    dev = cand_rows.device
    _cuda.require(counts, "counts", (n_tiles,), dtype=torch.int32,
                  device=dev)
    if cand_rows.dim() != 3 or cand_rows.shape[0] != n_tiles or \
            cand_rows.shape[2] != 16:
        raise ValueError(f"cand_rows: expected ({n_tiles}, K, 16), got "
                         f"{tuple(cand_rows.shape)}")
    _cuda.require(cand_rows, "cand_rows", device=dev)
    if prev_w is not None:
        _cuda.require(prev_w, "prev_w", (n_tiles, TILE_H, TILE_W),
                      device=dev)
    shape = (n_tiles, layers or 1, TILE_H, TILE_W)
    tid = torch.empty(shape, dtype=torch.int32, device=dev)
    b1, b2, w = (torch.empty(shape, dtype=torch.float32, device=dev)
                 for _ in range(3))
    lib = _cuda.library()
    outs = (tid.data_ptr(), b1.data_ptr(), b2.data_ptr(), w.data_ptr(),
            _cuda.stream_ptr(cand_rows))
    if layers is None:
        _cuda.check(lib.sge_list_raster(
            counts.data_ptr(), cand_rows.data_ptr(), _cuda.ptr(prev_w),
            n_tiles, cand_rows.shape[1], sx, sy, tiles_x, _cuda.ptr(work),
            *outs), "sge_list_raster")
        return tid[:, 0], b1[:, 0], b2[:, 0], w[:, 0]
    _cuda.check(lib.sge_list_peeled(
        counts.data_ptr(), cand_rows.data_ptr(), n_tiles, cand_rows.shape[1],
        sx, sy, tiles_x, layers, _cuda.ptr(work), *outs), "sge_list_peeled")
    return tid, b1, b2, w


def list_raster(counts, cand_rows, width: int, height: int, prev_w=None):
    """K9 wrapper: the nearest inside fragment per pixel, strictly behind
    ``prev_w`` ((tiles, TILE_H, TILE_W) view depth; None: in front of the
    camera) -> (id int32, b1, b2, w), each (tiles, TILE_H, TILE_W)."""
    if not cand_rows.is_cuda:
        return list_raster_plain(counts, cand_rows, width, height, prev_w)
    global list_launches
    list_launches += 1
    return _launch_list(counts, cand_rows, width, height, prev_w, None, None)


def _check_layers(layers):
    if not 1 <= layers <= 3:
        raise ValueError(f"layers must be 1..3, got {layers}")


def list_raster_peeled(counts, cand_rows, width: int, height: int,
                       layers: int):
    """K10 wrapper: the ``layers`` nearest inside fragments per pixel ->
    (id int32, b1, b2, w), each (tiles, layers, TILE_H, TILE_W)."""
    _check_layers(layers)
    if not cand_rows.is_cuda:
        return list_raster_peeled_plain(counts, cand_rows, width, height,
                                        layers)
    global peel_launches
    peel_launches += 1
    return _launch_list(counts, cand_rows, width, height, None, layers, None)


LIST_COUNT_FIELDS = ("lane_test", "lane_inside", "warp_cull", "warp_admit")


def _list_counts(counts, cand_rows, width, height, prev_w, layers):
    _, n_tiles, _, _ = _grid(width, height)
    p = n_tiles * TILE_H * TILE_W
    w = p // 32
    work = torch.zeros(2 * p + 2 * w, dtype=torch.int32,
                       device=cand_rows.device)
    out = _launch_list(counts, cand_rows, width, height, prev_w, layers,
                       work)
    lane = work[:2 * p].reshape(2, p)
    warp = work[2 * p:].reshape(w, 2).T
    return out, dict(zip(LIST_COUNT_FIELDS, (*lane, *warp)))


def list_raster_counts(counts, cand_rows, width: int, height: int,
                       prev_w=None):
    """K9's counting instantiation, on the card only (a measurement, not a
    launch of the frame) -> ((id, b1, b2, w), work). Per pixel, in the
    kernel's thread order (32 a warp: an 8x4 patch of a tile): "lane_test"
    (rows it edge-tests: those its patch's cull admits), "lane_inside"
    (inside fragments among them); per warp: "warp_cull" (rows its lanes
    cull-test: the tile's count), "warp_admit" (rows its ballots
    admit)."""
    return _list_counts(counts, cand_rows, width, height, prev_w, None)


def list_raster_peeled_counts(counts, cand_rows, width: int, height: int,
                              layers: int):
    """K10's counting instantiation, on the card only; as
    ``list_raster_counts``."""
    _check_layers(layers)
    return _list_counts(counts, cand_rows, width, height, None, layers)


def rasterize(v0, v1, v2, view_proj, cam_pos, width: int, height: int,
              prev_w=None) -> RasterHits:
    """List-binned rasterization (K9) -> scanline (H*W,) RasterHits with ray
    t from ``cam_pos``. ``prev_w``: optional (H*W,) view depth of the
    previous layer — the nearest fragment strictly behind it (depth
    peeling); pixels past the image's edge are padded with BIG."""
    cand, counts, overflowed = setup_lists(v0, v1, v2, view_proj, width,
                                           height, RASTER_K)
    prev = None
    if prev_w is not None:
        tiles_x = -(-width // TILE_W)
        tiles_y = -(-height // TILE_H)
        img = torch.nn.functional.pad(
            prev_w.to(torch.float32).reshape(height, width),
            (0, tiles_x * TILE_W - width, 0, tiles_y * TILE_H - height),
            value=BIG)
        prev = img.reshape(tiles_y, TILE_H, tiles_x, TILE_W).permute(
            0, 2, 1, 3).reshape(-1, TILE_H, TILE_W).contiguous()
    tid, b1, b2, w = list_raster(counts, cand, width, height, prev)
    return _scanline_hits(tid[:, None], b1[:, None], b2[:, None],
                          w[:, None], width, height, (v0, v1, v2), cam_pos,
                          overflowed)[0]


def rasterize_peeled(v0, v1, v2, view_proj, cam_pos, width: int,
                     height: int, layers: int):
    """One-pass depth-peeled list rasterization (K10) -> list of ``layers``
    scanline RasterHits (nearest fragment, second-nearest, ...)."""
    cand, counts, overflowed = setup_lists(v0, v1, v2, view_proj, width,
                                           height, RASTER_K)
    return _scanline_hits(*list_raster_peeled(counts, cand, width, height,
                                              layers),
                          width, height, (v0, v1, v2), cam_pos, overflowed)
