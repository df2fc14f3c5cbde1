"""BVH traversal kernels over the packed tree and their helpers.

Port of the parts of swift_game_engine_tpu/ops/rt_kernel.py the RT frame
uses: ``pack_bvh`` (the (M, 128) row-per-node layout), ``barycentrics``,
``trace_batch`` and five kernels, each with its plain PyTorch twin, all
instances of one walk over the 4-wide tree (``WideTree``; csrc/bvh_trace.cu,
``_wide_walk`` in the twins):

  * K4 ``trace_rays`` — closest hit per ray (the ``trace_rays_pallas``
    contract) over the packed rows;
  * K5 ``trace_layers_so`` — the layered shared-origin walk: the nearest
    opaque hit and the n_slots nearest translucent hits of rays that share
    one origin, over the origin rows of ``build_origin_rows``;
  * K6 ``trace_rays_so`` — closest hit of rays that share one origin, with
    a per-lane t floor, over the same origin rows;
  * K7 ``trace_shadow_factor`` — the shared-direction shadow walk: the
    nearest opaque t and the n_slots nearest translucent hits toward one
    light, over the shadow rows of ``build_shadow_rows``;
  * K8 ``trace_shadow_any`` — any-hit occlusion against opaque triangles
    over the packed rows, the shadow prepass.

``trace_layers_so_binary``, ``trace_rays_so_binary``,
``trace_shadow_factor_binary`` and ``trace_shadow_any_binary`` compute
K5-K8's functions on the binary tree, as the reference walks it: the CPU
tests hold them against the reference's records, and ``chip_smoke.py``
counts with them the work of the binary walks the wide walk replaced.

K5–K8 serve trees of at most ``WALK_MAX_ROWS`` packed rows
(``walk_available``), the reference's rule.

Row layout (f32 lanes):
  [0:3] bmin  [3:6] bmax  [6] skip link  [7] leaf flag
  [8+9j : 17+9j] triangle j as (a, b-a, c-a), j in 0..SLOT_N-1
  [8+9*SLOT_N + j] triangle j's original id (-1 empty; translucent id+0.5)

Wide-node layout (``collapse_wide`` maps the binary tree onto it once,
``wide_nodes`` fills the boxes per frame): one 128-byte line of 32 f32 per
node, its up to WIDE children's boxes as structure of arrays
  [0:4] bmin.x  [4:8] bmin.y  [8:12] bmin.z
  [12:16] bmax.x  [16:20] bmax.y  [20:24] bmax.z
  [24:28] child refs  [28:32] leaf ranks
A ref >= 0 is a wide node; -1 an empty slot; ref <= -2 a leaf, the packed
row (the leaf's binary node) r with c triangles: -2 - ref = 16 r + c. A
leaf child's rank is its 1-based rank among the binary tree's leaves in
node order (``_leaf_rows``), so its origin row (K5, K6) and its shadow row
(K7) are rank - 1; 0 for other slots. The leaves' triangles stay in the
packed rows, which K4 and K8 read.

Each wrapper launches its CUDA kernel for CUDA tensors (and counts the
launch) and runs its plain twin only for CPU tensors. The twins walk every
lane in lockstep with masked tensor ops, in the kernel's own per-lane node
order and f32 operation order.

The kernels read their per-frame values from device memory, so that a CUDA
graph that captured a launch reads each replay's own: K5's and K6's shared
origin and K7's light direction (its safe inverse) are (3,) tensors on the
device (a wrapper given host values copies them there first). K4 and K6
take an optional ``count``, a 0-d int32 tensor on the device: lanes at or
past it are not walked and keep their miss record, so a call on compacted
lanes (``render/compact.py``) costs its live lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

BIG = 3.0e38
EPS = 1e-6
ROW = 128
SLOT_N = 12      # triangles inlined per leaf row (SGE_RT_LEAF)
_IDS = 8 + 9 * SLOT_N

# Tree-size rule of the shared-origin (K5) and shadow (K7) walks: the
# reference serves them from an SMEM header that fits at most this many
# packed rows (ops/rt_kernel.py:82 _SMEM_MAX_NODES, so_available :1455,
# shadow_prepass_available :1038); larger trees take the general paths.
WALK_MAX_ROWS = 22_000
STACK = 128      # render/bvh.py STACK_MAX: refit refuses deeper trees
SO_SLOT_F = 10   # origin rows: k_u, k_v, k_d, tn per triangle
SO_ROW_W = SO_SLOT_F * SLOT_N + SLOT_N           # + the ids
SHADOW_SLOT_F = 12   # shadow rows: g1, g2, g3, c per triangle
SHADOW_ROW_W = SHADOW_SLOT_F * SLOT_N + SLOT_N   # + the ids
WIDE = 4         # children per wide node
NODE_F = 32      # f32 per wide node: one 128-byte line
# The walks' per-ray stack lives in shared memory, sized by the tree's own
# bound (``collapse_wide``); trees that need more entries are refused at
# build.
WIDE_STACK_MAX = 96

launches = 0         # trace_rays (K4) kernel launches since the last reset
so_launches = 0      # trace_layers_so (K5) kernel launches
so_closest_launches = 0  # trace_rays_so (K6) kernel launches
shadow_launches = 0  # trace_shadow_factor (K7) kernel launches
any_launches = 0     # trace_shadow_any (K8) kernel launches


def pack_bvh(bvh, translucent=None):
    """BVHArrays -> (M_pad, 128) rows; M padded to a multiple of 8."""
    m = bvh.bmin.shape[0]
    slots = bvh.slot_tri
    k = slots.shape[1]
    if k > SLOT_N:
        raise ValueError(f"leaf width {k} exceeds row capacity {SLOT_N}")
    if k < SLOT_N:
        slots = torch.cat([slots, slots.new_full((m, SLOT_N - k), -1)], 1)
    safe = slots.clamp(min=0)
    a = bvh.v0[safe]
    tri_block = torch.cat([a, bvh.v1[safe] - a, bvh.v2[safe] - a], -1)
    slots_f = slots.to(torch.float32)
    if translucent is not None:
        slots_f = slots_f + 0.5 * (translucent[safe] & (slots >= 0)).float()
    rows = torch.zeros(((m + 7) // 8 * 8, ROW), dtype=torch.float32,
                       device=bvh.bmin.device)
    rows[:m, 0:3] = bvh.bmin
    rows[:m, 3:6] = bvh.bmax
    rows[:m, 6] = bvh.skip.to(torch.float32)
    rows[:m, 7] = bvh.is_leaf.to(torch.float32)
    rows[:m, 8:_IDS] = tri_block.reshape(m, 9 * SLOT_N)
    rows[:m, _IDS:_IDS + SLOT_N] = slots_f
    return rows


def _safe_inv(v):
    tiny = v.abs() < 1e-12
    return 1.0 / torch.where(tiny, torch.where(v < 0, -1e-12, 1e-12), v)


# ------------------------------------------------------------ K4: wide tree


class WideTree(NamedTuple):
    """The wide nodes of K4-K8; their leaf refs name packed rows
    (pack_bvh), which K4 and K8 take beside them, and their leaf ranks the
    origin rows (build_origin_rows) that K5 and K6 take and the shadow rows
    (build_shadow_rows) that K7 takes. ``leaves``: the packed row of each
    leaf rank (``leaf_index``), the topology's, or None (the row builders
    then find the leaves in the rows)."""

    nodes: torch.Tensor   # (W, NODE_F) wide-node lines
    stack: int            # stack entries a walk can need (collapse_wide)
    leaves: torch.Tensor | None = None   # (Lp,) int64


def collapse_wide(left, right, leaf_count):
    """Collapse a preorder binary tree (children after their parent; node 0
    the root) into a WIDE-wide one, once per topology: a wide node starts
    from a binary interior node's two children and opens the interior child
    with the most triangles until it has WIDE children or only leaves.

    left, right: (M,) children (-1 at leaves); leaf_count: (M,) triangles
    per leaf, which fill its first slots. Returns (index (W, 24) int64: the
    gather of the wide boxes from the (M*6,) view of cat([bmin, bmax], 1),
    child j's component k at [4k + j] (an empty slot reads the root, never
    a child); tail (W, 8) float32: the child refs and leaf ranks, as in the
    module docstring; stack: the most entries a walk can hold, the largest
    sum over a root-to-leaf path of each wide node's children less one)."""
    left, right = np.asarray(left, np.int64), np.asarray(right, np.int64)
    count = np.asarray(leaf_count, np.int64)
    m = len(count)
    is_leaf = left < 0
    count = np.where(is_leaf, count, 0)
    inner = np.nonzero(~is_leaf)[0]
    if np.any(left[inner] <= inner) or np.any(right[inner] <= inner):
        raise ValueError("collapse_wide needs children after their parent")
    size = count.copy()
    rank = np.cumsum(is_leaf)          # 1-based at leaves, as _leaf_rows
    for n in inner[::-1]:
        size[n] = size[left[n]] + size[right[n]]

    def children(n):
        kids = [int(left[n]), int(right[n])]
        while len(kids) < WIDE:
            open_ = [j for j, c in enumerate(kids) if not is_leaf[c]]
            if not open_:
                break
            j = max(open_, key=lambda j: size[kids[j]])
            c = kids[j]
            kids[j:j + 1] = [int(left[c]), int(right[c])]
        return kids

    wide_of, kids_of, todo = {}, [], [0]
    while todo:
        n = todo.pop()
        wide_of[n] = len(kids_of)
        kids = [0] if is_leaf[n] else children(n)
        kids_of.append(kids)
        todo.extend(c for c in reversed(kids) if not is_leaf[c])
    w = len(kids_of)
    src = np.full((w, WIDE), -1, np.int64)
    ref = np.full((w, WIDE), -1.0, np.float32)
    ranks = np.zeros((w, WIDE), np.float32)
    need = np.zeros(w, np.int64)
    for i in range(w - 1, -1, -1):      # children were numbered after i
        kids = kids_of[i]
        src[i, :len(kids)] = kids
        below = [need[wide_of[c]] for c in kids if not is_leaf[c]]
        need[i] = len(kids) - 1 + max(below, default=0)
        for j, c in enumerate(kids):
            ref[i, j] = -2 - (16 * c + count[c]) if is_leaf[c] else \
                wide_of[c]
            ranks[i, j] = rank[c] if is_leaf[c] else 0
    if m >= 1 << 19:
        raise ValueError(f"{m} nodes: leaf refs would lose f32 precision")
    index = np.maximum(src, 0)[:, None, :] * 6 + np.arange(6)[None, :, None]
    tail = np.concatenate([ref, ranks], 1)
    return index.reshape(w, 24), tail, int(need[0])


def wide_nodes(bmin, bmax, index, tail):
    """The frame's wide-node lines: one gather of the binary boxes, then the
    static refs and leaf ranks (``tail`` (W, 8))."""
    boxes = torch.cat([bmin, bmax], 1).reshape(-1)[index]
    return torch.cat([boxes, tail], 1).contiguous()


def wide_tree(rows) -> WideTree:
    """The wide tree rebuilt from packed rows alone (their skip links give the
    children: the left child of interior node n is n + 1, the right the
    left's skip link); the frame path gets it from refit instead."""
    r = rows.detach().cpu().numpy()
    m = int(np.nonzero(r[:, 7] > 0.5)[0].max()) + 1
    leaf = r[:m, 7] > 0.5
    count = (r[:m, 8 + 9 * SLOT_N:ROW] >= 0).sum(1)
    left = np.where(leaf, -1, np.arange(m) + 1)
    right = np.where(leaf, -1, r[np.minimum(np.arange(m) + 1, m - 1), 6])
    index, tail, stack = collapse_wide(left, right.astype(np.int64), count)
    nodes = wide_nodes(rows[:m, 0:3], rows[:m, 3:6],
                       torch.as_tensor(index, device=rows.device),
                       torch.as_tensor(tail, device=rows.device))
    leaves = torch.as_tensor(leaf_index(r[:, 7] > 0.5), device=rows.device)
    return WideTree(nodes=nodes, stack=stack, leaves=leaves)


def _check_tree(tree: WideTree, rows, width, t_max, o=None, d=None):
    """The walks' checks: the tree, the leaf ``rows`` (M, width), the rays
    (origins ``o``, directions ``d``: (N, 3) where given) and their bounds
    ``t_max`` (N,) on the tree's device -> (device, ray count)."""
    dev = tree.nodes.device
    n = t_max.shape[0]
    _cuda.require(tree.nodes, "nodes", (tree.nodes.shape[0], NODE_F),
                  device=dev)
    _cuda.require(rows, "rows", dtype=torch.float32, device=dev)
    if rows.dim() != 2 or rows.shape[1] != width:
        raise ValueError(f"rows: expected (M, {width}), got "
                         f"{tuple(rows.shape)}")
    if not 0 <= tree.stack <= WIDE_STACK_MAX:
        raise ValueError(f"stack bound {tree.stack} outside 0.."
                         f"{WIDE_STACK_MAX}")
    for name, x in (("o", o), ("d", d)):
        if x is not None:
            _cuda.require(x, name, (n, 3), device=dev)
    _cuda.require(t_max, "t_max", (n,), device=dev)
    return dev, n


def _counts(n, dev):
    return torch.zeros((4, n), dtype=torch.int32, device=dev)


def _count_dict(counts):
    return dict(zip(("nodes", "boxes", "leaves", "slots"), counts))


def _device_vec3(x, dev):
    """A (3,) f32 tensor on ``dev``: a per-frame value the kernels read from
    device memory (host values are copied there)."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(
        3).contiguous()


def _check_count(count, dev):
    if count is not None:
        _cuda.require(count, "count", (), dtype=torch.int32, device=dev)


def _lanes_below(n, count, dev):
    """(N,) bool: the lanes a call with ``count`` walks (all without)."""
    if count is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    return torch.arange(n, device=dev) < count


def _launch_k4(tree, rows, o, d, t_max, counts, count=None):
    dev, n = _check_tree(tree, rows, ROW, t_max, o, d)
    _check_count(count, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    _cuda.check(_cuda.library().sge_trace_closest(
        tree.nodes.data_ptr(), rows.data_ptr(), o.data_ptr(),
        d.data_ptr(), t_max.data_ptr(), _cuda.ptr(count), n, tree.stack,
        _cuda.ptr(counts), t.data_ptr(), tri.data_ptr(), _cuda.stream_ptr(o)),
        "sge_trace_closest")
    return t, tri


def trace_rays(tree: WideTree, rows, o, d, t_max, count=None):
    """Nearest hit per ray over ``tree`` and the packed ``rows`` its leaves
    name -> (t (N,) f32, tri (N,) int32; -1 on a miss, t = t_max). Rays
    with t_max <= 0, and with ``count`` (0-d int32 on the device) the rays
    at or past it, are inactive."""
    if not tree.nodes.is_cuda:
        return trace_rays_plain(tree, rows, o, d, t_max, count)
    global launches
    launches += 1
    return _launch_k4(tree, rows, o, d, t_max, None, count)


def trace_rays_counts(tree: WideTree, rows, o, d, t_max, count=None):
    """K4's counting instantiation, on the card only (a measurement, not a
    launch of the frame): (t, tri, per-ray counts {"nodes": wide nodes
    visited, "boxes": child boxes tested (the non-empty slots of those
    nodes), "leaves": leaves visited, "slots": triangle tests})."""
    counts = _counts(o.shape[0], o.device)
    t, tri = _launch_k4(tree, rows, o, d, t_max, counts, count)
    return t, tri, _count_dict(counts)


def walk_threads(walk: str, n: int = 0) -> int:
    """Threads a ray of wide walk ``walk`` ("K4" to "K8") at ``n`` rays as
    the built kernel library runs it (card only; K5's count depends on
    ``n``): the group by which the counting instantiations' per-ray counts
    fill a warp."""
    return _cuda.library().sge_walk_threads(
        ("K4", "K6", "K8", "K5", "K7").index(walk), n)


# the 4-input sorting network of the wide walks' child order: compare-
# exchange (i, j) moves j ahead of i only when its entry distance is
# strictly smaller
_SORT4 = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


def _wide_walk(tree: WideTree, o, inv, bound, active, visit_leaf,
               by_rank=False, counts=None):
    """The lockstep walk of the wide twins (K4-K8), in the kernels' per-ray
    order: every live ray (``active``) holds a current node and its
    own stack. At a wide node it tests the WIDE child boxes against its
    walk bound ``bound`` (N,), orders the hit children by entry distance
    with the kernels' sorting network, goes on to the nearest and stacks
    the rest, farthest first; at a leaf ``visit_leaf(lanes, code)`` tests
    the slots (code = 16 row + triangle count, the row a packed row, or an
    origin or shadow row with ``by_rank``), may lower ``bound`` in place,
    and returns
    (the lanes whose walk ends there, or None; the slot tests per lane). A
    popped entry whose entry distance is not below the ray's bound is
    dropped. ``counts``: a dict that receives the walk's child-box tests
    ("box": the non-empty slots of the nodes visited) and slot tests
    ("slot"), the kernels' own work."""
    nodes = tree.nodes
    n, dev = inv.shape[0], inv.device
    depth = max(tree.stack, 1)
    st_ref = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    st_t = torch.zeros((n, depth), device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.nonzero(active).squeeze(1)
    inf = float("inf")
    if counts is not None:
        counts.setdefault("box", 0)
        counts.setdefault("slot", 0)
    while idx.numel():
        c = cur[idx]
        pop = torch.ones_like(c, dtype=torch.bool)
        wi = torch.nonzero(c >= 0).squeeze(1)
        if wi.numel():
            lanes = idx[wi]
            nd = nodes[c[wi]]
            lo = nd[:, 0:12].reshape(-1, 3, WIDE)
            hi = nd[:, 12:24].reshape(-1, 3, WIDE)
            ref = nd[:, 24:28].to(torch.int64)
            if by_rank:      # a leaf's origin or shadow row: rank less one
                rank = nd[:, 28:32].to(torch.int64)
                ref = torch.where(ref <= -2,
                                  -2 - (16 * (rank - 1) + (-2 - ref) % 16),
                                  ref)
            oi, ii = o[lanes][:, :, None], inv[lanes][:, :, None]
            t0, t1 = (lo - oi) * ii, (hi - oi) * ii
            tmin = torch.minimum(t0, t1).amax(1)
            tmax = torch.maximum(t0, t1).amin(1)
            hit = (tmax >= tmin.clamp(min=0.0)) & \
                (tmin < bound[lanes][:, None]) & (ref != -1)
            if counts is not None:
                counts["box"] += int((ref != -1).sum())
            key = torch.where(hit, tmin, inf)
            cols_t, cols_r = list(key.unbind(1)), list(ref.unbind(1))
            for a, b in _SORT4:
                sw = cols_t[b] < cols_t[a]
                cols_t[a], cols_t[b] = (torch.where(sw, cols_t[b], cols_t[a]),
                                        torch.where(sw, cols_t[a], cols_t[b]))
                cols_r[a], cols_r[b] = (torch.where(sw, cols_r[b], cols_r[a]),
                                        torch.where(sw, cols_r[a], cols_r[b]))
            h = hit.sum(1)
            for j in range(WIDE - 1, 0, -1):     # farthest first
                m = h > j
                pl = lanes[m]
                st_ref[pl, sp[pl]] = cols_r[j][m]
                st_t[pl, sp[pl]] = cols_t[j][m]
                sp[pl] += 1
            go = h > 0
            cur[lanes[go]] = cols_r[0][go]
            pop[wi] = ~go
        li = torch.nonzero(c < -1).squeeze(1)
        if li.numel():
            stop, tests = visit_leaf(idx[li], -2 - c[li])
            if counts is not None:
                counts["slot"] += int(tests.sum())
            if stop is not None:
                cur[idx[li[stop]]] = -1
                pop[li[stop]] = False
        # pop: the first stacked entry still below the walk bound
        pend = idx[pop]
        done = []
        while pend.numel():
            has = sp[pend] > 0
            done.append(pend[~has])
            pend = pend[has]
            sp[pend] -= 1
            top = sp[pend]
            ok = st_t[pend, top] < bound[pend]
            cur[pend[ok]] = st_ref[pend[ok], top[ok]]
            pend = pend[~ok]
        if done:
            cur[torch.cat(done)] = -1          # -1: the walk is over
        idx = idx[cur[idx] != -1]


def trace_rays_plain(tree: WideTree, rows, o, d, t_max, count=None):
    """Plain PyTorch twin of the K4 kernel (``_wide_walk`` with the bound
    t_best): at a leaf the slots' Moller-Trumbore tests (the kernel's
    arithmetic) keep the nearest hit below the best, the first slot among
    equals; lanes at or past ``count`` are not walked."""
    n, dev = o.shape[0], o.device
    t_best = t_max.clone()
    tri_best = torch.full((n,), -1.0, device=dev)
    inf = float("inf")

    def visit_leaf(lanes, code):
        tbl = t_best[lanes]
        t, crosses, ids = _mt_leaf(rows[torch.div(code, 16,
                                                  rounding_mode="floor")],
                                   o[lanes], d[lanes])
        t = torch.where(crosses & (t > 1e-4) & (t < tbl[:, None]), t, inf)
        t_near, j = t.min(1)
        got = t_near < inf
        t_best[lanes] = torch.where(got, t_near, tbl)
        tri_best[lanes] = torch.where(
            got, ids.gather(1, j[:, None])[:, 0], tri_best[lanes])
        return None, code % 16

    _wide_walk(tree, o, _safe_inv(d), t_best, _lanes_below(n, count, dev),
               visit_leaf)
    return t_best, tri_best.to(torch.int32)


def _mt_leaf(row, o, d):
    """Moller-Trumbore tests of the SLOT_N triangles of leaf rows ``row``
    (P, 128) against rays ``o``, ``d`` (P, 3), in the kernels' operation
    order -> (t, crosses, ids), each (P, SLOT_N): ``crosses`` is a real
    triangle (id >= 0) with |det| >= EPS and the barycentrics in range."""
    tri = row[:, 8:_IDS].reshape(-1, SLOT_N, 9)
    a, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    dl = d[:, None, :]
    p = _cross(dl, e2)
    det = _dot(e1, p)
    ok = det.abs() >= EPS
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tv = o[:, None, :] - a
    u = _dot(tv, p) * inv_det
    q = _cross(tv, e1)
    v = _dot(dl, q) * inv_det
    ids = row[:, _IDS:_IDS + SLOT_N]
    crosses = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (ids >= 0)
    return _dot(e2, q) * inv_det, crosses, ids


def barycentrics(bvh, o, d, t, tri):
    """(u, v, found) of kernel hits (matches render/bvh.py traverse)."""
    found = tri >= 0
    safe = tri.clamp(min=0).to(torch.int64)
    a, b, c = bvh.v0[safe], bvh.v1[safe], bvh.v2[safe]
    p = o + d * t[..., None]
    ab, ac, ap = b - a, c - a, p - a
    d00 = (ab * ab).sum(-1)
    d01 = (ab * ac).sum(-1)
    d11 = (ac * ac).sum(-1)
    d20 = (ap * ab).sum(-1)
    d21 = (ap * ac).sum(-1)
    denom = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
    u = (d11 * d20 - d01 * d21) / denom
    v = (d00 * d21 - d01 * d20) / denom
    return u, v, found


def trace_batch(bvh, o, d, active, count=None):
    """Nearest-hit records for a ray batch; inactive lanes miss at once
    (rt.py _trace_batch). ``count``: a compacted batch's live lanes (0-d
    int32 on the device; the lanes past it must be inactive), which K4
    skips. Returns (t, tri int64, u, v, found)."""
    t_max = torch.where(active, BIG, 0.0)
    # park inactive rays far outside the scene: they fail the root box
    o = torch.where(active[:, None], o, 1.0e9).contiguous()
    t, tri = trace_rays(bvh.wide, bvh.rows, o, d.contiguous(), t_max, count)
    u, v, found = barycentrics(bvh, o, d, t, tri)
    found = found & active & (t < BIG)
    return (torch.where(found, t, BIG), torch.where(found, tri.long(), -1),
            u, v, found)


# ------------------------------------------------------------------ K5 - K8


def walk_available(rows) -> bool:
    """The shared-origin walks (K5, K6), the shadow walk (K7) and the shadow
    prepass (K8) serve this tree (rt_kernel.py:1455 so_available, :1038
    shadow_prepass_available)."""
    return rows.shape[0] <= WALK_MAX_ROWS


def leaf_index(is_leaf):
    """The packed row of each leaf rank (rt_kernel.py:1081-1088) from the
    (M_pad,) leaf flags of the packed rows (numpy or a tensor): every
    builder emits a binary tree, so there are at most (M_pad+1)//2 leaves
    -> (Lp,) int64, the leaf of rank r + 1 at r, then zeros. The leaves
    are the topology's, so ``BVHTopology`` computes this once; refit keeps
    it."""
    m = is_leaf.shape[0]
    lp = ((m + 1) // 2 + 7) // 8 * 8
    if isinstance(is_leaf, torch.Tensor):
        found = torch.nonzero(is_leaf).squeeze(1)[:lp]
        out = torch.zeros(lp, dtype=torch.int64, device=is_leaf.device)
    else:
        found = np.nonzero(np.asarray(is_leaf))[0][:lp]
        out = np.zeros(lp, np.int64)
    out[:found.shape[0]] = found
    return out


def _leaf_rows(rows, leaves=None):
    """Leaf-compacted rows -> (Lp, 128), the leaf of rank r + 1 at row r
    (the rest row 0's copies, which no rank names): ``leaves`` the
    topology's ``leaf_index``, else found in the rows."""
    if leaves is None:
        leaves = leaf_index(rows[:, 7] > 0.5)
    return rows[leaves]


def binary_header(rows):
    """The binary tree's header as the reference's row builders give it
    beside their rows (rt_kernel.py:1081-1088) -> (M*8,): each row's box,
    skip link and, in field 7, the leaf's 1-based rank (0 for interior
    nodes). Only the binary walks read it (``trace_layers_so_binary``,
    ``trace_rays_so_binary``, ``trace_shadow_factor_binary``)."""
    is_leaf = rows[:, 7] > 0.5
    header = rows[:, :8].clone()
    rank = torch.cumsum(is_leaf.to(torch.float32), 0)
    header[:, 7] = torch.where(is_leaf, rank, 0.0)
    return header.reshape(-1).contiguous()


def _split_tris(leaf_rows):
    lp = leaf_rows.shape[0]
    tri = leaf_rows[:, 8:_IDS].reshape(lp, SLOT_N, 9)
    return tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], \
        leaf_rows[:, _IDS:_IDS + SLOT_N]


def _cross(a, b):
    """a x b with the reference's component formula (jnp.cross)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def build_origin_rows(rows, o, leaves=None):
    """Per-frame constants for rays sharing origin ``o`` (3,)
    (rt_kernel.py:1295-1324) -> srows (Lp, 132): per leaf triangle
    k_u = e2 x (o-a), k_v = (o-a) x e1, k_d = e2 x e1, tn = e2 . k_v, then
    the ids; row r is the leaf of rank r + 1, which the wide tree names
    (K5, K6); ``leaves``: the tree's ``leaf_index`` (the frame passes the
    topology's; without it the leaves are found in the rows, a host read).
    The reference returns the binary tree's header beside them, which only
    the binary walks read: ``binary_header``."""
    leaf = _leaf_rows(rows, leaves)
    a, e1, e2, ids = _split_tris(leaf)
    tv = torch.as_tensor(o, dtype=torch.float32, device=rows.device) - a
    k_v = _cross(tv, e1)
    slot = torch.cat([_cross(e2, tv), k_v, _cross(e2, e1),
                      _dot(e2, k_v)[..., None]], -1)
    srows = torch.cat([slot.reshape(leaf.shape[0], SO_SLOT_F * SLOT_N), ids],
                      -1)
    return srows.contiguous()


def build_shadow_rows(rows, l, leaves=None):
    """Per-frame constants for rays along unit direction ``l`` (3,) toward
    the light (rt_kernel.py:1070-1110) -> srows (Lp, 156): per leaf
    triangle g1, g2, g3, c with u = P.g1 - c1, v = P.g2 - c2,
    t = P.g3 - c3; ids of triangles parallel to ``l`` are -1; row r is the
    leaf of rank r + 1, which the wide tree names (K7); ``leaves`` as for
    ``build_origin_rows``. The reference returns the binary tree's header
    beside them, which only the binary walk reads: ``binary_header``."""
    leaf = _leaf_rows(rows, leaves)
    a, e1, e2, ids = _split_tris(leaf)
    lv = torch.as_tensor(l, dtype=torch.float32,
                         device=rows.device).expand_as(e2)
    h = _cross(lv, e2)
    det = _dot(e1, h)
    ok = det.abs() >= EPS
    f = (1.0 / torch.where(ok, det, 1.0))[..., None]
    g1 = h * f
    g2 = _cross(e1, lv) * f
    g3 = _cross(e1, e2) * f
    c = torch.stack([_dot(a, g1), _dot(a, g2), _dot(a, g3)], -1)
    slot = torch.cat([g1, g2, g3, c], -1)
    srows = torch.cat([slot.reshape(leaf.shape[0], SHADOW_SLOT_F * SLOT_N),
                       torch.where(ok, ids, -1.0)], -1)
    return srows.contiguous()


def _insert(ts, ids, hit, ct, cid):
    """The insertion network over (P, S) slot lists, for the lanes of
    ``hit`` only (rt_kernel.py:1609-1615)."""
    ct = torch.where(hit, ct, BIG)
    cid = torch.where(hit, cid, -1.0)
    for k in range(ts.shape[1]):
        win = ct < ts[:, k]
        nt = torch.where(win, ct, ts[:, k])
        nid = torch.where(win, cid, ids[:, k])
        ct, cid = torch.where(win, ts[:, k], ct), torch.where(win, ids[:, k],
                                                              cid)
        ts[:, k], ids[:, k] = nt, nid


def _slab(hdr, o, inv, bound):
    """Per-lane slab test of header rows ``hdr`` (P, 8) -> (hit, tmin)."""
    t0 = (hdr[:, 0:3] - o) * inv
    t1 = (hdr[:, 3:6] - o) * inv
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    return (tmax >= tmin.clamp(min=0.0)) & (tmin < bound), tmin


def _launch_k5(tree, srows, o, d, t_max, n_slots, counts):
    if not 1 <= n_slots <= 3:
        raise ValueError(f"n_slots must be 1..3, got {n_slots}")
    dev, n = _check_tree(tree, srows, SO_ROW_W, t_max, d=d)
    origin = _device_vec3(o, dev)
    t_opq = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    ts = torch.empty((n, n_slots), dtype=torch.float32, device=dev)
    ids = torch.empty((n, n_slots), dtype=torch.float32, device=dev)
    _cuda.check(_cuda.library().sge_so_layers(
        tree.nodes.data_ptr(), srows.data_ptr(), origin.data_ptr(),
        d.data_ptr(), t_max.data_ptr(), n, tree.stack, n_slots,
        _cuda.ptr(counts),
        t_opq.data_ptr(), tri.data_ptr(), ts.data_ptr(), ids.data_ptr(),
        _cuda.stream_ptr(d)), "sge_so_layers")
    return t_opq, tri, ts, ids


def trace_layers_so(tree: WideTree, srows, o, d, t_max, n_slots: int = 3):
    """K5: layered records over ``tree`` of rays sharing origin ``o`` (3,)
    — the origin that ``build_origin_rows`` baked into its origin rows
    ``srows``, which the tree's leaf ranks name; a tensor on the device,
    which the kernel reads there — with directions ``d`` (N, 3): one walk
    -> (t_opq (N,), tri_opq (N,) int32, ts (N, n_slots), ids (N, n_slots)
    float with the translucent +0.5 marker), n_slots 1..3. Rays with
    t_max <= 0 are inactive (t_opq 0, tri -1)."""
    if not tree.nodes.is_cuda:
        return trace_layers_so_plain(tree, srows, o, d, t_max, n_slots)
    t_opq, tri, ts, ids = _launch_k5(tree, srows, o, d, t_max, n_slots, None)
    global so_launches
    so_launches += 1
    return t_opq, tri, ts, ids


def trace_layers_so_counts(tree: WideTree, srows, o, d, t_max,
                           n_slots: int = 3):
    """K5's counting instantiation, on the card only (not a launch of the
    frame): (t_opq, tri, ts, ids, per-ray counts as
    ``trace_rays_counts``'s)."""
    counts = _counts(d.shape[0], d.device)
    out = _launch_k5(tree, srows, o, d, t_max, n_slots, counts)
    return (*out, _count_dict(counts))


def _near_first_walk(hdr, o, inv, active, bound_of, visit_leaf, counts=None):
    """The lockstep walk of the binary shared-origin walks (K5's and K6's
    functions on the binary tree): every live ray walks near-first with its
    own stack, one node per step (interior: test both children against the
    ray's bound, descend to the nearer, stack the farther; leaf: test the
    box, then ``visit_leaf(lanes, leaf row index, box hit, bound)`` runs the
    slots). ``bound_of(lanes)``: the rays' prune
    bound. ``counts``: a dict that receives the box and slot tests of the
    walk ("box", "slot") — the kernels' own work, since they walk each ray
    in the same order — and per ray the nodes it visits and its slot tests
    ("nodes", "slots": (N,) int64)."""
    n, dev = inv.shape[0], inv.device
    stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.nonzero(active).squeeze(1)
    if counts is not None:
        for k in ("nodes", "slots"):
            counts[k] = torch.zeros(n, dtype=torch.int64, device=dev)
    while idx.numel():
        nd = node[idx]
        h = hdr[nd]
        bound = bound_of(idx)
        leaf = h[:, 7] > 0.5
        nxt = torch.full_like(nd, -2)          # -2: pop
        li = torch.nonzero(leaf).squeeze(1)
        if counts is not None:
            counts["box"] = counts.get("box", 0) + 2 * idx.numel() - \
                li.numel()
            counts["nodes"][idx] += 1
        if li.numel():
            lanes = idx[li]
            box, _ = _slab(h[li], o, inv[lanes], bound[li])
            if counts is not None:
                counts["slot"] = counts.get("slot", 0) + \
                    SLOT_N * int(box.sum())
                counts["slots"][lanes] += SLOT_N * box
            visit_leaf(lanes, h[li, 7].to(torch.int64) - 1, box, bound[li])
        ii = torch.nonzero(~leaf).squeeze(1)
        if ii.numel():
            lanes = idx[ii]
            left = nd[ii] + 1
            right = hdr[left, 6].to(torch.int64)
            hl, tl = _slab(hdr[left], o, inv[lanes], bound[ii])
            hr, tr_ = _slab(hdr[right], o, inv[lanes], bound[ii])
            both = hl & hr
            left_near = tl <= tr_
            near = torch.where(left_near, left, right)
            far = torch.where(left_near, right, left)
            bi = torch.nonzero(both).squeeze(1)
            stack[lanes[bi], sp[lanes[bi]]] = far[bi]
            sp[lanes[bi]] += 1
            nxt[ii] = torch.where(both, near, torch.where(
                hl, left, torch.where(hr, right, -2)))
        pop = nxt == -2
        pi = idx[pop]
        has = sp[pi] > 0
        sp[pi] = torch.where(has, sp[pi] - 1, sp[pi])
        nxt[pop] = torch.where(has, stack[pi, sp[pi].clamp(min=0)], -1)
        node[idx] = nxt
        idx = idx[nxt >= 0]


def _dot_fused(a, b):
    """``_dot`` as XLA contracts it on the CPU and K6 computes it:
    fma(a2, b2, fma(a0, b0, a1*b1)) in f32. Each fma is taken in f64, which
    holds the f32 product exactly, then rounded to f32 (equal to the fused
    f32 operation except where the f64 sum lands exactly halfway between
    two f32 values)."""
    a, b = a.double(), b.double()
    p = (a[..., 1] * b[..., 1]).float().double()
    p = (a[..., 0] * b[..., 0] + p).float().double()
    return (a[..., 2] * b[..., 2] + p).float()


def _so_slot(dl, s, fused=False):
    """The shared-origin slot test's sign-folded terms (rt_kernel.py:
    1393-1401) of directions ``dl`` against slot constants ``s`` (..., 10)
    -> (t, dnp, un_s, vn_s, tn_s); ``fused``: its dot products as
    ``_dot_fused`` (K6), else separately rounded (K5)."""
    dot = _dot_fused if fused else _dot
    un, vn, dn = (dot(dl, s[..., 3 * c:3 * c + 3]) for c in range(3))
    sgn = torch.where(dn < 0, -1.0, 1.0)
    dnp, un_s, vn_s, tn_s = dn * sgn, un * sgn, vn * sgn, s[..., 9] * sgn
    return tn_s / torch.where(dnp >= EPS, dnp, 1.0), dnp, un_s, vn_s, tn_s


def _so_inside(tid, dnp, un_s, vn_s):
    return (tid >= 0) & (dnp >= EPS) & (un_s >= 0) & (un_s <= dnp) & \
        (vn_s >= 0) & (un_s + vn_s <= dnp)


def _slot_records(n, active, n_slots, dev):
    """The slot walks' records before the walk: t_opq (BIG where active, 0
    elsewhere), tri -1, n_slots empty slots."""
    return (torch.where(active, BIG, 0.0), torch.full((n,), -1.0, device=dev),
            torch.full((n, n_slots), BIG, device=dev),
            torch.full((n, n_slots), -1.0, device=dev))


def _take_slot(rec, hit, t, tid):
    """The slot walks' take of an accepted (t, id) on records ``rec`` =
    [t_opq, tri, ts, ids] of the leaf's lanes: an opaque id lowers t_opq,
    a translucent one enters the insertion network."""
    opaque = tid == torch.floor(tid)
    win = hit & opaque & (t < rec[0])
    rec[0] = torch.where(win, t, rec[0])
    rec[1] = torch.where(win, tid, rec[1])
    _insert(rec[2], rec[3], hit & ~opaque, t, tid)


def trace_layers_so_plain(tree: WideTree, srows, o, d, t_max,
                          n_slots: int = 3, counts=None):
    """Plain PyTorch twin of K5 (``_wide_walk`` with the bound
    min(t_max, t_opq, ts[-1]), the leaves by rank): at a leaf, the slots
    whose so_cross test passes with tn_s > 1e-4*dnp and t = tn_s/dnp below
    the bound at the leaf's entry are taken in slot order, as the kernel
    takes them at any threads a ray. ``counts``: as for ``_wide_walk``."""
    n, dev = d.shape[0], d.device
    active = t_max > 0
    rec_all = _slot_records(n, active, n_slots, dev)
    t_opq, tri, ts, ids = rec_all
    bound = torch.minimum(t_max, t_opq)
    base = SO_SLOT_F * SLOT_N

    def visit_leaf(lanes, code):
        row = srows[torch.div(code, 16, rounding_mode="floor")]
        cnt = code % 16
        dl, bl = d[lanes], bound[lanes]
        rec = [x[lanes] for x in rec_all]
        for j in range(SLOT_N):
            tid = row[:, base + j]
            t, dnp, un_s, vn_s, tn_s = _so_slot(
                dl, row[:, SO_SLOT_F * j:SO_SLOT_F * (j + 1)])
            _take_slot(rec, _so_inside(tid, dnp, un_s, vn_s) & (j < cnt) &
                       (tn_s > 1e-4 * dnp) & (t < bl), t, tid)
        for x, v in zip(rec_all, rec):
            x[lanes] = v
        bound[lanes] = torch.minimum(torch.minimum(t_max[lanes], rec[0]),
                                     rec[2][:, -1])
        return None, cnt

    o = torch.as_tensor(o, dtype=torch.float32, device=dev)
    _wide_walk(tree, o.expand(n, 3), _safe_inv(d), bound, active, visit_leaf,
               by_rank=True, counts=counts)
    return t_opq, tri.to(torch.int32), ts, ids


def trace_layers_so_binary(origin_rows, o, d, t_max, n_slots: int = 3,
                           counts=None):
    """K5's function on the binary tree, as the reference and the design
    before the wide walk walk it (``_near_first_walk``; ``origin_rows`` the
    pair (``binary_header``, ``build_origin_rows``)): at a leaf whose box
    the ray hits, the slots in order. Kept to count the work of that walk
    (``counts``: as for ``_near_first_walk``), the bound of K5 before its
    redesign."""
    header, srows = origin_rows
    dev = d.device
    n = d.shape[0]
    active = t_max > 0
    t_opq, tri, ts, ids = _slot_records(n, active, n_slots, dev)
    base = SO_SLOT_F * SLOT_N

    def bound_of(lanes):
        return torch.minimum(torch.minimum(t_max[lanes], t_opq[lanes]),
                             ts[lanes, n_slots - 1])

    def visit_leaf(lanes, leaf_row, box, bl):
        row = srows[leaf_row]
        dl = d[lanes]
        rec = [t_opq[lanes], tri[lanes], ts[lanes], ids[lanes]]
        for j in range(SLOT_N):
            tid = row[:, base + j]
            t, dnp, un_s, vn_s, tn_s = _so_slot(
                dl, row[:, SO_SLOT_F * j:SO_SLOT_F * (j + 1)])
            _take_slot(rec, _so_inside(tid, dnp, un_s, vn_s) &
                       (tn_s > 1e-4 * dnp) & (t < bl) & box, t, tid)
        t_opq[lanes], tri[lanes], ts[lanes], ids[lanes] = rec

    _near_first_walk(header.reshape(-1, 8),
                     torch.as_tensor(o, dtype=torch.float32, device=dev),
                     _safe_inv(d), active, bound_of, visit_leaf, counts)
    return t_opq, tri.to(torch.int32), ts, ids


def _launch_k6(tree, srows, o, d, t_max, t_floor, counts, count=None):
    dev, n = _check_tree(tree, srows, SO_ROW_W, t_max, d=d)
    if t_floor is not None:
        _cuda.require(t_floor, "t_floor", (n,), device=dev)
    _check_count(count, dev)
    origin = _device_vec3(o, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    _cuda.check(_cuda.library().sge_trace_so(
        tree.nodes.data_ptr(), srows.data_ptr(), origin.data_ptr(),
        d.data_ptr(), t_max.data_ptr(), _cuda.ptr(t_floor), _cuda.ptr(count),
        n, tree.stack, _cuda.ptr(counts), t.data_ptr(), tri.data_ptr(),
        _cuda.stream_ptr(d)), "sge_trace_so")
    return t, tri


def trace_rays_so(tree: WideTree, srows, o, d, t_max, t_floor=None,
                  count=None):
    """K6: closest hit over ``tree`` of rays sharing origin ``o`` (3,) — the
    origin that ``build_origin_rows`` baked into its origin rows ``srows``,
    which the tree's leaf ranks name; a tensor on the device, which the
    kernel reads there — with directions ``d`` (N, 3) -> (t (N,), tri (N,)
    int32; a miss keeps t = t_max, tri -1). A hit needs tn > t_floor * dn:
    ``t_floor`` (N,) is the per-lane least accepted t (default 1e-4; a
    transparency continuation passes t_hit + 2*bias). Rays with t_max <= 0,
    and with ``count`` (0-d int32 on the device) the rays at or past it,
    are inactive."""
    if not tree.nodes.is_cuda:
        return trace_rays_so_plain(tree, srows, o, d, t_max, t_floor,
                                   count=count)
    global so_closest_launches
    so_closest_launches += 1
    return _launch_k6(tree, srows, o, d, t_max, t_floor, None, count)


def trace_rays_so_counts(tree: WideTree, srows, o, d, t_max, t_floor=None,
                         count=None):
    """K6's counting instantiation, on the card only (not a launch of the
    frame): (t, tri, per-ray counts as ``trace_rays_counts``'s)."""
    counts = _counts(d.shape[0], d.device)
    t, tri = _launch_k6(tree, srows, o, d, t_max, t_floor, counts, count)
    return t, tri, _count_dict(counts)


def _so_closest_leaf(srows, d, t_floor, t_best, tri, lanes, row, mask):
    """K6's leaf test, as the kernel (one thread a ray) and the reference
    make it (its dot products fused, as XLA fuses the reference's): for
    rays ``lanes`` where ``mask`` at origin rows ``row``, each slot in
    order replaces the best hit (``t_best``, ``tri``, updated in place)
    when tn_s lies in (t_floor*dnp, best*dnp)."""
    r = srows[row]
    dl, fl = d[lanes], t_floor[lanes]
    tb, tr = t_best[lanes], tri[lanes]
    base = SO_SLOT_F * SLOT_N
    for j in range(SLOT_N):
        tid = r[:, base + j]
        t, dnp, un_s, vn_s, tn_s = _so_slot(
            dl, r[:, SO_SLOT_F * j:SO_SLOT_F * (j + 1)], fused=True)
        hit = _so_inside(tid, dnp, un_s, vn_s) & \
            (tn_s > fl * dnp) & (tn_s < tb * dnp) & mask
        tb = torch.where(hit, t, tb)
        tr = torch.where(hit, tid, tr)
    t_best[lanes], tri[lanes] = tb, tr


def trace_rays_so_plain(tree: WideTree, srows, o, d, t_max, t_floor=None,
                        counts=None, count=None):
    """Plain PyTorch twin of K6 (``_wide_walk`` with the bound t_best, the
    leaves by rank, ``_so_closest_leaf`` at a leaf); lanes at or past
    ``count`` are not walked. ``counts``: as for ``_wide_walk``."""
    n, dev = d.shape[0], d.device
    if t_floor is None:
        t_floor = torch.full((n,), 1e-4, device=dev)
    t_best = t_max.clone()
    tri = torch.full((n,), -1.0, device=dev)

    def visit_leaf(lanes, code):
        _so_closest_leaf(srows, d, t_floor, t_best, tri, lanes,
                         torch.div(code, 16, rounding_mode="floor"), True)
        return None, code % 16

    o = torch.as_tensor(o, dtype=torch.float32, device=dev)
    _wide_walk(tree, o.expand(n, 3), _safe_inv(d), t_best,
               (t_max > 0) & _lanes_below(n, count, dev), visit_leaf,
               by_rank=True, counts=counts)
    return t_best, tri.to(torch.int32)


def trace_rays_so_binary(origin_rows, o, d, t_max, t_floor=None,
                         counts=None):
    """K6's function on the binary tree, as the reference and the design
    before the wide walk walk it (``_near_first_walk`` with the bound
    t_best; ``origin_rows`` the pair (``binary_header``,
    ``build_origin_rows``);
    ``_so_closest_leaf`` at a leaf whose box the ray hits). Kept to count
    the work of that walk (``counts``: as for ``_near_first_walk``), the
    bound of K6 before its redesign."""
    header, srows = origin_rows
    n = d.shape[0]
    if t_floor is None:
        t_floor = torch.full((n,), 1e-4, device=d.device)
    t_best = t_max.clone()
    tri = torch.full((n,), -1.0, device=d.device)

    def visit_leaf(lanes, leaf_row, box, _):
        _so_closest_leaf(srows, d, t_floor, t_best, tri, lanes, leaf_row,
                         box)

    _near_first_walk(header.reshape(-1, 8),
                     torch.as_tensor(o, dtype=torch.float32, device=d.device),
                     _safe_inv(d), t_max > 0, lambda lanes: t_best[lanes],
                     visit_leaf, counts)
    return t_best, tri.to(torch.int32)


def _launch_k8(tree, rows, o, d, t_limit, counts):
    dev, n = _check_tree(tree, rows, ROW, t_limit, o, d)
    blocked = torch.empty(n, dtype=torch.bool, device=dev)
    _cuda.check(_cuda.library().sge_trace_any(
        tree.nodes.data_ptr(), rows.data_ptr(), o.data_ptr(), d.data_ptr(),
        t_limit.data_ptr(), n, tree.stack, _cuda.ptr(counts),
        blocked.data_ptr(), _cuda.stream_ptr(o)), "sge_trace_any")
    return blocked


def trace_shadow_any(tree: WideTree, rows, o, d, t_limit):
    """K8: any-hit occlusion against OPAQUE triangles (integral slot ids;
    translucent ids carry +0.5) of rays ``o`` + t ``d`` over ``tree`` and
    the packed ``rows`` its leaves name -> (N,) bool blocked: some opaque
    triangle is hit at 1e-4 < t < t_limit. Lanes with t_limit <= 0 count
    as blocked."""
    if not tree.nodes.is_cuda:
        return trace_shadow_any_plain(tree, rows, o, d, t_limit)
    global any_launches
    any_launches += 1
    return _launch_k8(tree, rows, o, d, t_limit, None)


def trace_shadow_any_counts(tree: WideTree, rows, o, d, t_limit):
    """K8's counting instantiation, on the card only (not a launch of the
    frame): (blocked, per-ray counts as ``trace_rays_counts``'s; "slots"
    are the Moller-Trumbore tests, of opaque slots)."""
    counts = _counts(o.shape[0], o.device)
    blocked = _launch_k8(tree, rows, o, d, t_limit, counts)
    return blocked, _count_dict(counts)


def trace_shadow_any_plain(tree: WideTree, rows, o, d, t_limit, counts=None):
    """Plain PyTorch twin of K8 (``_wide_walk`` with the fixed bound
    t_limit): at a leaf the opaque slots' Moller-Trumbore tests (the
    kernel's arithmetic); a ray's walk ends at the first leaf where one
    hits at 1e-4 < t < t_limit. ``counts``: as for ``_wide_walk``; "slot"
    counts the Moller-Trumbore tests, one per opaque slot of the leaves
    visited."""
    n = o.shape[0]
    blocked = t_limit <= 0
    slot = torch.arange(SLOT_N, device=o.device)

    def visit_leaf(lanes, code):
        t, crosses, ids = _mt_leaf(rows[torch.div(code, 16,
                                                  rounding_mode="floor")],
                                   o[lanes], d[lanes])
        opaque = (ids == torch.floor(ids)) & (slot < (code % 16)[:, None])
        hit = (crosses & (t > 1e-4) & (t < t_limit[lanes, None]) &
               opaque).any(1)
        blocked[lanes] = hit
        return hit, opaque.sum(1)

    _wide_walk(tree, o, _safe_inv(d), t_limit, ~blocked, visit_leaf,
               counts=counts)
    return blocked


def trace_shadow_any_binary(rows, o, d, t_limit, counts=None):
    """K8's function on the binary tree, as the reference and the design
    before the wide walk walk it: every unblocked ray steps its own
    skip-link cursor in lockstep (descend to node+1 on a box hit at an
    interior node, else jump to skip); at a leaf its box hits, the slots'
    Moller-Trumbore tests; a ray stops at its first opaque hit. Kept to
    count the work of that walk, the bound of K8 before its redesign.
    ``counts``: as for trace_shadow_factor_binary; "slot" counts the
    Moller-Trumbore tests that walk makes: the opaque slots up to the
    first opaque hit; per ray "nodes" and "slots" ((N,) int64) as for
    ``_near_first_walk``."""
    n = o.shape[0]
    inv = _safe_inv(d)
    blocked = t_limit <= 0
    node = torch.zeros(n, dtype=torch.int64, device=o.device)
    idx = torch.nonzero(~blocked).squeeze(1)
    if counts is not None:
        for k in ("nodes", "slots"):
            counts[k] = torch.zeros(n, dtype=torch.int64, device=o.device)
    while idx.numel():
        nd = node[idx]
        h = rows[nd, :8]
        oi, tl = o[idx], t_limit[idx]
        box, _ = _slab(h, oi, inv[idx], tl)
        leaf = h[:, 7] > 0.5
        li = torch.nonzero(leaf & box).squeeze(1)
        if counts is not None:
            counts["box"] = counts.get("box", 0) + idx.numel()
            counts["nodes"][idx] += 1
        hit_any = torch.zeros_like(box)
        if li.numel():
            t, crosses, ids = _mt_leaf(rows[nd[li]], oi[li], d[idx[li]])
            opaque = (ids >= 0) & (ids == torch.floor(ids))
            hits = crosses & (t > 1e-4) & (t < tl[li, None]) & opaque
            if counts is not None:     # no hit in an earlier slot
                before = (torch.cumsum(hits.int(), 1) - hits.int()) == 0
                tested = (opaque & before).sum(1)
                counts["slot"] = counts.get("slot", 0) + int(tested.sum())
                counts["slots"][idx[li]] += tested
            hit = hits.any(1)
            hit_any[li] = hit
            blocked[idx[li]] = hit
        nxt = torch.where(box & ~leaf, nd + 1, h[:, 6].to(torch.int64))
        node[idx] = nxt
        idx = idx[(nxt >= 0) & ~hit_any]
    return blocked


def _launch_k7(tree, srows, l, o, t_limit, n_slots, counts):
    if not 1 <= n_slots <= 4:
        raise ValueError(f"n_slots must be 1..4, got {n_slots}")
    dev, n = _check_tree(tree, srows, SHADOW_ROW_W, t_limit, o)
    inv_l = _safe_inv(_device_vec3(l, dev))
    t_opq = torch.empty(n, dtype=torch.float32, device=dev)
    ts = torch.empty((n, n_slots), dtype=torch.float32, device=dev)
    ids = torch.empty((n, n_slots), dtype=torch.float32, device=dev)
    _cuda.check(_cuda.library().sge_shadow_walk(
        tree.nodes.data_ptr(), srows.data_ptr(), inv_l.data_ptr(),
        o.data_ptr(), t_limit.data_ptr(), n, tree.stack, n_slots,
        _cuda.ptr(counts),
        t_opq.data_ptr(), ts.data_ptr(), ids.data_ptr(), _cuda.stream_ptr(o)),
        "sge_shadow_walk")
    return t_opq, ts, ids


def trace_shadow_factor(tree: WideTree, srows, l, o, t_limit,
                        n_slots: int = 4):
    """K7: shadow records over ``tree`` of origins ``o`` (N, 3) along unit
    direction ``l`` (3,) — the direction ``build_shadow_rows`` baked into
    its shadow rows ``srows``, which the tree's leaf ranks name; a tensor
    on the device, whose safe inverse the kernel reads there: one walk ->
    (t_opq (N,),
    ts (N, n_slots), ids (N, n_slots) float with the translucent +0.5
    marker), n_slots 1..4. Origins with t_limit <= 0 are inactive (t_opq
    0, ids -1)."""
    if not tree.nodes.is_cuda:
        return trace_shadow_factor_plain(tree, srows, l, o, t_limit, n_slots)
    out = _launch_k7(tree, srows, l, o, t_limit, n_slots, None)
    global shadow_launches
    shadow_launches += 1
    return out


def trace_shadow_factor_counts(tree: WideTree, srows, l, o, t_limit,
                               n_slots: int = 4):
    """K7's counting instantiation, on the card only (not a launch of the
    frame): (t_opq, ts, ids, per-ray counts as ``trace_rays_counts``'s)."""
    counts = _counts(o.shape[0], o.device)
    out = _launch_k7(tree, srows, l, o, t_limit, n_slots, counts)
    return (*out, _count_dict(counts))


def _shadow_test(row, p, t_limit, j):
    """Slot j of shadow rows ``row`` for origins ``p``: (accepted, t, id)
    with u = P.g1 - c1, v = P.g2 - c2, t = P.g3 - c3 in range and
    1e-4 < t < t_limit."""
    s = row[:, SHADOW_SLOT_F * j:SHADOW_SLOT_F * (j + 1)]
    tid = row[:, SHADOW_SLOT_F * SLOT_N + j]
    u, v, t = (_dot(p, s[:, 3 * c:3 * c + 3]) - s[:, 9 + c] for c in range(3))
    return ((tid >= 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) &
            (t > 1e-4) & (t < t_limit)), t, tid


def trace_shadow_factor_plain(tree: WideTree, srows, l, o, t_limit,
                              n_slots: int = 4, counts=None):
    """Plain PyTorch twin of K7 (``_wide_walk`` with the bound
    min(t_limit, t_opq, ts[-1]), the leaves by rank): at a leaf, the
    accepted slots (``_shadow_test``) are taken in slot order, as the
    kernel takes them at any threads a ray. ``counts``: as for
    ``_wide_walk``."""
    n, dev = o.shape[0], o.device
    active = t_limit > 0
    rec_all = _slot_records(n, active, n_slots, dev)
    t_opq, _, ts, ids = rec_all
    bound = torch.minimum(t_limit, t_opq)

    def visit_leaf(lanes, code):
        row = srows[torch.div(code, 16, rounding_mode="floor")]
        cnt = code % 16
        p, tl = o[lanes], t_limit[lanes]
        rec = [x[lanes] for x in rec_all]
        for j in range(SLOT_N):
            hit, t, tid = _shadow_test(row, p, tl, j)
            _take_slot(rec, hit & (j < cnt), t, tid)
        for x, v in zip(rec_all, rec):
            x[lanes] = v
        bound[lanes] = torch.minimum(torch.minimum(tl, rec[0]),
                                     rec[2][:, -1])
        return None, cnt

    inv = _safe_inv(torch.as_tensor(l, dtype=torch.float32, device=dev))
    _wide_walk(tree, o, inv.expand(n, 3), bound, active, visit_leaf,
               by_rank=True, counts=counts)
    return t_opq, ts, ids


def trace_shadow_factor_binary(shadow_rows, l, o, t_limit, n_slots: int = 4,
                               counts=None):
    """K7's function on the binary tree, as the reference and the design
    before the wide walk walk it (``shadow_rows`` the pair
    (``binary_header``, ``build_shadow_rows``)): every live origin steps
    its own skip-link cursor in lockstep (descend to node+1 on a box hit at
    an interior node, else jump to skip); leaves its box hits test their
    slots in order.
    Kept to count the work of that walk, the bound of K7 before its
    redesign. ``counts``: a dict that receives the box and slot tests of
    the walk ("box", "slot") and per origin the nodes it visits and its
    slot tests ("nodes", "slots": (N,) int64)."""
    header, srows = shadow_rows
    hdr = header.reshape(-1, 8)
    dev = o.device
    n = o.shape[0]
    inv = _safe_inv(torch.as_tensor(l, dtype=torch.float32, device=dev))
    active = t_limit > 0
    t_opq, tri, ts, ids = _slot_records(n, active, n_slots, dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.nonzero(active).squeeze(1)
    if counts is not None:
        for k in ("nodes", "slots"):
            counts[k] = torch.zeros(n, dtype=torch.int64, device=dev)
    while idx.numel():
        nd = node[idx]
        h = hdr[nd]
        tl = t_limit[idx]
        bound = torch.minimum(torch.minimum(tl, t_opq[idx]),
                              ts[idx, n_slots - 1])
        box, _ = _slab(h, o[idx], inv, bound)
        leaf = h[:, 7] > 0.5
        li = torch.nonzero(leaf & box).squeeze(1)
        if counts is not None:
            counts["box"] = counts.get("box", 0) + idx.numel()
            counts["slot"] = counts.get("slot", 0) + SLOT_N * li.numel()
            counts["nodes"][idx] += 1
            counts["slots"][idx[li]] += SLOT_N
        if li.numel():
            lanes = idx[li]
            row = srows[h[li, 7].to(torch.int64) - 1]
            p, tll = o[lanes], tl[li]
            rec = [t_opq[lanes], tri[lanes], ts[lanes], ids[lanes]]
            for j in range(SLOT_N):
                _take_slot(rec, *_shadow_test(row, p, tll, j))
            t_opq[lanes], ts[lanes], ids[lanes] = rec[0], rec[2], rec[3]
        nxt = torch.where(box & ~leaf, nd + 1, h[:, 6].to(torch.int64))
        node[idx] = nxt
        idx = idx[nxt >= 0]
    return t_opq, ts, ids
