"""Render BVH: host topology (native SAH, shared) + per-frame device refit.

Port of swift_game_engine_tpu/render/bvh.py. The frame's topology comes
from the native SAH builder (render.bvh_native); the reference's numpy
builds, the median split (``build_bvh``) and the Morton build
(``build_bvh_morton``), give the same topology arrays here, and
``traverse`` is its plain stackless walk (the kernels' reference, on no
frame's path). Nodes are preorder: interior
node n has its left child at n + 1 and its right child at skip[n + 1];
``skip`` jumps over a rejected subtree. The topology is built once on the
host (render.bvh_native) and kept on the device as index tensors; ``refit``
recomputes every node AABB from the frame's world-space triangles with
level-wise min/max, deepest level first, packs the rows the walks read and
fills the 4-wide nodes of the closest-hit kernel (K4) by one gather of the
binary boxes: the collapse of the binary tree into the wide one is computed
once, with the topology.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import rt_kernel as RK

BIG = 3.0e38
LEAF_SIZE = 4           # the median split's leaf (bvh.py:31)
# Traversal stack depth of the closest-hit kernel (ops.rt_kernel); the tree
# depth bounds it, so refit refuses deeper trees.
STACK_MAX = 128


class BVHTopology(NamedTuple):
    """Static structure, as device tensors (same fields as the reference)."""

    skip: torch.Tensor        # (M,) int32 — next node if subtree rejected
    first_tri: torch.Tensor   # (M,) int32 — start into tri_order (leaves)
    tri_count: torch.Tensor   # (M,) int32 — 0 for internal nodes
    left: torch.Tensor        # (M,) int64 — children (internal), -1 at leaves
    right: torch.Tensor       # (M,) int64
    tri_order: torch.Tensor   # (T,) int64 — leaf-contiguous permutation
    levels: tuple             # int64 tensors: internal nodes by depth, deepest first
    leaf_slots: torch.Tensor  # (M, LEAF) int64 into tri_order space, -1 padded
    # the 4-wide tree of K4 (ops.rt_kernel.collapse_wide)
    wide_index: torch.Tensor  # (W, 24) int64 gather of the wide boxes
    wide_tail: torch.Tensor   # (W, 8) f32 child refs and zeros
    # the packed row of each leaf rank (ops.rt_kernel.leaf_index): the rows
    # the origin and shadow rows (K5-K7) gather, fixed by the topology
    leaf_index: torch.Tensor  # (Lp,) int64
    wide_stack: int           # the most stack entries a wide walk holds

    @property
    def node_count(self):
        return int(self.skip.shape[0])

    @staticmethod
    def from_numpy(topo, device=None) -> "BVHTopology":
        """From the host builder's dict (or any object with the fields)."""
        get = topo.get if isinstance(topo, dict) else \
            (lambda k: getattr(topo, k))

        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        index, tail, stack = RK.collapse_wide(get("left"), get("right"),
                                              get("tri_count"))
        return BVHTopology(
            skip=t(get("skip"), torch.int32),
            first_tri=t(get("first_tri"), torch.int32),
            tri_count=t(get("tri_count"), torch.int32),
            left=t(get("left"), torch.int64),
            right=t(get("right"), torch.int64),
            tri_order=t(get("tri_order"), torch.int64),
            levels=tuple(t(lv, torch.int64) for lv in get("levels")),
            leaf_slots=t(get("leaf_slots"), torch.int64),
            wide_index=t(index, torch.int64),
            wide_tail=t(tail, torch.float32),
            # over the packed rows: the nodes padded to a multiple of 8
            leaf_index=t(RK.leaf_index(np.pad(
                np.asarray(get("tri_count")) > 0,
                (0, (-len(get("tri_count"))) % 8))), torch.int64),
            wide_stack=stack)


class BVHArrays(NamedTuple):
    """Refit output: node bounds + leaf triangle data + the kernel rows."""

    bmin: torch.Tensor      # (M,3)
    bmax: torch.Tensor      # (M,3)
    skip: torch.Tensor      # (M,) int32
    is_leaf: torch.Tensor   # (M,) bool
    slot_tri: torch.Tensor  # (M, LEAF) original triangle ids (-1 padded)
    v0: torch.Tensor        # (T,3) world-space triangle vertices
    v1: torch.Tensor
    v2: torch.Tensor
    rows: torch.Tensor      # (M_pad, 128) kernel layout (ops.rt_kernel)
    wide: RK.WideTree       # K4's wide nodes; their leaves are ``rows``


def refit(topo: BVHTopology, v0, v1, v2, translucent=None) -> BVHArrays:
    """Recompute all node AABBs from world-space triangles."""
    if len(topo.levels) >= STACK_MAX:
        raise ValueError(f"BVH depth {len(topo.levels)} exceeds the traversal "
                         f"stack ({STACK_MAX})")
    if topo.wide_stack > RK.WIDE_STACK_MAX:
        raise ValueError(f"the wide tree's walk needs {topo.wide_stack} stack "
                         f"entries, over {RK.WIDE_STACK_MAX}")
    tri_min = torch.minimum(torch.minimum(v0, v1), v2)[topo.tri_order]
    tri_max = torch.maximum(torch.maximum(v0, v1), v2)[topo.tri_order]
    slots = topo.leaf_slots
    valid = (slots >= 0)[..., None]
    safe = slots.clamp(min=0)
    bmin = torch.where(valid, tri_min[safe], BIG).amin(1)
    bmax = torch.where(valid, tri_max[safe], -BIG).amax(1)
    for lv in topo.levels:
        l_idx, r_idx = topo.left[lv], topo.right[lv]
        bmin[lv] = torch.minimum(bmin[l_idx], bmin[r_idx])
        bmax[lv] = torch.maximum(bmax[l_idx], bmax[r_idx])
    slot_tri = torch.where(slots >= 0, topo.tri_order[safe], -1)
    out = BVHArrays(bmin=bmin, bmax=bmax, skip=topo.skip,
                    is_leaf=topo.tri_count > 0, slot_tri=slot_tri,
                    v0=v0, v1=v1, v2=v2, rows=None, wide=None)
    rows = RK.pack_bvh(out, translucent=translucent)
    wide = RK.WideTree(nodes=RK.wide_nodes(bmin, bmax, topo.wide_index,
                                           topo.wide_tail),
                       stack=topo.wide_stack, leaves=topo.leaf_index)
    return out._replace(rows=rows, wide=wide)


# ------------------------------------------------------- the host builds


def _topology(order, first_tri, tri_count, left, right, parent, depth,
              leaf_size: int, device=None) -> BVHTopology:
    """The preorder node lists of a build -> BVHTopology: skip links (a
    left child skips to its sibling, a right child as its parent), the
    internal levels deepest first and the leaf slots (bvh.py:118-150)."""
    m = len(first_tri)
    left, right = np.asarray(left, np.int32), np.asarray(right, np.int32)
    parent = np.asarray(parent, np.int32)
    tri_count = np.asarray(tri_count, np.int32)
    first_tri = np.asarray(first_tri, np.int32)
    skip = np.full(m, -1, np.int32)
    for i in range(m):
        p = parent[i]
        if p >= 0:
            skip[i] = right[p] if left[p] == i else skip[p]
    depth = np.asarray(depth, np.int32)
    internal = np.nonzero(tri_count == 0)[0]
    levels = []
    if len(internal):
        for d in range(int(depth[internal].max()), -1, -1):
            lv = internal[depth[internal] == d]
            if len(lv):
                levels.append(lv.astype(np.int32))
    leaf_slots = np.full((m, leaf_size), -1, np.int32)
    for i in np.nonzero(tri_count > 0)[0]:
        leaf_slots[i, :tri_count[i]] = np.arange(first_tri[i],
                                                 first_tri[i] + tri_count[i])
    return BVHTopology.from_numpy(dict(
        skip=skip, first_tri=first_tri, tri_count=tri_count, left=left,
        right=right, tri_order=np.asarray(order, np.int32),
        levels=tuple(levels), leaf_slots=leaf_slots), device)


def _build(t: int, split, leaf_size: int, device):
    """The iterative preorder build over ranges of a permutation: ``split
    (start, count) -> left count`` may reorder ``order`` in the range."""
    nodes = ([], [], [], [], [], [])   # first, count, left, right, par, dep
    stack = [(0, t, -1, 0, False)]  # (start, count, parent, depth, right)
    while stack:
        start, count, par, dep, is_right = stack.pop()
        idx = len(nodes[0])
        for lst, v in zip(nodes, (start, 0, -1, -1, par, dep)):
            lst.append(v)
        if par >= 0:
            nodes[3 if is_right else 2][par] = idx
        if count <= leaf_size:
            nodes[1][idx] = count
            continue
        n_left = split(start, count)
        # right first, so that the left pops first (preorder)
        stack.append((start + n_left, count - n_left, idx, dep + 1, True))
        stack.append((start, n_left, idx, dep + 1, False))
    return nodes


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray,
              device=None) -> BVHTopology:
    """Median-split build over triangle AABBs (bvh.py:54-147; host numpy,
    the topology on ``device``): largest-axis centroid pivot, a sorted
    split where the pivot separates nothing, leaves of <= 4."""
    t = len(tri_min)
    assert t > 0
    centroids = (np.asarray(tri_min) + np.asarray(tri_max)) * 0.5
    order = np.arange(t, dtype=np.int64)

    def split(start, count):
        seg = order[start:start + count]
        c = centroids[seg]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        pivot = 0.5 * (c.min(axis=0)[axis] + c.max(axis=0)[axis])
        mask = c[:, axis] < pivot
        n_left = int(mask.sum())
        if n_left == 0 or n_left == count:
            # sorted-split fallback (CollisionQuery.swift:637-653)
            order[start:start + count] = seg[np.argsort(c[:, axis],
                                                        kind="stable")]
            return count // 2
        order[start:start + count] = np.concatenate([seg[mask], seg[~mask]])
        return n_left

    nodes = _build(t, split, LEAF_SIZE, device)
    return _topology(order, *nodes, LEAF_SIZE, device)


def build_bvh_morton(tri_min: np.ndarray, tri_max: np.ndarray,
                     leaf_size: int = 12, device=None) -> BVHTopology:
    """Morton-ordered build (bvh.py:150-255): triangles sorted by the 30-bit
    Morton code of their centroid, ranges split where the highest
    differing code bit flips (halved where a range shares one code), a
    full leaf split off ranges of at most 2 leaves."""
    t = len(tri_min)
    assert t > 0
    c = (np.asarray(tri_min) + np.asarray(tri_max)) * 0.5
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-9)
    q = np.clip(((c - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    order = np.argsort(morton, kind="stable").astype(np.int64)
    codes = morton[order].astype(np.uint64)

    def split(start, count):
        if count <= 2 * leaf_size:
            return min(leaf_size, count - 1)
        first, last = int(codes[start]), int(codes[start + count - 1])
        if first == last:
            return count // 2
        bit = 1 << (int(first ^ last).bit_length() - 1)
        target = (first & ~((bit << 1) - 1)) | bit
        n = int(np.searchsorted(codes[start:start + count], target))
        return min(max(n, 1), count - 1)

    nodes = _build(t, split, leaf_size, device)
    return _topology(order, *nodes, leaf_size, device)


def traverse(bvh: BVHArrays, origin, direction, t_max, max_steps=None,
             any_hit: bool = False):
    """Nearest-hit (or any-hit) stackless walk of the preorder nodes by
    their skip links (bvh.py:264-396), over a batch of rays (N, 3): each
    ray tests the boxes and the leaf slots on its path; with ``any_hit``
    a ray stops at its first hit. Returns (t, tri, u, v, found), ``tri``
    an original triangle id (-1 on a miss); the plain reference of the
    closest-hit kernels (reads the live count back each step)."""
    from ..physics.primitives import ray_triangle
    n = origin.shape[0]
    dev = origin.device
    if max_steps is None:
        max_steps = int(bvh.skip.shape[0]) + 2
    inv = 1.0 / torch.where(direction.abs() < 1e-12,
                            torch.where(direction < 0, -1e-12, 1e-12),
                            direction)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    t_best = torch.as_tensor(t_max, dtype=torch.float32,
                             device=dev).expand(n).clone()
    tri_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    skip = bvh.skip.long()
    for _ in range(max_steps):
        alive = node >= 0
        if any_hit:
            alive = alive & (tri_best == -1)
        if not bool(alive.any()):
            break
        nd = node.clamp(min=0)
        t0 = (bvh.bmin[nd] - origin) * inv
        t1 = (bvh.bmax[nd] - origin) * inv
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        box_hit = alive & (tmax >= torch.clamp(tmin, min=0.0)) & \
            (tmin < t_best)
        leaf = bvh.is_leaf[nd]
        slots = bvh.slot_tri[nd]
        s_safe = slots.clamp(min=0)
        hit, t = ray_triangle(origin[:, None], direction[:, None],
                              bvh.v0[s_safe], bvh.v1[s_safe], bvh.v2[s_safe])
        hit = hit & (slots >= 0) & (box_hit & leaf)[:, None] & \
            (t < t_best[:, None]) & (t > 1e-4)
        t = torch.where(hit, t, BIG)
        k = t.argmin(1, keepdim=True)
        tk = torch.gather(t, 1, k)[:, 0]
        better = tk < t_best
        t_best = torch.where(better, tk, t_best)
        tri_best = torch.where(better, torch.gather(slots, 1, k)[:, 0],
                               tri_best)
        nxt = torch.where(box_hit & ~leaf, node + 1, skip[nd])
        node = torch.where(alive, nxt, node)
    found = tri_best >= 0
    safe = tri_best.clamp(min=0)
    a, b, c = bvh.v0[safe], bvh.v1[safe], bvh.v2[safe]
    p = origin + direction * t_best[:, None]
    ab, ac, ap = b - a, c - a, p - a
    d00, d01, d11 = (ab * ab).sum(-1), (ab * ac).sum(-1), (ac * ac).sum(-1)
    d20, d21 = (ap * ab).sum(-1), (ap * ac).sum(-1)
    denom = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
    u = (d11 * d20 - d01 * d21) / denom
    v = (d00 * d21 - d01 * d20) / denom
    return t_best, tri_best, u, v, found
