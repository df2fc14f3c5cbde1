"""Render BVH: host topology (native SAH, shared) + per-frame device refit.

Port of swift_game_engine_tpu/render/bvh.py. Nodes are preorder: interior
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
