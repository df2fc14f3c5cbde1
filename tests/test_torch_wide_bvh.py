"""PyTorch port: the 4-wide tree of the closest-hit kernel (K4) on the CPU.

  * ``refit`` fills each wide child slot with the binary box it collapses
    (equal bits), and ``wide_tree`` rebuilds the same nodes from the packed
    rows alone;
  * every wide node but the root is one slot's child, and every triangle
    sits in exactly one leaf slot that the wide refs reach;
  * the stack bound ``collapse_wide`` computes is the largest sum of
    children less one down a root-to-leaf path (recomputed here by
    recursion), the twin's stack of exactly that size never overflows on
    rays that start inside boxes, and the decimated DemoScene's tree fits
    the kernel's cap;
  * the leaf ranks in the wide lines (K6's origin rows) equal
    ``binary_header``'s ranks, for soups and the decimated DemoScene;
  * the twin's records match ``trace_rays_pallas(interpret=True)`` of the
    JAX package on a soup, with inactive rays (t_max = 0) and parked
    origins among them: ids on >= 99.9% of rays (equal-t ties), t to 1e-5
    relative where they agree.

Inputs are seeded numpy soups.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from swift_game_engine_tpu_torch.assets.materials import Material
from swift_game_engine_tpu_torch.assets.mesh_api import MeshDescriptor
from swift_game_engine_tpu_torch.ops import rt_kernel as RK
from swift_game_engine_tpu_torch.render.scene_geometry import (
    RenderGeometryBuilder, flatten_frame)
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(__file__), "..")
ASSETS = os.path.join(REPO, "assets")


def soup(seed, t, spread=10.0, size=2.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    return (base,
            base + rng.uniform(-size, size, (t, 3)).astype(np.float32),
            base + rng.uniform(-size, size, (t, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def frame():
    v0, v1, v2 = soup(31, 2500)
    pos = np.stack([v0, v1, v2], 1).reshape(-1, 3)
    b = RenderGeometryBuilder(texture_size=4)
    b.add_static_mesh(MeshDescriptor(
        positions=pos, indices=np.arange(len(pos), dtype=np.int32)),
        Material(name="m"), instance=0)
    geo = b.build(device="cpu")
    fg = flatten_frame(geo, torch.eye(4)[None], torch.zeros((1, 1, 4, 4)))
    return geo, fg


def test_refit_wide_boxes_equal_binary_boxes(frame):
    geo, fg = frame
    index, tail, _ = RK.collapse_wide(geo.topo.left.numpy(),
                                      geo.topo.right.numpy(),
                                      geo.topo.tri_count.numpy())
    src = index[:, 0:4] // 6          # the binary node of each child slot
    nodes = fg.bvh.wide.nodes.numpy()
    full = tail[:, 0:4] != -1
    assert (src[full] > 0).all()      # the root is no node's child
    for k, (arr, comp) in enumerate([(fg.bvh.bmin, c) for c in range(3)] +
                                    [(fg.bvh.bmax, c) for c in range(3)]):
        want = arr.numpy()[np.maximum(src, 0), comp]
        np.testing.assert_array_equal(nodes[:, 4 * k:4 * k + 4][full],
                                      want[full])
    # the refs: the static tail, and the same tree from the rows alone
    np.testing.assert_array_equal(nodes[:, 24:],
                                  geo.topo.wide_tail.numpy())
    again = RK.wide_tree(fg.bvh.rows)
    assert torch.equal(again.nodes, fg.bvh.wide.nodes)
    assert again.stack == fg.bvh.wide.stack == geo.topo.wide_stack


def test_every_triangle_reachable_exactly_once(frame):
    geo, fg = frame
    ref = fg.bvh.wide.nodes[:, 24:28].numpy().astype(np.int64)
    rows = fg.bvh.rows.numpy()
    inner = ref[ref >= 0]
    assert sorted(inner.tolist()) == list(range(1, ref.shape[0]))
    code = -2 - ref[ref <= -2]
    row, count = code // 16, code % 16
    assert len(np.unique(row)) == len(row)
    ids = np.concatenate([rows[r, RK._IDS:RK._IDS + c]
                          for r, c in zip(row, count)])
    assert (rows[row, RK._IDS:][np.arange(RK.SLOT_N)[None, :] >=
                                count[:, None]] == -1).all()
    np.testing.assert_array_equal(np.sort(ids),
                                  np.arange(geo.tri.shape[0]))


def _need(ref, w=0):
    """Largest sum of (children - 1) down any path from wide node ``w``."""
    kids = ref[w][ref[w] != -1]
    below = [_need(ref, int(c)) for c in kids if c >= 0]
    return len(kids) - 1 + max(below, default=0)


def test_stack_bound(frame):
    geo, fg = frame
    wide = fg.bvh.wide
    ref = wide.nodes[:, 24:28].numpy().astype(np.int64)
    assert wide.stack == _need(ref) > 0
    # rays from inside the soup's boxes, in every direction: the twin's
    # stack holds exactly wide.stack entries and raises on an overflow
    rng = np.random.default_rng(32)
    o = torch.as_tensor(rng.uniform(-9, 9, (4000, 3)).astype(np.float32))
    d = torch.as_tensor(rng.normal(size=(4000, 3)).astype(np.float32))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    t, tri = RK.trace_rays(wide, fg.bvh.rows, o, d,
                           torch.full((4000,), RK.BIG))
    assert int((tri >= 0).sum()) > 1000
    # the decimated DemoScene, which paths 2, 3, 5 and 6 trace
    from swift_game_engine_tpu_torch.scene.demo_scene import \
        build_demo_scene
    topo = build_demo_scene(ASSETS, device="cpu").geometry.topo
    assert 0 < topo.wide_stack <= RK.WIDE_STACK_MAX
    assert topo.wide_stack == _need(topo.wide_tail[:, :4].numpy().astype(
        np.int64))


def _soup_topo(t):
    """The topology of a ``t``-triangle soup."""
    v0, v1, v2 = soup(37, t)
    pos = np.stack([v0, v1, v2], 1).reshape(-1, 3)
    b = RenderGeometryBuilder(texture_size=4)
    b.add_static_mesh(MeshDescriptor(
        positions=pos, indices=np.arange(len(pos), dtype=np.int32)),
        Material(name="m"), instance=0)
    return b.build(device="cpu").topo


@pytest.mark.parametrize("which", ["1", "13", "2500", "demo"])
def test_leaf_ranks_match_leaf_rows(which):
    """Each leaf child's rank in the wide lines ([28:32]) is the rank that
    ``binary_header`` gives its packed row (the row of its origin rows,
    plus one), for soups from a one-leaf tree up and for the decimated
    DemoScene's topology; every other slot holds 0."""
    if which == "demo":
        from swift_game_engine_tpu_torch.scene.demo_scene import \
            build_demo_scene
        topo = build_demo_scene(ASSETS, device="cpu").geometry.topo
    else:
        topo = _soup_topo(int(which))
    leaf = (topo.left < 0).float()
    rows = torch.zeros(((leaf.numel() + 7) // 8 * 8, RK.ROW))
    rows[:leaf.numel(), 7] = leaf            # all binary_header reads
    header = RK.binary_header(rows)
    ref = topo.wide_tail[:, :4].to(torch.int64)
    rank = topo.wide_tail[:, 4:].to(torch.int64)
    is_leaf = ref <= -2
    row = torch.div(-2 - ref[is_leaf], 16, rounding_mode="floor")
    assert torch.equal(rank[is_leaf], header.reshape(-1, 8)[row, 7].long())
    assert bool((rank[~is_leaf] == 0).all())
    assert int(is_leaf.sum()) == int(leaf.sum())   # every leaf, once


K4_CODE = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["SGE_RT_BLOCK"] = "1024"
import numpy as np
import jax.numpy as jnp
from swift_game_engine_tpu.render import bvh as B
from swift_game_engine_tpu.ops import rt_kernel as K

rng = np.random.default_rng(33)
t = 700
base = rng.uniform(-9, 9, (t, 3)).astype(np.float32)
v1 = base + rng.uniform(-2, 2, (t, 3)).astype(np.float32)
v2 = base + rng.uniform(-2, 2, (t, 3)).astype(np.float32)
translucent = rng.random(t) < 0.3
topo = B.build_bvh(np.minimum(np.minimum(base, v1), v2),
                   np.maximum(np.maximum(base, v1), v2))
bvh = B.refit(topo, jnp.asarray(base), jnp.asarray(v1), jnp.asarray(v2),
              translucent=jnp.asarray(translucent))
kb = K.pack_bvh(bvh, translucent=jnp.asarray(translucent))
n = 768
o = rng.uniform(-11, 11, (n, 3)).astype(np.float32)
d = rng.normal(size=(n, 3)).astype(np.float32)
d /= np.linalg.norm(d, axis=-1, keepdims=True)
t_max = np.full(n, 1e6, np.float32)
t_max[::11] = 0.0                       # inactive
o[5::11] = 1.0e9                        # parked, as trace_batch parks them
t_max[5::11] = 0.0
t, tri = K.trace_rays_pallas(kb, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t_max), interpret=True)
np.savez(sys.argv[1], rows=np.asarray(kb.rows), o=o, d=d, t_max=t_max,
         t=np.asarray(t), tri=np.asarray(tri))
"""


def test_twin_matches_pallas_kernel(tmp_path):
    out = str(tmp_path / "k4.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.run([sys.executable, "-c", K4_CODE, out], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = dict(np.load(out))
    rows = torch.as_tensor(ref["rows"])
    t, tri = RK.trace_rays(RK.wide_tree(rows), rows,
                           *(torch.as_tensor(ref[k])
                             for k in ("o", "d", "t_max")))
    same = tri.numpy() == ref["tri"]
    assert same.mean() >= 0.999, same.mean()
    assert (ref["tri"] >= 0).sum() > 100
    hit = same & (ref["tri"] >= 0)
    np.testing.assert_allclose(t.numpy()[hit], ref["t"][hit], rtol=1e-5)
    inactive = ref["t_max"] <= 0
    assert (tri.numpy()[inactive] == -1).all()
    assert (t.numpy()[inactive] == 0).all()
