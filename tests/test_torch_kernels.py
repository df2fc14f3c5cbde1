"""PyTorch port, the four kernels' plain twins vs the JAX reference (CPU).
Each CUDA kernel is held against its twin on the card by
tests/test_torch_cuda_kernels.py.

  * K1 cluster raster twin vs render/tile_raster.rasterize_clusters run in
    interpret mode, in the two configurations the hybrid frame uses: the
    opaque raster (1 layer, 128-triangle clusters) and the translucent-subset
    raster (3 layers, 16-triangle clusters, bounded by the opaque depth).
    Ids must agree on >= 99.9% of in-image pixels — the only freedom is
    which triangle wins a pixel centre that lies exactly on a shared edge
    or depth tie — and view depth to 1e-5 where ids agree.
    Out-of-image padding lanes are cropped (the reference fills them).
    K1's per-row screen boxes (the kernel's row cull) are checked against
    the reference's cluster metadata and against every fragment the twin
    keeps.
  * K2/K3 shadow sweep twins vs ops/cluster_shadow.trace_shadow_split in
    interpret mode with anyhit=False: t_opq to 1e-5, slot records as sets
    (ties in t may order them differently). With anyhit=True the records
    are only factor-equivalent, so the shadow factors are compared.
  * K4 traversal twin (the 4-wide walk over the wide nodes rebuilt from
    the reference's packed rows) vs render/bvh.traverse: triangle ids on
    >= 99.9% of rays (equal-t ties), t to 1e-5 where they agree.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from swift_game_engine_tpu.assets.materials import Material
from swift_game_engine_tpu.assets.mesh_api import MeshDescriptor
from swift_game_engine_tpu.ops import cluster_shadow as j_cs
from swift_game_engine_tpu.render import bvh as j_bvh
from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu.render import scene_geometry as j_sg
from swift_game_engine_tpu.render import tile_raster as j_tr
from swift_game_engine_tpu.render.camera import Camera, untile_image
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.ops import cluster_shadow as p_cs
from swift_game_engine_tpu_torch.ops import rt_kernel as p_rk
from swift_game_engine_tpu_torch.render import rt as p_rt
from swift_game_engine_tpu_torch.render import tile_raster as p_tr
from torch_threads import one_thread  # noqa: E402,F401

W, H = 160, 80
BIG = 3.0e38


def soup(seed, t, spread=8.0, size=2.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    return (base,
            base + rng.uniform(-size, size, (t, 3)).astype(np.float32),
            base + rng.uniform(-size, size, (t, 3)).astype(np.float32))


# --------------------------------------------------------------------- K1


@pytest.fixture(scope="module")
def raster_case():
    v0, v1, v2 = soup(21, 400)
    v0[0], v1[0], v2[0] = [-50, -2, 30], [50, -2, 30], [0, -2, -50]  # w = 0
    translucent = np.random.default_rng(3).random(400) < 0.2
    cam = Camera()
    cam.position = np.array([0.0, 3.0, 16.0], np.float32)
    cam.target = np.array([0.0, 0.0, 0.0], np.float32)
    return v0, v1, v2, translucent, cam.view_proj(W, H)


def _raster_both(case, which):
    v0, v1, v2, translucent, vp = case
    idx = np.nonzero(translucent if which == "translucent" else ~translucent)[0]
    tv = [torch.as_tensor(v[idx]) for v in (v0, v1, v2)]
    ids = idx.astype(np.float32)
    j_kw = dict(interpret=True, flat_tiles=True, resolve_t=False,
                ids=jnp.asarray(ids))
    p_kw = dict(ids=torch.as_tensor(ids))
    if which == "translucent":
        prior_j, prior_p = _raster_both(case, "opaque")
        j_kw.update(layers=3, cluster=16, prior_w=prior_j[0].w_depth)
        p_kw.update(layers=3, cluster=16, prior_w=prior_p[0].w_depth)
    else:
        j_kw.update(layers=1, opaque=jnp.ones(len(idx), bool))
        p_kw.update(layers=1, opaque=torch.ones(len(idx), dtype=torch.bool))
    jv = [jnp.asarray(v[idx]) for v in (v0, v1, v2)]
    jh = j_tr.rasterize_clusters(*jv, jnp.asarray(vp), jnp.zeros(3), W, H,
                                 **j_kw)
    ph = p_tr.rasterize_clusters(*tv, torch.as_tensor(vp), W, H, **p_kw)
    return jh, ph


def _img(x):
    return np.asarray(untile_image(jnp.asarray(np.asarray(x))[:, None], W,
                                   H))[..., 0]


@pytest.mark.parametrize("which", ["opaque", "translucent"])
def test_k1_twin_matches_reference(raster_case, which):
    jh, ph = _raster_both(raster_case, which)
    assert len(jh) == len(ph)
    assert (_img(jh[-1].tri) >= 0).sum() > 10   # the deepest layer has hits
    for jl, pl in zip(jh, ph):
        jt, pt = _img(jl.tri), _img(pl.tri.numpy())
        same = jt == pt
        assert same.mean() >= 0.999, same.mean()
        hit = same & (jt >= 0)
        np.testing.assert_allclose(_img(pl.w_depth.numpy())[hit],
                                   _img(jl.w_depth)[hit], rtol=1e-5)
        # barycentrics divide an edge function by the sum of all three,
        # which cancels for the near-plane crosser: 1e-4 on values in [0, 1]
        for a, b in ((jl.u, pl.u), (jl.v, pl.v)):
            np.testing.assert_allclose(_img(b.numpy())[hit], _img(a)[hit],
                                       atol=1e-4)


@pytest.mark.parametrize("which", ["opaque", "translucent"])
def test_k1_row_boxes_cover_their_clusters(raster_case, which):
    """K1's per-row screen boxes: the cluster metadata equals the
    reference's, and each cluster's box is the union of its rows' boxes
    (rows found through the metadata's base row); padding rows are
    empty."""
    v0, v1, v2, translucent, vp = raster_case
    idx = np.nonzero(translucent if which == "translucent" else
                     ~translucent)[0]
    cl = 16 if which == "translucent" else 128
    _, j_meta, n_cl = j_tr._setup_clusters(
        *(jnp.asarray(v[idx]) for v in (v0, v1, v2)), jnp.asarray(vp), W, H,
        cluster=cl)
    rows, meta, boxes = p_tr.setup_clusters(
        *(torch.as_tensor(v[idx]) for v in (v0, v1, v2)), torch.as_tensor(vp),
        W, H, cluster=cl)
    assert meta.shape == (n_cl, 8) and boxes.shape == (rows.shape[0], 4)
    np.testing.assert_allclose(meta.numpy(), np.asarray(j_meta).reshape(-1, 8),
                               rtol=1e-5, atol=1e-3)
    base = meta[:, 5].long() * 8
    per_cluster = boxes[base[:, None] + torch.arange(cl)]   # (C, cl, 4)
    for k, red in ((0, torch.amin), (1, torch.amin), (2, torch.amax),
                   (3, torch.amax)):
        assert torch.equal(red(per_cluster[:, :, k], 1), meta[:, k])
    pad = rows[:, 12] == -1.0
    assert bool((boxes[pad, 0] > boxes[pad, 2]).all())


def test_k1_row_boxes_hold_their_fragments(raster_case):
    """The premise of K1's row cull: every fragment the plain version keeps
    (3 layers, every triangle, the camera-plane crosser included) lies in
    its row's box widened to the pixel's square."""
    v0, v1, v2, _, vp = raster_case
    rows, meta, boxes = p_tr.setup_clusters(
        *(torch.as_tensor(v) for v in (v0, v1, v2)), torch.as_tensor(vp),
        W, H)
    tid, *_ = p_tr.cluster_raster_plain(rows, W, H, 3)
    tiles_x = -(-W // 128)
    t = torch.arange(tid.shape[0])
    px = ((t % tiles_x)[:, None, None] * 128 +
          torch.arange(128)).expand(-1, 32, -1).float()
    py = ((t // tiles_x)[:, None, None] * 32 +
          torch.arange(32)[:, None]).expand(-1, -1, 128).float()
    assert int((tid[:, -1] >= 0).sum()) > 10
    for l in range(3):
        hit = tid[:, l] >= 0
        b = boxes[tid[:, l][hit].long()]
        x, y = px[hit], py[hit]
        assert bool(((b[:, 0] <= x + 1) & (b[:, 2] >= x) &
                     (b[:, 1] <= y + 1) & (b[:, 3] >= y)).all())


def test_k1_culls_triangles_behind_the_camera(raster_case):
    """Triangles wholly behind the camera (every vertex w <= 0) get empty
    boxes, and rightly: with them the twin's records are the same as
    without them (no fragment of theirs is ever inside)."""
    v0, v1, v2, _, vp = raster_case
    rng = np.random.default_rng(5)
    n = 300                                # behind the camera at z = 16
    b0 = rng.uniform([-30, -20, 40], [30, 20, 80], (n, 3)).astype(np.float32)
    b1 = (b0 + rng.uniform(-20, 20, (n, 3)) * [1, 1, 0]).astype(np.float32)
    b2 = (b0 + rng.uniform(-20, 20, (n, 3)) * [1, 1, 0]).astype(np.float32)
    tv = [torch.as_tensor(np.concatenate([a, b]))
          for a, b in ((v0, b0), (v1, b1), (v2, b2))]
    vpt = torch.as_tensor(vp)
    rows, meta, boxes = p_tr.setup_clusters(*tv, vpt, W, H, cluster=16)
    w = torch.stack([rows[:, 9], rows[:, 10], rows[:, 11]], -1)
    behind = (w <= 0).all(-1) & (rows[:, 12] >= 0)
    assert int(behind.sum()) == n
    assert bool((boxes[behind, 0] > boxes[behind, 2]).all())
    with_them = p_tr.cluster_raster_plain(rows, W, H, 3)
    only = p_tr.setup_clusters(*(t[:len(v0)] for t in tv), vpt, W, H,
                               cluster=16)[0]
    without = p_tr.cluster_raster_plain(only, W, H, 3)
    for a, b in zip(with_them, without):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- K2 / K3


@pytest.fixture(scope="module")
def shadow_case():
    v0, v1, v2 = soup(7, 500, spread=10.0, size=3.0)
    rng = np.random.default_rng(8)
    translucent = rng.random(500) < 0.3
    alpha = rng.uniform(0.1, 0.9, 500).astype(np.float32)
    l = np.array([-0.2, 1.0, -0.4], np.float32)
    l /= np.linalg.norm(l)
    o = rng.uniform(-12, 12, (1000, 3)).astype(np.float32)
    t_lim = np.full(1000, 50.0, np.float32)
    t_lim[::13] = 0.0
    o[::13] = 1e9
    return v0, v1, v2, translucent, alpha, l, o, t_lim


def _shadow_both(case, anyhit, alpha_payload):
    v0, v1, v2, tr, alpha, l, o, t_lim = case
    tri = np.nonzero(tr)[0]
    js = j_cs.build_shadow_split(*(jnp.asarray(v) for v in (v0, v1, v2)),
                                 jnp.asarray(l), jnp.asarray(tr),
                                 alpha=jnp.asarray(alpha), trans_idx=tri)
    jr = j_cs.trace_shadow_split(js, jnp.asarray(o), jnp.asarray(t_lim),
                                 n_slots=4, interpret=True,
                                 alpha_payload=alpha_payload, anyhit=anyhit)
    ps = p_cs.build_shadow_split(*(torch.as_tensor(v) for v in (v0, v1, v2)),
                                 torch.as_tensor(l), torch.as_tensor(tr),
                                 alpha=torch.as_tensor(alpha),
                                 trans_idx=torch.as_tensor(tri))
    pr = p_cs.trace_shadow_split(ps, torch.as_tensor(o),
                                 torch.as_tensor(t_lim), n_slots=4,
                                 alpha_payload=alpha_payload, anyhit=anyhit)
    return [np.asarray(x) for x in jr], [x.numpy() for x in pr]


@pytest.mark.parametrize("alpha_payload", [False, True])
def test_k2_k3_twins_match_reference_records(shadow_case, alpha_payload):
    (jt, jts, jids), (pt, pts, pids) = _shadow_both(shadow_case, False,
                                                    alpha_payload)
    np.testing.assert_allclose(pt, jt, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pts, jts, rtol=1e-5, atol=1e-5)
    same_set = (np.sort(pids, 1) == np.sort(jids, 1)).all(1)
    assert same_set.mean() >= 0.999, same_set.mean()
    assert (jids >= 0).any(1).sum() > 20 and (jt < 1e30).sum() > 100


def test_k2_groups_cover_their_clusters(shadow_case):
    """The sweeps' 32-row culling groups, on both sets of the split (K2's
    full set and K3's translucent subset): each cluster's box is the union
    of its groups' boxes, and a group's depth range lies inside its
    cluster's."""
    v0, v1, v2, tr, alpha, l, o, t_lim = shadow_case
    ps = p_cs.build_shadow_split(*(torch.as_tensor(v) for v in (v0, v1, v2)),
                                 torch.as_tensor(l), torch.as_tensor(tr),
                                 alpha=torch.as_tensor(alpha),
                                 trans_idx=torch.as_tensor(np.nonzero(tr)[0]))
    for sc in (ps.full, ps.trans):
        per = sc.cluster // p_cs.GROUP
        g = sc.groups.reshape(-1, per, 8)
        assert g.shape[0] == sc.meta.shape[0]
        for k, red in ((0, torch.amin), (1, torch.amin), (2, torch.amax),
                       (3, torch.amax), (4, torch.amin), (5, torch.amax)):
            assert torch.equal(red(g[:, :, k], 1), sc.meta[:, k])


def test_k2_anyhit_factor_matches_reference(shadow_case):
    """Any-hit occlusion: records may differ, the shadow factor may not."""
    (jt, jts, jids), (pt, pts, pids) = _shadow_both(shadow_case, True, True)
    *_, l, o, t_lim = shadow_case
    active = t_lim > 0
    max_dist = np.float32(40.0)
    jf = j_rt._apply_shadow_records(
        None, None, jnp.asarray(o), jnp.asarray(l), jnp.asarray(jt),
        jnp.asarray(jts), jnp.asarray(jids), jnp.asarray(active), max_dist,
        4, None, alpha_payload=True)
    fr = p_rt._Frame(geo=None, fg=None, ibl=None, lights=None, cam=None,
                     shadow=None, shadow_layers=4, enable_mirror=False,
                     enable_refraction=False)
    pf = p_rt._apply_shadow_records(
        fr, torch.as_tensor(o), torch.as_tensor(l), torch.as_tensor(pt),
        torch.as_tensor(pts), torch.as_tensor(pids), torch.as_tensor(active),
        torch.tensor(max_dist), True)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-6)
    assert (np.asarray(jf) == 0).sum() > 50   # some lanes are in shadow


# --------------------------------------------------------------------- K4


@pytest.fixture(scope="module")
def trace_case():
    v0, v1, v2 = soup(5, 600)
    pos = np.stack([v0, v1, v2], 1).reshape(-1, 3)
    mesh = MeshDescriptor(positions=pos,
                          indices=np.arange(len(pos), dtype=np.int32))
    b = j_sg.RenderGeometryBuilder(texture_size=4)
    b.add_static_mesh(mesh, Material(name="m"), instance=0)
    geo = b.build()
    fg = j_sg.flatten_frame(geo, jnp.eye(4)[None], jnp.zeros((1, 1, 4, 4)))
    rng = np.random.default_rng(6)
    o = rng.uniform(-14, 14, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return fg, o, d


def test_k4_twin_matches_traverse(trace_case):
    fg, o, d = trace_case
    t_max = np.full(len(o), 1e6, np.float32)
    jt, jtri, _, _, _ = jax.vmap(
        lambda a, b: j_bvh.traverse(fg.bvh, a, b, jnp.float32(1e6)))(
        jnp.asarray(o), jnp.asarray(d))
    jt, jtri = np.asarray(jt), np.asarray(jtri)
    bvh = interop.frame_geometry(fg, device="cpu").bvh
    pt, ptri = p_rk.trace_rays(bvh.wide, bvh.rows, torch.as_tensor(o),
                               torch.as_tensor(d), torch.as_tensor(t_max))
    same = ptri.numpy() == jtri
    assert same.mean() >= 0.999, same.mean()
    assert (jtri >= 0).sum() > 300
    hit = same & (jtri >= 0)
    np.testing.assert_allclose(pt.numpy()[hit], jt[hit], rtol=1e-5)
