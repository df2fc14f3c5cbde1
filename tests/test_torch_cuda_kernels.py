"""PyTorch port: each CUDA kernel vs its plain PyTorch twin, on the card.

The machine with the card has no JAX, and tests/conftest.py imports it, so
this file imports no jax and runs there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Here (no CUDA device) every test skips. K4 (the closest hit), K5 (the
layered shared-origin walk), K6 (the shared-origin closest hit), K7 (the
shadow walk) and K8 (the any-hit prepass), the instances of the wide walk,
walk each lane in the same order as their twins, so their records agree
lane for lane; K9 and K10 (the list rasters) keep the same
fragments as theirs, bit for bit on adversarial lists (the inputs of
tests/torch_list_cases.py), and cull exactly the rows that the plain
version of their patch cull drops. The twins themselves are held against the JAX
reference by the CPU tests (tests/test_torch_kernels.py,
test_torch_trace_kernels.py, test_torch_so_prepass.py,
test_torch_raster.py).

Inputs are seeded numpy triangle soups, larger than the CPU tests' so that
the kernels walk many clusters and deep trees. Both sides evaluate the same
f32 expressions in the same order (the kernels build with --fmad=false), so
records agree except where a sample lies exactly on a shared triangle edge
or two hits tie in depth: ids/slots must agree on >= 99.9% of lanes, and
depths / barycentrics to 1e-5 where they do.
"""

import numpy as np
import pytest
import torch

from swift_game_engine_tpu_torch.assets.materials import Material
from swift_game_engine_tpu_torch.assets.mesh_api import MeshDescriptor
from swift_game_engine_tpu_torch.ops import cluster_shadow as CS
from swift_game_engine_tpu_torch.ops import rt_kernel as RK
from swift_game_engine_tpu_torch.render import tile_raster as TR
from swift_game_engine_tpu_torch.render.camera import Camera
from swift_game_engine_tpu_torch.render.scene_geometry import (
    RenderGeometryBuilder, flatten_frame)
from torch_list_cases import borderline_rows, triangles

pytestmark = pytest.mark.cuda

W, H = 320, 180


def soup(seed, t, spread=10.0, size=2.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    return (base,
            base + rng.uniform(-size, size, (t, 3)).astype(np.float32),
            base + rng.uniform(-size, size, (t, 3)).astype(np.float32))


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def agree(key_k, key_p, vals_k, vals_p):
    """Keys equal on >= 99.9% of lanes; values to 1e-5 where they agree."""
    same = key_k == key_p
    assert float(same.float().mean()) >= 0.999
    for a, b in zip(vals_k, vals_p):
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["opaque", "translucent"])
def test_k1_kernel_matches_plain(cuda, which):
    v0, v1, v2 = soup(21, 3000)
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 22.0], np.float32)
    vp = torch.as_tensor(cam.view_proj(W, H), device=cuda)
    tv = [torch.as_tensor(v, device=cuda) for v in (v0, v1, v2)]
    opaque = TR.setup_clusters(
        *tv, vp, W, H, opaque=torch.ones(len(v0), dtype=torch.bool,
                                         device=cuda))
    prior = None
    if which == "opaque":
        (rows, meta, boxes), layers = opaque, 1
    else:
        # the translucent raster is bounded by the opaque raster's depth
        prior = TR.cluster_raster(*opaque, W, H, 1)[3]
        prior = (prior.reshape(-1) * 1.3).contiguous()
        rows, meta, boxes = TR.setup_clusters(*tv, vp, W, H,
                                              cluster=TR.TRANS_CLUSTER)
        layers = 3
    before = sum(TR.launches)
    k = TR.cluster_raster(rows, meta, boxes, W, H, layers, prior)
    assert sum(TR.launches) == before + 1
    p = TR.cluster_raster_plain(rows, W, H, layers, prior, meta)
    torch.cuda.synchronize()
    assert int((k[0][:, -1] >= 0).sum()) > 100   # the deepest layer has hits
    agree(k[0], p[0], k[1:], p[1:])


def _quad(z, dup):
    """Two triangles of the plane z over x in [-40, 40], y in [-30, 40],
    each repeated ``dup`` times in a row (coplanar fragments at equal
    depth)."""
    a, b, c, d = ([-40, -30, z], [40, -30, z], [40, 40, z], [-40, 40, z])
    return [t for t in ((a, b, c), (a, c, d)) for _ in range(dup)]


def _k1_stress_inputs(case):
    """-> (v0, v1, v2, width, height, layers, cluster, prior, dup): inputs
    that stress K1's cull, each handled by the plain version as it is;
    triangles ``dup`` in a row share one geometry."""
    rng = np.random.default_rng(41)
    width, height, layers, cluster, prior, dup = W, H, 1, TR.CLUSTER, None, 1
    if case == "full_screen":
        # one triangle behind everything covers the screen; one crosses the
        # camera plane (w = 0), whose box is the whole screen
        v0, v1, v2 = soup(31, 2000)
        big = np.array([[[-900, -900, -40], [900, -900, -40], [0, 900, -40]],
                        [[-50, -2, 30], [50, -2, 30], [0, -2, -50]]],
                       np.float32)
        v0, v1, v2 = (np.concatenate([v, big[:, i]])
                      for i, v in enumerate((v0, v1, v2)))
        layers = 2
    elif case == "slivers":
        # needles far thinner than a pixel
        v0 = rng.uniform(-10, 10, (20000, 3)).astype(np.float32)
        v1 = v0 + rng.uniform(-4, 4, (20000, 3)).astype(np.float32)
        v2 = v1 + rng.uniform(-5e-3, 5e-3, (20000, 3)).astype(np.float32)
    elif case == "padding":
        # the last tile row and column of the grid are partly padding
        v0, v1, v2 = soup(33, 3000)
        width, height, layers, cluster = 960, 540, 3, TR.TRANS_CLUSTER
    elif case == "deep_ties":
        # 6 planes, each triangle twice: 12 fragments a pixel, 3 layers
        tris = np.array([t for z in np.arange(6) * -1.5
                         for t in _quad(z, 2)], np.float32)
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        layers, cluster, dup = 3, TR.TRANS_CLUSTER, 2
    else:                                  # the prior bound at 0 and at BIG
        v0, v1, v2 = soup(35, 3000)
        layers, cluster = 3, TR.TRANS_CLUSTER
        tiles = -(-W // 128) * -(-H // 32)
        prior = np.full(tiles * 32 * 128,
                        0.0 if case == "prior_zero" else TR.BIG, np.float32)
    return v0, v1, v2, width, height, layers, cluster, prior, dup


@pytest.mark.parametrize("case", ["full_screen", "slivers", "padding",
                                  "deep_ties", "prior_zero", "prior_big"])
def test_k1_cull_stress(cuda, case):
    """Inputs that stress the warp cull (a screen-filling triangle, sub-
    pixel slivers, a padded grid, depth complexity above the layer count
    with coplanar ties, the prior bound at 0 and BIG): the records equal
    the plain version's (tied fragments as their geometry), padding pixels
    stay empty, and the counting instantiation equals the kernel."""
    v0, v1, v2, width, height, layers, cluster, prior, dup = \
        _k1_stress_inputs(case)
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 22.0], np.float32)
    vp = torch.as_tensor(cam.view_proj(width, height), device=cuda)
    tv = [torch.as_tensor(v, device=cuda) for v in (v0, v1, v2)]
    rows, meta, boxes = TR.setup_clusters(*tv, vp, width, height,
                                          cluster=cluster)
    if prior is not None:
        prior = torch.as_tensor(prior, device=cuda)
    before = sum(TR.launches)
    k = TR.cluster_raster(rows, meta, boxes, width, height, layers, prior)
    kc, cnt = TR.cluster_raster_counts(rows, meta, boxes, width, height,
                                       layers, prior)
    assert sum(TR.launches) == before + 1  # the counting build is no launch
    p = TR.cluster_raster_plain(rows, width, height, layers, prior, meta)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kc, k))
    key_k = torch.where(k[0] >= 0, k[0] // dup, -1)
    key_p = torch.where(p[0] >= 0, p[0] // dup, -1)
    agree(key_k, key_p, k[1:], p[1:])
    hits = int((k[0] >= 0).sum())
    if case == "prior_zero":
        assert hits == 0
    else:
        assert int((k[0][:, -1] >= 0).sum()) > 100   # the last layer fills
    if case == "deep_ties":               # nearest plane twice, then the next
        full = (k[0] >= 0).all(1)
        w0, w1, w2 = (k[3][:, l][full] for l in range(3))
        assert int(full.sum()) > 0.5 * W * H
        assert float(((w0 == w1) & (w2 > w1)).float().mean()) >= 0.99
    # padding pixels (outside the image) keep empty records
    tiles_x = -(-width // 128)
    px = (torch.arange(k[0].shape[0], device=cuda) % tiles_x)[:, None,
                                                               None] * 128 + \
        torch.arange(128, device=cuda)
    py = (torch.arange(k[0].shape[0], device=cuda) // tiles_x)[:, None,
                                                                None] * 32 + \
        torch.arange(32, device=cuda)[:, None]
    pad = ((px >= width) | (py >= height))[:, None].expand_as(k[0])
    if case == "padding":
        assert bool(pad.any())
    assert bool((k[0][pad] == -1).all()) and bool((k[3][pad] == TR.BIG).all())
    # the work: a pixel enters only clusters it tests, tests rows only of
    # clusters it enters; a warp loops only over rows whose boxes it tests
    assert bool((cnt["lane_enter"] <= cnt["lane_meta"]).all())
    assert bool((cnt["lane_tri"] <= cluster * cnt["lane_enter"]).all())
    assert bool((cnt["warp_tri"] <= cnt["warp_box"]).all())
    assert bool((cnt["warp_surv"] <= cnt["warp_meta"]).all())
    assert int(cnt["warp_meta"].numel()) * 32 == cnt["lane_meta"].numel()


@pytest.fixture
def shadow_case(cuda):
    v0, v1, v2 = soup(7, 5000, spread=14.0, size=2.5)
    rng = np.random.default_rng(8)
    tr = rng.random(5000) < 0.3
    alpha = rng.uniform(0.1, 0.9, 5000).astype(np.float32)
    l = np.array([-0.2, 1.0, -0.4], np.float32)
    l /= np.linalg.norm(l)
    o = rng.uniform(-16, 16, (20000, 3)).astype(np.float32)
    t_lim = np.full(20000, 60.0, np.float32)
    t_lim[::13] = 0.0                                     # dead lanes
    split = CS.build_shadow_split(
        *(torch.as_tensor(v, device=cuda) for v in (v0, v1, v2)),
        torch.as_tensor(l, device=cuda), torch.as_tensor(tr, device=cuda),
        alpha=torch.as_tensor(alpha, device=cuda),
        trans_idx=torch.as_tensor(np.nonzero(tr)[0], device=cuda))
    return split, torch.as_tensor(o, device=cuda), \
        torch.as_tensor(t_lim, device=cuda)


def test_k2_kernel_matches_plain(shadow_case):
    split, o, t_lim = shadow_case
    before = CS.occl_launches
    k = CS.trace_shadow_occl(split.full, o, t_lim)
    assert CS.occl_launches == before + 1
    p = CS.trace_shadow_occl_plain(split.full, o, t_lim)
    assert int((p < 1e30).sum()) > 1000                   # lanes in shadow
    agree(k < 1e30, p < 1e30, [k], [p])


def test_k2_anyhit_is_factor_equivalent(shadow_case):
    """With a settle threshold a lane may stop at SOME opaque t < tt; the
    shadow factor only asks whether t_opq < tt, and that must agree."""
    split, o, t_lim = shadow_case
    tt = torch.full_like(t_lim, 5.0)
    k = CS.trace_shadow_occl(split.full, o, t_lim, tt=tt)
    p = CS.trace_shadow_occl_plain(split.full, o, t_lim)
    assert torch.equal(k < tt, p < tt)
    never_settled = p >= tt                 # these walk on: exact t
    torch.testing.assert_close(k[never_settled], p[never_settled], rtol=1e-5,
                               atol=1e-5)


def test_k2_incoherent_lanes(shadow_case):
    """Lanes in random order (incoherent warps), a lane count that is no
    multiple of 32, dead lanes and lanes that settle at once mixed in: the
    exact records equal the plain version's, the any-hit ones are
    factor-equivalent, and the counting instantiation agrees."""
    split, o, t_lim = shadow_case
    n = o.shape[0] - 7
    perm = torch.as_tensor(np.random.default_rng(17).permutation(n),
                           device=o.device)
    o, t_lim = o[perm].contiguous(), t_lim[perm].contiguous()
    t_lim[::5] = 0.0                                      # more dead lanes
    tt = torch.full_like(t_lim, 3.0e38)                   # settle at a hit
    tt[1::3] = 2.0
    tt[2::3] = 0.0                                        # never settle
    k = CS.trace_shadow_occl(split.full, o, t_lim)
    p = CS.trace_shadow_occl_plain(split.full, o, t_lim)
    assert int((p < 1e30).sum()) > 1000
    agree(k < 1e30, p < 1e30, [k], [p])
    ka = CS.trace_shadow_occl(split.full, o, t_lim, tt=tt)
    assert torch.equal(ka < tt, p < tt)
    assert torch.equal(ka[t_lim <= 0], torch.zeros_like(ka[t_lim <= 0]))
    ca, counts = CS.trace_shadow_occl_counts(split.full, o, t_lim, tt)
    assert torch.equal(ca, ka)
    assert counts["warp_meta"].numel() == (n + 31) // 32
    assert int(counts["lane_enter"][t_lim <= 0].sum()) == 0
    # a lane tests only opaque rows of the clusters it enters
    assert bool((counts["lane_tri"] <=
                 split.full.cluster * counts["lane_enter"]).all())
    with pytest.raises(ValueError):          # a set built without groups
        CS.trace_shadow_occl(split.full._replace(groups=None), o, t_lim)


def test_k2_k3_live_first_stream_with_dead_tail(shadow_case):
    """The deferred shade's sweep (render/deferred.py): the live lanes
    scattered among a dead majority (t_lim 0), put first by the live-first
    partition (render/rt.py ``_live_first_order``), then a long dead tail.
    K2 (any-hit, settled by K3's nearest slot, as the frame runs them) and
    K3 on the sorted stream agree with their twins, and gathered back they
    equal the kernels' records on the unsorted stream bit for bit; every
    warp of the dead tail retires at once (it tests no cluster)."""
    from swift_game_engine_tpu_torch.render.rt import _live_first_order
    split, o, t_lim = shadow_case
    rng = np.random.default_rng(21)
    n = 6 * o.shape[0] + 5
    pick = torch.as_tensor(rng.integers(0, o.shape[0], n), device=o.device)
    o_u = o[pick].contiguous()
    t_u = torch.where(torch.as_tensor(rng.random(n) < 0.2, device=o.device),
                      t_lim[pick], 0.0).contiguous()
    order = _live_first_order(t_u > 0)
    inv = torch.argsort(order)
    live = int((t_u > 0).sum())
    assert 0.1 * n < live < 0.25 * n
    assert not torch.equal(order, torch.arange(n, device=o.device))
    o_s, t_s = o_u[order].contiguous(), t_u[order].contiguous()
    assert bool((t_s[:live] > 0).all()) and bool((t_s[live:] == 0).all())
    for n_slots in (1, 4):
        k3 = CS.trace_shadow_clusters(split.trans, o_s, t_s, n_slots, True)
        p3 = CS.trace_shadow_clusters_plain(split.trans, o_s, t_s, n_slots,
                                            True)
        agree(k3[0] < 1e30, p3[0] < 1e30, [k3[0]], [p3[0]])
        same = (k3[2] == p3[2]).all(1)
        assert float(same.float().mean()) >= 0.999
        u3 = CS.trace_shadow_clusters(split.trans, o_u, t_u, n_slots, True)
        for a, b in zip(k3, u3):
            assert torch.equal(a[inv], b)
        tt = k3[1][:, 0].contiguous()
        k2 = CS.trace_shadow_occl(split.full, o_s, t_s, tt=tt)
        p2 = CS.trace_shadow_occl_plain(split.full, o_s, t_s)
        assert torch.equal(k2 < tt, p2 < tt)
        u2 = CS.trace_shadow_occl(split.full, o_u, t_u, tt=u3[1][:, 0]
                                  .contiguous())
        assert torch.equal(k2[inv], u2)
    _, cnt = CS.trace_shadow_occl_counts(split.full, o_s, t_s, tt)
    first_dead_warp = -(-live // 32)
    assert int(cnt["warp_meta"][first_dead_warp:].sum()) == 0
    assert int(cnt["warp_meta"][:first_dead_warp].min()) > 0


@pytest.mark.parametrize("n_slots,alpha_payload", [(4, True), (4, False),
                                                   (2, True)])
def test_k3_kernel_matches_plain(shadow_case, n_slots, alpha_payload):
    split, o, t_lim = shadow_case
    before = CS.slots_launches
    k = CS.trace_shadow_clusters(split.trans, o, t_lim, n_slots,
                                 alpha_payload)
    assert CS.slots_launches == before + 1
    p = CS.trace_shadow_clusters_plain(split.trans, o, t_lim, n_slots,
                                       alpha_payload)
    assert int((p[2][:, 0] >= 0).sum()) > 1000            # translucent hits
    agree(k[0] < 1e30, p[0] < 1e30, [k[0]], [p[0]])
    same = (k[2] == p[2]).all(1)
    assert float(same.float().mean()) >= 0.999
    torch.testing.assert_close(k[1][same], p[1][same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("alpha_payload", [False, True])
@pytest.mark.parametrize("n_slots", [1, 2, 3, 4])
def test_k3_incoherent_lanes(shadow_case, n_slots, alpha_payload):
    """Lanes in random order (incoherent warps), a lane count that is no
    multiple of 32 and many dead lanes, at every slot count: t_opq and the
    slot sets equal the plain version's, dead lanes carry empty records,
    and the counting instantiation equals the kernel."""
    split, o, t_lim = shadow_case
    n = o.shape[0] - 11
    perm = torch.as_tensor(np.random.default_rng(19).permutation(n),
                           device=o.device)
    o, t_lim = o[perm].contiguous(), t_lim[perm].contiguous()
    t_lim[::4] = 0.0                                      # more dead lanes
    before = CS.slots_launches
    k = CS.trace_shadow_clusters(split.trans, o, t_lim, n_slots,
                                 alpha_payload)
    kc, cnt = CS.trace_shadow_clusters_counts(split.trans, o, t_lim,
                                              n_slots, alpha_payload)
    assert CS.slots_launches == before + 1
    p = CS.trace_shadow_clusters_plain(split.trans, o, t_lim, n_slots,
                                       alpha_payload)
    assert all(torch.equal(a, b) for a, b in zip(kc, k))
    assert int((p[2][:, 0] >= 0).sum()) > 1000            # translucent hits
    agree(k[0] < 1e30, p[0] < 1e30, [k[0]], [p[0]])
    same = (k[2].sort(1)[0] == p[2].sort(1)[0]).all(1)    # slot sets
    assert float(same.float().mean()) >= 0.999
    torch.testing.assert_close(k[1][same], p[1][same], rtol=1e-5, atol=1e-5)
    dead = t_lim <= 0
    assert bool((k[0][dead] == 0).all()) and bool((k[2][dead] == -1).all())
    assert cnt["warp_meta"].numel() == (n + 31) // 32
    assert int(cnt["lane_enter"][dead].sum()) == 0
    assert bool((cnt["lane_tri"] <=
                 split.trans.cluster * cnt["lane_enter"]).all())


def _k4_geometry(dev, v0, v1, v2):
    pos = np.stack([v0, v1, v2], 1).reshape(-1, 3)
    b = RenderGeometryBuilder(texture_size=4)
    b.add_static_mesh(MeshDescriptor(positions=pos,
                                     indices=np.arange(len(pos),
                                                       dtype=np.int32)),
                      Material(name="m"), instance=0)
    geo = b.build(dev)
    return flatten_frame(geo, torch.eye(4, device=dev)[None],
                         torch.zeros((1, 1, 4, 4), device=dev))


@pytest.mark.parametrize("n", [256, 2000, 100_000])
def test_k4_kernel_matches_plain(cuda, n):
    """The cooperative walk (4 threads a ray) from a few blocks of rays to
    more than the card holds at once."""
    fg = _k4_geometry(cuda, *soup(5, 6000, spread=14.0))
    rng = np.random.default_rng(6)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d, t_max = (torch.as_tensor(x, device=cuda) for x in (
        rng.uniform(-18, 18, (n, 3)).astype(np.float32), d,
        np.full(n, 1e6, np.float32)))
    t_max[::17] = 0.0                                     # inactive rays
    bvh = fg.bvh
    before = RK.launches
    kt, ktri = RK.trace_rays(bvh.wide, bvh.rows, o, d, t_max)
    assert RK.launches == before + 1
    pt, ptri = RK.trace_rays_plain(bvh.wide, bvh.rows, o, d, t_max)
    assert int((ptri >= 0).sum()) > n // 8
    agree(ktri, ptri, [kt], [pt])
    # the counting instantiation walks the same way
    ct, ctri, counts = RK.trace_rays_counts(bvh.wide, bvh.rows, o, d, t_max)
    assert torch.equal(ctri, ktri) and torch.equal(ct, kt)
    assert int(counts["slots"].sum()) > 0
    assert int(counts["boxes"].sum()) <= RK.WIDE * int(counts["nodes"].sum())


@pytest.mark.parametrize("n", [2000, 100_000])
def test_k4_grazing_and_inside(cuda, n):
    """Rays grazing a large plane (directions within 1e-3 of it, origins
    just above it) and rays that start inside the soup's boxes."""
    lift = np.array([0.0, 11.0, 0.0], np.float32)          # soup above y=1
    v0, v1, v2 = (v + lift for v in soup(15, 3000, spread=8.0))
    plane = np.array([[-200, 0, -200], [200, 0, -200], [200, 0, 200],
                      [-200, 0, 200]], np.float32)
    v0 = np.concatenate([v0, plane[[0, 0]]])
    v1 = np.concatenate([v1, plane[[1, 2]]])
    v2 = np.concatenate([v2, plane[[2, 3]]])
    fg = _k4_geometry(cuda, v0, v1, v2)
    rng = np.random.default_rng(16)
    half = n // 2
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32) + lift  # in the soup
    o[:half, 1] = rng.uniform(1e-4, 1e-2, half)            # above the plane
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:half, 1] = -rng.uniform(0, 1e-3, half) * np.linalg.norm(
        d[:half, [0, 2]], axis=1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
    t_max = torch.full((n,), 3.0e38, device=cuda)
    kt, ktri = RK.trace_rays(fg.bvh.wide, fg.bvh.rows, o, d, t_max)
    pt, ptri = RK.trace_rays_plain(fg.bvh.wide, fg.bvh.rows, o, d, t_max)
    plane_ids = torch.tensor([3000, 3001], device=cuda)
    assert int(torch.isin(ptri[:half], plane_ids).sum()) > half // 4
    assert int((ptri[half:] >= 0).sum()) > n // 8
    agree(ktri, ptri, [kt], [pt])


@pytest.fixture
def walk_tree(cuda):
    """A 6,000-triangle soup, a fifth of it translucent, as the packed and
    wide trees the walks read (well under their 22,000-row cap)."""
    v0, v1, v2 = soup(9, 6000, spread=14.0)
    pos = np.stack([v0, v1, v2], 1).reshape(-1, 3)
    cut = 3 * 4800
    b = RenderGeometryBuilder(texture_size=4)
    b.add_static_mesh(MeshDescriptor(
        positions=pos[:cut], indices=np.arange(cut, dtype=np.int32)),
        Material(name="opaque"), instance=0)
    b.add_static_mesh(MeshDescriptor(
        positions=pos[cut:], indices=np.arange(len(pos) - cut,
                                               dtype=np.int32)),
        Material(name="glass", alpha=0.4), instance=0)
    geo = b.build(cuda)
    fg = flatten_frame(geo, torch.eye(4, device=cuda)[None],
                       torch.zeros((1, 1, 4, 4), device=cuda))
    assert RK.walk_available(fg.bvh.rows)
    return fg.bvh


def records_agree(key_k, key_p, vals_k, vals_p):
    """Per-lane records of a walk kernel and its twin (same per-lane order):
    the (N, K) keys equal on >= 99.9% of lanes, values to 1e-5 there."""
    same = (key_k == key_p).all(1)
    assert float(same.float().mean()) >= 0.999
    for a, b in zip(vals_k, vals_p):
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-5)


def _k5_case(bvh, n, n_slots, seed):
    """K5 and its wide twin on n rays from one origin into the soup, every
    17th inactive."""
    dev = bvh.rows.device
    rng = np.random.default_rng(seed)
    o = torch.tensor([0.0, 3.0, 30.0], device=dev)
    tgt = torch.as_tensor(rng.uniform(-14, 14, (n, 3)).astype(np.float32),
                          device=dev)
    d = tgt - o
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).contiguous()
    t_max = torch.full((n,), 3.0e38, device=dev)
    t_max[::17] = 0.0                                     # inactive rays
    srows = RK.build_origin_rows(bvh.rows, o)
    before = RK.so_launches
    k = RK.trace_layers_so(bvh.wide, srows, o.tolist(), d, t_max, n_slots)
    assert RK.so_launches == before + 1
    p = RK.trace_layers_so_plain(bvh.wide, srows, o, d, t_max, n_slots)
    torch.cuda.synchronize()
    assert int((p[1] >= 0).sum()) > n // 7 and \
        int((p[3][:, 0] >= 0).sum()) > n // 20
    assert bool((k[0][::17] == 0).all() and (k[1][::17] == -1).all())
    records_agree(torch.cat([k[1][:, None].float(), k[3]], 1),
                  torch.cat([p[1][:, None].float(), p[3]], 1),
                  [k[0], k[2]], [p[0], p[2]])


@pytest.mark.parametrize("n_slots", [1, 2, 3])
def test_k5_kernel_matches_plain(walk_tree, n_slots):
    _k5_case(walk_tree, 20000, n_slots, 10)


def test_k5_kernel_matches_plain_at_scale(walk_tree):
    """Past 100,000 rays: many blocks of rays in flight."""
    _k5_case(walk_tree, 131_072, 3, 12)


@pytest.mark.parametrize("threads", [4, 1])
def test_k5_kernel_matches_plain_per_thread_count(walk_tree, threads):
    """K5 picks its threads a ray by the call's ray count: each build,
    below and above the switch (a frame's dense call runs the one-thread
    build), against the twin."""
    n = 200_000 if threads == 4 else 300_000
    assert RK.walk_threads("K5", n) == threads
    _k5_case(walk_tree, n, 3, 14)


def _k7_case(bvh, n, n_slots, seed):
    """K7 and its wide twin on n origins in and around the soup toward one
    light, every 13th inactive."""
    dev = bvh.rows.device
    rng = np.random.default_rng(seed)
    l = torch.as_tensor(np.array([0.3, 0.8, -0.2], np.float32), device=dev)
    l = l / torch.linalg.vector_norm(l)
    o = torch.as_tensor(rng.uniform(-16, 16, (n, 3)).astype(np.float32),
                        device=dev)
    t_lim = torch.full((n,), 60.0, device=dev)
    t_lim[::13] = 0.0                                     # dead lanes
    srows = RK.build_shadow_rows(bvh.rows, l)
    before = RK.shadow_launches
    k = RK.trace_shadow_factor(bvh.wide, srows, l, o, t_lim, n_slots)
    assert RK.shadow_launches == before + 1
    # the direction as host floats, as the frame passes it: the same walk
    for a, b in zip(RK.trace_shadow_factor(bvh.wide, srows, l.tolist(), o,
                                           t_lim, n_slots), k):
        assert torch.equal(a, b)
    p = RK.trace_shadow_factor_plain(bvh.wide, srows, l, o, t_lim, n_slots)
    torch.cuda.synchronize()
    assert int((p[0] < 1e30).sum()) > n // 7 and \
        int((p[2][:, 0] >= 0).sum()) > n // 20
    assert bool((k[0][::13] == 0).all() and (k[2][::13] == -1).all())
    records_agree(torch.cat([(k[0] < 1e30)[:, None].float(), k[2]], 1),
                  torch.cat([(p[0] < 1e30)[:, None].float(), p[2]], 1),
                  [k[0], k[1]], [p[0], p[1]])


@pytest.mark.parametrize("n_slots", [1, 2, 3, 4])
def test_k7_kernel_matches_plain(walk_tree, n_slots):
    _k7_case(walk_tree, 20000, n_slots, 11)


def test_k7_kernel_matches_plain_at_scale(walk_tree):
    """Past 100,000 origins: many blocks of origins in flight."""
    _k7_case(walk_tree, 131_072, 4, 13)


def test_wrappers_reject_bad_inputs(cuda):
    rows = torch.zeros((8, RK.ROW), device=cuda)
    tree = RK.WideTree(nodes=torch.zeros((1, RK.NODE_F), device=cuda),
                       stack=0)
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError):
        RK.trace_rays(tree, rows, o.double(), o, torch.ones(4, device=cuda))
    with pytest.raises(ValueError):
        RK.trace_rays(tree, rows, o, torch.zeros((3, 4), device=cuda).T,
                      torch.ones(4, device=cuda))
    with pytest.raises(ValueError):
        RK.trace_rays(tree, rows, o, o, torch.ones(4))    # t_max on the CPU
    with pytest.raises(ValueError):
        RK.trace_rays(tree, rows[:, :64], o, o, torch.ones(4, device=cuda))
    with pytest.raises(ValueError):                       # stack over the cap
        RK.trace_rays(tree._replace(stack=RK.WIDE_STACK_MAX + 1), rows, o, o,
                      torch.ones(4, device=cuda))
    so = RK.build_origin_rows(rows, torch.zeros(3, device=cuda))
    with pytest.raises(ValueError):
        RK.trace_layers_so(tree, so, torch.zeros(3), o,
                           torch.ones(4, device=cuda),
                           n_slots=4)                     # K5 takes 1..3
    with pytest.raises(ValueError):                       # K5: srows width
        RK.trace_layers_so(tree, rows, [0.0, 0.0, 0.0], o,
                           torch.ones(4, device=cuda))
    with pytest.raises(ValueError):                       # K6: srows width
        RK.trace_rays_so(tree, so[:, :8].contiguous(), [0.0, 0.0, 0.0], o,
                         torch.ones(4, device=cuda))
    with pytest.raises(ValueError):                       # K6: floor shape
        RK.trace_rays_so(tree, so, [0.0, 0.0, 0.0], o,
                         torch.ones(4, device=cuda),
                         torch.ones(5, device=cuda))
    with pytest.raises(ValueError):                       # K8: rows width
        RK.trace_shadow_any(tree, rows[:, :64], o, o,
                            torch.ones(4, device=cuda))
    with pytest.raises(ValueError):                       # K8: stack bound
        RK.trace_shadow_any(tree._replace(stack=RK.WIDE_STACK_MAX + 1),
                            rows, o, o, torch.ones(4, device=cuda))
    sr = RK.build_shadow_rows(rows, torch.tensor([0.0, 1.0, 0.0],
                                                 device=cuda))
    with pytest.raises(ValueError):
        RK.trace_shadow_factor(tree, sr, torch.tensor([0.0, 1.0, 0.0]), o,
                               torch.ones(5, device=cuda))  # t_limit shape
    with pytest.raises(ValueError):                       # K7 takes 1..4
        RK.trace_shadow_factor(tree, sr, [0.0, 1.0, 0.0], o,
                               torch.ones(4, device=cuda), n_slots=5)


@pytest.fixture
def wide_case(cuda):
    """The wide tree of a 6,000-triangle soup (a fifth of it translucent)
    lifted over an opaque 400-unit plane at y = 0, under the walks' cap."""
    lift = np.float32([0.0, 17.0, 0.0])                   # soup in y 1..33
    v0, v1, v2 = (v + lift for v in soup(9, 6000, spread=14.0))
    pos = np.stack([v0, v1, v2], 1).reshape(-1, 3)
    plane = np.array([[-200, 0, -200], [200, 0, -200], [200, 0, 200],
                      [-200, 0, 200]], np.float32)
    cut = 3 * 4800
    b = RenderGeometryBuilder(texture_size=4)
    for mat, p, idx in ((Material(name="opaque"), pos[:cut], None),
                        (Material(name="glass", alpha=0.4), pos[cut:], None),
                        (Material(name="floor"), plane,
                         np.array([0, 1, 2, 0, 2, 3], np.int32))):
        b.add_static_mesh(MeshDescriptor(
            positions=p, indices=np.arange(len(p), dtype=np.int32)
            if idx is None else idx), mat, instance=0)
    geo = b.build(cuda)
    fg = flatten_frame(geo, torch.eye(4, device=cuda)[None],
                       torch.zeros((1, 1, 4, 4), device=cuda))
    assert RK.walk_available(fg.bvh.rows)
    return fg.bvh


def _grazing(rng, n):
    """n unit directions within 1e-3 of the plane y = 0, going down."""
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -rng.uniform(0, 1e-3, n) * np.linalg.norm(d[:, [0, 2]], axis=1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _walk_work(cnt, walk, active):
    """The counting instantiation against the twin's work: the same child
    boxes and slot tests in total, no work on inactive lanes, and each
    count within what the nodes and leaves visited allow."""
    assert int(cnt["boxes"].sum()) == walk["box"]
    assert int(cnt["slots"].sum()) == walk["slot"]
    for v in cnt.values():
        assert int(v[~active].abs().sum()) == 0
    assert bool((cnt["boxes"] <= RK.WIDE * cnt["nodes"]).all())
    assert bool((cnt["slots"] <= RK.SLOT_N * cnt["leaves"]).all())


@pytest.mark.parametrize("origin", ["inside", "grazing"])
@pytest.mark.parametrize("floor", [False, True], ids=["no_floor", "floor"])
@pytest.mark.parametrize("n", [6, 1000, 20000])
def test_k6_kernel_matches_plain(wide_case, n, floor, origin):
    """K6 on the wide tree from 6 rays to 20,000, one origin inside the
    soup's leaf boxes or just above the plane (half the rays grazing it),
    inactive lanes, and a floor past the first hit or exactly at it."""
    bvh, dev = wide_case, wide_case.rows.device
    rng = np.random.default_rng(12)
    if origin == "inside":
        o = np.float32([0.0, 17.0, 0.0])
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    else:
        o = np.float32([0.0, 1e-3, 0.0])
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d[: n // 2] = _grazing(rng, n // 2)
    o = torch.as_tensor(o, device=dev)
    d = torch.as_tensor(d, device=dev)
    t_max = torch.full((n,), 3.0e38, device=dev)
    t_max[::17] = 0.0                                     # inactive rays
    srows = RK.build_origin_rows(bvh.rows, o)
    t_floor = None
    if floor:   # past the first hit by a margin, or exactly at it
        t1, tri1 = RK.trace_rays_so_plain(bvh.wide, srows, o, d, t_max)
        t_floor = torch.where(tri1 >= 0, t1 + 0.01, 1e-4)
        t_floor[1::2] = torch.where(tri1 >= 0, t1, 1e-4)[1::2]
        t_floor = t_floor.contiguous()
    before = RK.so_closest_launches
    kt, ktri = RK.trace_rays_so(bvh.wide, srows, o.tolist(), d, t_max,
                                t_floor)
    ct, ctri, cnt = RK.trace_rays_so_counts(bvh.wide, srows, o.tolist(), d,
                                            t_max, t_floor)
    assert RK.so_closest_launches == before + 1   # counting: no launch
    walk = {}
    pt, ptri = RK.trace_rays_so_plain(bvh.wide, srows, o, d, t_max, t_floor,
                                      counts=walk)
    torch.cuda.synchronize()
    assert int((ptri >= 0).sum()) > n // 8
    assert torch.equal(ctri, ktri) and torch.equal(ct, kt)
    agree(ktri, ptri, [kt], [pt])
    inactive = t_max <= 0
    assert bool((ktri[inactive] == -1).all()) and \
        bool((kt[inactive] == 0).all())
    _walk_work(cnt, walk, ~inactive)


@pytest.mark.parametrize("n", [6, 1000, 20000])
def test_k8_kernel_matches_plain(wide_case, n):
    """K8 on the wide tree from 6 rays to 20,000: a full warp of rays
    (32 lanes) blocked by the plane, origins inside the soup's leaf boxes,
    rays grazing the plane from just above it, lanes blocked at once
    (t_lim 0) and short limits: every lane equals the twin's."""
    bvh, dev = wide_case, wide_case.rows.device
    rng = np.random.default_rng(13)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32) + \
        np.float32([0.0, 17.0, 0.0])                      # in the soup
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    graze = slice(n // 2, n)
    o[graze, 1] = rng.uniform(1e-4, 1e-2, n - n // 2)
    d[graze] = _grazing(rng, n - n // 2)
    warp = slice(0, min(32, n))                           # straight down
    o[warp, 1] = 0.5
    d[warp] = np.float32([0.0, -1.0, 0.0])
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    t_lim = torch.full((n,), 60.0, device=dev)
    t_lim[33::13] = 0.0                                   # blocked at once
    t_lim[34::7] = 3.0                                    # short limits
    before = RK.any_launches
    k = RK.trace_shadow_any(bvh.wide, bvh.rows, o, d, t_lim)
    kc, cnt = RK.trace_shadow_any_counts(bvh.wide, bvh.rows, o, d, t_lim)
    assert RK.any_launches == before + 1          # counting: no launch
    walk = {}
    p = RK.trace_shadow_any_plain(bvh.wide, bvh.rows, o, d, t_lim,
                                  counts=walk)
    torch.cuda.synchronize()
    assert bool(p[warp].all())
    if n > 32:
        assert 0.05 * n < int(p.sum()) < 0.95 * n
    assert torch.equal(k, p) and torch.equal(kc, k)
    _walk_work(cnt, walk, t_lim > 0)


@pytest.fixture
def list_case(cuda):
    """The list binning of a 3,000-triangle soup at 320x180 (18 tiles), K
    = 512 so that 3 tiles overflow."""
    v0, v1, v2 = soup(23, 3000)
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 22.0], np.float32)
    vp = torch.as_tensor(cam.view_proj(W, H), device=cuda)
    cand, counts, over = TR.setup_lists(
        *(torch.as_tensor(v, device=cuda) for v in (v0, v1, v2)), vp, W, H,
        k=512)
    assert int(over) > 0
    return cand, counts


@pytest.mark.parametrize("peel", [False, True], ids=["first", "peel"])
def test_k9_kernel_matches_plain(list_case, peel):
    cand, counts = list_case
    prev = None
    if peel:   # behind the first layer's depth, with the frame's margin
        w = TR.list_raster_plain(counts, cand, W, H)[3]
        prev = torch.where(w < 1e30, w * 1.000001, 3.0e38).contiguous()
    before = TR.list_launches
    k = TR.list_raster(counts, cand, W, H, prev)
    assert TR.list_launches == before + 1
    p = TR.list_raster_plain(counts, cand, W, H, prev)
    torch.cuda.synchronize()
    assert int((p[0] >= 0).sum()) > 10000
    agree(k[0], p[0], k[1:], p[1:])


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_k10_kernel_matches_plain(list_case, layers):
    cand, counts = list_case
    before = TR.peel_launches
    k = TR.list_raster_peeled(counts, cand, W, H, layers)
    assert TR.peel_launches == before + 1
    p = TR.list_raster_peeled_plain(counts, cand, W, H, layers)
    torch.cuda.synchronize()
    assert int((p[0][:, -1] >= 0).sum()) > 3000   # the deepest layer has hits
    agree(k[0], p[0], k[1:], p[1:])


def _bits_equal(out_k, out_p):
    """Records equal bit for bit (NaN records included)."""
    for a, b in zip(out_k, out_p):
        a, b = a.contiguous(), b.contiguous()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture(params=["triangles", "borderline_rows"])
def adversarial_lists(cuda, request):
    """Adversarial candidate lists at 320x180 (18 tiles), each with one
    tile emptied and tiles at the K cap: the CPU cull tests' triangles
    together (far slivers and specks, triangles crossing w = 0 or wholly
    behind the camera, a screen-filling one, degenerate and coplanar
    duplicates at equal depth) through the list binning at K = 256, or
    rows built directly (one edge form vanishing at a patch corner to a
    few ulps; inf, NaN, huge and tiny coefficients; ties at depths 1, 2
    and 3)."""
    if request.param == "borderline_rows":
        cand, counts = borderline_rows(W, H, 256)
        cand, counts = cand.to(cuda), counts.to(cuda)
    else:
        tris = [triangles(c) for c in ("far_slivers", "crossing_w0",
                                        "screen_filling", "coplanar_ties")]
        cam = Camera()
        cam.position = np.array([0.0, 4.0, 22.0], np.float32)
        vp = torch.as_tensor(cam.view_proj(W, H), device=cuda)
        cand, counts, over = TR.setup_lists(
            *(torch.as_tensor(np.concatenate([t[i] for t in tris]),
                              device=cuda) for i in range(3)), vp, W, H,
            k=256)
        assert int(over) > 0
    counts[5] = 0                                # an empty tile
    assert int((counts == cand.shape[1]).sum()) > 0
    return cand, counts


@pytest.mark.parametrize("twin", ["k9_first", "k9_peel", "k10_1", "k10_2",
                                  "k10_3"])
def test_list_kernels_adversarial(adversarial_lists, twin):
    """K9 (the first peel and the peel behind it) and K10 (1..3 layers)
    equal their twins bit for bit on adversarial lists."""
    cand, counts = adversarial_lists
    before = TR.list_launches + TR.peel_launches
    if twin.startswith("k9"):
        prev = None
        if twin == "k9_peel":
            w = TR.list_raster_plain(counts, cand, W, H)[3]
            prev = torch.where(w < 1e30, w * 1.000001, 3.0e38).contiguous()
        k = TR.list_raster(counts, cand, W, H, prev)
        p = TR.list_raster_plain(counts, cand, W, H, prev)
    else:
        layers = int(twin[-1])
        k = TR.list_raster_peeled(counts, cand, W, H, layers)
        p = TR.list_raster_peeled_plain(counts, cand, W, H, layers)
    torch.cuda.synchronize()
    assert TR.list_launches + TR.peel_launches == before + 1
    assert int((p[0] >= 0).sum()) > 1000
    assert bool((k[0][5] == -1).all())           # the empty tile
    _bits_equal(k, p)


@pytest.mark.parametrize("layers", [None, 1, 3], ids=["k9", "k10_1",
                                                      "k10_3"])
def test_list_counting_instantiation(adversarial_lists, layers):
    """The counting instantiation writes the production build's records
    and counts no launch; its work is the plain cull's: each warp
    cull-tests its tile's rows and admits the rows that
    ``list_patch_cull_plain`` keeps for its patch, and each of its pixels
    edge-tests every admitted row."""
    cand, counts = adversarial_lists
    before = TR.list_launches + TR.peel_launches
    if layers is None:
        k = TR.list_raster(counts, cand, W, H)
        kc, work = TR.list_raster_counts(counts, cand, W, H)
    else:
        k = TR.list_raster_peeled(counts, cand, W, H, layers)
        kc, work = TR.list_raster_peeled_counts(counts, cand, W, H, layers)
    torch.cuda.synchronize()
    assert TR.list_launches + TR.peel_launches == before + 1
    _bits_equal(kc, k)
    keep = TR.list_patch_cull_plain(counts, cand, W, H)
    n_tiles = cand.shape[0]
    admit = work["warp_admit"].reshape(n_tiles, TR.N_PATCHES)
    assert torch.equal(admit, keep.sum(-1).to(torch.int32))
    assert torch.equal(work["warp_cull"].reshape(n_tiles, -1),
                       counts[:, None].expand(-1, TR.N_PATCHES))
    assert torch.equal(work["lane_test"].reshape(-1, 32),
                       work["warp_admit"][:, None].expand(-1, 32))
    assert bool((work["lane_inside"] <= work["lane_test"]).all())
    assert int(work["lane_inside"].sum()) > 0
    assert int(admit.sum()) < int(counts.sum()) * TR.N_PATCHES
