"""PyTorch port, collision primitives and queries vs the JAX reference (CPU).

The port's queries run a batch of casts at once; the reference runs one
cast per call. The same inputs, made from a numpy seed, go through both:
random triangles, the box-on-ground scene of tests/test_queries.py, and
the 17-Cheese / Semla collision hulls of the DemoScene. The two agree to
f32 rounding (the reference's XLA build fuses multiply-adds, the port's
eager ops do not): TOIs, depths and distances within 1e-4, normals and
points within 1e-4, hit flags and triangle ids equal. The analytic cast
is also held against the conservative-advancement twin (1e-3, the bound
of tests/test_queries.py) and the scalar oracle (5e-3, as there).
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swift_game_engine_tpu.physics import capsule_pair as JP
from swift_game_engine_tpu.physics import primitives as JPr
from swift_game_engine_tpu.physics import queries as JQ
from swift_game_engine_tpu.physics import stats as JS
from swift_game_engine_tpu.physics.collision_world import (
    CollisionWorldBuilder as JCB, transform_soup as j_transform)
from swift_game_engine_tpu.assets import procedural_meshes as pm
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.physics import capsule_pair as PP
from swift_game_engine_tpu_torch.physics import primitives as PPr
from swift_game_engine_tpu_torch.physics import queries as PQ
from swift_game_engine_tpu_torch.physics import stats as PS
from swift_game_engine_tpu_torch.physics.collision_world import (
    CollisionWorldBuilder as PCB, transform_soup as p_transform)
from swift_game_engine_tpu_torch.assets.static_mesh import load_static_mesh

sys.path.insert(0, os.path.dirname(__file__))
import oracle_collision as O  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-4


def _soups(meshes):
    """(JAX soup, port soup) of [(positions, indices, kwargs)] meshes, one
    entity each at the identity."""
    jb, pb = JCB(), PCB()
    for i, (p, idx, kw) in enumerate(meshes):
        jb.add_mesh(p, idx, entity=i, **kw)
        pb.add_mesh(p, idx, entity=i, **kw)
    n = len(meshes)
    js = j_transform(jb.build(), jnp.tile(jnp.eye(4), (n, 1, 1)))
    ps = p_transform(pb.build(device="cpu"), torch.eye(4).repeat(n, 1, 1))
    return js, ps


def _random_soup(seed, n_tris, spread, size):
    rng = np.random.default_rng(seed)
    tris = [rng.uniform(-spread, spread, 3) + rng.uniform(-size, size, (3, 3))
            for _ in range(n_tris)]
    pos = np.concatenate(tris).astype(np.float32)
    return tris, _soups([(pos, np.arange(len(pos)), {})])


def _sweeps(rng, tris, n, lo, hi, r_range, h_range):
    s, d, r, h = [], [], [], []
    for i in range(n):
        start = rng.uniform(lo, lo * -1, 3).astype(np.float32)
        if i % 2 == 0:
            t = tris[rng.integers(len(tris))]
            delta = ((t.mean(0) - start) * rng.uniform(0.9, 1.6))
        else:
            delta = rng.uniform(-hi, hi, 3)
        s.append(start)
        d.append(delta.astype(np.float32))
        r.append(rng.uniform(*r_range))
        h.append(rng.uniform(*h_range))
    f32 = np.float32
    return (np.array(s, f32), np.array(d, f32), np.array(r, f32),
            np.array(h, f32))


def _check_hit(ref, port, i, what):
    assert bool(ref.hit) == bool(port.hit[i]), (what, i)
    assert int(ref.tri_index) == int(port.tri_index[i]), (what, i)
    if bool(ref.hit):
        for f in ("toi", "normal", "tri_normal", "position", "mu_s", "mu_k"):
            np.testing.assert_allclose(getattr(port, f)[i].numpy(),
                                       np.asarray(getattr(ref, f)), atol=TOL,
                                       err_msg=f"{what} {f} cast {i}")
        assert bool(ref.flatten) == bool(port.flatten[i])
    assert int(ref.iterations) == int(port.iterations[i]), (what, i)


def test_primitives_match_reference():
    rng = np.random.default_rng(3)
    n = 500
    p, a, b, c, q = (rng.uniform(-3, 3, (n, 3)).astype(np.float32)
                     for _ in range(5))
    hh = rng.uniform(0.05, 2.0, n).astype(np.float32)
    t = torch.as_tensor
    pairs = [
        (JPr.closest_point_on_triangle(p, a, b, c),
         PPr.closest_point_on_triangle(t(p), t(a), t(b), t(c))),
        (JPr.segment_segment_closest(p, q, a, b),
         PPr.segment_segment_closest(t(p), t(q), t(a), t(b))),
        (JPr.segment_triangle_distance(p, hh, a, b, c),
         PPr.segment_triangle_distance(t(p), t(hh), t(a), t(b), t(c))),
        (JPr.segment_triangle_intersect(p, q, a, b, c),
         PPr.segment_triangle_intersect(t(p), t(q), t(a), t(b), t(c))),
        (JPr.ray_triangle(p, q, a, b, c),
         PPr.ray_triangle(t(p), t(q), t(a), t(b), t(c))),
        (JPr.ray_aabb(p, 1.0 / q, np.minimum(a, b), np.maximum(a, b)),
         PPr.ray_aabb(t(p), 1.0 / t(q), torch.minimum(t(a), t(b)),
                      torch.maximum(t(a), t(b)))),
        ((JPr.triangle_normal(a, b, c),), (PPr.triangle_normal(t(a), t(b),
                                                              t(c)),)),
        ((JPr.aabb_overlap(p, p + 1, a, a + 1),),
         (PPr.aabb_overlap(t(p), t(p) + 1, t(a), t(a) + 1),)),
    ]
    for k, (ref, port) in enumerate(pairs):
        for x, y in zip(ref, port):
            x, y = np.asarray(x), y.numpy()
            if x.dtype == np.bool_:
                assert (x == y).mean() > 0.998, k    # ulp ties at borders
            else:
                np.testing.assert_allclose(y, x, atol=2e-4, rtol=1e-4,
                                           err_msg=f"primitive {k}")


def test_capsule_casts_match_reference_and_ca():
    """60 sweeps through 40 random triangles: the port's analytic and CA
    casts against the reference's, and the two against each other."""
    tris, (js, ps) = _random_soup(7, 40, 6, 2.5)
    s, d, r, h = _sweeps(np.random.default_rng(8), tris, 60, -9, 12,
                         (0.15, 1.8), (0.05, 1.8))
    pa = PQ.capsule_cast(ps, torch.as_tensor(s), torch.as_tensor(d),
                         torch.as_tensor(r), torch.as_tensor(h))
    pc = PQ.capsule_cast_ca(ps, torch.as_tensor(s), torch.as_tensor(d),
                            torch.as_tensor(r), torch.as_tensor(h),
                            max_iters=256)
    hits = 0
    for i in range(len(s)):
        _check_hit(JQ.capsule_cast(js, s[i], d[i], r[i], h[i]), pa, i,
                   "analytic")
        _check_hit(JQ.capsule_cast_ca(js, s[i], d[i], r[i], h[i],
                                      max_iters=256), pc, i, "ca")
        assert bool(pa.hit[i]) == bool(pc.hit[i])
        if bool(pa.hit[i]):
            hits += 1
            assert abs(float(pa.toi[i]) - float(pc.toi[i])) < 1e-3
    assert hits >= 20


def test_capsule_cast_matches_oracle():
    tris, (js, ps) = _random_soup(42, 30, 5, 2)
    otris = [tuple(np.float32(v) for v in t) for t in tris]
    s, d, r, h = _sweeps(np.random.default_rng(43), tris, 16, -8, 10,
                         (0.2, 1.5), (0.1, 1.5))
    got = PQ.capsule_cast(ps, torch.as_tensor(s), torch.as_tensor(d),
                          torch.as_tensor(r), torch.as_tensor(h))
    n_hit = 0
    for i in range(len(s)):
        want = O.capsule_cast_soup(otris, s[i], d[i], float(r[i]),
                                   float(h[i]))
        assert bool(got.hit[i]) == (want is not None), i
        if want is not None:
            n_hit += 1
            assert float(got.toi[i]) == pytest.approx(want["toi"], abs=5e-3)
    assert n_hit >= 4


def test_blocking_and_ground_filtered_casts():
    """tests/test_queries.py's box-on-ground cases, batched: plain, blocking
    and ground-filtered casts of the same sweeps, with per-cast layer
    masks."""
    js, ps = _soups([(pm.plane(40.0).positions, pm.plane(40.0).indices, {}),
                     (pm.box(4.0).positions, pm.box(4.0).indices,
                      dict(mu_s=0.5, mu_k=0.3, layer=2))])
    s = np.array([[10, 10, 10], [6, 1, 0], [2.51, 1, 0], [6, 1.2, 0],
                  [1, 5, 1], [0, 6, -1]], np.float32)
    d = np.array([[0, -20, 0], [-8, 0, 0], [3, 0, 0], [-8, 0, 0],
                  [0, -9, 0.5], [0.2, -4, 0]], np.float32)
    r = np.array([1.5, 0.5, 0.5, 0.5, 0.8, 1.0], np.float32)
    h = np.array([1.0, 0.5, 0.5, 0.5, 0.3, 0.6], np.float32)
    masks = np.array([0xFFFFFFFF, 3, 2, 0xFFFFFFFF, 1, 2], np.uint32)
    for kw in (dict(), dict(blocking=True), dict(min_normal_y=0.5)):
        port = PQ.capsule_cast(
            ps, torch.as_tensor(s), torch.as_tensor(d), torch.as_tensor(r),
            torch.as_tensor(h), mask=torch.as_tensor(masks.astype(np.int64)),
            **{k: (torch.full((len(s),), v) if k == "min_normal_y" else v)
               for k, v in kw.items()})
        for i in range(len(s)):
            _check_hit(JQ.capsule_cast(js, s[i], d[i], r[i], h[i],
                                       mask=masks[i], **kw), port, i, kw)


def _hull_soups():
    """The 17-Cheese and Semla collision hulls, placed as the DemoScene
    places them (parts' transforms, Semla at +18,0,10)."""
    meshes = []
    for name, off, layer in (("17-Cheese.static.json", (0, 0, 0), 1),
                             ("Semla.static.json", (18, 0, 10), 8)):
        asset = load_static_mesh(os.path.join(REPO, "assets", name))
        for part in asset.parts:
            m = part.transform.astype(np.float64)
            for hull in part.collision_hulls:
                p = hull.positions @ m[:3, :3].T + m[:3, 3] + off
                meshes.append((p.astype(np.float32), hull.indices,
                               dict(mu_s=0.6, mu_k=0.5, layer=layer)))
    return meshes


def _match_overlaps(ref, port, i):
    """The deepest-K lists agree hit by hit, matched by triangle id: depths
    within 1e-4, triangle normals within 1e-4; a hit may change rank only
    within a run of depths tied to 1e-5. The contact normal and point are
    held to 1e-3: against a hull edge nearly parallel to the capsule's
    vertical core the closest-point pair slides along the two features
    under f32 rounding while the depth stays put."""
    rd, rt = np.asarray(ref.depth), np.asarray(ref.tri_index)
    pt = port.tri_index[i].numpy()
    np.testing.assert_array_equal(port.valid[i].numpy(),
                                  np.asarray(ref.valid))
    for j in np.nonzero(np.asarray(ref.valid))[0]:
        k = int(np.nonzero(pt == rt[j])[0][0])
        tied = np.abs(rd[min(j, k):max(j, k) + 1] - rd[j]) <= 1e-5
        assert tied.all(), (i, j, k, rd)
        for f, tol in (("depth", TOL), ("tri_normal", TOL),
                       ("normal", 1e-3), ("position", 1e-3)):
            np.testing.assert_allclose(getattr(port, f)[i, k].numpy(),
                                       np.asarray(getattr(ref, f))[j],
                                       atol=tol, err_msg=f"{f} hit {j}")


def test_queries_on_demo_hulls():
    """Casts (against the reference's and against the port's CA twin),
    overlaps and rays against the 17-Cheese and Semla hulls."""
    meshes = _hull_soups()
    js, ps = _soups(meshes)
    allp = np.concatenate([m[0] for m in meshes])
    lo, hi = allp.min(0), allp.max(0)
    rng = np.random.default_rng(5)
    n = 48
    s = rng.uniform(lo - 3, hi + 3, (n, 3)).astype(np.float32)
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = ((target - s) * rng.uniform(0.5, 1.5, (n, 1))).astype(np.float32)
    r = rng.uniform(0.3, 1.5, n).astype(np.float32)
    h = rng.uniform(0.2, 1.2, n).astype(np.float32)
    port = PQ.capsule_cast(ps, torch.as_tensor(s), torch.as_tensor(d),
                           torch.as_tensor(r), torch.as_tensor(h),
                           blocking=True)
    ca = PQ.capsule_cast_ca(ps, torch.as_tensor(s), torch.as_tensor(d),
                            torch.as_tensor(r), torch.as_tensor(h),
                            blocking=True, max_iters=256)
    for i in range(n):
        _check_hit(JQ.capsule_cast(js, s[i], d[i], r[i], h[i],
                                   blocking=True), port, i, "hull cast")
        assert bool(ca.hit[i]) == bool(port.hit[i]), i
        if bool(port.hit[i]):
            assert abs(float(ca.toi[i]) - float(port.toi[i])) < 1e-3, i
    assert int(port.hit.sum()) >= 10

    # capsules centred near hull triangles, so that most overlap some
    tri = rng.integers(int(ps.valid.sum()), size=n)
    c = (ps.v0.numpy()[tri] + ps.v1.numpy()[tri] + ps.v2.numpy()[tri]) / 3
    c = (c + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    ov = PQ.capsule_overlap_all(ps, torch.as_tensor(c), torch.as_tensor(r),
                                torch.as_tensor(h), k=8)
    n_ov = 0
    for i in range(n):
        ref = JQ.capsule_overlap_all(js, c[i], r[i], h[i], k=8)
        assert int(ov.candidates[i]) == int(ref.candidates)
        _match_overlaps(ref, ov, i)
        n_ov += int(ref.valid[0])
    assert n_ov >= 5

    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for mask in (0xFFFFFFFF, 8):
        ray = PQ.raycast(ps, torch.as_tensor(s), torch.as_tensor(dirs), 60.0,
                         mask=mask)
        for i in range(n):
            ref = JQ.raycast(js, s[i], dirs[i], 60.0, mask=np.uint32(mask))
            assert bool(ray.hit[i]) == bool(ref.hit)
            assert int(ray.tri_index[i]) == int(ref.tri_index)
            if bool(ref.hit):
                for f in ("distance", "position", "normal", "mu_s"):
                    np.testing.assert_allclose(
                        getattr(ray, f)[i].numpy(),
                        np.asarray(getattr(ref, f)), atol=TOL)


def test_gather_candidates_tie_order():
    """Equal keys keep the lowest index first, as ``jax.lax.top_k``: four
    copies of each triangle (equal centroid distances), agents whose
    reach covers fewer triangles than the cap (the -BIG keys of the rest
    tie) and more (overflow)."""
    rng = np.random.default_rng(9)
    base = [rng.uniform(-6, 6, 3) + rng.uniform(-1, 1, (3, 3))
            for _ in range(40)]
    pos = np.concatenate([t for t in base for _ in range(4)]).astype(
        np.float32)
    js, ps = _soups([(pos, np.arange(len(pos)), {})])
    n = 12
    center = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    center[3] = base[5].mean(0)                # on a centroid: d2 = 0 ties
    hh = np.full(n, 1.0, np.float32)
    r = np.full(n, 0.5, np.float32)
    reach = rng.uniform(0.0, 4.0, n).astype(np.float32)
    for cap in (16, 64):
        jsub, jcount = JQ.gather_candidates(js, center, hh, r, reach, cap)
        psub, pcount = PQ.gather_candidates(ps, torch.as_tensor(center),
                                            torch.as_tensor(hh),
                                            torch.as_tensor(r),
                                            torch.as_tensor(reach), cap)
        np.testing.assert_array_equal(pcount.numpy(), np.asarray(jcount))
        np.testing.assert_array_equal(psub.tri_id.numpy(),
                                      np.asarray(jsub.tri_id))
        np.testing.assert_array_equal(psub.valid.numpy(),
                                      np.asarray(jsub.valid))
        np.testing.assert_array_equal(psub.v0.numpy(), np.asarray(jsub.v0))
    assert (np.asarray(jcount) < 64).any() and (np.asarray(jcount) > 16).any()


def test_capsule_pair_sweep_matches_reference():
    rng = np.random.default_rng(4)
    n = 400
    f = np.float32
    a = rng.uniform(-4, 4, (n, 3)).astype(f)
    da = rng.uniform(-3, 3, (n, 3)).astype(f)
    b = rng.uniform(-4, 4, (n, 3)).astype(f)
    db = rng.uniform(-3, 3, (n, 3)).astype(f)
    db[::5] = da[::5]                           # static relative motion
    ra, rb = rng.uniform(0.3, 1.5, (2, n)).astype(f)
    ha, hb = rng.uniform(0.2, 1.2, (2, n)).astype(f)
    ref = JP.capsule_capsule_sweep(a, da, ra, ha, b, db, rb, hb)
    t = torch.as_tensor
    port = PP.capsule_capsule_sweep(t(a), t(da), t(ra), t(ha), t(b), t(db),
                                    t(rb), t(hb))
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))
    hit = np.asarray(ref[2])
    np.testing.assert_allclose(port[0].numpy()[hit], np.asarray(ref[0])[hit],
                               atol=TOL, rtol=1e-5)
    np.testing.assert_allclose(port[1].numpy()[hit], np.asarray(ref[1])[hit],
                               atol=TOL)
    assert 20 < hit.sum() < n


def test_cast_stats_match_reference():
    tris, (js, ps) = _random_soup(12, 30, 5, 2)
    s, d, r, h = _sweeps(np.random.default_rng(13), tris, 10, -8, 10,
                         (0.2, 1.5), (0.1, 1.5))
    ref = JS.capsule_cast_stats(js, s, d, r, h)
    port = PS.capsule_cast_stats(ps, torch.as_tensor(s), torch.as_tensor(d),
                                 torch.as_tensor(r), torch.as_tensor(h))
    for x, y in zip(ref, port):
        assert int(x) == int(y)


def test_local_triangles_interop_matches_builder():
    """The port's own CollisionWorldBuilder gives what interop carries
    across from the reference's (padding, culling, layers, materials)."""
    meshes = _hull_soups()[:2] + [(pm.ramp().positions, pm.ramp().indices,
                                   dict(flatten=True, mu_s=0.35))]
    jb, pb = JCB(), PCB()
    for i, (p, idx, kw) in enumerate(meshes):
        jb.add_mesh(p, idx, entity=i, **kw)
        pb.add_mesh(p, idx, entity=i, **kw)
    ref = interop.local_triangles(jb.build(), device="cpu")
    own = pb.build(device="cpu")
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(own, f)), f
