"""PyTorch port, the host helpers the JAX package has and no frame of the
port calls: ``math3d``'s matrix and quaternion builders, the procedural
textures and meshes, ``render/ibl.make_env_cube``, the reference's BVH
builds and plain walk (``render/bvh.build_bvh``, ``build_bvh_morton``,
``traverse``), ``Camera.projection`` / ``view``, ``tile_permutation``,
``FPSOverlay.blit`` and ``DirectionalLights.default_sun`` (CPU).

Each against its JAX counterpart on seeded numpy inputs. Exact where both
sides run the same numpy (textures, meshes, the BVH topologies, the tile
permutation, the overlay) or the same f32 ops; 1e-6 where XLA's f32
transcendentals (tan, cos, sin, pow) may differ from torch's or numpy's by
an ulp (the matrix builders, the env cube). ``traverse`` is held to K4's
plain twin (``trace_rays``) on the same refit tree and to the JAX
``traverse``: the same triangles, t within 1e-5, the barycentrics within
5e-4 (they are recovered from the hit point o + d t, whose rounding
XLA's fused multiply-adds change). Last, the new and changed modules of
the port are imported and driven in a process where jax cannot be
imported.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from swift_game_engine_tpu import math3d as j_m3
from swift_game_engine_tpu.assets import procedural_meshes as j_pm
from swift_game_engine_tpu.assets import procedural_textures as j_pt
from swift_game_engine_tpu.render import bvh as j_bvh
from swift_game_engine_tpu.render import camera as j_cam
from swift_game_engine_tpu.render import composite as j_comp
from swift_game_engine_tpu.render import ibl as j_ibl
from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu_torch import math3d as p_m3
from swift_game_engine_tpu_torch.assets import procedural_meshes as p_pm
from swift_game_engine_tpu_torch.assets import procedural_textures as p_pt
from swift_game_engine_tpu_torch.ops import rt_kernel as p_rk
from swift_game_engine_tpu_torch.render import bvh as p_bvh
from swift_game_engine_tpu_torch.render import camera as p_cam
from swift_game_engine_tpu_torch.render import composite as p_comp
from swift_game_engine_tpu_torch.render import ibl as p_ibl
from swift_game_engine_tpu_torch.render import rt as p_rt

sys.path.insert(0, os.path.dirname(__file__))
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
F32 = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- math3d

def _inputs(seed, n=7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(
        angle=rng.uniform(-3, 3, n).astype(np.float32),
        axis=rng.normal(size=(n, 3)).astype(np.float32),
        t=rng.normal(size=(n, 3)).astype(np.float32) * 5,
        deg=rng.uniform(-180, 180, (n, 3)).astype(np.float32),
        p=rng.normal(size=(n, 3)).astype(np.float32) * 3,
        q=q)


@pytest.mark.parametrize("seed", [0, 1])
def test_math3d_builders_match_reference(seed):
    a = _inputs(seed)
    T = {k: torch.as_tensor(v) for k, v in a.items()}
    J = {k: jnp.asarray(v) for k, v in a.items()}
    pairs = [
        (p_m3.mat4_identity((2, 3)), j_m3.mat4_identity((2, 3))),
        (p_m3.mat4_rotation(T["angle"], T["axis"]),
         j_m3.mat4_rotation(J["angle"], J["axis"])),
        (p_m3.mat4_translation(T["t"]), j_m3.mat4_translation(J["t"])),
        (p_m3.rotation_xyz_degrees(T["deg"]),
         j_m3.rotation_xyz_degrees(J["deg"])),
        (p_m3.mat4_perspective_rh(1.1, 16 / 9, 0.1, 100.0),
         j_m3.mat4_perspective_rh(1.1, 16 / 9, 0.1, 100.0)),
        (p_m3.mat4_perspective_rh_inverse(1.1, 16 / 9, 0.1, 100.0),
         j_m3.mat4_perspective_rh_inverse(1.1, 16 / 9, 0.1, 100.0)),
        (p_m3.mat4_ortho_rh(-3.0, 5.0, -2.0, 4.0, 0.5, 50.0),
         j_m3.mat4_ortho_rh(-3.0, 5.0, -2.0, 4.0, 0.5, 50.0)),
        (p_m3.mat4_look_at_rh(T["p"], T["t"], torch.tensor([0.0, 1.0, 0.0])),
         j_m3.mat4_look_at_rh(J["p"], J["t"], jnp.array([0.0, 1.0, 0.0]))),
        (p_m3.quat_identity((3,)), j_m3.quat_identity((3,))),
        (p_m3.quat_inverse(T["q"] * 2.0), j_m3.quat_inverse(J["q"] * 2.0)),
    ]
    rot = p_m3.mat4_rotation(T["angle"], T["axis"])
    jrot = j_m3.mat4_rotation(J["angle"], J["axis"])
    rigid = p_m3.mat4_from_rt(rot[:, :3, :3], T["t"])
    jrigid = j_m3.mat4_from_rt(jrot[:, :3, :3], J["t"])
    pairs += [
        (rigid, jrigid),
        (p_m3.mat4_translation_part(rigid), j_m3.mat4_translation_part(jrigid)),
        (p_m3.transform_point(rigid, T["p"]),
         j_m3.transform_point(jrigid, J["p"])),
        (p_m3.transform_dir(rigid, T["p"]), j_m3.transform_dir(jrigid, J["p"])),
        (p_m3.mat4_inverse_rigid(rigid), j_m3.mat4_inverse_rigid(jrigid)),
        (p_m3.quat_from_mat4(rigid), j_m3.quat_from_mat4(jrigid)),
    ]
    for k, (got, want) in enumerate(pairs):
        assert got.dtype == torch.float32, k
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32,
                                   err_msg=f"pair {k}")
    # the rigid inverse inverts
    np.testing.assert_allclose(
        _np(p_m3.mat4_inverse_rigid(rigid) @ rigid),
        np.broadcast_to(np.eye(4, dtype=np.float32), (7, 4, 4)), atol=1e-5)


# -------------------------------------------------- textures and meshes

TEXTURES = [
    ("solid", (5, 3, (10, 200, 30, 255), True)),
    ("checkerboard", (40, 24, 8, 200, 30)),
    ("flat_normal", (4, 6)),
    ("metallic_roughness", (0.7, 0.3, 5, 4)),
    ("occlusion", (0.6, 3, 3)),
    ("occlusion_radial", (33, 20, 0.1, 0.8)),
    ("emissive", ((0.9, 0.4, 1.3), 4, 2, True)),
    ("normal_map_from_height", (32, 24, 0.8, 3.0)),
    ("normal_map_noise", (32, 16, 1.2, 4.0, 3)),
    ("occlusion_grime", (24, 32, 2.0, 1.4)),
    ("digits_atlas", ()),
]


@pytest.mark.parametrize("name,args", TEXTURES, ids=[t[0] for t in TEXTURES])
def test_textures_match_reference(name, args):
    got, want = getattr(p_pt, name)(*args), getattr(j_pt, name)(*args)
    assert got.srgb == want.srgb
    assert got.pixels.dtype == np.uint8
    np.testing.assert_array_equal(got.pixels, want.pixels)


@pytest.mark.parametrize("name,args", [
    ("tetrahedron", (3.0,)), ("triangular_prism", (5.0, 2.5)),
    ("quad", (2.0, 1.5, (0.25, 0.0), (0.5, 1.0)))])
def test_meshes_match_reference(name, args):
    got, want = getattr(p_pm, name)(*args), getattr(j_pm, name)(*args)
    assert got.name == want.name
    for f in ("positions", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


# ------------------------------------------------------------ env cube

def test_env_cube_matches_reference():
    """Every mip and face of the analytic environment (1e-6: pow in f32)."""
    got, want = p_ibl.make_env_cube(16), j_ibl.make_env_cube(16)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **F32)
    xs = np.linspace(-0.9, 0.9, 5)
    u, v = np.meshgrid(xs, xs)
    for face in range(6):
        np.testing.assert_array_equal(p_ibl._cube_direction(face, u, v),
                                      j_ibl._cube_direction(face, u, v))


# ---------------------------------------------------------------- BVH

def _triangles(seed, n):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    v0 = c
    v1 = c + rng.normal(size=(n, 3)).astype(np.float32)
    v2 = c + rng.normal(size=(n, 3)).astype(np.float32)
    if n > 20:   # a cluster of coincident centroids: the fallback splits
        v1[:12], v2[:12] = v1[0], v2[0]
        v0[:12] = c[0]
    return v0, v1, v2


def _same_topology(got, want):
    for f in ("skip", "first_tri", "tri_count", "left", "right", "tri_order",
              "leaf_slots"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 5), (2, 300), (3, 1200)])
def test_bvh_builds_match_reference(seed, n):
    v0, v1, v2 = _triangles(seed, n)
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    _same_topology(p_bvh.build_bvh(tmin, tmax), j_bvh.build_bvh(tmin, tmax))
    for leaf in (4, 12):
        _same_topology(p_bvh.build_bvh_morton(tmin, tmax, leaf),
                       j_bvh.build_bvh_morton(tmin, tmax, leaf))


@pytest.mark.parametrize("morton", [False, True])
def test_traverse_matches_k4_twin_and_reference(morton):
    """Rays aimed at triangle centroids (and some past the scene) on a
    refit tree of each build: the walk's nearest hits are K4's plain
    twin's (same triangle, t within 1e-5) and the JAX walk's."""
    v0, v1, v2 = _triangles(4, 400)
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    build = p_bvh.build_bvh_morton if morton else p_bvh.build_bvh
    jbuild = j_bvh.build_bvh_morton if morton else j_bvh.build_bvh
    topo = build(tmin, tmax)
    tv = [torch.as_tensor(x) for x in (v0, v1, v2)]
    arrays = p_bvh.refit(topo, *tv)
    rng = np.random.default_rng(5)
    o = rng.uniform(-25, 25, (96, 3)).astype(np.float32)
    aim = ((v0 + v1 + v2) / 3)[rng.integers(0, 400, 96)]
    aim[::8] += 40.0
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    t, tri, u, v, found = p_bvh.traverse(arrays, to, td, 3.0e38)
    assert int(found.sum()) > 48
    kt, ktri = p_rk.trace_rays(arrays.wide, arrays.rows, to, td,
                               torch.full((96,), 3.0e38))
    assert torch.equal(torch.where(found, tri, -1),
                       torch.where(ktri >= 0, ktri.long(), -1))
    np.testing.assert_allclose(_np(t[found]), _np(kt[found]), rtol=1e-5,
                               atol=1e-5)
    jarr = j_bvh.refit(jbuild(tmin, tmax), *(jnp.asarray(x) for x in
                                             (v0, v1, v2)))
    jt, jtri, ju, jv, jf = jax.vmap(
        lambda oo, dd: j_bvh.traverse(jarr, oo, dd, 3.0e38))(
            jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(_np(found), np.asarray(jf))
    np.testing.assert_array_equal(_np(tri), np.asarray(jtri))
    # t within 1e-5; the barycentrics, recovered from the hit point
    # o + d t, whose rounding XLA's fused multiply-adds change, within 5e-4
    for a, b, tol in ((t, jt, 1e-5), (u, ju, 5e-4), (v, jv, 5e-4)):
        np.testing.assert_allclose(_np(a)[_np(found)],
                                   np.asarray(b)[np.asarray(jf)], rtol=tol,
                                   atol=tol)
    # any-hit stops at a hit of the ray: each found ray finds one
    _, atri, _, _, afound = p_bvh.traverse(arrays, to, td, 3.0e38,
                                           any_hit=True)
    assert torch.equal(afound, found)


# ------------------------------------------------- camera and overlay

def test_camera_matrices_match_reference():
    cam, jcam = p_cam.Camera(), j_cam.Camera()
    for c in (cam, jcam):
        c.position = np.array([1.0, 4.0, 9.0], np.float32)
        c.target = np.array([0.5, 1.0, -2.0], np.float32)
    np.testing.assert_allclose(_np(cam.projection(96, 54)),
                               np.asarray(jcam.projection(96, 54)), **F32)
    np.testing.assert_allclose(_np(cam.view()), np.asarray(jcam.view()),
                               **F32)
    # P @ V is the camera's own numpy forward matrix
    np.testing.assert_allclose(_np(cam.projection(96, 54) @ cam.view()),
                               cam.view_proj(96, 54), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w,h,tile", [(96, 54, None), (130, 70, 16),
                                      (7, 5, 8)])
def test_tile_permutation_matches_reference(w, h, tile):
    got, want = p_cam.tile_permutation(w, h, tile), \
        j_cam.tile_permutation(w, h, tile)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fps", [0, 7, 61, 999, 12345])
def test_overlay_blit_matches_reference(fps):
    rng = np.random.default_rng(fps)
    frame = rng.integers(0, 256, (54, 160, 3)).astype(np.uint8)
    got = p_comp.FPSOverlay().blit(frame, fps)
    np.testing.assert_array_equal(got, j_comp.FPSOverlay().blit(frame, fps))
    # the device blit draws the same digits where both draw (<= 999)
    if fps <= 999:
        dev = p_comp.overlay_blit_device(torch.as_tensor(frame), fps)
        np.testing.assert_array_equal(dev.numpy(), got)


def test_default_sun_matches_reference():
    got = p_rt.DirectionalLights.default_sun(device="cpu")
    want = j_rt.DirectionalLights.default_sun()
    for f in got._fields:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_rt.DirectionalLights.default_sun()


# ------------------------------------------------------- without jax

NO_JAX = r"""
import builtins, os, sys
real_import = builtins.__import__
def guarded(name, *a, **k):
    if name == "jax" or name.startswith("jax."):
        raise ImportError("jax is blocked")
    return real_import(name, *a, **k)
builtins.__import__ = guarded
import numpy as np, torch
from swift_game_engine_tpu_torch import math3d
from swift_game_engine_tpu_torch.assets import procedural_meshes as pm
from swift_game_engine_tpu_torch.assets import procedural_textures as pt
from swift_game_engine_tpu_torch.examples import bench_crowd
from swift_game_engine_tpu_torch.parallel import sharding as SH
from swift_game_engine_tpu_torch.physics import character, separation
from swift_game_engine_tpu_torch.render import (bvh, camera, compact,
                                                composite, ibl, rt,
                                                scene_geometry)
from swift_game_engine_tpu_torch.scene import demo_scene, engine, step
from swift_game_engine_tpu_torch.scene.engine import FIXED_DT
stepper, state = bench_crowd.build(10, device="cpu")
sim = SH.EntityShardedSubstep(stepper, SH.shard_world_state(3, state),
                              FIXED_DT, 3)
sim.step()
assert bool(torch.isfinite(sim.state.body_pos).all())
m = compact.packets(torch.arange(16) % 5 == 0, 4)
assert int(m.count) == 16
assert len(ibl.make_env_cube(4)) == 3
assert pt.normal_map_noise(8, 8).pixels.shape == (8, 8, 4)
v = pm.tetrahedron().positions[pm.tetrahedron().indices].reshape(-1, 3, 3)
topo = bvh.build_bvh_morton(v.min(1), v.max(1))
assert topo.node_count >= 1
assert camera.tile_permutation(8, 8)[0].shape == (64,)
assert math3d.mat4_perspective_rh(1.0, 1.5, 0.1, 10.0).shape == (4, 4)
assert 'jax' not in sys.modules, 'jax was imported'
ref = os.path.join(os.getcwd(), 'swift_game_engine_tpu') + os.sep
bad = [n for n, mod in list(sys.modules.items()) if
       (getattr(mod, '__file__', None) or '').startswith(ref)]
assert not bad, bad
print('NO_JAX_OK')
"""


def test_new_modules_run_without_jax():
    """The modules this slice added to or changed in the port import and
    run (an entity-sharded substep, a packet compaction, the host
    helpers) with jax blocked and no module of the JAX package loaded."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
