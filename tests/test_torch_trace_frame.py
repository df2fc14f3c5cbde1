"""PyTorch port, the traced RT frame and the Engine's RT resolution scale vs
the JAX reference (CPU), plus the slice's scene and device rules.

The scene is test_torch_frame.py's procedural one — textured ground, a
normal-mapped box, a translucent capsule, a mirror box, a glass box, an
unlit emissive box and a skinned body — at 96x54 (8,192 padded lanes, so
the frame takes the shadow walk K7, under the reference's 100,000-lane
cluster threshold). The port renders it with ``primary="trace"`` through
its plain twins (CPU tensors), against two references:

  * the JAX frame on its Pallas kernels in interpret mode
    (SGE_JAX_TRAVERSAL=0, SGE_RT_PRIMARY=trace: K5 for visibility, K7 for
    shadows, K4 for bounces), run in a subprocess because the kernels read
    their knobs at import;
  * the suite's default pure-JAX trace (tests/conftest.py sets
    SGE_JAX_TRAVERSAL=1: a stackless traversal and the per-layer shadow
    loop).

Both with the JAX package's own layered-vs-loop and walk-vs-loop
tolerance (tests/test_layered_kernel.py, tests/test_shadow_kernel.py) of
>= 99% of pixels within 1e-4, and the means within a bound just above the
measured gap: 0.3% against the kernel frame (measured 0.255%), the
package's 0.5% against the pure-JAX one (measured 0.075%). The whole gap is
the refraction bounce: without it the port's frame is the kernel frame to
1e-4 on every pixel, which a test holds. With it, the refraction rays that
start a bias inside the glass box differ on 15-21 of its pixels between
any two of the port, the kernel frame and the pure-JAX frame (the two
references by 0.32% in mean).

The cluster-sweep shadow branch (frames of >= 100,000 lanes) is held
against the JAX hybrid kernel frame with both sides' lane threshold set to
0, without the refraction bounce: measured, every pixel within 1e-4.

The trace branch for trees past the walks' row cap (dense K4 trace, offset
continuation origins, the K4 shadow loop) is forced by setting the port's
row threshold to 0, and held against the pure-JAX trace the same way.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from swift_game_engine_tpu.assets import mesh_api as j_mesh
from swift_game_engine_tpu.assets import procedural_meshes as pm
from swift_game_engine_tpu.assets import procedural_textures as pt
from swift_game_engine_tpu.assets import skeleton as j_skel
from swift_game_engine_tpu.assets import skinned_mesh as j_skin
from swift_game_engine_tpu.assets import static_mesh as j_static
from swift_game_engine_tpu.assets.materials import Material
from swift_game_engine_tpu.assets.skinned_mesh import dense_weight_matrix
from swift_game_engine_tpu.render import composite as j_comp
from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu.render import scene_geometry as j_sg
from swift_game_engine_tpu.render.camera import Camera
from swift_game_engine_tpu.render.ibl import IBL
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.assets import mesh_api as p_mesh
from swift_game_engine_tpu_torch.assets import skeleton as p_skel
from swift_game_engine_tpu_torch.assets import skinned_mesh as p_skin
from swift_game_engine_tpu_torch.assets import static_mesh as p_static
from swift_game_engine_tpu_torch.ops import rt_kernel as p_rk
from swift_game_engine_tpu_torch.render import rt as p_rt
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
from swift_game_engine_tpu_torch.scene import demo_scene as p_demo
from swift_game_engine_tpu_torch.scene.demo_scene import DemoWorld
from swift_game_engine_tpu_torch.scene.engine import Engine
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(__file__), "..")
ASSETS = os.path.join(REPO, "assets")
W, H = 96, 54
LAYERS, SHADOW_LAYERS = 3, 2


def build_scene():
    """(JAX SceneGeometry, transforms, palettes, lights, IBL) of the test
    scene; deterministic, so a subprocess builds the same one."""
    b = j_sg.RenderGeometryBuilder(texture_size=16)
    b.add_static_mesh(pm.plane(40.0), Material(
        name="ground", base_color_factor=(0.6, 0.6, 0.6),
        base_color_texture=pt.checkerboard(16, 16, 4), roughness_factor=0.9),
        instance=0)
    b.add_static_mesh(pm.box(3.0), Material(
        name="red", base_color_factor=(0.8, 0.1, 0.1), roughness_factor=0.4,
        normal_texture=pt.normal_map_noise(16, 16)), instance=1)
    b.add_static_mesh(pm.capsule(1.5, 1.0), Material(
        name="hull", base_color_factor=(0.3, 0.5, 0.9), alpha=0.3),
        instance=2)
    b.add_static_mesh(pm.box(2.5), Material(
        name="mirror", metallic_factor=1.0, roughness_factor=0.02),
        instance=3)
    b.add_static_mesh(pm.box(1.5), Material(
        name="glass", base_color_factor=(0.9, 0.95, 1.0),
        transmission_factor=0.8, ior=1.5, roughness_factor=0.1), instance=4)
    b.add_static_mesh(pm.box(1.0), Material(
        name="glow", base_color_factor=(0, 0, 0), unlit=True,
        emissive_factor=(3.0, 0.4, 0.2)), instance=5)
    body = pm.humanoid_skinned()
    nb = int(body.joints.max()) + 1
    b.add_skinned_mesh(body.positions, body.normals, body.uvs, body.indices,
                       dense_weight_matrix(body.joints, body.weights, nb),
                       [Material(name="body", base_color_factor=(0.2, 0.7,
                                                                 0.3))],
                       [(0, len(body.indices))], instance=6, character=0)
    geo = b.build()
    tf = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    tf[1, :3, 3] = [0, 1.5, 0]
    tf[2, :3, 3] = [2.5, 2.0, 3.0]
    tf[3, :3, 3] = [-4.5, 1.25, -1.0]
    tf[4, :3, 3] = [1.5, 0.75, 4.5]
    tf[5, :3, 3] = [5.0, 0.5, 0.0]
    tf[6, :3, 3] = [-1.5, 0.0, 3.0]
    pal = np.tile(np.eye(4, dtype=np.float32), (1, nb, 1, 1))
    pal[0, 1:, :3, 3] = [0.1, 0.05, 0.0]
    lights = j_rt.DirectionalLights(
        direction=jnp.array([[0.6, -0.7, -0.1], [-0.3, -0.6, 0.6]]),
        intensity=jnp.array([2.0, 0.4]),
        color=jnp.array([[1.0, 0.86, 0.68], [0.95, 0.85, 0.75]]),
        enabled=jnp.array([True, True]),
        max_distance=jnp.array([450.0, 300.0]))
    return geo, tf, pal, lights, IBL.build()


def camera():
    cam = Camera()
    cam.position = np.array([0.5, 4.0, 11.0], np.float32)
    cam.target = np.array([0.0, 1.0, 0.0], np.float32)
    return cam


def reference_render(scene, cam, tf, w=W, h=H, refraction=True):
    geo, _, pal, lights, ibl = scene
    fg = j_sg.flatten_frame(geo, jnp.asarray(tf), jnp.asarray(pal))
    return j_rt.render_frame(
        geo, fg, ibl, lights, jnp.asarray(cam.inv_view_proj(w, h)),
        jnp.asarray(cam.position), w, h, max_layers=LAYERS,
        shadow_layers=SHADOW_LAYERS,
        view_proj=jnp.asarray(cam.view_proj(w, h)),
        enable_refraction=refraction)


# The JAX frame on its Pallas kernels (interpret mode); argv: the output
# path, 1/0 for the refraction bounce, then KEY=VALUE knobs, set before the
# package reads them at import.
KERNEL_FRAME = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["SGE_RT_BLOCK"] = "1024"
os.environ["SGE_JAX_TRAVERSAL"] = "0"
os.environ.update(a.split("=", 1) for a in sys.argv[3:])
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import numpy as np
import test_torch_trace_frame as T
scene = T.build_scene()
np.save(sys.argv[1], np.asarray(T.reference_render(
    scene, T.camera(), scene[1], refraction=sys.argv[2] == "1")))
"""


@pytest.fixture(scope="module")
def scene():
    return build_scene()


def _kernel_frame(tmp_path, *knobs, refraction=True):
    out_path = str(tmp_path / "kernels.npy")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.run([sys.executable, "-c", KERNEL_FRAME, out_path,
                           "1" if refraction else "0", *knobs],
                          cwd=os.path.abspath(REPO), env=env,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(out_path)


def _port_render(scene, cam, tf, w=W, h=H, primary="trace",
                 refraction=True):
    geo, _, pal, lights, ibl = scene
    pgeo = interop.scene_geometry(geo, device="cpu")
    pfg = p_sg.flatten_frame(pgeo, torch.as_tensor(tf), torch.as_tensor(pal))
    return p_rt.render_frame(
        pgeo, pfg, interop.ibl(ibl, device="cpu"),
        interop.lights(lights, device="cpu"),
        torch.as_tensor(cam.inv_view_proj(w, h)), cam.position, w, h,
        max_layers=LAYERS, shadow_layers=SHADOW_LAYERS,
        view_proj=torch.as_tensor(cam.view_proj(w, h)),
        primary=primary, enable_refraction=refraction).numpy()


def _agree(out, ref, frac_min, mean_rel):
    assert out.shape == ref.shape and np.isfinite(out).all()
    frac = float((np.abs(out - ref).max(-1) < 1e-4).mean())
    gap = abs(out.mean() - ref.mean()) / ref.mean()
    print(f"{frac:.5f} of pixels within 1e-4, mean gap {gap:.3e}")
    assert frac >= frac_min, frac
    assert gap <= mean_rel, (out.mean(), ref.mean())


def test_traced_frame_matches_reference_kernels(scene, tmp_path):
    """Measured: 15 of 5,184 pixels differ, mean gap 2.55e-3 — all of it
    from the refraction bounce (see the next test)."""
    ref = _kernel_frame(tmp_path, "SGE_RT_PRIMARY=trace")
    _agree(_port_render(scene, camera(), scene[1]), ref, 0.99, 3e-3)


def test_traced_frame_without_refraction_equals_reference_kernels(
        scene, tmp_path):
    """Without the refraction bounce the port's traced frame is the JAX
    kernel frame (measured: every pixel within 1e-4, mean gap 1e-7). The
    refraction rays start a bias inside the glass box's surface, and there
    the port, the JAX kernel frame and the pure-JAX frame each differ from
    the other two on 15-21 of the box's pixels."""
    ref = _kernel_frame(tmp_path, "SGE_RT_PRIMARY=trace", refraction=False)
    _agree(_port_render(scene, camera(), scene[1], refraction=False), ref,
           0.999, 1e-4)


def test_cluster_shadow_frame_matches_reference_kernels(scene, tmp_path,
                                                        monkeypatch):
    """The cluster-sweep shadow branch (split shadow clusters, the root-AABB
    t limit, the alpha payload; K2/K3 on the card), which frames of at least
    100,000 lanes take, forced at 96x54 by setting both sides' lane
    threshold to 0; hybrid visibility on both sides, no refraction bounce
    (see above). Measured: every pixel within 1e-4, mean gap 1e-7."""
    monkeypatch.setattr(p_rt, "SHADOW_CLUSTER_MIN_LANES", 0)

    def no_other_shadows(*a, **k):
        raise AssertionError("the frame's shadows take the cluster sweeps")

    monkeypatch.setattr(p_rk, "trace_shadow_factor", no_other_shadows)
    monkeypatch.setattr(p_rt, "_shadow_loop", no_other_shadows)
    ref = _kernel_frame(tmp_path, "SGE_SHADOW_CLUSTER_MIN_LANES=0",
                        refraction=False)
    _agree(_port_render(scene, camera(), scene[1], primary="hybrid",
                        refraction=False), ref, 0.999, 1e-4)


def test_traced_frame_matches_reference_traversal(scene):
    ref = np.asarray(reference_render(scene, camera(), scene[1]))
    _agree(_port_render(scene, camera(), scene[1]), ref, 0.99, 5e-3)


def test_large_tree_trace_branch_matches_reference(scene, monkeypatch):
    """Past the walks' row cap: dense K4 primary trace, offset-origin
    continuations and the K4 shadow loop."""
    monkeypatch.setattr(p_rk, "WALK_MAX_ROWS", 0)

    def no_walk(*a, **k):
        raise AssertionError("the walks serve no tree past the row cap")

    monkeypatch.setattr(p_rk, "trace_layers_so", no_walk)
    monkeypatch.setattr(p_rk, "trace_shadow_factor", no_walk)
    ref = np.asarray(reference_render(scene, camera(), scene[1]))
    _agree(_port_render(scene, camera(), scene[1]), ref, 0.99, 5e-3)


@pytest.mark.parametrize("lanes,rows,mode", [
    (557_056, 12_768, "clusters"), (99_999, 12_768, "walk"),
    (99_999, 22_000, "walk"), (73_728, 42_688, "loop"),
    (100_000, 42_688, "clusters")])
def test_shadow_source_follows_reference_rule(scene, lanes, rows, mode):
    """rt.py:1420-1452: cluster sweeps at >= 100k padded lanes, else the
    walk at <= 22,000 rows, else the per-layer loop; the record kernels
    need 1..4 shadow layers (else the loop, at any frame size)."""
    geo, tf, pal, lights, _ = scene
    pgeo = interop.scene_geometry(geo, device="cpu")
    pfg = p_sg.flatten_frame(pgeo, torch.as_tensor(tf), torch.as_tensor(pal))
    fake = pfg._replace(bvh=pfg.bvh._replace(rows=torch.zeros((rows, 128))))
    for layers, want in ((4, mode), (1, mode), (0, "loop"), (5, "loop")):
        got, consts = p_rt._shadow_mode(
            pgeo, fake if mode != "clusters" else pfg,
            interop.lights(lights, device="cpu"), lanes, layers)
        assert got == want, (layers, got)
        assert (consts is None) == (want == "loop")


# --------------------------------------------------------------- Engine


def _port_world(scene, player):
    geo, tf, pal, lights, _ = scene
    return DemoWorld(geometry=interop.scene_geometry(geo, device="cpu"),
                     transforms=torch.as_tensor(tf),
                     palettes=torch.as_tensor(pal),
                     lights=interop.lights(lights, device="cpu"),
                     player_position=np.asarray(player, np.float64),
                     movement=(4.5, 12.5, 0.78))


@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_engine_rt_scale_matches_reference_chain(scene, scale):
    """Render at rt_size, jax.image.resize bilinear to the drawable,
    composite, u8, overlay (scene/engine.py:132-141,211-240)."""
    eng = Engine(_port_world(scene, [0.0, 0.5, 1.0]), W, H,
                 rt_resolution_scale=scale, max_layers=LAYERS,
                 shadow_layers=SHADOW_LAYERS, primary="trace", device="cpu")
    assert eng.rt_size == (int(W * scale), int(H * scale))
    u8 = eng.frame(1 / 60).numpy()
    cam = eng.camera
    rebased = scene[1].copy()
    rebased[:, :3, 3] -= cam.world_position.astype(np.float32)
    rw, rh = eng.rt_size
    img = reference_render(scene, cam, rebased, rw, rh)
    img = jax.image.resize(img, (H, W, 3), method="bilinear")
    img = j_comp.composite_frame(img, 1.0, True)
    ref = (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    ref = np.asarray(j_comp.overlay_blit_device(ref, 60))
    assert u8.shape == ref.shape == (H, W, 3) and u8.dtype == np.uint8
    close = np.abs(u8.astype(int) - ref.astype(int)).max(-1) <= 1
    assert close.mean() >= 0.97, close.mean()


@pytest.mark.parametrize("scale", [0.25, 0.5, 1.5, 2.0])
def test_upscale_matches_jax_resize(scene, scale):
    """The Engine's RT-target -> drawable resize is jax.image.resize's
    bilinear: half-pixel, renormalised at the edges, antialiased when it
    shrinks."""
    eng = Engine(_port_world(scene, [0.0, 0.5, 1.0]), W, H,
                 rt_resolution_scale=scale, device="cpu")
    rw, rh = eng.rt_size
    img = np.random.default_rng(3).random((rh, rw, 3), np.float32)
    got = eng._upscale(torch.as_tensor(img)).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (H, W, 3),
                                      method="bilinear"))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_rt_scale_clamp_and_runtime_change(scene):
    """Renderer.swift:175 clamps the scale at 0.25; a runtime change takes
    effect on the next frame."""
    eng = Engine(_port_world(scene, [0.0, 0.5, 1.0]), W, H,
                 rt_resolution_scale=0.1, max_layers=1, shadow_layers=1,
                 device="cpu")
    assert eng.rt_scale == 0.25 and eng.rt_size == (24, 13)
    assert eng.frame(1 / 60).shape == (H, W, 3)
    eng.set_rt_resolution_scale(0.5)
    assert eng.rt_size == (48, 27)
    assert eng.frame(1 / 60).shape == (H, W, 3)
    eng.set_rt_resolution_scale(1.0)
    assert eng.rt_size == (W, H)


# ---------------------------------------------------- scene and devices


def test_decimation_matches_reference():
    """The port's copies of simplify_mesh / simplify_skinned give the JAX
    package's arrays on the repository's 17-Cheese parts and the YBot
    submeshes at budget 20,000, with the reference's per-part rule."""
    budget = p_demo.IMPORT_TRI_BUDGET
    path = os.path.join(ASSETS, "17-Cheese.static.json")
    j_parts = j_static.load_static_mesh(path).parts
    p_parts = p_static.load_static_mesh(path).parts
    done = 0
    for jp, pp in zip(j_parts, p_parts):
        if not (jp.mesh.triangle_count > budget and len(jp.submeshes) == 1):
            continue
        jm = j_mesh.simplify_mesh(jp.mesh.with_tangents(), budget)
        pmesh = p_mesh.simplify_mesh(pp.mesh.with_tangents(), budget)
        for f in ("positions", "indices", "normals", "uvs"):
            np.testing.assert_array_equal(getattr(pmesh, f), getattr(jm, f))
        assert pmesh.triangle_count <= budget
        done += 1
    assert done >= 1

    ybot = os.path.join(ASSETS, "YBot.skinned.json")
    import json
    with open(ybot) as f:
        names = [b["name"] for b in json.load(f)["skin"]["bones"]]
    zeros = np.zeros((len(names), 3), np.float32)
    js = j_skel.build_skeleton(names, [-1] * len(names), zeros, zeros,
                               unit_scale=p_demo.UNIT_SCALE)
    ps = p_skel.build_skeleton(names, [-1] * len(names), zeros, zeros,
                               unit_scale=p_demo.UNIT_SCALE)
    np.testing.assert_array_equal(ps.inv_bind_model, js.inv_bind_model)
    jsm = j_skin.load_skinned_mesh(ybot, js)
    psm = p_skin.load_skinned_mesh(ybot, ps)
    for f in ("positions", "normals", "uvs", "joints", "weights", "indices"):
        np.testing.assert_array_equal(getattr(psm, f), getattr(jsm, f))
    for s in psm.submeshes:
        idx = psm.indices[s.start:s.start + s.count]
        used = np.unique(idx)
        remap = np.full(psm.vertex_count, -1, np.int64)
        remap[used] = np.arange(len(used))
        args = (psm.positions[used], psm.normals[used], psm.uvs[used],
                remap[idx].astype(np.int32), psm.joints[used],
                psm.weights[used],
                max(int(budget * s.count / len(psm.indices)), 2000))
        for a, b in zip(p_mesh.simplify_skinned(*args),
                        j_mesh.simplify_skinned(*args)):
            np.testing.assert_array_equal(a, b)


def test_default_demo_scene_is_decimated():
    """The default DemoScene is the reference's decimated one: its tree
    fits the walks' 22,000-row cap."""
    world = p_demo.build_demo_scene(ASSETS, device="cpu")
    geo = world.geometry
    assert geo.tri.shape[0] == 53_342
    assert int(geo.tri_translucent.sum()) == 4124
    assert geo.topo.node_count == 12_761
    fg = p_sg.flatten_frame(geo, world.transforms, world.palettes)
    assert fg.bvh.rows.shape[0] == 12_768
    assert p_rk.walk_available(fg.bvh.rows)


def test_entry_points_need_a_device_without_cuda(scene):
    """Entry points default to the card; where there is none, a call that
    names no device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults use it")
    from swift_game_engine_tpu_torch.render.ibl import IBL as PIBL
    calls = [
        lambda: p_demo.build_demo_scene(ASSETS),
        lambda: Engine(_port_world(scene, [0.0, 0.5, 1.0]), W, H),
        lambda: p_sg.RenderGeometryBuilder(texture_size=4).build(),
        lambda: PIBL.build(),
        lambda: p_rt.DirectionalLights.from_list([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
