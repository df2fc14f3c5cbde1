"""PyTorch port, the whole slice vs the JAX reference (CPU), plus the port's
own guarantees: no jax import, the DemoScene world, the paused render-only
Engine and the stepping one.

One procedural scene — textured ground, a normal-mapped box, a translucent
capsule, a mirror box, a glass box, an unlit emissive box and a skinned
body — is built by the reference and carried across with ``interop``. The
reference renders it with its CPU test configuration (traced visibility,
tests/conftest.py sets SGE_JAX_TRAVERSAL=1); the port renders it with its
only mode, hybrid raster visibility. The two differ by design at sub-pixel
triangle edges, so the tolerance is the reference's own hybrid-vs-traced
one (tests/test_rt_raster_primary.py): > 97% of pixels within 1e-4 and the
image mean within 1%; u8 frames: >= 97% of pixels within 1 LSB.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swift_game_engine_tpu.assets import procedural_meshes as pm
from swift_game_engine_tpu.assets import procedural_textures as pt
from swift_game_engine_tpu.assets.materials import Material
from swift_game_engine_tpu.assets.skinned_mesh import dense_weight_matrix
from swift_game_engine_tpu.render import composite as j_comp
from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu.render import scene_geometry as j_sg
from swift_game_engine_tpu.render.camera import Camera
from swift_game_engine_tpu.render.ibl import IBL
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.render import rt as p_rt
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
from swift_game_engine_tpu_torch.scene.demo_scene import DemoWorld
from swift_game_engine_tpu_torch.scene.engine import Engine
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(__file__), "..")
W, H = 96, 54
LAYERS, SHADOW_LAYERS = 2, 1


@pytest.fixture(scope="module")
def scene():
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


def _reference_render(scene, cam, tf):
    geo, _, pal, lights, ibl = scene
    fg = j_sg.flatten_frame(geo, jnp.asarray(tf), jnp.asarray(pal))
    return j_rt.render_frame(
        geo, fg, ibl, lights, jnp.asarray(cam.inv_view_proj(W, H)),
        jnp.asarray(cam.position), W, H, max_layers=LAYERS,
        shadow_layers=SHADOW_LAYERS,
        view_proj=jnp.asarray(cam.view_proj(W, H)))


def test_render_frame_matches_reference(scene):
    geo, tf, pal, lights, ibl = scene
    cam = Camera()
    cam.position = np.array([0.5, 4.0, 11.0], np.float32)
    cam.target = np.array([0.0, 1.0, 0.0], np.float32)
    ref = np.asarray(_reference_render(scene, cam, tf))
    pgeo = interop.scene_geometry(geo, device="cpu")
    pfg = p_sg.flatten_frame(pgeo, torch.as_tensor(tf), torch.as_tensor(pal))
    out = p_rt.render_frame(
        pgeo, pfg, interop.ibl(ibl, device="cpu"),
        interop.lights(lights, device="cpu"),
        torch.as_tensor(cam.inv_view_proj(W, H)), cam.position, W, H,
        max_layers=LAYERS, shadow_layers=SHADOW_LAYERS,
        view_proj=torch.as_tensor(cam.view_proj(W, H))).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    frac = float((np.abs(out - ref).max(-1) < 1e-4).mean())
    assert frac > 0.97, frac
    assert abs(out.mean() - ref.mean()) < 0.01 * ref.mean()


def _port_world(scene, player):
    geo, tf, pal, lights, _ = scene
    return DemoWorld(geometry=interop.scene_geometry(geo, device="cpu"),
                     transforms=torch.as_tensor(tf),
                     palettes=torch.as_tensor(pal),
                     lights=interop.lights(lights, device="cpu"),
                     player_position=np.asarray(player, np.float64),
                     movement=(4.5, 12.5, 0.78))


def test_engine_frame_matches_reference_chain(scene):
    geo, tf, pal, lights, ibl = scene
    eng = Engine(_port_world(scene, [0.0, 0.5, 1.0]), W, H, path="rt",
                 max_layers=LAYERS, shadow_layers=SHADOW_LAYERS, device="cpu")
    u8 = eng.frame(1 / 60).numpy()
    cam = eng.camera
    rebased = tf.copy()
    rebased[:, :3, 3] -= cam.world_position.astype(np.float32)
    img = j_comp.composite_frame(_reference_render(scene, cam, rebased), 1.0,
                                 True)
    ref = (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    ref = np.asarray(j_comp.overlay_blit_device(ref, 60))
    assert u8.shape == ref.shape == (H, W, 3) and u8.dtype == np.uint8
    close = np.abs(u8.astype(int) - ref.astype(int)).max(-1) <= 1
    assert close.mean() >= 0.97, close.mean()


def test_engine_is_paused_and_refuses_substeps(scene):
    """A render-only world (no stepper) starts paused: camera, input and
    overlay run on unscaled time; a substep due raises."""
    eng = Engine(_port_world(scene, [0.0, 0.5, 1.0]), 32, 18, device="cpu")
    from swift_game_engine_tpu_torch.scene.input import InputFrame
    assert eng.time_scale == 0.0
    eng.frame(0.05, InputFrame(rx=0.8, exposure_delta=1.0))
    assert eng.time == 0.0 and eng.unscaled_time == pytest.approx(0.05)
    assert eng.input.yaw != 0.0                       # camera animates
    assert eng.tone_mapping_exposure == pytest.approx(1.05)
    eng.time_scale = 1.0
    with pytest.raises(NotImplementedError, match="render-only"):
        eng.frame(1 / 60)


def _stepping_world():
    """A small world built by the port alone: ground, player and box, with
    render meshes and the simulation (CPU)."""
    from swift_game_engine_tpu_torch.assets import procedural_meshes as ppm
    from swift_game_engine_tpu_torch.assets.materials import Material as PM
    from swift_game_engine_tpu_torch.ecs.world import WorldBuilder
    from swift_game_engine_tpu_torch.physics.collision_world import \
        CollisionWorldBuilder
    from swift_game_engine_tpu_torch.render.scene_geometry import \
        RenderGeometryBuilder
    from swift_game_engine_tpu_torch.scene.step import Stepper
    wb, cb, rb = WorldBuilder(), CollisionWorldBuilder(), \
        RenderGeometryBuilder(texture_size=4)
    g = wb.create_entity("ground")
    wb.add(g, "transform", translation=[0, -3, 0])
    wb.add(g, "world_position")
    wb.add(g, "body", body_type=0, position=[0, -3, 0])
    cb.add_mesh(ppm.plane(40.0).positions, ppm.plane(40.0).indices, entity=g)
    rb.add_static_mesh(ppm.plane(40.0), PM(name="g"), instance=g)
    p = wb.create_entity("player")
    for comp, kw in (("transform", dict(translation=[0.3, 1.0, 0.2])),
                     ("world_position", {}), ("player", {}),
                     ("body", dict(body_type=2, position=[0.3, 1.0, 0.2])),
                     ("intent", {}), ("movement", {}),
                     ("controller", dict(radius=1.5, half_height=1.0)),
                     ("agent", dict(mass_weight=3.0))):
        wb.add(p, comp, **kw)
    rb.add_static_mesh(ppm.capsule(1.5, 1.0), PM(name="p"), instance=p)
    spec, state = wb.build(device="cpu")
    stepper = Stepper(spec, cb.build(device="cpu"))
    tf, pal = stepper.extract(state, 1.0, np.zeros(3, np.float32))
    return DemoWorld(geometry=rb.build(device="cpu"), transforms=tf,
                     palettes=pal,
                     lights=p_rt.DirectionalLights.from_list([], device="cpu"),
                     player_position=np.array([0.3, 1.0, 0.2]),
                     movement=(4.5, 12.5, 0.78), spec=spec, state=state,
                     stepper=stepper, player=p)


def test_stepping_engine_starts_running_and_advances(tmp_path):
    """A world with a Stepper starts at time_scale 1.0, as the reference's
    Engine does: each 1/60 s frame takes one substep, the player falls and
    walks, and the camera follows the previous frame's snapshot. The
    checkpoint (.npz of the state's tensors, accumulator and time) restores
    the run exactly."""
    from swift_game_engine_tpu_torch.scene.input import InputFrame
    world = _stepping_world()
    eng = Engine(world, 32, 18, device="cpu")
    assert eng.time_scale == 1.0
    y0 = float(world.state.body_pos[world.player, 1])
    for _ in range(3):
        u8 = eng.frame(1 / 60, InputFrame(ly=1.0))
        assert eng.substeps == 1 and u8.shape == (18, 32, 3)
    assert eng.time == pytest.approx(3 / 60)
    assert float(eng.state.body_pos[world.player, 1]) < y0     # falls
    assert eng._snap[4] < y0 and eng._snap[6] == 0.0
    np.testing.assert_allclose(eng._snap[3:6],
                               eng.state.body_pos[world.player].numpy())
    # a frame of 1/12 s takes the most substeps and resets the rest
    eng.frame(1 / 12, InputFrame(ly=1.0))
    assert eng.substeps == 4 and eng.accumulator == 0.0
    eng.save_state(str(tmp_path / "w.npz"))
    after = eng.stepper.substep(eng.state, 1 / 60)
    eng.load_state(str(tmp_path / "w.npz"))
    again = eng.stepper.substep(eng.state, 1 / 60)
    for a, b in zip(after, again):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert eng.time == pytest.approx(3 / 60 + 1 / 12)


def test_port_runs_without_jax():
    """The port renders both primary modes, from a scene its own builder
    made, and steps one Engine frame of a world its own WorldBuilder made,
    with no jax and no module of the JAX package loaded."""
    code = (
        "import os, sys\n"
        "import numpy as np, torch\n"
        "from swift_game_engine_tpu_torch.assets import procedural_meshes as pm\n"
        "from swift_game_engine_tpu_torch.assets.materials import Material\n"
        "from swift_game_engine_tpu_torch.render.scene_geometry import "
        "RenderGeometryBuilder, flatten_frame\n"
        "from swift_game_engine_tpu_torch.render import rt\n"
        "from swift_game_engine_tpu_torch.render.ibl import IBL\n"
        "from swift_game_engine_tpu_torch.render.camera import Camera\n"
        "b = RenderGeometryBuilder(texture_size=4)\n"
        "b.add_static_mesh(pm.plane(20.0), Material(name='g'), instance=0)\n"
        "b.add_static_mesh(pm.capsule(1.0, 1.0), Material(name='c', "
        "alpha=0.4), instance=1)\n"
        "geo = b.build(device='cpu')\n"
        "fg = flatten_frame(geo, torch.eye(4).expand(2, 4, 4), "
        "torch.zeros(1, 1, 4, 4))\n"
        "cam = Camera(); cam.position = np.array([0, 3, 8], np.float32)\n"
        "for primary in ('hybrid', 'trace'):\n"
        "    img = rt.render_frame(geo, fg, IBL.build(device='cpu'), "
        "rt.DirectionalLights.from_list([], device='cpu'), "
        "torch.as_tensor(cam.inv_view_proj(32, 18)), cam.position, 32, 18, "
        "primary=primary)\n"
        "    assert img.shape == (18, 32, 3)\n"
        "    assert bool(torch.isfinite(img).all())\n"
        "from swift_game_engine_tpu_torch.ecs.world import WorldBuilder\n"
        "from swift_game_engine_tpu_torch.physics.collision_world import "
        "CollisionWorldBuilder\n"
        "from swift_game_engine_tpu_torch.scene.step import Stepper\n"
        "from swift_game_engine_tpu_torch.scene.demo_scene import DemoWorld\n"
        "from swift_game_engine_tpu_torch.scene.engine import Engine\n"
        "wb, cb = WorldBuilder(), CollisionWorldBuilder()\n"
        "g = wb.create_entity('ground')\n"
        "wb.add(g, 'transform', translation=[0, -3, 0])\n"
        "wb.add(g, 'body', body_type=0, position=[0, -3, 0])\n"
        "cb.add_mesh(pm.plane(20.0).positions, pm.plane(20.0).indices, "
        "entity=g)\n"
        "p = wb.create_entity('player')\n"
        "for c, kw in (('transform', dict(translation=[0.2, 1, 0.1])), "
        "('world_position', {}), ('player', {}), ('body', dict(body_type=2, "
        "position=[0.2, 1, 0.1])), ('intent', {}), ('movement', {}), "
        "('controller', {}), ('agent', {})):\n"
        "    wb.add(p, c, **kw)\n"
        "spec, state = wb.build(device='cpu')\n"
        "st = Stepper(spec, cb.build(device='cpu'))\n"
        "tf, pal = st.extract(state, 1.0, np.zeros(3, np.float32))\n"
        "world = DemoWorld(geo, tf, pal, rt.DirectionalLights.from_list([], "
        "device='cpu'), np.array([0.2, 1, 0.1]), (4.5, 12.5, 0.78), spec, "
        "state, st, p)\n"
        "eng = Engine(world, 32, 18, device='cpu')\n"
        "u8 = eng.frame(1 / 60)\n"
        "assert eng.substeps == 1 and u8.shape == (18, 32, 3)\n"
        "assert float(eng.state.body_pos[p, 1]) < 1.0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "ref = os.path.join(os.getcwd(), 'swift_game_engine_tpu') + os.sep\n"
        "bad = [m for m, mod in list(sys.modules.items()) if "
        "(getattr(mod, '__file__', None) or '').startswith(ref)]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_demo_scene_render_world():
    """The repository's assets give the full DemoScene render world
    (``import_tri_budget=0``): 181,340 triangles (17-Cheese, Semla, YBot and
    the procedural items), the YBot at bind pose (identity palettes) 4.69
    units tall."""
    from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene
    world = build_demo_scene(os.path.join(REPO, "assets"), device="cpu",
                             import_tri_budget=0)
    geo = world.geometry
    assert geo.tri.shape[0] == 181_340
    assert int(geo.tri_translucent.sum()) == 4124
    assert world.transforms.shape == (17, 4, 4)
    assert torch.equal(world.palettes[0],
                       torch.eye(4).expand_as(world.palettes[0]))
    body = geo.skinned_blocks[0]["positions"]
    assert float(body[:, 1].max() - body[:, 1].min()) == pytest.approx(
        4.69, abs=0.01)
    np.testing.assert_array_equal(world.player_position, [0.0, 7.5, 0.0])
