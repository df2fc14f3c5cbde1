"""The test scene of the reference's knob paths (JAX builders, numpy).

tests/test_torch_trace_frame.py's procedural scene with the translucent
capsule made an unlit hull, as the DemoScene's collision hulls are
(scene/demo_scene.py:292: unlit, alpha 0.25, no texture), and a lit
translucent pane in front of it, so that rays cross four translucent
surfaces before the ground: the continuation layers then hold
simple-unlit records (SGE_RT_UNLIT_SPLIT / _DENSE), the layered walk
with fewer slots than layers parts from the full walk
(SGE_RT_LAYER_SLOTS), and the translucent subset binds no texture, so its
subdivision gate holds (SGE_RASTER_TRANS_SUBDIV). ``textured=True`` gives
the pane a base texture, which closes the gate. Deterministic, so a
subprocess builds the same scene.
"""

import numpy as np
import jax.numpy as jnp

from swift_game_engine_tpu.assets import procedural_meshes as pm
from swift_game_engine_tpu.assets import procedural_textures as pt
from swift_game_engine_tpu.assets.materials import Material
from swift_game_engine_tpu.assets.skinned_mesh import dense_weight_matrix
from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu.render import scene_geometry as j_sg
from swift_game_engine_tpu.render.camera import Camera
from swift_game_engine_tpu.render.ibl import IBL

W, H = 96, 54
LAYERS, SHADOW_LAYERS = 3, 2


def build_scene(textured=False):
    """(JAX SceneGeometry, transforms, palettes, lights, IBL)."""
    b = j_sg.RenderGeometryBuilder(texture_size=16)
    b.add_static_mesh(pm.plane(40.0), Material(
        name="ground", base_color_factor=(0.6, 0.6, 0.6),
        base_color_texture=pt.checkerboard(16, 16, 4), roughness_factor=0.9),
        instance=0)
    b.add_static_mesh(pm.box(3.0), Material(
        name="red", base_color_factor=(0.8, 0.1, 0.1), roughness_factor=0.4,
        normal_texture=pt.normal_map_noise(16, 16)), instance=1)
    b.add_static_mesh(pm.capsule(1.5, 1.0), Material(
        name="hull", base_color_factor=(0.3, 0.5, 0.9), alpha=0.25,
        unlit=True), instance=2)
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
    b.add_static_mesh(pm.box(2.0), Material(
        name="pane", base_color_factor=(0.9, 0.8, 0.3), alpha=0.35,
        roughness_factor=0.5,
        base_color_texture=pt.checkerboard(16, 16, 2) if textured else None),
        instance=7)
    geo = b.build()
    tf = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    tf[1, :3, 3] = [0, 1.5, 0]
    tf[2, :3, 3] = [2.5, 2.0, 3.0]
    tf[3, :3, 3] = [-4.5, 1.25, -1.0]
    tf[4, :3, 3] = [1.5, 0.75, 4.5]
    tf[5, :3, 3] = [5.0, 0.5, 0.0]
    tf[6, :3, 3] = [-1.5, 0.0, 3.0]
    tf[7, :3, 3] = [2.0, 2.0, 6.0]
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


def reference_render(scene, refraction=True):
    """The JAX frame of the scene at the module's size and layer counts,
    with the JAX module's knobs as they stand."""
    geo, tf, pal, lights, ibl = scene
    cam = camera()
    fg = j_sg.flatten_frame(geo, jnp.asarray(tf), jnp.asarray(pal))
    return np.asarray(j_rt.render_frame(
        geo, fg, ibl, lights, jnp.asarray(cam.inv_view_proj(W, H)),
        jnp.asarray(cam.position), W, H, max_layers=LAYERS,
        shadow_layers=SHADOW_LAYERS,
        view_proj=jnp.asarray(cam.view_proj(W, H)),
        enable_refraction=refraction))


def port_inputs(scene, device="cpu"):
    """The port's (geometry, frame geometry, IBL, lights) of the scene."""
    import torch
    from swift_game_engine_tpu_torch import interop
    from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
    geo, tf, pal, lights, ibl = scene
    pgeo = interop.scene_geometry(geo, device=device)
    pfg = p_sg.flatten_frame(pgeo, torch.as_tensor(tf, device=device),
                             torch.as_tensor(pal, device=device))
    return (pgeo, pfg, interop.ibl(ibl, device=device),
            interop.lights(lights, device=device))


def port_render(inputs, primary="hybrid", refraction=True, **kw):
    """The port's frame of the scene with ``render_frame`` keywords."""
    import torch
    from swift_game_engine_tpu_torch.render import rt as p_rt
    pgeo, pfg, pibl, plights = inputs
    cam = camera()
    dev = pfg.pos.device
    return p_rt.render_frame(
        pgeo, pfg, pibl, plights,
        torch.as_tensor(cam.inv_view_proj(W, H), device=dev), cam.position,
        W, H, max_layers=LAYERS, shadow_layers=SHADOW_LAYERS,
        view_proj=torch.as_tensor(cam.view_proj(W, H), device=dev),
        primary=primary, enable_refraction=refraction, **kw).cpu().numpy()
