"""DemoScene render world: port of swift_game_engine_tpu/scene/demo_scene.py.

Builds the render geometry of the reference demo world, item for item and
in the same entity order (scene/demo_scene.py:116-272,282-426):

  * 80x80 ground at y=-3; 17-Cheese and Semla (+18,0,10) with their
    translucent unlit collision hulls; the ornate mirror when its asset is
    present (it is not in the repository, and the reference skips it too);
  * elevator + ground_mover platforms, the oscillating capsule, the
    player's body and capsule overlay, three NPC capsules, the red mirror
    wall, the ramp, the dome and the emissive step; the two sun lights.

The player's body is ``assets/YBot.skinned.json``. Its skeleton and motion
profiles (``YBot.skeleton.json``, ``*.motionProfile.json``) are not in the
repository, so a 52-bone stand-in skeleton is built from the skin's own
bone names (unitScale 0.026); each bone's inverse bind comes from the skin
file, so the bind pose is exactly the identity palette and the body is drawn
at bind pose. This stands in until those files are in the repository and
the fixed-step simulation is ported.

Import decimation follows the reference's ``import_tri_budget``
(config.py:83 SGE_IMPORT_TRI_BUDGET = 20000, scene/demo_scene.py:79,
323-331,390-401): an imported part with more triangles than the budget and
exactly one submesh is vertex-clustered down to the budget, and each YBot
submesh to its share of it (at least 2000 triangles). The default scene is
this decimated one (53,342 triangles, a tree under the 22,000-row cap of
the shared-origin and shadow walks); ``import_tri_budget=0`` keeps full
fidelity (181,340 triangles).

There is no simulation here: ``transforms`` are the instance transforms of
the initial state in world space — what the reference's ``Stepper._extract``
gives when the previous and current states agree — and the Engine rebases
them to the camera each frame.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..assets import procedural_meshes as pm
from ..assets.materials import Material, load_materials
from ..assets.mesh_api import simplify_mesh, simplify_skinned
from ..assets.nputil import quat_from_mat
from ..assets.skeleton import build_skeleton
from ..assets.skinned_mesh import dense_weight_matrix, load_skinned_mesh
from ..assets.static_mesh import load_static_mesh
from .. import resolve_device
from ..math3d import quat_from_axis_angle_np, quat_mul_np, trs_matrices
from ..render.rt import DirectionalLights
from ..render.scene_geometry import RenderGeometryBuilder, SceneGeometry

GROUND_Y = -3.0
UNIT_SCALE = 0.026   # the YBot skeleton's unitScale (BASELINE.md)
# MovementComponent defaults (ecs/world.py): walk, run, run threshold
PLAYER_MOVEMENT = (4.5, 12.5, 0.78)
# Render-mesh triangle budget per imported part (config.py:83
# SGE_IMPORT_TRI_BUDGET); 0 disables decimation.
IMPORT_TRI_BUDGET = 20000


class DemoWorld(NamedTuple):
    geometry: SceneGeometry
    transforms: torch.Tensor       # (E,4,4) world-space instance transforms
    palettes: torch.Tensor         # (1,B,4,4) skinning palettes (bind pose)
    lights: DirectionalLights
    player_position: np.ndarray    # (3,) player world position
    movement: tuple                # (walk, run, run_threshold) of the player


def _solid_mat(name, rgb, roughness, metallic=0.0, alpha=1.0, unlit=False,
               emissive_factor=None):
    return Material(name=name,
                    base_color_factor=tuple(np.asarray(rgb, np.float32) / 255.0),
                    metallic_factor=metallic, roughness_factor=roughness,
                    alpha=alpha, unlit=unlit,
                    emissive_factor=tuple(emissive_factor or (0.0, 0.0, 0.0)))


class _Entities:
    """Entity table in creation order: translation, rotation, scale."""

    def __init__(self):
        self.t, self.q, self.s, self.follow, self.body = [], [], [], [], []

    def add(self, t, q=(0, 0, 0, 1), s=(1, 1, 1), follow=-1, body=False):
        self.t.append(np.asarray(t, np.float32))
        self.q.append(np.asarray(q, np.float32))
        self.s.append(np.broadcast_to(np.asarray(s, np.float32), (3,)))
        self.follow.append(follow)
        self.body.append(body)
        return len(self.t) - 1

    def transforms(self, device):
        """Initial-state render extraction (scene/step.py _extract with
        prev == curr): body rotations pass through the slerp's normalize;
        followers take their target's transform."""
        q = np.stack(self.q)
        body = np.asarray(self.body)
        norm = np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        q = np.where(body[:, None], (q / norm).astype(np.float32), q)
        src = np.where(np.asarray(self.follow) >= 0, self.follow,
                       np.arange(len(self.t)))
        t = torch.as_tensor(np.stack(self.t)[src], device=device)
        return trs_matrices(t, torch.as_tensor(q[src], device=device),
                            torch.as_tensor(np.stack(self.s)[src],
                                            device=device))


def _add_imported(ents, rb, path, materials_path, offset, hull_color,
                  budget, scale=None, upright_flip=False):
    if not os.path.exists(path):
        print(f"DemoScene: missing static mesh asset: {os.path.basename(path)}")
        return
    asset = load_static_mesh(path)
    materials = load_materials(materials_path) \
        if os.path.exists(materials_path) else {}
    fallback = Material(name="fallback")
    hull_mat = _solid_mat("CollisionMat", hull_color, 0.5, alpha=0.25,
                          unlit=True)
    for part in asset.parts:
        basis = part.transform[:3, :3]
        t = part.transform[:3, 3].copy()
        s = np.linalg.norm(basis, axis=0)
        s = np.where(s > 0, s, 1.0)
        m4 = np.eye(4, dtype=np.float32)
        m4[:3, :3] = basis / s
        q = quat_from_mat(m4)
        if upright_flip:
            q = quat_mul_np(q, quat_mul_np(
                quat_from_axis_angle_np(np.pi * 0.5, [1.0, 0, 0]),
                quat_from_axis_angle_np(np.pi, [1.0, 0, 0])))
        if scale is not None:
            s = s * scale
        t = t + np.asarray(offset, np.float32)
        e = ents.add(t, q, s)
        mesh = part.mesh
        if mesh.triangle_count > budget and len(part.submeshes) == 1:
            mesh = simplify_mesh(mesh.with_tangents() if mesh.uvs is not None
                                 and mesh.normals is not None else mesh,
                                 budget)
            rb.add_static_mesh(mesh, materials.get(part.submeshes[0].material,
                                                   fallback), instance=e)
        else:
            for sub in part.submeshes:
                rb.add_static_mesh(mesh, materials.get(sub.material, fallback),
                                   instance=e, tri_range=(sub.start, sub.count))
        for hull in part.collision_hulls:
            he = ents.add(t, q, s, body=True)
            rb.add_static_mesh(hull, hull_mat, instance=he)


def _add_player_body(rb, skinned_path, instance, budget):
    """The YBot skin on a stand-in skeleton of its own bone names, each
    submesh decimated to its share of ``budget``."""
    with open(skinned_path) as f:
        names = [b["name"] for b in json.load(f)["skin"]["bones"]]
    b = len(names)
    skeleton = build_skeleton(names, [-1] * b, np.zeros((b, 3), np.float32),
                              np.zeros((b, 3), np.float32),
                              unit_scale=UNIT_SCALE)
    sm = load_skinned_mesh(skinned_path, skeleton)
    for s in sm.submeshes:
        mat = Material(name=s.material)
        idx = sm.indices[s.start:s.start + s.count]
        used = np.unique(idx)
        remap = np.full(sm.vertex_count, -1, np.int64)
        remap[used] = np.arange(len(used))
        pos, nrm, uv, tri, j4, w4 = simplify_skinned(
            sm.positions[used], sm.normals[used], sm.uvs[used],
            remap[idx].astype(np.int32), sm.joints[used], sm.weights[used],
            max(int(budget * s.count / len(sm.indices)), 2000))
        rb.add_skinned_mesh(pos, nrm, uv, tri,
                            dense_weight_matrix(j4, w4, skeleton.bone_count),
                            [mat], [(0, len(tri))], instance=instance,
                            character=0)
    return skeleton.bone_count


def build_demo_scene(asset_dir: str = "assets", device="cuda",
                     import_tri_budget: int = IMPORT_TRI_BUDGET) -> DemoWorld:
    """The DemoScene render world on ``device`` (the card unless asked
    otherwise; see the module docstring). ``asset_dir`` holds the
    *.static.json / *.skinned.json files; ``import_tri_budget`` is the
    per-part triangle budget of the imported meshes (0: full fidelity)."""
    device = resolve_device(device)
    budget = import_tri_budget or (1 << 30)
    ents = _Entities()
    rb = RenderGeometryBuilder()

    def asset(name):
        return os.path.join(asset_dir, name)

    lights = DirectionalLights(
        direction=torch.tensor([[0.6, -0.7, -0.1], [-0.3, -0.6, 0.6]],
                               device=device),
        intensity=torch.tensor([2.0, 0.4], device=device),
        color=torch.tensor([[1.0, 0.86, 0.68], [0.95, 0.85, 0.75]],
                           device=device),
        enabled=torch.tensor([True, True], device=device),
        max_distance=torch.tensor([450.0, 300.0], device=device))

    ground = ents.add([0, GROUND_Y, 0], body=True)
    rb.add_static_mesh(pm.plane(80.0),
                       _solid_mat("GroundMat", (80, 80, 80), 0.8),
                       instance=ground)

    _add_imported(ents, rb, asset("17-Cheese.static.json"),
                  asset("17-Cheese.materials.json"), (0, 0, 0),
                  (80, 180, 255), budget)
    _add_imported(ents, rb, asset("Semla.static.json"),
                  asset("Semla.materials.json"), (18, 0, 10), (120, 220, 180),
                  budget)
    _add_imported(ents, rb, asset("ornate_mirror.static.json"),
                  asset("ornate-mirror.materials.json"), (-10, 1, 4),
                  (200, 160, 255), budget, scale=8.0, upright_flip=True)

    plat_mesh = pm.box(4.0)
    for name, pos, color in (("elevator", [16, -1.0, 0], (120, 200, 255)),
                             ("ground_mover", [-16, -2.0, 12],
                              (160, 255, 140))):
        e = ents.add(pos, s=(1.5, 0.2, 1.5), body=True)
        rb.add_static_mesh(plat_mesh, _solid_mat(f"{name}Mat", color, 0.6),
                           instance=e)

    cap_mesh = pm.capsule(1.5, 1.0)
    osc = ents.add([24.0, GROUND_Y + 2.5 + 2.0, 16.0], body=True)
    rb.add_static_mesh(cap_mesh, _solid_mat("KinematicCapsuleMat",
                                            (220, 120, 255), 0.5, alpha=0.2),
                       instance=osc)

    start = np.array([0.0, GROUND_Y + 2.5 + 8.0, 0.0], np.float32)
    player = ents.add(start, body=True)
    n_bones = _add_player_body(rb, asset("YBot.skinned.json"), player, budget)
    overlay = ents.add(start, follow=player)
    rb.add_static_mesh(pm.capsule(1.5, 1.0),
                       _solid_mat("PlayerCapsuleOverlayMat", (120, 160, 255),
                                  0.4, alpha=0.2), instance=overlay)

    for pos in ([-16.0, 0.9, 12.0], [8.0, 3.5, -2.5], [0.0, 5.5, -10.0]):
        e = ents.add(pos, body=True)
        rb.add_static_mesh(cap_mesh, _solid_mat("NPCMat", (255, 180, 80), 0.5,
                                                alpha=0.2), instance=e)

    wall = ents.add([0, 0, -10], body=True)
    rb.add_static_mesh(pm.box(6.0), _solid_mat("WallMat", (255, 80, 80), 0.02,
                                               metallic=1.0), instance=wall)
    ramp = ents.add([8, GROUND_Y + 2.0, 0], body=True)
    rb.add_static_mesh(pm.ramp(8.0, 10.0, 4.0),
                       _solid_mat("RampMat", (80, 160, 255), 0.6),
                       instance=ramp)
    dome = ents.add([-10, GROUND_Y, -6], body=True)
    rb.add_static_mesh(pm.dome(4.0, 12, 6),
                       _solid_mat("DomeMat", (120, 200, 140), 0.5),
                       instance=dome)
    step = ents.add([-6, -2, 4], body=True)
    rb.add_static_mesh(pm.box(2.0),
                       _solid_mat("StepMat", (255, 220, 120), 0.8,
                                  emissive_factor=(2.5, 2.0, 1.2)),
                       instance=step)

    palettes = torch.eye(4, device=device).expand(1, n_bones, 4, 4).contiguous()
    return DemoWorld(geometry=rb.build(device), transforms=ents.transforms(device),
                     palettes=palettes, lights=lights,
                     player_position=start.astype(np.float64),
                     movement=PLAYER_MOVEMENT)
