"""DemoScene: port of swift_game_engine_tpu/scene/demo_scene.py.

Builds the reference demo world, entity for entity and in the same order
(scene/demo_scene.py:116-272,282-426): its render geometry, its
simulation world (``WorldBuilder`` components, ``CollisionWorldBuilder``
meshes) and the ``Stepper`` that advances it:

  * 80x80 ground at y=-3 (mu .9/.8); 17-Cheese and Semla (+18,0,10) with
    their translucent unlit collision hulls (static bodies; collision
    layers 1 and 1<<3, mu .6/.5); the ornate mirror when its asset is
    present (it is not in the repository, and the reference skips it too);
    ``include_imported_assets=False`` leaves out these three;
  * the elevator and ground_mover kinematic platforms, the oscillating
    capsule NPC (mass 500), the player (body, intent, movement, controller
    r 1.5 / hh 1.0, agent of mass 3) with its capsule overlay following
    it, three separation-test NPCs, the red mirror wall, the flattenGround
    ramp, the dome and the emissive step; the two sun lights.

The player takes one of two branches, and ``DemoWorld.posed`` says which:

  * **posed** (the reference's player, scene/demo_scene.py:346-411), when
    ``asset_dir`` holds the reference's ``YBot.skeleton.json`` and the five
    profiles ``Idle``, ``Walking``, ``Running``, ``FallingIdle`` and
    ``StandingDodgeBackward`` (``*.motionProfile.json``): the skeleton and
    profiles are loaded, a ``PoseEngine`` with its locomotion bank and the
    dodge's action profile steps the player in every substep, and the
    player carries ``motion_profile``, ``locomotion`` (idle exit 0.3, run
    enter 6 / exit 5, fall drop 50), ``action`` (the dodge profile's cycle,
    blend 0.08 in / 0.18 out) and ``dodge`` (34 frames of the dodge
    profile's sample rate, distance 8). The body is ``YBot.skinned.json``
    loaded against that skeleton, whose own inverse binds override the
    palette's (``inv_bind_override``); without the skin file it is the
    skeleton's capsules (``skeleton_capsules``);
  * **stand-in**, otherwise (the repository holds neither file; the tests
    write a synthetic rig in their schemas, tests/torch_pose_rig.py): a
    52-bone skeleton built from the skin's own bone names (unitScale
    0.026), each bone's inverse bind from the skin file, so the palette is
    the identity and the body is drawn at bind pose, and the player goes
    without the four components above. It walks, falls, jumps and collides.

Import decimation follows the reference's ``import_tri_budget``
(config.py:83 SGE_IMPORT_TRI_BUDGET = 20000, scene/demo_scene.py:79,
323-331,390-401): an imported part with more triangles than the budget and
exactly one submesh is vertex-clustered down to the budget, and each YBot
submesh to its share of it (at least 2000 triangles). The default scene is
this decimated one (53,342 triangles, a tree under the 22,000-row cap of
the shared-origin and shadow walks); ``import_tri_budget=0`` keeps full
fidelity (181,340 triangles). Collision always uses the exact hulls.

``transforms`` are the instance transforms of the initial state in world
space (``Stepper.extract`` with the previous and current states equal);
the builders stay readable (``world_builder``, ``collision_builder``:
their staged components and meshes are plain numpy), so that a test can
replay them into the reference's builders.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..assets import procedural_meshes as pm
from ..assets.materials import Material, load_materials
from ..assets.mesh_api import simplify_mesh, simplify_skinned
from ..assets.nputil import quat_from_mat
from ..anim.pose import ActionProfile, PoseEngine, ProfileBank
from ..assets.motion_profile import load_motion_profile, pack_profile
from ..assets.skeleton import Skeleton, build_skeleton, load_skeleton
from ..assets.skinned_mesh import dense_weight_matrix, load_skinned_mesh
from ..assets.static_mesh import load_static_mesh
from .. import resolve_device
from ..ecs.world import (BODY_DYNAMIC, BODY_KINEMATIC, BODY_STATIC, SceneSpec,
                         WorldBuilder, WorldState)
from ..math3d import quat_from_axis_angle_np, quat_mul_np
from ..physics.collision_world import CollisionWorldBuilder, LocalTriangles
from ..render.rt import DirectionalLights
from ..render.scene_geometry import (TEXTURE_SIZE, RenderGeometryBuilder,
                                     SceneGeometry)
from .step import Stepper

GROUND_Y = -3.0
UNIT_SCALE = 0.026   # the YBot skeleton's unitScale (BASELINE.md)
# Render-mesh triangle budget per imported part (config.py:83
# SGE_IMPORT_TRI_BUDGET); 0 disables decimation.
IMPORT_TRI_BUDGET = 20000


class DemoWorld(NamedTuple):
    """A world the Engine renders and, with a ``stepper``, simulates. A
    render-only world (no stepper) has fixed ``transforms``."""

    geometry: SceneGeometry
    transforms: torch.Tensor       # (E,4,4) initial world-space instances
    palettes: torch.Tensor         # (C,B,4,4) skinning palettes (bind pose)
    lights: DirectionalLights
    player_position: np.ndarray    # (3,) initial player world position
    movement: tuple                # (walk, run, run_threshold) of the player
    spec: Optional[SceneSpec] = None
    state: Optional[WorldState] = None
    stepper: Optional[Stepper] = None
    player: Optional[int] = None   # the player's entity index
    collision: Optional[LocalTriangles] = None
    world_builder: Optional[WorldBuilder] = None
    collision_builder: Optional[CollisionWorldBuilder] = None
    posed: bool = False            # the player has a skeleton and profiles


def _solid_mat(name, rgb, roughness, metallic=0.0, alpha=1.0, unlit=False,
               emissive_factor=None):
    return Material(name=name,
                    base_color_factor=tuple(np.asarray(rgb, np.float32) / 255.0),
                    metallic_factor=metallic, roughness_factor=roughness,
                    alpha=alpha, unlit=unlit,
                    emissive_factor=tuple(emissive_factor or (0.0, 0.0, 0.0)))


def _add_imported(wb, cb, rb, path, materials_path, offset, layer,
                  hull_color, budget, scale=None, upright_flip=False):
    if not os.path.exists(path):
        print(f"DemoScene: missing static mesh asset: {os.path.basename(path)}")
        return
    name = os.path.basename(path)
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
        e = wb.create_entity(f"{name}:{part.name}")
        wb.add(e, "transform", translation=t, rotation=q, scale=s)
        wb.add(e, "world_position")
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
        for i, hull in enumerate(part.collision_hulls):
            he = wb.create_entity(f"{name}:{part.name}:hull{i}")
            wb.add(he, "transform", translation=t, rotation=q, scale=s)
            wb.add(he, "world_position")
            wb.add(he, "body", body_type=BODY_STATIC, position=t, rotation=q)
            cb.add_mesh(hull.positions, hull.indices, entity=he, mu_s=0.6,
                        mu_k=0.5, layer=layer)
            rb.add_static_mesh(hull, hull_mat, instance=he)


def _add_skin(rb, skinned_path, skeleton, instance, budget):
    """The YBot skin loaded against ``skeleton``, each submesh decimated to
    its share of ``budget`` -> the skin's inverse binds (B, 4, 4)."""
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
    return sm.inv_bind_model


def _add_player_body(rb, skinned_path, instance, budget):
    """The stand-in: the YBot skin on a skeleton of its own bone names."""
    with open(skinned_path) as f:
        names = [b["name"] for b in json.load(f)["skin"]["bones"]]
    b = len(names)
    skeleton = build_skeleton(names, [-1] * b, np.zeros((b, 3), np.float32),
                              np.zeros((b, 3), np.float32),
                              unit_scale=UNIT_SCALE)
    _add_skin(rb, skinned_path, skeleton, instance, budget)
    return skeleton.bone_count


POSE_PROFILES = ("Idle", "Walking", "Running", "FallingIdle",
                 "StandingDodgeBackward")


def has_pose_assets(asset_dir: str) -> bool:
    """Whether ``asset_dir`` holds the skeleton and the five profiles the
    posed player reads."""
    return all(os.path.exists(os.path.join(asset_dir, n)) for n in
               ["YBot.skeleton.json"] +
               [f"{p}.motionProfile.json" for p in POSE_PROFILES])


class PoseRig(NamedTuple):
    """What the posed player reads from its asset directory."""

    skeleton: Skeleton
    engine: PoseEngine
    bank: ProfileBank
    action: ActionProfile          # the dodge's
    dodge_cycle: float
    dodge_sample_fps: int


def load_pose_rig(asset_dir: str, device="cuda") -> PoseRig:
    """The skeleton and the five profiles of ``asset_dir``: a PoseEngine on
    ``device``, its locomotion bank and the dodge's action profile."""
    def asset(name):
        return os.path.join(asset_dir, name)
    skeleton = load_skeleton(asset("YBot.skeleton.json"))
    profiles = {n: load_motion_profile(asset(f"{n}.motionProfile.json"))
                for n in POSE_PROFILES}
    engine = PoseEngine(skeleton, resolve_device(device))
    bank = engine.make_bank(*(pack_profile(profiles[n], skeleton)
                              for n in POSE_PROFILES[:4]))
    dodge = profiles["StandingDodgeBackward"]
    return PoseRig(skeleton, engine, bank,
                   engine.make_action(pack_profile(dodge, skeleton)),
                   dodge.cycle, dodge.sample_fps)


def add_pose_components(wb, player: int, rig: PoseRig):
    """The posed player's components (scene/demo_scene.py:361-377):
    motion_profile, locomotion, action, dodge and its character slot."""
    wb.add(player, "motion_profile", playback_rate=1.0, loop=True,
           in_place=True)
    wb.add(player, "locomotion", idle_enter_speed=0.15, idle_exit_speed=0.3,
           run_enter_speed=6.0, run_exit_speed=5.0, fall_min_drop_height=50.0)
    end_time = 34.0 / max(rig.dodge_sample_fps, 1)
    wb.add(player, "action", cycle=rig.dodge_cycle, blend_in=0.08,
           blend_out=0.18)
    wb.add(player, "dodge", duration=end_time, distance=8.0, start_time=0.0,
           end_time=end_time)
    wb.add(player, "character", slot=0, bone_count=rig.skeleton.bone_count)


def _add_posed_player(wb, rb, asset_dir, player, budget, device):
    """The reference's posed player (scene/demo_scene.py:346-411): its pose
    components and body -> (PoseRig, the skin's inverse binds (1, B, 4, 4)
    or None)."""
    rig = load_pose_rig(asset_dir, device)
    add_pose_components(wb, player, rig)
    skeleton = rig.skeleton
    skinned = os.path.join(asset_dir, "YBot.skinned.json")
    if os.path.exists(skinned):
        return rig, _add_skin(rb, skinned, skeleton, player, budget)[None]
    print("DemoScene: missing YBot.skinned.json, using skeletonCapsules body")
    body = pm.skeleton_capsules(skeleton, radius=0.05)
    rb.add_skinned_mesh(
        body.positions, body.normals, body.uvs, body.indices,
        dense_weight_matrix(body.joints, body.weights, skeleton.bone_count),
        [_solid_mat("YBotBody", (25, 107, 133), 0.55)],
        [(0, len(body.indices))], instance=player, character=0)
    return rig, None


def build_demo_scene(asset_dir: str = "assets", device="cuda",
                     import_tri_budget: int = IMPORT_TRI_BUDGET,
                     include_imported_assets: bool = True,
                     pad_entities_to: int = 1,
                     texture_size: int = TEXTURE_SIZE) -> DemoWorld:
    """The DemoScene world on ``device`` (the card unless asked otherwise;
    see the module docstring). ``asset_dir`` holds the *.static.json /
    *.skinned.json files; ``import_tri_budget`` is the per-part triangle
    budget of the imported meshes (0: full fidelity);
    ``include_imported_assets=False`` leaves out 17-Cheese, Semla and the
    mirror with their hulls (scene/demo_scene.py:72,149: the small
    world); ``pad_entities_to`` pads the entity table with dormant slots
    (``alive=False``, skipped by every system) to a multiple of that count
    (scene/demo_scene.py:80-82, 256-264: an entity axis split over ranks;
    0 or 1: no padding); ``texture_size`` is the texture bank's side
    (demo_scene.py:121, SGE_TEX_SIZE)."""
    device = resolve_device(device)
    budget = import_tri_budget or (1 << 30)
    wb = WorldBuilder()
    cb = CollisionWorldBuilder()
    rb = RenderGeometryBuilder(texture_size=texture_size)

    def asset(name):
        return os.path.join(asset_dir, name)

    def add_static(e, mesh, surface=(0.8, 0.6, False)):
        cb.add_mesh(mesh.positions, mesh.indices, entity=e, mu_s=surface[0],
                    mu_k=surface[1], flatten=bool(surface[2]))

    def body_entity(name, pos, body_type, **transform):
        e = wb.create_entity(name)
        wb.add(e, "transform", translation=pos, **transform)
        wb.add(e, "world_position")
        wb.add(e, "body", body_type=body_type, position=pos)
        return e

    lights = DirectionalLights(
        direction=torch.tensor([[0.6, -0.7, -0.1], [-0.3, -0.6, 0.6]],
                               device=device),
        intensity=torch.tensor([2.0, 0.4], device=device),
        color=torch.tensor([[1.0, 0.86, 0.68], [0.95, 0.85, 0.75]],
                           device=device),
        enabled=torch.tensor([True, True], device=device),
        max_distance=torch.tensor([450.0, 300.0], device=device))

    ground = body_entity("ground", [0, GROUND_Y, 0], BODY_STATIC)
    add_static(ground, pm.plane(80.0), surface=(0.9, 0.8, False))
    rb.add_static_mesh(pm.plane(80.0),
                       _solid_mat("GroundMat", (80, 80, 80), 0.8),
                       instance=ground)

    if include_imported_assets:
        _add_imported(wb, cb, rb, asset("17-Cheese.static.json"),
                      asset("17-Cheese.materials.json"), (0, 0, 0), 1,
                      (80, 180, 255), budget)
        _add_imported(wb, cb, rb, asset("Semla.static.json"),
                      asset("Semla.materials.json"), (18, 0, 10), 1 << 3,
                      (120, 220, 180), budget)
        _add_imported(wb, cb, rb, asset("ornate_mirror.static.json"),
                      asset("ornate-mirror.materials.json"), (-10, 1, 4),
                      1 << 4, (200, 160, 255), budget, scale=8.0,
                      upright_flip=True)

    plat_mesh = pm.box(4.0)
    plat_scale = np.array([1.5, 0.2, 1.5], np.float32)
    local_aabb = plat_mesh.positions * plat_scale
    for name, pos, axis, amp, speed, phase, color in (
            ("elevator", [16, -1.0, 0], [0, 1, 0], 2.0, 1.1, 0.0,
             (120, 200, 255)),
            ("ground_mover", [-16, -2.0, 12], [1, 0, 0], 4.0, 0.9, 0.7,
             (160, 255, 140))):
        e = body_entity(name, pos, BODY_KINEMATIC, scale=plat_scale)
        wb.add(e, "platform", origin=pos, axis=axis, amplitude=amp,
               speed=speed, phase=phase, aabb_min=local_aabb.min(axis=0),
               aabb_max=local_aabb.max(axis=0))
        add_static(e, plat_mesh, surface=(0.9, 0.7, False))
        rb.add_static_mesh(plat_mesh, _solid_mat(f"{name}Mat", color, 0.6),
                           instance=e)

    def controller(e, mass):
        wb.add(e, "controller", radius=1.5, half_height=1.0, skin_width=0.3,
               ground_snap_skin=0.05)
        wb.add(e, "agent", mass_weight=mass)

    cap_mesh = pm.capsule(1.5, 1.0)
    osc_pos = [24.0, GROUND_Y + 2.5 + 2.0, 16.0]
    osc = body_entity("osc_npc", osc_pos, BODY_DYNAMIC)
    wb.add(osc, "intent")
    wb.add(osc, "movement", max_acceleration=14.0, max_deceleration=28.0)
    controller(osc, 500.0)
    wb.add(osc, "oscillate", origin=osc_pos, axis=[1, 0, 0], amplitude=6.0,
           speed=0.6)
    rb.add_static_mesh(cap_mesh, _solid_mat("KinematicCapsuleMat",
                                            (220, 120, 255), 0.5, alpha=0.2),
                       instance=osc)

    # The player (CharacterFactory.swift:12-135), posed or the stand-in
    # (see the module docstring).
    start = [0.0, GROUND_Y + 2.5 + 8.0, 0.0]
    player = body_entity("player", start, BODY_DYNAMIC)
    wb.add(player, "player")
    wb.add(player, "intent")
    wb.add(player, "movement", max_acceleration=20.0, max_deceleration=36.0)
    controller(player, 3.0)
    posed = has_pose_assets(asset_dir)
    rig = inv_bind = None
    if posed:
        rig, inv_bind = _add_posed_player(wb, rb, asset_dir, player, budget,
                                          device)
    else:
        n_bones = _add_player_body(rb, asset("YBot.skinned.json"), player,
                                   budget)
        wb.add(player, "character", slot=0, bone_count=n_bones)
    overlay = wb.create_entity("player_overlay")
    wb.add(overlay, "transform", translation=start)
    wb.add(overlay, "follow", target=player)
    rb.add_static_mesh(pm.capsule(1.5, 1.0),
                       _solid_mat("PlayerCapsuleOverlayMat", (120, 160, 255),
                                  0.4, alpha=0.2), instance=overlay)

    for i, pos in enumerate([[-16.0, 0.9, 12.0], [8.0, 3.5, -2.5],
                             [0.0, 5.5, -10.0]]):
        e = body_entity(f"npc_{i}", pos, BODY_DYNAMIC)
        controller(e, 1.0)
        rb.add_static_mesh(cap_mesh, _solid_mat("NPCMat", (255, 180, 80), 0.5,
                                                alpha=0.2), instance=e)

    wall = body_entity("test_wall", [0, 0, -10], BODY_STATIC)
    add_static(wall, pm.box(6.0))
    rb.add_static_mesh(pm.box(6.0), _solid_mat("WallMat", (255, 80, 80), 0.02,
                                               metallic=1.0), instance=wall)
    ramp = body_entity("test_ramp", [8, GROUND_Y + 2.0, 0], BODY_STATIC)
    add_static(ramp, pm.ramp(8.0, 10.0, 4.0), surface=(0.35, 0.25, True))
    rb.add_static_mesh(pm.ramp(8.0, 10.0, 4.0),
                       _solid_mat("RampMat", (80, 160, 255), 0.6),
                       instance=ramp)
    dome = body_entity("test_dome", [-10, GROUND_Y, -6], BODY_STATIC)
    add_static(dome, pm.dome(4.0, 12, 6), surface=(0.3, 0.2, False))
    rb.add_static_mesh(pm.dome(4.0, 12, 6),
                       _solid_mat("DomeMat", (120, 200, 140), 0.5),
                       instance=dome)
    step = body_entity("test_step", [-6, -2, 4], BODY_STATIC)
    add_static(step, pm.box(2.0))
    rb.add_static_mesh(pm.box(2.0),
                       _solid_mat("StepMat", (255, 220, 120), 0.8,
                                  emissive_factor=(2.5, 2.0, 1.2)),
                       instance=step)

    if pad_entities_to > 1:
        while wb.n % pad_entities_to:
            wb.create_entity(alive=False)
    spec, state = wb.build(device)
    collision = cb.build(device=device)
    pose = dict(pose_engine=rig.engine, bank=rig.bank,
                action_profile=rig.action) if posed else {}
    stepper = Stepper(spec, collision, inv_bind_override=inv_bind, **pose)
    transforms, palettes = stepper.extract(state, 1.0, np.zeros(3, np.float32))
    mv = spec.movement
    return DemoWorld(
        geometry=rb.build(device), transforms=transforms, palettes=palettes,
        lights=lights, player_position=np.asarray(start, np.float64),
        movement=(float(mv["walk_speed"][player]),
                  float(mv["run_speed"][player]),
                  float(mv["run_threshold"][player])),
        spec=spec, state=state, stepper=stepper, player=player,
        collision=collision, world_builder=wb, collision_builder=cb,
        posed=posed)
