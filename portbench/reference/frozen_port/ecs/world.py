"""ECS world: port of swift_game_engine_tpu/ecs/world.py.

Every component is a dense table over the entity capacity E plus a
boolean ``has`` mask (reference: Game/World.swift:12-133): queries become
mask intersections and per-entity loops masked tensor ops. The mutable
state is one NamedTuple of tensors (``WorldState``) on the device;
configuration (masks, tuning, drivers) is the host-side ``SceneSpec``,
whose controller and pose parameters are tensors on the same device.

Positions keep the reference's chunk + local split (Components.swift:
54-135) as int32 chunk and f32 local.

``WorldBuilder`` stages components per entity as plain numpy/python values
(``names``, ``c``: component -> entity -> keyword dict, ``alive``) and
densifies them in ``build``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..anim.locomotion import LocomotionTuning
from ..anim.pose import LocoParams, LocoState
from ..physics.character import ControllerParams, ControllerState
from ..physics.systems import ActionClock, DodgeState

BODY_STATIC, BODY_KINEMATIC, BODY_DYNAMIC = 0, 1, 2
CHUNK_SIZE = 512.0


class WorldState(NamedTuple):
    """All mutable per-entity state (E entities)."""

    # Liveness (createEntity/destroyEntity, World.swift:44-57): capacity is
    # fixed; spawn/despawn flip the mask; dead entities are skipped by
    # every system, lose their collision and are parked by extraction.
    alive: torch.Tensor         # (E,) bool
    trs_t: torch.Tensor         # (E,3) TransformComponent
    trs_r: torch.Tensor         # (E,4)
    trs_s: torch.Tensor         # (E,3)
    wp_chunk: torch.Tensor      # (E,3) int32 WorldPositionComponent
    wp_local: torch.Tensor      # (E,3) f32
    wp_prev_chunk: torch.Tensor
    wp_prev_local: torch.Tensor
    body_pos: torch.Tensor      # (E,3) PhysicsBodyComponent
    body_vel: torch.Tensor
    body_ang_vel: torch.Tensor
    body_rot: torch.Tensor      # (E,4)
    body_prev_pos: torch.Tensor
    body_prev_rot: torch.Tensor
    ctrl: ControllerState
    intent_vel: torch.Tensor    # (E,3) MoveIntentComponent
    intent_yaw: torch.Tensor    # (E,)
    intent_has_yaw: torch.Tensor  # (E,) bool
    intent_jump: torch.Tensor   # (E,) bool
    intent_dodge: torch.Tensor  # (E,) bool
    loco: LocoState
    action: ActionClock
    dodge: DodgeState
    single_clip_time: torch.Tensor  # (E,)
    osc_time: torch.Tensor      # (E,)
    platform_time: torch.Tensor  # (E,)
    palettes: torch.Tensor      # (C,B,4,4)
    pose_phase: torch.Tensor    # (E,)


def world_to_chunk_local(world):
    """WorldPosition.fromWorld (Components.swift:58-68), f32/int32."""
    shifted = torch.floor((world + CHUNK_SIZE * 0.5) / CHUNK_SIZE)
    return shifted.to(torch.int32), world - shifted * CHUNK_SIZE


def chunk_local_to_world(chunk, local):
    return chunk.to(torch.float32) * CHUNK_SIZE + local


def canonicalize(chunk, local):
    """WorldPosition.canonicalize (Components.swift:71-86)."""
    d, l = world_to_chunk_local(local)
    return chunk + d, l


@dataclass
class SceneSpec:
    """Static scene description produced by WorldBuilder.build()."""

    n_entities: int
    names: list
    has_body: np.ndarray
    body_type: np.ndarray         # (E,) int32
    has_controller: np.ndarray
    has_intent: np.ndarray
    has_movement: np.ndarray
    has_loco: np.ndarray
    has_action: np.ndarray
    has_dodge: np.ndarray
    has_osc: np.ndarray
    has_spin: np.ndarray
    has_platform: np.ndarray
    has_wp: np.ndarray
    is_player: np.ndarray
    controller_params: ControllerParams   # tensors on the world's device
    loco_params: LocoParams               # tensors on the world's device
    movement: dict                # walk/run speeds, threshold, accel (E,)
    osc: dict                     # origin/axis/amplitude/speed
    spin: dict                    # speed/axis
    platform: dict                # origin/axis/amplitude/speed/phase, aabb
    dodge_cfg: dict               # duration/distance/start/end
    action_cfg: dict              # cycle/blend_in/blend_out/rate
    character_slot: np.ndarray    # (E,) int32 pose slot or -1
    follow_target: np.ndarray     # (E,) int32 target entity or -1
    gravity: tuple = (0.0, -98.0, 0.0)
    loco_tuning: Optional[LocomotionTuning] = field(default=None)

    def to(self, device) -> "SceneSpec":
        """A copy with its tensors on ``device``."""
        return dataclasses.replace(
            self, controller_params=to_device(self.controller_params, device),
            loco_params=to_device(self.loco_params, device))


def to_device(tree, device):
    """A (nested) NamedTuple of tensors, every tensor on ``device``."""
    return type(tree)(*(to_device(x, device) if isinstance(x, tuple)
                        else x.to(device) for x in tree))


def state_leaves(tree):
    """The tensors of a (nested) NamedTuple of tensors, in field order."""
    out = []
    for x in tree:
        out.extend(state_leaves(x) if isinstance(x, tuple) else [x])
    return out


def rebuild_state(like, leaves):
    """``like``'s structure filled from the iterator ``leaves``."""
    return type(like)(*(rebuild_state(x, leaves) if isinstance(x, tuple)
                        else next(leaves) for x in like))


def clone_state(tree):
    """A (nested) NamedTuple of tensors with every tensor cloned."""
    return rebuild_state(tree, iter([x.clone() for x in state_leaves(tree)]))


def copy_state(dst, src):
    """Copy every leaf of ``src`` into ``dst``'s tensor of the same leaf, in
    place; ``dst``'s tensors stay the same objects. A leaf of ``src`` that
    shares storage with another leaf of ``dst`` is cloned before any copy,
    so no copy overwrites a value that a later one reads. Raises where a
    leaf's shape or dtype differs (a copy would cast or broadcast it)."""
    d, s = state_leaves(dst), state_leaves(src)
    owner = {x.untyped_storage().data_ptr(): i for i, x in enumerate(d)
             if x.numel()}
    s = [x.clone() if x.numel() and owner.get(
        x.untyped_storage().data_ptr(), i) != i else x
        for i, x in enumerate(s)]
    for i, (a, b) in enumerate(zip(d, s)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"state leaf {i}: {tuple(b.shape)} {b.dtype} "
                             f"into {tuple(a.shape)} {a.dtype}")
        if b is not a:
            a.copy_(b)


class WorldBuilder:
    """Host-side scene assembly (the reference's World.add(...) calls):
    components are staged per entity and densified by build()."""

    def __init__(self):
        self.names: list = []
        self.c: dict = {}
        self.alive: list = []

    def create_entity(self, name: Optional[str] = None,
                      alive: bool = True) -> int:
        """``alive=False`` reserves a dormant slot (configured, skipped by
        every system) for a later spawn_entity."""
        e = len(self.names)
        self.names.append(name or f"entity_{e}")
        self.alive.append(bool(alive))
        return e

    def add(self, e: int, comp: str, **kw):
        self.c.setdefault(comp, {})[e] = kw
        return self

    @property
    def n(self) -> int:
        return len(self.names)

    def _dense(self, comp, key, default, shape=(), dtype=np.float32):
        out = np.full((self.n, *shape), default, dtype)
        for e, kw in self.c.get(comp, {}).items():
            if key in kw and kw[key] is not None:
                out[e] = kw[key]
        return out

    def _mask(self, comp):
        m = np.zeros(self.n, bool)
        for e in self.c.get(comp, {}):
            m[e] = True
        return m

    def build(self, device="cuda"):
        """-> (SceneSpec, WorldState) with the state on ``device`` (the card
        unless the caller names another)."""
        device = resolve_device(device)
        n = self.n
        tc = self.c.get("transform", {})

        def trs(key, default):
            out = np.tile(np.asarray(default, np.float32), (n, 1))
            for e, kw in tc.items():
                if key in kw and kw[key] is not None:
                    out[e] = kw[key]
            return out

        t = trs("translation", [0, 0, 0])
        r = trs("rotation", [0, 0, 0, 1])
        s = trs("scale", [1, 1, 1])
        body_t = self._dense("body", "position", 0.0, (3,))
        body_r = self._dense("body", "rotation", [0, 0, 0, 1], (4,))
        body_type = self._dense("body", "body_type", BODY_STATIC, (), np.int32)

        cp = ControllerParams.defaults(n)
        for e, kw in self.c.get("controller", {}).items():
            for k, v in kw.items():
                if k in cp and v is not None:
                    cp[k][e] = v
        has_ctrl = self._mask("controller")
        has_agent = self._mask("agent")
        for e, kw in self.c.get("agent", {}).items():
            cp["agent_mass_weight"][e] = kw.get("mass_weight", 1.0)
            cp["agent_solid"][e] = kw.get("is_solid", True)
            ro = kw.get("radius_override")
            cp["agent_radius"][e] = ro if ro is not None else cp["radius"][e]
        # agents without overrides follow their controller radius
        cp["agent_radius"][~has_agent] = cp["radius"][~has_agent]
        # only controller bodies are active in the mover
        cp["active"] = has_ctrl & (body_type != BODY_STATIC) & \
            self._mask("body")
        # agent_solid needs an agent component (collectAgentStates)
        cp["agent_solid"] = cp["agent_solid"] & has_agent

        def tt(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        controller_params = ControllerParams(**{k: tt(v) for k, v in cp.items()})

        d = self._dense
        movement = dict(
            walk_speed=d("movement", "walk_speed", 4.5),
            run_speed=d("movement", "run_speed", 12.5),
            run_threshold=d("movement", "run_threshold", 0.78),
            max_accel=d("movement", "max_acceleration", 20.0),
            max_decel=d("movement", "max_deceleration", 30.0))
        osc = dict(origin=d("oscillate", "origin", 0.0, (3,)),
                   axis=d("oscillate", "axis", [1, 0, 0], (3,)),
                   amplitude=d("oscillate", "amplitude", 4.0),
                   speed=d("oscillate", "speed", 1.0))
        spin = dict(speed=d("spin", "speed", 0.0),
                    axis=d("spin", "axis", [0, 1, 0], (3,)))
        platform = dict(origin=d("platform", "origin", 0.0, (3,)),
                        axis=d("platform", "axis", [0, 1, 0], (3,)),
                        amplitude=d("platform", "amplitude", 2.0),
                        speed=d("platform", "speed", 1.0),
                        phase=d("platform", "phase", 0.0),
                        aabb_min=d("platform", "aabb_min", 0.0, (3,)),
                        aabb_max=d("platform", "aabb_max", 0.0, (3,)))
        dodge_cfg = dict(duration=d("dodge", "duration", 0.35),
                         distance=d("dodge", "distance", 3.0),
                         start_time=d("dodge", "start_time", 0.0),
                         end_time=d("dodge", "end_time", 0.0))
        action_cfg = dict(cycle=d("action", "cycle", 1.0),
                          blend_in=d("action", "blend_in", 0.08),
                          blend_out=d("action", "blend_out", 0.12),
                          rate=d("action", "rate", 1.0))
        loco_params = LocoParams(
            playback_rate=tt(d("motion_profile", "playback_rate", 1.0)),
            loop=tt(d("motion_profile", "loop", True, (), bool)),
            in_place=tt(d("motion_profile", "in_place", True, (), bool)),
            blend_time=tt(d("locomotion", "blend_time", 0.2)),
            idle_inertia_half_life=tt(
                d("locomotion", "idle_inertia_half_life", 0.18)))

        character_slot = d("character", "slot", -1, (), np.int32)
        n_chars = max(int(character_slot.max(initial=-1)) + 1, 1)
        n_bones = max([1] + [int(kw.get("bone_count", 1))
                             for kw in self.c.get("character", {}).values()])
        lt = LocomotionTuning.default((n,))._asdict()
        for e, kw in self.c.get("locomotion", {}).items():
            for k, v in kw.items():
                if k in lt and v is not None:
                    lt[k][e] = v

        m = self._mask
        spec = SceneSpec(
            n_entities=n, names=list(self.names), has_body=m("body"),
            body_type=body_type, has_controller=has_ctrl,
            has_intent=m("intent"), has_movement=m("movement"),
            has_loco=m("locomotion"), has_action=m("action"),
            has_dodge=m("dodge"), has_osc=m("oscillate"),
            has_spin=m("spin"), has_platform=m("platform"),
            has_wp=m("world_position"), is_player=m("player"),
            controller_params=controller_params, loco_params=loco_params,
            movement=movement, osc=osc, spin=spin, platform=platform,
            dodge_cfg=dodge_cfg, action_cfg=action_cfg,
            character_slot=character_slot,
            follow_target=d("follow", "target", -1, (), np.int32),
            loco_tuning=LocomotionTuning(**lt))

        w = t.astype(np.float64)
        sh = np.floor((w + CHUNK_SIZE / 2) / CHUNK_SIZE)
        chunk = sh.astype(np.int32)
        local = (w - sh * CHUNK_SIZE).astype(np.float32)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        state = WorldState(
            alive=tt(np.asarray(self.alive, bool)),
            trs_t=tt(t), trs_r=tt(r), trs_s=tt(s),
            wp_chunk=tt(chunk), wp_local=tt(local),
            wp_prev_chunk=tt(chunk), wp_prev_local=tt(local),
            body_pos=tt(body_t), body_vel=z(n, 3),
            body_ang_vel=tt(d("body", "angular_velocity", 0.0, (3,))),
            body_rot=tt(body_r), body_prev_pos=tt(body_t),
            body_prev_rot=tt(body_r),
            ctrl=ControllerState.initial(n, device),
            intent_vel=z(n, 3), intent_yaw=z(n),
            intent_has_yaw=z(n, dtype=torch.bool),
            intent_jump=z(n, dtype=torch.bool),
            intent_dodge=z(n, dtype=torch.bool),
            loco=LocoState.initial((n,), device),
            action=ActionClock(active=z(n, dtype=torch.bool), time=z(n),
                               weight=z(n), exiting=z(n, dtype=torch.bool)),
            dodge=DodgeState(
                active=z(n, dtype=torch.bool), time=z(n),
                duration=tt(dodge_cfg["duration"]),
                distance=tt(dodge_cfg["distance"]),
                start_time=tt(dodge_cfg["start_time"]),
                end_time=tt(dodge_cfg["end_time"]),
                direction=z(n, 3), facing_yaw=z(n)),
            single_clip_time=z(n), osc_time=z(n), platform_time=z(n),
            palettes=torch.eye(4, device=device).repeat(n_chars, n_bones, 1, 1),
            pose_phase=z(n))
        return spec, state


# ---------------------------------------------------------------------------
# Runtime entity lifecycle (World.swift:44-57): fixed capacity + alive mask;
# spawn/despawn update one slot whose components were reserved at build.


def _set(x, e, v):
    """``x`` with row ``e`` set to ``v`` (a fill of a one-row slice)."""
    x = x.clone()
    x[e:e + 1] = v
    return x


def despawn_entity(state: WorldState, e: int) -> WorldState:
    """destroyEntity: the slot stops simulating, colliding and rendering;
    its velocities, intents and animation clocks are cleared so that a
    reused slot does not resume its previous occupant's motion."""
    act, dod, loco = state.action, state.dodge, state.loco
    return state._replace(
        alive=_set(state.alive, e, False),
        body_vel=_set(state.body_vel, e, 0.0),
        body_ang_vel=_set(state.body_ang_vel, e, 0.0),
        intent_vel=_set(state.intent_vel, e, 0.0),
        intent_jump=_set(state.intent_jump, e, False),
        intent_dodge=_set(state.intent_dodge, e, False),
        action=act._replace(active=_set(act.active, e, False),
                            time=_set(act.time, e, 0.0),
                            weight=_set(act.weight, e, 0.0),
                            exiting=_set(act.exiting, e, False)),
        dodge=dod._replace(active=_set(dod.active, e, False),
                           time=_set(dod.time, e, 0.0)),
        loco=loco._replace(state=_set(loco.state, e, 0),
                           from_state=_set(loco.from_state, e, 0),
                           times=_set(loco.times, e, 0.0),
                           blend_t=_set(loco.blend_t, e, 1.0),
                           idle_inertia=_set(loco.idle_inertia, e, 0.0),
                           is_blending=_set(loco.is_blending, e, False)))


def spawn_entity(state: WorldState, e: int, position=None,
                 rotation=None) -> WorldState:
    """createEntity into a dormant or despawned slot ``e``: its dynamic
    state is reset and it is enabled at ``position``/``rotation`` (default:
    its body's)."""
    st = despawn_entity(state, e)
    dev = state.body_pos.device
    pos = state.body_pos[e] if position is None else \
        torch.as_tensor(np.asarray(position, np.float32), device=dev)
    rot = state.body_rot[e] if rotation is None else \
        torch.as_tensor(np.asarray(rotation, np.float32), device=dev)
    chunk, local = world_to_chunk_local(pos)
    return st._replace(
        alive=_set(st.alive, e, True),
        trs_t=_set(st.trs_t, e, pos), trs_r=_set(st.trs_r, e, rot),
        body_pos=_set(st.body_pos, e, pos), body_rot=_set(st.body_rot, e, rot),
        body_prev_pos=_set(st.body_prev_pos, e, pos),
        body_prev_rot=_set(st.body_prev_rot, e, rot),
        wp_chunk=_set(st.wp_chunk, e, chunk),
        wp_local=_set(st.wp_local, e, local),
        wp_prev_chunk=_set(st.wp_prev_chunk, e, chunk),
        wp_prev_local=_set(st.wp_prev_local, e, local))
