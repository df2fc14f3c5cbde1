"""World step: port of swift_game_engine_tpu/scene/step.py.

``Stepper.substep`` advances every system in the reference's order
(Game/DemoScene.swift:56-75 wiring + Game/Systems.swift:52-94
FixedStepRunner), as plain tensor code on the world's device:

  pre:   Spin -> OscillateMove -> ActiveChunk -> PhysicsLocalize -> Dodge ->
         PhysicsIntent -> Jump -> PhysicsBeginStep
  fixed: PlatformMotion -> CollisionQueryRefresh (soup retransform) ->
         Gravity -> KinematicMoveStop -> AgentSeparation -> PhysicsIntegrate ->
         LocomotionProfile -> ActionAnimation -> PoseStack
  post:  PhysicsWriteback -> WorldPositionSync

The pose systems run as the reference's do (scene/step.py:236-290): the
locomotion FSM with a profile ``bank``, the action clock with an
``action_profile``, and with a ``pose_engine`` the pose stack
(anim/pose.py) over the characters (``character_slot >= 0``), whose
palettes are scattered by slot (``model @ inv_bind_override`` where the
skin gives its own inverse binds). Without them those systems are
skipped, as in the reference.

A substep reads nothing back to the host: every branch is a
``torch.where`` and every loop runs its fixed count. ``SubstepGraph``
captures one substep on the card as a CUDA graph over world-state buffers
it owns (the port of the reference's ``fori_loop`` over ``_substep_impl``
inside its one-dispatch frame, scene/engine.py:220-223): one ``replay()``
issues the substep's ~31,000 kernels with one launch from the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import math3d as m3
from ..ecs.world import (BODY_DYNAMIC, BODY_KINEMATIC, BODY_STATIC,
                         CHUNK_SIZE, SceneSpec, WorldState, canonicalize,
                         chunk_local_to_world, clone_state, copy_state,
                         world_to_chunk_local)
from ..math3d import trs_matrices, where_rows as _w
from ..anim.locomotion import LocomotionTuning, locomotion_fsm_step
from ..anim.pose import ActionState, LocoParams, LocoState, PoseInputs
from ..physics import systems as S
from ..physics.systems import ActionClock
from ..physics.character import CharacterPipeline, PlatformSet
from ..physics.collision_world import LocalTriangles, transform_soup
from ..physics.separation import separate_agents

_MASKS = ("has_body", "has_controller", "has_intent", "has_loco",
          "has_action", "has_dodge", "has_osc", "has_spin", "has_platform",
          "has_wp", "is_player")


class Begun(NamedTuple):
    """The values of a substep's stages before the mover (``Stepper._begin``)
    that the mover, separation and the stages after them read."""

    m: dict
    static: torch.Tensor
    center: torch.Tensor
    body_pos: torch.Tensor
    body_vel: torch.Tensor
    body_rot: torch.Tensor
    trs_r: torch.Tensor
    trs_t: torch.Tensor
    body_prev_pos: torch.Tensor
    body_prev_rot: torch.Tensor
    osc_time: torch.Tensor
    intent_vel: torch.Tensor
    intent_yaw: torch.Tensor
    intent_has_yaw: torch.Tensor
    intent_jump: torch.Tensor
    intent_dodge: torch.Tensor
    dodge: object
    action_trigger: torch.Tensor
    plat_time: torch.Tensor
    soup: object
    platforms: PlatformSet
    cp: object
    ctrl: object


class Stepper:
    """The fixed substep and render extraction of one scene."""

    def __init__(self, spec: SceneSpec, collision: LocalTriangles,
                 pose_engine=None, bank=None, action_profile=None,
                 inv_bind_override=None, chunk_radius: int = 2):
        self.spec = spec
        self.collision = collision
        dev = collision.p0.device
        self.device = dev
        # ActiveChunk radius (Components.swift:150 default 2); without a
        # player with a WorldPosition the system is a no-op
        # (Systems.swift:2360-2364).
        self.chunk_radius = int(chunk_radius)
        p = np.nonzero(spec.is_player & spec.has_wp)[0]
        self.player_idx = int(p[0]) if len(p) else None
        self.pipeline = CharacterPipeline(gravity=spec.gravity)

        def tt(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        self.m = {k: tt(getattr(spec, k)) for k in _MASKS}
        self.body_type = tt(spec.body_type)
        self.spin = {k: tt(v) for k, v in spec.spin.items()}
        self.osc = {k: tt(v) for k, v in spec.osc.items()}
        self.platform = {k: tt(v) for k, v in spec.platform.items()}
        self.movement = {k: tt(v) for k, v in spec.movement.items()}
        self.follow = tt(spec.follow_target).long()
        ax = self.platform["axis"]
        ax_len = m3.norm(ax)[:, None]
        up = torch.zeros_like(ax)
        up[:, 1] = 1.0
        self.platform_axis_n = torch.where(
            ax_len > 1e-4, ax / torch.clamp(ax_len, min=1e-20), up)

        # the pose systems and what they read
        self.pose_engine, self.bank = pose_engine, bank
        self.action_profile = action_profile
        # the skin's inverse binds win over the skeleton's
        # (Systems.swift:2507-2527): (C, B, 4, 4) or None
        self.inv_bind_override = None if inv_bind_override is None else \
            tt(np.asarray(inv_bind_override, np.float32))
        self.character_slot = tt(spec.character_slot).long()
        ce = np.nonzero(spec.character_slot >= 0)[0]
        self.char_entities = tt(ce).long()
        self.n_chars = len(ce)
        self.loco_tuning = None if spec.loco_tuning is None else \
            LocomotionTuning(*(tt(x) for x in spec.loco_tuning))
        self.action_cfg = {k: tt(v) for k, v in spec.action_cfg.items()}
        dc = spec.dodge_cfg
        self.dodge_end = tt(np.where(dc["end_time"] > 0, dc["end_time"],
                                     dc["duration"]))

    def to(self, device) -> "Stepper":
        """The same scene's Stepper with every tensor on ``device``."""
        from ..ecs.world import to_device
        dev = torch.device(device)

        def move(x):
            return None if x is None else to_device(x, dev)
        return Stepper(self.spec.to(dev), to_device(self.collision, dev),
                       None if self.pose_engine is None else
                       self.pose_engine.to(dev), move(self.bank),
                       move(self.action_profile),
                       None if self.inv_bind_override is None else
                       self.inv_bind_override.cpu().numpy(),
                       self.chunk_radius)

    # ------------------------------------------------------------------

    def substep(self, state: WorldState, dt: float) -> WorldState:
        return self._substep_impl(state, dt)

    def _substep_impl(self, state: WorldState, dt: float, rows=None,
                      gather=None) -> WorldState:
        """One fixed substep -> the next WorldState: ``_begin``, ``_move``,
        ``_separate`` and ``_end``.

        ``rows`` and ``gather``: this process's part of an entity-sharded
        substep (parallel/sharding.py). ``rows`` holds the (lo, hi) entity
        ranges it steps (one a rank; every range of the virtual shards);
        the mover and separation's casts run over each range in turn, and
        ``gather(one list of (hi - lo, ...) tensors per range)`` gives
        each tensor over every entity (the ranks' all-gather): after the
        mover (separation reads every agent) and after separation (the
        stages after it run over every entity). With no ``rows`` every
        stage runs over every entity."""
        dt = float(np.float32(dt))
        b = self._begin(state, dt)
        if rows is None:
            pos, vel, ctrl = self._move(b, dt)
            pos, vel, ctrl = self._separate(b, pos, vel, ctrl)
            return self._end(state, b, pos, vel, ctrl, dt)
        moved = [self._move(b, dt, r) for r in rows]
        pos, vel = gather([m[:2] for m in moved])
        seps = [self._separate(b, pos, vel, m[2], r)
                for r, m in zip(rows, moved)]
        pos, vel, *c = gather([[p, v, *ctrl] for p, v, ctrl in seps])
        return self._end(state, b, pos, vel, type(seps[0][2])(*c), dt)

    def _begin(self, state: WorldState, dt: float) -> Begun:
        """The substep's stages before the mover, over every entity (the
        collision soup and the platform set are built from every
        collider's and platform's pose) -> their values (Begun)."""
        spec, sm = self.spec, self.m
        dt = float(np.float32(dt))
        alive = state.alive
        m = {k: v & alive for k, v in sm.items()}
        static = self.body_type == BODY_STATIC

        # --- pre: Spin (Systems.swift:97-119)
        body_rot = _w(m["has_spin"] & m["has_body"],
                      S.spin_step(state.body_rot, self.spin["speed"],
                                  self.spin["axis"], dt), state.body_rot)
        trs_r = _w(m["has_spin"] & ~m["has_body"],
                   S.spin_step(state.trs_r, self.spin["speed"],
                               self.spin["axis"], dt), state.trs_r)

        # --- pre: OscillateMove -> intent velocity
        osc_time, osc_vel = S.oscillate_move(
            self.osc["axis"], self.osc["amplitude"], self.osc["speed"],
            state.osc_time, dt, m["has_osc"])
        intent_vel = _w(m["has_osc"] & m["has_intent"], osc_vel,
                        state.intent_vel)

        # --- pre: ActiveChunk (Systems.swift:2354-2411): the Chebyshev
        # chunk-radius set around the player's chunk; the rest stop
        # simulating and their collision drops out (they still render).
        # --- pre: PhysicsLocalize (Systems.swift:2310-2351): positions
        # rebased to that chunk, exact in int32.
        trs_t, body_pos = state.trs_t, state.body_pos
        center = torch.zeros(3, dtype=torch.int32, device=self.device)
        if self.player_idx is not None:
            center = state.wp_chunk[self.player_idx]
            rel_chunk = state.wp_chunk - center
            cheb = rel_chunk.abs().amax(-1) <= self.chunk_radius
            chunk_active = ~sm["has_wp"] | cheb
            alive = alive & chunk_active
            m = {k: v & chunk_active for k, v in m.items()}
            local_world = rel_chunk.to(torch.float32) * CHUNK_SIZE + \
                state.wp_local
            haswp_alive = state.alive & sm["has_wp"]
            trs_t = _w(haswp_alive, local_world, trs_t)
            body_pos = _w(haswp_alive & sm["has_body"], local_world,
                          body_pos)

        # --- pre: Dodge (drives intent, restarts the action clip)
        dodge, ov = S.dodge_step(state.dodge, body_rot,
                                 state.intent_dodge & m["has_dodge"], dt)
        apply_d = ov["apply"] & m["has_dodge"]
        intent_vel = _w(apply_d, ov["desired_velocity"], intent_vel)
        intent_yaw = torch.where(apply_d, ov["facing_yaw"], state.intent_yaw)
        intent_has_yaw = state.intent_has_yaw | apply_d
        intent_jump = state.intent_jump & ~apply_d
        intent_dodge = torch.zeros_like(state.intent_dodge)
        action_trigger = ov["action_trigger"] & m["has_action"]

        # --- pre: PhysicsIntent
        body_vel, body_rot = S.physics_intent(
            state.body_vel, body_rot, intent_vel, intent_yaw, intent_has_yaw,
            dodge.active, m["has_controller"], self.movement["max_accel"],
            self.movement["max_decel"], dt,
            m["has_intent"] & m["has_body"] & ~static)

        # --- pre: Jump
        body_vel, grounded, intent_jump = S.jump_step(
            body_vel, state.ctrl.grounded,
            intent_jump & m["has_intent"] & m["has_controller"])
        ctrl = state.ctrl._replace(grounded=grounded)

        # --- pre: PhysicsBeginStep (latch prev, in the localized frame)
        latch = m["has_body"] & ~static
        body_prev_pos = _w(latch, body_pos, state.body_prev_pos)
        body_prev_rot = _w(latch, body_rot, state.body_prev_rot)

        # --- fixed: PlatformMotion. The orbit origin is the localized
        # position minus the current offset (Systems.swift:2339-2348).
        pl = self.platform
        offset_now = torch.sin(state.platform_time * pl["speed"] +
                               pl["phase"]) * pl["amplitude"]
        plat_origin = _w(m["has_platform"] & sm["has_wp"],
                         body_pos - self.platform_axis_n * offset_now[:, None],
                         pl["origin"])
        plat_time, plat_pos = S.kinematic_platform_motion(
            plat_origin, pl["axis"], pl["amplitude"], pl["speed"],
            pl["phase"], state.platform_time, dt, m["has_platform"])
        is_plat = m["has_platform"] & (self.body_type == BODY_KINEMATIC)
        body_pos = _w(is_plat, plat_pos, body_pos)
        body_vel = _w(is_plat, torch.zeros_like(body_vel), body_vel)
        trs_t = _w(is_plat, plat_pos, trs_t)

        # --- fixed: CollisionQueryRefresh: the soup from the current
        # entity transforms (body pose for bodies, TRS otherwise).
        ent_t = _w(m["has_body"], body_pos, trs_t)
        ent_r = _w(m["has_body"], body_rot, trs_r)
        soup = transform_soup(self.collision,
                              trs_matrices(ent_t, ent_r, state.trs_s),
                              entity_alive=alive)
        platforms = PlatformSet(aabb_min=body_pos + pl["aabb_min"],
                                aabb_max=body_pos + pl["aabb_max"],
                                delta=body_pos - body_prev_pos,
                                valid=is_plat)

        # --- fixed: Gravity (dynamic bodies, not while grounded & near)
        body_vel = S.gravity_step(body_vel, ctrl.grounded, ctrl.grounded_near,
                                  m["has_body"] &
                                  (self.body_type == BODY_DYNAMIC), dt,
                                  spec.gravity)

        cp = spec.controller_params
        cp = cp._replace(active=cp.active & alive)
        return Begun(m=m, static=static, center=center, body_pos=body_pos,
                     body_vel=body_vel, body_rot=body_rot, trs_r=trs_r,
                     trs_t=trs_t, body_prev_pos=body_prev_pos,
                     body_prev_rot=body_prev_rot, osc_time=osc_time,
                     intent_vel=intent_vel, intent_yaw=intent_yaw,
                     intent_has_yaw=intent_has_yaw, intent_jump=intent_jump,
                     intent_dodge=intent_dodge, dodge=dodge,
                     action_trigger=action_trigger, plat_time=plat_time,
                     soup=soup, platforms=platforms, cp=cp, ctrl=ctrl)

    def _move(self, b: Begun, dt: float, rows=None):
        """KinematicMoveStop over agents ``rows`` (lo, hi), all if None ->
        their (body_pos, body_vel, ctrl). Despawned agents stay inert."""
        return self.pipeline.step(b.soup, b.body_pos, b.body_vel, b.ctrl,
                                  b.cp, b.platforms, float(np.float32(dt)),
                                  rows)

    def _separate(self, b: Begun, body_pos, body_vel, ctrl, rows=None):
        """AgentSeparation: ``body_pos`` and ``body_vel`` after the mover
        over every agent, ``ctrl`` over ``rows`` (all agents if None) ->
        (body_pos, body_vel, ctrl) over ``rows``."""
        return separate_agents(b.soup, body_pos, body_vel, ctrl, b.cp,
                               rows=rows)

    def _end(self, state: WorldState, b: Begun, body_pos, body_vel, ctrl,
             dt: float) -> WorldState:
        """The stages after separation, over every entity -> the next
        WorldState."""
        dt = float(np.float32(dt))
        m, static, center = b.m, b.static, b.center
        body_rot, trs_r, trs_t = b.body_rot, b.trs_r, b.trs_t

        # --- fixed: PhysicsIntegrate (plain bodies only)
        integ = m["has_body"] & ~m["has_controller"] & ~m["has_platform"]
        int_pos, int_rot = S.integrate_bodies(
            body_pos, body_rot, body_vel, state.body_ang_vel, ~static & integ,
            dt)
        body_pos = _w(integ, int_pos, body_pos)
        body_rot = _w(integ, int_rot, body_rot)

        loco, action, palettes, pose_phase = self._pose_systems(
            state, m, body_vel, body_rot, ctrl, b.action_trigger, dt)

        # --- post: PhysicsWriteback (body -> transform)
        trs_t = _w(m["has_body"], body_pos, trs_t)
        trs_r = _w(m["has_body"], body_rot, trs_r)

        # --- post: WorldPositionSync (chunk/local, latch prev). Body
        # positions are relative to the active chunk: re-anchor before
        # canonicalizing (Systems.swift:2270-2307).
        has_wp = m["has_wp"]
        chunk_b, local_b = world_to_chunk_local(body_pos)
        chunk_b = chunk_b + center
        chunk_c, local_c = canonicalize(state.wp_chunk, state.wp_local)
        use_body = has_wp & m["has_body"]
        return state._replace(
            trs_t=trs_t, trs_r=trs_r,
            wp_chunk=_w(use_body, chunk_b, _w(has_wp, chunk_c,
                                              state.wp_chunk)),
            wp_local=_w(use_body, local_b, _w(has_wp, local_c,
                                              state.wp_local)),
            wp_prev_chunk=_w(has_wp, state.wp_chunk, state.wp_prev_chunk),
            wp_prev_local=_w(has_wp, state.wp_local, state.wp_prev_local),
            body_pos=body_pos, body_vel=body_vel, body_rot=body_rot,
            body_prev_pos=b.body_prev_pos, body_prev_rot=b.body_prev_rot,
            ctrl=ctrl, intent_vel=b.intent_vel, intent_yaw=b.intent_yaw,
            intent_has_yaw=b.intent_has_yaw, intent_jump=b.intent_jump,
            intent_dodge=b.intent_dodge, dodge=b.dodge, osc_time=b.osc_time,
            platform_time=b.plat_time, loco=loco, action=action,
            palettes=palettes, pose_phase=pose_phase)

    def _pose_systems(self, state, m, body_vel, body_rot, ctrl,
                      action_trigger, dt):
        """LocomotionProfile -> ActionAnimation -> PoseStack (the
        reference's step.py:253-290) -> (loco, action, palettes,
        pose_phase)."""
        spec = self.spec
        loco, action = state.loco, state.action
        palettes, pose_phase = state.palettes, state.pose_phase
        if self.bank is not None:
            new = locomotion_fsm_step(loco, self.bank, self.loco_tuning,
                                      body_vel, ctrl.grounded_near,
                                      ctrl.ground_distance)
            loco = LocoState(*(_w(m["has_loco"], a, b)
                               for a, b in zip(new, loco)))
        if self.action_profile is not None:
            cfg = self.action_cfg
            new = S.action_animation_step(
                action, cfg["cycle"], self.dodge_end, m["has_dodge"], dt,
                playback_rate=cfg["rate"], blend_in_time=cfg["blend_in"],
                blend_out_half_life=cfg["blend_out"], trigger=action_trigger)
            action = ActionClock(*(torch.where(m["has_action"], a, b)
                                   for a, b in zip(new, action)))
        if self.pose_engine is not None and self.n_chars:
            ce = self.char_entities
            inputs = PoseInputs(forward=m3.quat_forward(body_rot[ce]),
                                ground_normal=ctrl.ground_normal[ce],
                                grounded_near=ctrl.grounded_near[ce])
            res = self.pose_engine.step_character(
                self.bank, self.action_profile,
                LocoState(*(x[ce] for x in loco)),
                LocoParams(*(x[ce] for x in spec.loco_params)),
                ActionState(time=action.time[ce], weight=action.weight[ce],
                            active=action.active[ce]), inputs, dt)
            loco = LocoState(*(full.index_put((ce,), upd)
                               for full, upd in zip(loco, res.loco)))
            # palettes by character_slot (slots need not follow entity
            # order)
            slots = self.character_slot[ce]
            pal = res.palette if self.inv_bind_override is None else \
                torch.matmul(res.model, self.inv_bind_override[slots])
            palettes = palettes.index_put((slots,), pal)
            pose_phase = pose_phase.index_put((ce,), res.phase)
        return loco, action, palettes, pose_phase

    # ------------------------------------------------------------------

    def extract(self, state: WorldState, alpha: float, camera_world):
        """RenderExtract (Systems.swift:2415-2547): camera-relative instance
        transforms (E,4,4) interpolated between the previous and current
        physics state by ``alpha``, with follow-target substitution, and
        the palettes."""
        cam = torch.as_tensor(np.asarray(camera_world, np.float32),
                              device=self.device)
        return self._extract(state, float(np.float32(alpha)), cam)

    def _extract(self, state: WorldState, alpha, camera_world):
        """``extract`` with ``alpha`` a float or a 0-d tensor and
        ``camera_world`` a (3,) tensor, both on the state's device (the
        Engine's frame program passes its input buffers)."""
        m = self.m
        prev_w = chunk_local_to_world(state.wp_prev_chunk, state.wp_prev_local)
        curr_w = chunk_local_to_world(state.wp_chunk, state.wp_local)
        interp_wp = prev_w + (curr_w - prev_w) * alpha
        interp_body = state.body_prev_pos + \
            (state.body_pos - state.body_prev_pos) * alpha
        pos = _w(m["has_wp"], interp_wp,
                 _w(m["has_body"], interp_body, state.trs_t))
        rot = _w(m["has_body"],
                 m3.quat_slerp(state.body_prev_rot, state.body_rot, alpha),
                 state.trs_r)
        idx = torch.arange(self.spec.n_entities, device=self.device)
        src = torch.where(self.follow >= 0, self.follow, idx)
        # a follower renders with its target's scale too
        pos, rot, scale = pos[src], rot[src], state.trs_s[src]
        pos = pos - camera_world
        # despawned entities: zero-scale instances parked far away
        alive = state.alive[src] & state.alive
        pos = _w(alive, pos, torch.full_like(pos, 1.0e7))
        scale = _w(alive, scale, torch.zeros_like(scale))
        return trs_matrices(pos, rot, scale), state.palettes
