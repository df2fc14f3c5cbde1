"""Pose stack: port of swift_game_engine_tpu/anim/pose.py (reference:
Game/ProceduralPoseSystem.swift:10-407).

Locomotion blending, the action layer, the procedural corrections and FK,
as plain tensor code over a leading character axis (N) where the reference
vmaps its per-character function. The four locomotion clips are one
stacked coefficient bank (4, B, 6, C); poses are (t, q) pairs and matrices
are built once, for FK's output. Every branch that depends on state is a
``torch.where``; the pelvis, the lean bone, its parent and the FK levels
are static Python ints, so a step reads nothing back and is captured into
the substep's CUDA graph (scene/step.py). Bone rows are written out of
place, through one-hot bone masks.

Reference semantics (anim/pose.py:1-31): clock advance and loop wrap
:42-56; idle-inertia vs timed blend :58-75; weightTo :101-111; runWeight
:112-124; per-bone sampling with rest-delta unit rescaling :144-179; the
root's in-place XZ lock :174-179; pre-rotation and root fix :181-200; the
root's yaw-stable slerp during blends :206-218; the action layer :286-338;
pelvis pitch-only ground align (0.33) :344-367; run/idle chest lean 10 deg
:369-393; FK and palette :396-402.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constant, resolve_device
from .. import math3d as m3
from ..assets import nputil
from ..assets.motion_profile import PackedMotionProfile
from ..assets.skeleton import Skeleton
from .fk import FKSolver, compose_tq, palette_from_model
from .fourier import evaluate_packed

# Locomotion states (Components.swift:223-228).
IDLE, WALK, RUN, FALLING = 0, 1, 2, 3

# radians_from_degrees(10.0) in f32, as the reference computes it
LEAN_RADIANS = float(np.float32(np.float32(10.0) / np.float32(180.0)) *
                     np.float32(np.pi))


class LocoState(NamedTuple):
    """Mutable locomotion pose state (per character, leading batch axis)."""

    state: torch.Tensor        # int32
    from_state: torch.Tensor   # int32
    times: torch.Tensor        # (...,4) clip clocks [idle, walk, run, fall]
    blend_t: torch.Tensor
    idle_inertia: torch.Tensor
    is_blending: torch.Tensor  # bool

    @staticmethod
    def initial(batch_shape=(), device=None):
        z = torch.zeros(batch_shape, device=device)
        zi = torch.zeros(batch_shape, dtype=torch.int32, device=device)
        return LocoState(state=zi, from_state=zi.clone(),
                         times=torch.zeros((*batch_shape, 4), device=device),
                         blend_t=z + 1.0, idle_inertia=z,
                         is_blending=torch.zeros(batch_shape, dtype=torch.bool,
                                                 device=device))


class LocoParams(NamedTuple):
    """Per-character tuning (Components.swift:230-293, 203-221)."""

    playback_rate: torch.Tensor
    loop: torch.Tensor                 # bool
    in_place: torch.Tensor             # bool
    blend_time: torch.Tensor
    idle_inertia_half_life: torch.Tensor

    @staticmethod
    def default(batch_shape=(), device=None):
        o = torch.ones(batch_shape, device=device)
        t = torch.ones(batch_shape, dtype=torch.bool, device=device)
        return LocoParams(playback_rate=o, loop=t, in_place=t.clone(),
                          blend_time=o * 0.2, idle_inertia_half_life=o * 0.18)


class ActionState(NamedTuple):
    """Action clip playback state (Components.swift:620-653)."""

    time: torch.Tensor
    weight: torch.Tensor
    active: torch.Tensor               # bool

    @staticmethod
    def inactive(batch_shape=(), device=None):
        z = torch.zeros(batch_shape, device=device)
        return ActionState(time=z, weight=z.clone(),
                           active=torch.zeros(batch_shape, dtype=torch.bool,
                                              device=device))


class PoseInputs(NamedTuple):
    """Per-character inputs of the procedural corrections."""

    forward: torch.Tensor        # (N, 3) world forward (rotation of (0,0,-1))
    ground_normal: torch.Tensor  # (N, 3)
    grounded_near: torch.Tensor  # (N,) bool


class SkeletonArrays(NamedTuple):
    """Device tensors of a skeleton (B bones)."""

    inv_bind_model: torch.Tensor      # (B, 4, 4)
    rest_translation: torch.Tensor    # (B, 3)
    raw_rest_translation: torch.Tensor  # (B, 3)
    pre_rot_quat: torch.Tensor        # (B, 4) pre-rotation (+root fix, bone 0)


class ProfileBank(NamedTuple):
    """Stacked locomotion profiles [idle, walk, run, fall]."""

    coeffs: torch.Tensor       # (4, B, 6, C)
    has_channel: torch.Tensor  # (4, B, 6) bool
    cycles: torch.Tensor       # (4,)


class ActionProfile(NamedTuple):
    coeffs: torch.Tensor       # (B, 6, C)
    has_channel: torch.Tensor  # (B, 6) bool
    cycle: torch.Tensor        # ()
    in_place: torch.Tensor     # () bool


class PoseResult(NamedTuple):
    local: torch.Tensor    # (N, B, 4, 4)
    model: torch.Tensor    # (N, B, 4, 4)
    palette: torch.Tensor  # (N, B, 4, 4)
    phase: torch.Tensor    # (N,)
    loco: LocoState


def _rows(x, i: int, row):
    """``x`` (N, B, k) with bone row ``i`` replaced by ``row`` (N, k), out
    of place (a one-hot bone mask)."""
    mask = torch.arange(x.shape[-2], device=x.device) == i
    return torch.where(mask[:, None], row[..., None, :], x)


def _sample_tq(coeffs, has_channel, phase, order: int, skel: SkeletonArrays,
               unit_scale: float, in_place):
    """One profile sampled at ``phase`` (N,) into per-bone translations and
    rotations (Game/ProceduralPoseSystem.swift:144-200): the translation is
    ``rest_scaled + (anim_raw - rest_raw) * unitScale``, the rotation
    ``pre_rot * eulerXYZ(anim_degrees)``; with ``in_place`` (N,) or () the
    root's X and Z stay at rest. -> (t (N, B, 3), q (N, B, 4))."""
    trans_raw, rot_deg = evaluate_packed(coeffs, has_channel, phase, order,
                                         skel.raw_rest_translation)
    delta = trans_raw - skel.raw_rest_translation
    t = skel.rest_translation + delta * unit_scale
    lock = np.zeros(t.shape[-2:], bool)
    lock[0, [0, 2]] = True
    locked = torch.where(constant(lock, t.device, torch.bool),
                         skel.rest_translation, t)
    t = torch.where(in_place[..., None, None], locked, t)
    q = m3.quat_mul(skel.pre_rot_quat, m3.quat_from_euler_xyz_degrees(rot_deg))
    return t, q


def _pick(x, idx):
    """x (N, 4) at the per-row index idx (N,) -> (N,)."""
    return torch.gather(x, -1, idx.long()[..., None])[..., 0]


def locomotion_pose_tq(bank: ProfileBank, state: LocoState, params: LocoParams,
                       skel: SkeletonArrays, order: int, unit_scale: float,
                       dt: float):
    """Advance the clip clocks and blends, and sample the blended pose.

    Returns (t (N, B, 3), q (N, B, 4), phase (N,), run_lean_weight (N,),
    the new LocoState)."""
    dev = state.times.device
    cycles = torch.clamp(bank.cycles, min=0.001)
    times = state.times + (dt * params.playback_rate)[..., None]
    times = torch.where(params.loop[..., None], torch.remainder(times, cycles),
                        torch.minimum(times, cycles))

    # blend bookkeeping (ProceduralPoseSystem.swift:58-75)
    is_idle = state.state == IDLE
    half_life = torch.clamp(params.idle_inertia_half_life, min=0.001)
    inertia_decayed = state.idle_inertia * torch.pow(0.5, dt / half_life)
    idle_done = inertia_decayed <= 0.001
    blend_dur = torch.clamp(params.blend_time, min=0.001)
    bt_next = torch.clamp(state.blend_t + dt / blend_dur, max=1.0)
    blend_t = torch.where(
        state.is_blending,
        torch.where(is_idle, torch.where(idle_done, 1.0, state.blend_t),
                    bt_next),
        state.blend_t)
    idle_inertia = torch.where(state.is_blending & is_idle,
                               torch.where(idle_done, 0.0, inertia_decayed),
                               state.idle_inertia)
    is_blending = state.is_blending & torch.where(is_idle, ~idle_done,
                                                  bt_next < 1.0)

    phases = torch.clamp(times / cycles, 0.0, 1.0)          # (N, 4)
    pose_phase = _pick(phases, state.state)

    # weightTo (:101-111) from the updated blend values
    w_idle = 1.0 - torch.clamp(idle_inertia, 0.0, 1.0)
    w_timed = m3.smootherstep01(torch.clamp(blend_t, 0.0, 1.0))
    weight_to = torch.where(is_blending, torch.where(is_idle, w_idle, w_timed),
                            1.0)
    # runWeight (:112-124)
    is_run = state.state == RUN
    run_weight = torch.where(
        is_blending,
        torch.where(is_run, weight_to,
                    torch.where(state.from_state == RUN, 1.0 - weight_to,
                                0.0)),
        torch.where(is_run, 1.0, 0.0))

    from_eff = torch.where(is_blending, state.from_state, state.state).long()
    to_eff = state.state.long()
    t_from, q_from = _sample_tq(
        bank.coeffs[from_eff], bank.has_channel[from_eff],
        _pick(phases, from_eff), order, skel, unit_scale, params.in_place)
    t_to, q_to = _sample_tq(
        bank.coeffs[to_eff], bank.has_channel[to_eff], _pick(phases, to_eff),
        order, skel, unit_scale, params.in_place)

    t = t_from + (t_to - t_from) * weight_to[:, None, None]
    q = m3.quat_slerp(q_from, q_to, weight_to[:, None])

    # the root's yaw-stable slerp while blending (:206-218): the from
    # root's yaw (quat_act(q, e_z) is the matrix's z column) is kept, only
    # the pitch/roll remainder is slerped
    z_axis = m3.quat_act(q_from[:, 0], constant([0.0, 0.0, 1.0], dev))
    yaw = torch.atan2(z_axis[:, 0], z_axis[:, 2])
    yaw_q = m3.quat_from_axis_angle(yaw, constant([0.0, 1.0, 0.0], dev))
    yaw_q_inv = m3.quat_conj(yaw_q)
    pr = m3.quat_slerp(m3.quat_mul(yaw_q_inv, q_from[:, 0]),
                       m3.quat_mul(yaw_q_inv, q_to[:, 0]), weight_to)
    root = torch.where(is_blending[:, None], m3.quat_mul(yaw_q, pr), q[:, 0])
    q = _rows(q, 0, root)

    new_state = LocoState(state=state.state, from_state=state.from_state,
                          times=times, blend_t=blend_t,
                          idle_inertia=idle_inertia, is_blending=is_blending)
    return t, q, pose_phase, run_weight, new_state


def single_profile_pose_tq(coeffs, has_channel, cycle, time,
                           params: LocoParams, skel: SkeletonArrays,
                           order: int, unit_scale: float, dt: float):
    """Single-clip playback (ProceduralPoseSystem.swift:224-276).
    -> (t, q, phase, new_time)."""
    cycle = torch.clamp(cycle, min=0.001)
    time = time + dt * params.playback_rate
    time = torch.where(params.loop, torch.remainder(time, cycle),
                       torch.minimum(time, cycle))
    phase = torch.clamp(time / cycle, 0.0, 1.0)
    t, q = _sample_tq(coeffs, has_channel, phase, order, skel, unit_scale,
                      params.in_place)
    return t, q, phase, time


def apply_action_layer(t, q, run_lean_weight, action: ActionProfile,
                       astate: ActionState, skel: SkeletonArrays, order: int,
                       unit_scale: float):
    """A one-shot action clip over the base pose (ProceduralPoseSystem.swift:
    286-338): translations lerped and rotations slerped by the action
    weight; the lean weight attenuated by 1 - w."""
    phase = torch.clamp(astate.time / torch.clamp(action.cycle, min=0.001),
                        0.0, 1.0)
    t_a, q_a = _sample_tq(action.coeffs, action.has_channel, phase, order,
                          skel, unit_scale, action.in_place)
    apply = astate.active & (astate.weight > 0.001)
    w = torch.where(apply, torch.clamp(astate.weight, 0.0, 1.0), 0.0)
    t_out = t + (t_a - t) * w[:, None, None]
    q_out = m3.quat_slerp(q, q_a, w[:, None])
    return t_out, q_out, run_lean_weight * (1.0 - w)


class PoseEngine:
    """The pose pipeline of one skeleton: its tensors on ``device`` (the
    card unless the caller names another; raises where CUDA is asked for
    and absent), the static FK plan and semantic bone indices."""

    def __init__(self, skeleton: Skeleton, device="cuda"):
        self.skeleton = skeleton
        self.device = resolve_device(device)
        self.unit_scale = float(skeleton.unit_scale)
        self.fk = FKSolver(skeleton.parent, skeleton.levels, self.device)
        pre_q = np.stack([nputil.quat_from_mat(m) for m in skeleton.pre_rot])

        def tt(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.arrays = SkeletonArrays(
            inv_bind_model=tt(skeleton.inv_bind_model),
            rest_translation=tt(skeleton.rest_translation),
            raw_rest_translation=tt(skeleton.raw_rest_translation),
            pre_rot_quat=tt(pre_q))
        self.pelvis: Optional[int] = skeleton.semantic.get("pelvis")
        # the lean bone's fallback chain (ProceduralPoseSystem.swift:371-374)
        self.lean_index: Optional[int] = None
        for key in ("chest", "spine3", "spine2", "spine1"):
            if key in skeleton.semantic:
                self.lean_index = skeleton.semantic[key]
                break
        self.parent_np = np.asarray(skeleton.parent, np.int32)
        self.order: Optional[int] = None

    def to(self, device) -> "PoseEngine":
        """The same engine with its tensors on ``device``."""
        out = PoseEngine(self.skeleton, device)
        out.order = self.order
        return out

    def make_bank(self, idle: PackedMotionProfile, walk: PackedMotionProfile,
                  run: PackedMotionProfile,
                  fall: PackedMotionProfile) -> ProfileBank:
        profs = [idle, walk, run, fall]
        order = profs[0].order
        if any(p.order != order for p in profs):
            raise ValueError("profile order mismatch")
        self.order = order
        dev = self.device
        return ProfileBank(
            coeffs=torch.as_tensor(np.stack([p.coeffs for p in profs]),
                                   device=dev),
            has_channel=torch.as_tensor(
                np.stack([p.has_channel for p in profs]), device=dev),
            cycles=torch.as_tensor(np.array([p.cycle for p in profs],
                                            np.float32), device=dev))

    def make_action(self, packed: PackedMotionProfile,
                    in_place=True) -> ActionProfile:
        dev = self.device
        return ActionProfile(
            coeffs=torch.as_tensor(packed.coeffs, device=dev),
            has_channel=torch.as_tensor(packed.has_channel, device=dev),
            cycle=torch.tensor(np.float32(packed.cycle), device=dev),
            in_place=torch.tensor(bool(in_place), device=dev))

    # -- procedural corrections + FK ------------------------------------

    def finish_pose(self, t, q, run_lean_weight, inputs: PoseInputs):
        """Pelvis ground-align, chest run-lean, FK, palette
        (ProceduralPoseSystem.swift:344-402). -> (local, model, palette)."""
        dev = t.device
        if self.pelvis is not None:
            up = constant([0.0, 1.0, 0.0], dev)
            horiz = inputs.forward * constant([1.0, 0.0, 1.0], dev)
            horiz_ok = (horiz * horiz).sum(-1) > 1e-4
            fwd_h = torch.where(horiz_ok[:, None], m3.normalize(horiz),
                                constant([0.0, 0.0, -1.0], dev))
            right = m3.normalize(m3.cross(up, fwd_h))
            gn = inputs.ground_normal
            n_proj = m3.normalize(gn - right * m3.dot(gn, right)[:, None])
            cross_up = m3.cross(up, n_proj)
            angle = torch.atan2(m3.dot(cross_up, right),
                                m3.dot(up, n_proj)) * 0.33
            angle = torch.where(inputs.grounded_near, angle, 0.0)
            align_q = m3.quat_from_axis_angle(angle, right)
            # a pure rotation M left-multiplied onto T(t) R: t' = M t,
            # q' = qM q
            p = self.pelvis
            t = _rows(t, p, m3.quat_act(align_q, t[:, p]))
            q = _rows(q, p, m3.quat_mul(align_q, q[:, p]))

            if self.lean_index is not None:
                li = self.lean_index
                _, q_model = self.fk.model_tq(t, q)
                # the model matrix's column 0 is quat_act(q_model, e_x)
                right_world = m3.normalize(m3.quat_act(
                    q_model[:, li], constant([1.0, 0.0, 0.0], dev)))
                pi = int(self.parent_np[li])
                right_local = right_world if pi < 0 else m3.quat_act(
                    m3.quat_conj(q_model[:, pi]), right_world)
                lean_q = m3.quat_from_axis_angle(
                    LEAN_RADIANS * run_lean_weight, right_local)
                t = _rows(t, li, m3.quat_act(lean_q, t[:, li]))
                q = _rows(q, li, m3.quat_mul(lean_q, q[:, li]))

        local = compose_tq(t, q)
        model = self.fk.model_matrices(t, q)
        return local, model, palette_from_model(model,
                                                self.arrays.inv_bind_model)

    # -- one step of N characters ---------------------------------------

    def step_character(self, bank: ProfileBank,
                       action: Optional[ActionProfile], loco: LocoState,
                       params: LocoParams, astate: Optional[ActionState],
                       inputs: PoseInputs, dt: float) -> PoseResult:
        """The reference's per-character step, over the leading axis of
        ``loco``, ``params``, ``astate`` and ``inputs`` (N characters)."""
        dt = float(np.float32(dt))
        t, q, phase, run_w, new_loco = locomotion_pose_tq(
            bank, loco, params, self.arrays, self.order, self.unit_scale, dt)
        if action is not None and astate is not None:
            t, q, run_w = apply_action_layer(t, q, run_w, action, astate,
                                             self.arrays, self.order,
                                             self.unit_scale)
        local, model, palette = self.finish_pose(t, q, run_w, inputs)
        return PoseResult(local=local, model=model, palette=palette,
                          phase=phase, loco=new_loco)
