"""Per-substep systems: port of swift_game_engine_tpu/physics/systems.py.

Intent, gravity, jump, dodge, action clock, platform motion, oscillation,
spin and plain-body integration, batched over entities (reference
file:line per function). Each is a pure function of state tensors and dt;
masks stand in for the reference's per-entity component queries.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import math3d as m3


def _y_only(v):
    out = torch.zeros_like(v)
    out[..., 1] = v[..., 1]
    return out


def approach_vec(current, target, max_delta):
    """Move ``current`` toward ``target`` by at most ``max_delta``
    (Systems.swift:410-426)."""
    delta = target - current
    ln = m3.norm(delta)[..., None]
    snap = (ln <= max_delta[..., None]) | (ln < 1e-5)
    step = current + delta / torch.clamp(ln, min=1e-20) * max_delta[..., None]
    return torch.where(snap, target, step)


def physics_intent(velocity, rotation, desired_velocity, desired_yaw,
                   has_yaw, dodge_active, is_controller, max_accel,
                   max_decel, dt, enabled):
    """PhysicsIntentSystem (Systems.swift:205-250) -> (velocity, rotation):
    controllers approach the XZ target, dodges write through, the rest
    approach the full 3D target; a facing yaw sets the rotation."""
    target_xz = m3.xz(desired_velocity)
    current_xz = m3.xz(velocity)
    speeding_up = m3.norm(target_xz) >= m3.norm(current_xz)
    accel = torch.where(speeding_up, max_accel, max_decel)
    v_ctrl = approach_vec(current_xz, target_xz, accel * dt) + _y_only(velocity)
    v_dodge = target_xz + _y_only(velocity)
    speeding3 = m3.norm(desired_velocity) >= m3.norm(velocity)
    accel3 = torch.where(speeding3, max_accel, max_decel)
    v_plain = approach_vec(velocity, desired_velocity, accel3 * dt)

    new_v = torch.where(dodge_active[..., None], v_dodge,
                        torch.where(is_controller[..., None], v_ctrl, v_plain))
    new_v = torch.where(enabled[..., None], new_v, velocity)
    new_rot = torch.where((enabled & has_yaw)[..., None],
                          m3.quat_from_yaw(desired_yaw), rotation)
    return new_v, new_rot


def gravity_step(velocity, grounded, grounded_near, is_dynamic, dt,
                 gravity=(0.0, -98.0, 0.0)):
    """GravitySystem (Systems.swift:596-620): skipped while grounded and
    near the ground. g * dt is rounded to f32, as the reference computes
    it."""
    apply = is_dynamic & ~(grounded & grounded_near)
    g = torch.stack([velocity[..., i] + float(np.float32(gravity[i]) *
                                              np.float32(dt))
                     for i in range(3)], -1)
    return torch.where(apply[..., None], g, velocity)


def jump_step(velocity, grounded, jump_requested, jump_speed: float = 34.0):
    """JumpSystem (Systems.swift:437-469) -> (velocity, grounded,
    jump_requested cleared)."""
    jumped = m3.xz(velocity)
    jumped[..., 1] = jump_speed
    velocity = torch.where((jump_requested & grounded)[..., None], jumped,
                           velocity)
    grounded = grounded & ~jump_requested
    return velocity, grounded, torch.zeros_like(jump_requested)


class DodgeState(NamedTuple):
    """Components.swift:655-682."""

    active: torch.Tensor
    time: torch.Tensor
    duration: torch.Tensor
    distance: torch.Tensor
    start_time: torch.Tensor
    end_time: torch.Tensor
    direction: torch.Tensor   # (...,3)
    facing_yaw: torch.Tensor


def dodge_step(dodge: DodgeState, rotation, dodge_requested, dt):
    """DodgeSystem (Systems.swift:521-592) -> (dodge, overrides): the
    desired velocity and facing while dodging, and ``action_trigger``
    (restart the action clip this substep)."""
    forward = m3.quat_forward(rotation)
    back = m3.normalize(torch.stack([-forward[..., 0],
                                     torch.zeros_like(forward[..., 1]),
                                     -forward[..., 2]], -1))
    yaw = torch.atan2(-forward[..., 0], -forward[..., 2])

    start = dodge_requested & ~dodge.active
    active = dodge.active | start
    time = torch.where(start, torch.zeros_like(dodge.time), dodge.time)
    direction = torch.where(start[..., None], back, dodge.direction)
    facing = torch.where(start, yaw, dodge.facing_yaw)

    time = torch.where(active, time + dt, time)
    duration = torch.clamp(dodge.duration, min=0.001)
    w_start = torch.minimum(torch.clamp(dodge.start_time, min=0.0), duration)
    w_end = torch.minimum(torch.maximum(dodge.end_time, w_start), duration)
    w_len = torch.clamp(w_end - w_start, min=0.001)
    in_window = (time >= w_start) & (time <= w_end)
    t = (time - w_start) / w_len
    t2 = t * t
    vel_frac = 30.0 * t2 * (1.0 - 2.0 * t + t2)  # smootherstep derivative
    speed = torch.where(active & in_window,
                        (dodge.distance / w_len) * vel_frac,
                        torch.zeros_like(t))
    desired_velocity = direction * speed[..., None]

    new_dodge = dodge._replace(active=active & (time < duration), time=time,
                               direction=direction, facing_yaw=facing)
    return new_dodge, dict(apply=active,
                           desired_velocity=m3.xz(desired_velocity),
                           facing_yaw=facing, action_trigger=start)


class ActionClock(NamedTuple):
    """ActionAnimationComponent's dynamic fields (Components.swift:620-653)."""

    active: torch.Tensor
    time: torch.Tensor
    weight: torch.Tensor
    exiting: torch.Tensor


def _at_least(x, lo: float):
    return torch.clamp(x, min=lo) if isinstance(x, torch.Tensor) else \
        max(float(x), lo)


def action_animation_step(clock: ActionClock, cycle, dodge_end_time,
                          has_dodge, dt, playback_rate=1.0, loop: bool = False,
                          blend_in_time=0.08, blend_out_half_life=0.12,
                          trigger=None) -> ActionClock:
    """ActionAnimationSystem (Systems.swift:472-518): the clip clock runs
    to its end (the dodge's end time where the entity dodges), then the
    weight decays and the clip ends; ``trigger`` restarts it (weight ramp
    from 0: DodgeSystem's restart, :551-557). ``loop`` is static; the other
    parameters are numbers or tensors over the entities."""
    if trigger is not None:
        clock = ActionClock(
            active=clock.active | trigger,
            time=torch.where(trigger, 0.0, clock.time),
            weight=torch.where(trigger, 0.0, clock.weight),
            exiting=clock.exiting & ~trigger)
    cycle = torch.clamp(cycle, min=0.001)
    end = torch.where(dodge_end_time > 0, dodge_end_time, cycle)
    cap = torch.where(has_dodge,
                      torch.clamp(torch.minimum(end, cycle), min=0.001), cycle)
    adv = clock.active & ~clock.exiting
    time = torch.where(adv, clock.time + dt * playback_rate, clock.time)
    hit_end = time >= cap
    time = torch.where(adv, torch.remainder(time, cap) if loop else
                       torch.where(hit_end, cap, time), time)
    exiting = clock.exiting if loop else clock.exiting | (adv & hit_end)

    half = _at_least(blend_out_half_life, 0.001)
    decayed = clock.weight * torch.pow(0.5, dt / half)
    w_out = torch.where(decayed <= 0.001, 0.0, decayed)
    done = clock.active & exiting & (decayed <= 0.001)
    blend_in = _at_least(blend_in_time, 0.001)
    w_in = torch.clamp(clock.weight + dt / blend_in, max=1.0)
    weight = torch.where(clock.active, torch.where(exiting, w_out, w_in),
                         clock.weight)
    return ActionClock(active=clock.active & ~done, time=time, weight=weight,
                       exiting=exiting & ~done)


def kinematic_platform_motion(origin, axis, amplitude, speed, phase, time,
                              dt, enabled):
    """KinematicPlatformMotionSystem (Systems.swift:122-154) ->
    (time, position)."""
    axis_len = m3.norm(axis)[..., None]
    up = torch.zeros_like(axis)
    up[..., 1] = 1.0
    axis_n = torch.where(axis_len > 1e-4,
                         axis / torch.clamp(axis_len, min=1e-20), up)
    time = torch.where(enabled, time + dt, time)
    offset = torch.sin(time * speed + phase) * amplitude
    return time, origin + axis_n * offset[..., None]


def oscillate_move(axis, amplitude, speed, time, dt, enabled):
    """OscillateMoveSystem (Systems.swift:253-273) -> (time, desired XZ
    velocity)."""
    axis_len = m3.norm(axis)[..., None]
    x = torch.zeros_like(axis)
    x[..., 0] = 1.0
    axis_n = torch.where(axis_len > 1e-5,
                         axis / torch.clamp(axis_len, min=1e-20), x)
    time = torch.where(enabled, time + dt, time)
    vel = axis_n * (torch.cos(time * speed) * amplitude * speed)[..., None]
    return time, m3.xz(vel)


def spin_step(rotation, speed, axis, dt):
    """SpinSystem quaternion integration (Systems.swift:97-119)."""
    dq = m3.quat_from_axis_angle(speed * dt, m3.normalize(axis))
    return m3.quat_normalize(m3.quat_mul(dq, rotation))


def integrate_bodies(position, rotation, linear_velocity, angular_velocity,
                     do, dt):
    """PhysicsIntegrateSystem (Systems.swift:2213-2246): Euler for the
    bodies in ``do``."""
    position = torch.where(do[..., None], position + linear_velocity * dt,
                           position)
    w_len = m3.norm(angular_velocity)
    spin = do & (w_len > 1e-4)
    axis = angular_velocity / torch.clamp(w_len[..., None], min=1e-20)
    dq = m3.quat_from_axis_angle(w_len * dt, axis)
    rotation = torch.where(spin[..., None],
                           m3.quat_normalize(m3.quat_mul(dq, rotation)),
                           rotation)
    return position, rotation
