"""Locomotion state machine: port of swift_game_engine_tpu/anim/
locomotion.py (reference: Game/Systems.swift:276-408
LocomotionProfileSystem).

Idle/walk/run/falling with enter/exit hysteresis speeds; airborne ->
falling only from a high enough drop or when already falling; on any state
change the new clip's clock is phase-aligned (toTime = fromPhase *
toCycle), a blend starts (blendT = 0) and entering idle arms the
idle-inertia blend. Branch-free over the entity axis: one update a fixed
substep, before the pose stack (scene/step.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import math3d as m3
from .pose import FALLING, IDLE, RUN, WALK, LocoState, ProfileBank


class LocomotionTuning(NamedTuple):
    """Per-character FSM thresholds (Components.swift:230-293); numpy (E,)
    in a SceneSpec, tensors in the FSM."""

    idle_enter_speed: np.ndarray      # default 0.15
    idle_exit_speed: np.ndarray       # default 0.25
    run_enter_speed: np.ndarray       # default 6.0
    run_exit_speed: np.ndarray        # default 5.0
    fall_min_drop_height: np.ndarray  # default 10.0

    @staticmethod
    def default(batch_shape=()):
        def f(v):
            return np.full(batch_shape, v, np.float32)
        return LocomotionTuning(
            idle_enter_speed=f(0.15), idle_exit_speed=f(0.25),
            run_enter_speed=f(6.0), run_exit_speed=f(5.0),
            fall_min_drop_height=f(10.0))


def _state(cond, a, b):
    """torch.where over int32 states (``a``, ``b``: ints or tensors)."""
    return torch.where(cond, a, b).to(torch.int32)


def _grounded_next_state(current, speed, tune: LocomotionTuning):
    """Systems.swift:297-324: the next state of a grounded character."""
    grounded = _state(current == FALLING, IDLE, current)
    from_idle = _state(speed >= tune.run_enter_speed, RUN,
                       _state(speed >= tune.idle_exit_speed, WALK, IDLE))
    from_walk = _state(speed >= tune.run_enter_speed, RUN,
                       _state(speed < tune.idle_enter_speed, IDLE, WALK))
    from_run = _state(speed < tune.run_exit_speed,
                      _state(speed < tune.idle_enter_speed, IDLE, WALK), RUN)
    return _state(grounded == IDLE, from_idle,
                  _state(grounded == WALK, from_walk, from_run))


def locomotion_fsm_step(state: LocoState, bank: ProfileBank,
                        tune: LocomotionTuning, velocity, grounded_near,
                        ground_distance) -> LocoState:
    """One FSM update. ``tune``'s fields are tensors (E,); ``velocity``
    (E, 3) the body's, ``grounded_near`` (E,) the controller's,
    ``ground_distance`` (E,) its fall probe."""
    speed = m3.norm(m3.xz(velocity))
    grounded_next = _grounded_next_state(state.state, speed, tune)
    high_fall = ground_distance >= tune.fall_min_drop_height
    falling_next = _state((state.state == FALLING) | high_fall, FALLING,
                          grounded_next)
    next_state = _state(~grounded_near, falling_next, grounded_next)
    changed = next_state != state.state

    # phase alignment: the old clip's normalized phase carried to the new
    # clip's clock (Systems.swift:350-383)
    cycles = torch.clamp(bank.cycles, min=0.001)
    cur, nxt = state.state.long(), next_state.long()
    from_time = torch.gather(state.times, -1, cur[..., None])[..., 0]
    from_phase = torch.clamp(from_time / cycles[cur], 0.0, 1.0)
    new_time = from_phase * cycles[nxt]
    slot = torch.arange(4, device=cur.device) == nxt[..., None]
    times = torch.where(changed[..., None] & slot, new_time[..., None],
                        state.times)
    return LocoState(
        state=next_state,
        from_state=_state(changed, state.state, state.from_state),
        times=times,
        blend_t=torch.where(changed, 0.0, state.blend_t),
        idle_inertia=torch.where(changed & (next_state == IDLE), 1.0,
                                 state.idle_inertia),
        is_blending=state.is_blending | changed)
