"""Locomotion tuning: the part of swift_game_engine_tpu/anim/locomotion.py
that the world builder stages (anim/locomotion.py:22-39).

The state machine (``locomotion_fsm_step``) waits for M4b with the pose
engine: it reads the motion profiles' cycles, which are not in the
repository.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LocomotionTuning(NamedTuple):
    """Per-character FSM thresholds (Components.swift:230-293)."""

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
