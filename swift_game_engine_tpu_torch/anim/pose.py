"""Pose state types: the part of swift_game_engine_tpu/anim/pose.py that the
world state holds (anim/pose.py:51-107).

``PoseEngine``, the profile bank, the action layer and FK wait for M4b
(the YBot skeleton and motion profiles are not in the repository); until
then a world carries these clocks and no system advances them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Locomotion states (Components.swift:223-228).
IDLE, WALK, RUN, FALLING = 0, 1, 2, 3


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


class ActionState(NamedTuple):
    """Action clip playback state (Components.swift:620-653)."""

    time: torch.Tensor
    weight: torch.Tensor
    active: torch.Tensor               # bool
