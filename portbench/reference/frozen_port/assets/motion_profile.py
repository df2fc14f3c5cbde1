"""MotionProfile asset: Fourier-fit animation clips.

The port's copy of swift_game_engine_tpu/assets/motion_profile.py (numpy
only). Schema (reference: Game/Animation.swift:11-53, Tools/FitMotion/fit_motion.py
output): ``{version, name, duration, order, sample_fps, phase{mode,
cycle_duration}, units{rotation, translation}, bones{name -> {translation{x,y,z
coeff-lists|null}, rotation{...}}}, contacts{left, right, threshold}?}``.

Each axis holds Fourier coefficients ``[a0, a1, b1, a2, b2, ...]`` evaluated as
``a0 + sum_k a_k cos(2 pi k phase) + b_k sin(2 pi k phase)`` up to ``order``
(reference: Game/Animation.swift:65-78, including its "stop when a dangling
a_k has no matching b_k" rule, which packing reproduces by zeroing the
dangling coefficient).

``pack_profile`` turns the dict-of-dicts into dense per-skeleton arrays so the
whole pose bank evaluates as one (B*6, C) x (C,) product on the device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .skeleton import Skeleton

# Channel layout in packed arrays.
CH_TX, CH_TY, CH_TZ, CH_RX, CH_RY, CH_RZ = range(6)


@dataclass(frozen=True)
class MotionProfile:
    """Parsed (unpacked) profile: bones keyed by name, coeff lists per axis."""

    name: str
    duration: float
    order: int
    sample_fps: int
    bones: dict            # name -> {"translation": {x,y,z}, "rotation": {x,y,z}}
    phase_mode: str = "normalized_time"
    cycle_duration: Optional[float] = None
    rotation_units: str = "degrees"
    translation_units: str = "fbx_local"
    contacts: Optional[dict] = None
    version: int = 1

    @property
    def cycle(self) -> float:
        """Effective cycle length (reference: ProceduralPoseSystem.swift:38-41, 225)."""
        c = self.cycle_duration if self.cycle_duration is not None else self.duration
        return max(float(c), 0.001)


def load_motion_profile(path: str) -> MotionProfile:
    with open(path) as f:
        data = json.load(f)
    phase = data.get("phase") or {}
    units = data.get("units") or {}
    return MotionProfile(
        name=data.get("name", ""),
        duration=float(data["duration"]),
        order=int(data.get("order", 4)),
        sample_fps=int(data.get("sample_fps", 60)),
        bones=data.get("bones", {}),
        phase_mode=phase.get("mode", "normalized_time"),
        cycle_duration=phase.get("cycle_duration"),
        rotation_units=units.get("rotation", "degrees"),
        translation_units=units.get("translation", "fbx_local"),
        contacts=data.get("contacts"),
        version=int(data.get("version", 1)),
    )


def evaluate_fourier(coeffs, phase: float, order: int) -> float:
    """Scalar oracle matching Game/Animation.swift:66-78 exactly."""
    if coeffs is None or len(coeffs) == 0:
        return 0.0
    p = min(max(float(phase), 0.0), 1.0)
    result = np.float32(coeffs[0])
    idx = 1
    for k in range(1, order + 1):
        if idx + 1 >= len(coeffs):
            break
        ang = np.float32(2.0 * np.pi * k * p)
        result = result + np.float32(coeffs[idx]) * np.cos(ang, dtype=np.float32) \
            + np.float32(coeffs[idx + 1]) * np.sin(ang, dtype=np.float32)
        idx += 2
    return float(result)


@dataclass(frozen=True)
class PackedMotionProfile:
    """Dense per-skeleton arrays for device evaluation.

    B = bone count of the target skeleton, C = 2*order+1.
    Channel axis is [tx, ty, tz, rx, ry, rz].
    """

    name: str
    coeffs: np.ndarray        # (B, 6, C) float32, zero where absent
    has_channel: np.ndarray   # (B, 6) bool — absent channels use defaults
    order: int
    duration: float
    cycle: float
    contacts_left: Optional[np.ndarray] = None   # (C,) or None
    contacts_right: Optional[np.ndarray] = None
    contacts_threshold: float = 0.5


def _pack_axis(out, has, b, ch, coeffs, order, c_len):
    if coeffs is None:
        return
    has[b, ch] = True
    arr = np.zeros(c_len, np.float32)
    n = min(len(coeffs), c_len)
    arr[:n] = np.asarray(coeffs[:n], np.float32)
    # Reproduce the evaluator's truncation: a dangling a_k with no b_k is
    # never read (Game/Animation.swift:71-73), so zero it out here.
    if len(coeffs) >= 2 and (len(coeffs) - 1) % 2 == 1:
        dangle = min(len(coeffs), c_len) - 1
        if dangle >= 1 and dangle % 2 == 1:
            arr[dangle] = 0.0
    out[b, ch] = arr


def pack_profile(profile: MotionProfile, skeleton: Skeleton) -> PackedMotionProfile:
    """Bind a profile to a skeleton's bone order as dense arrays."""
    b_count = skeleton.bone_count
    c_len = 2 * profile.order + 1
    coeffs = np.zeros((b_count, 6, c_len), np.float32)
    has = np.zeros((b_count, 6), bool)

    for b, name in enumerate(skeleton.names):
        bone = profile.bones.get(name)
        if bone is None:
            continue
        tr = bone.get("translation") or {}
        rot = bone.get("rotation") or {}
        _pack_axis(coeffs, has, b, CH_TX, tr.get("x"), profile.order, c_len)
        _pack_axis(coeffs, has, b, CH_TY, tr.get("y"), profile.order, c_len)
        _pack_axis(coeffs, has, b, CH_TZ, tr.get("z"), profile.order, c_len)
        _pack_axis(coeffs, has, b, CH_RX, rot.get("x"), profile.order, c_len)
        _pack_axis(coeffs, has, b, CH_RY, rot.get("y"), profile.order, c_len)
        _pack_axis(coeffs, has, b, CH_RZ, rot.get("z"), profile.order, c_len)

    cl = cr = None
    thr = 0.5
    if profile.contacts:
        left = profile.contacts.get("left")
        right = profile.contacts.get("right")
        if left:
            cl = np.asarray(left, np.float32)
        if right:
            cr = np.asarray(right, np.float32)
        thr = float(profile.contacts.get("threshold", 0.5))

    return PackedMotionProfile(
        name=profile.name,
        coeffs=coeffs,
        has_channel=has,
        order=profile.order,
        duration=profile.duration,
        cycle=profile.cycle,
        contacts_left=cl,
        contacts_right=cr,
        contacts_threshold=thr,
    )


def fourier_basis_np(phase, order: int) -> np.ndarray:
    """Host-side basis [1, cos(2pi*1*p), sin(2pi*1*p), ...] with phase clamp."""
    p = np.clip(np.asarray(phase, np.float32), 0.0, 1.0)
    ks = np.arange(1, order + 1, dtype=np.float32)
    ang = 2.0 * np.pi * ks * p[..., None]
    out = np.empty((*p.shape, 2 * order + 1), np.float32)
    out[..., 0] = 1.0
    out[..., 1::2] = np.cos(ang)
    out[..., 2::2] = np.sin(ang)
    return out
