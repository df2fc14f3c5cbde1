"""Engine: the host frame loop — port of swift_game_engine_tpu/scene/engine.py.

``frame(dt, pad)`` follows the reference's fused frame
(scene/engine.py:385-459, at ``pipeline_depth=1``) step for step: dt clamp
<= 0.1, time advance (scaled and unscaled) and the fixed-step accumulator
(<= ``MAX_SUBSTEPS`` substeps, reset at the cap), the player's intent
written into its WorldState row (jump and dodge OR-ed in), the chase
camera from the previous frame's player snapshot interpolated by
``alpha``, the substeps (``Stepper.substep``), render extraction
(``Stepper.extract``: camera-relative instance transforms), ``flatten_frame``,
the frame at the RT target size, the bilinear upscale to the drawable,
``composite_frame``, u8 quantisation, the FPS overlay, and the player
snapshot the next frame's camera reads (prev and current world position
and the dodge flag: one 7-float read a frame). The frame is the
reference's ``path``
(scene/engine.py:143-177,226-237):

  * ``"rt"``: the RT ``render_frame`` (``primary="hybrid"`` or
    ``"trace"``) with its mirror and refraction bounces;
  * ``"raster_pbr"``: the same RT frame with both bounces off;
  * ``"raster"``: ``render_frame_raster`` (2 layers, ``raster_mode``
    "clusters" or "lists"), which tone-maps per material: no composite.

The RT target is ``rt_resolution_scale`` times the drawable (at least 0.25,
Renderer.swift:175); ``set_rt_resolution_scale`` changes it between frames
(Renderer.swift:232-258). The reference compiles one frame program per RT
size and caches them; PyTorch runs eagerly, so the port needs no program
cache and a new scale takes effect on the next frame.

A world with a ``stepper`` starts at ``time_scale = 1.0``, as the
reference does. A render-only world (no stepper: fixed ``transforms``)
starts paused (``time_scale = 0``): the accumulator receives scaled time
and never asks for a substep, while the camera, input and overlay run on
unscaled time; if it does ask (a time_scale above 0), ``frame`` raises
rather than skip the substep. ``save_state`` / ``load_state`` keep the
world state (and the accumulator and time) in one ``.npz``.
``pipeline_depth`` (frames in flight) is not ported (ROADMAP M5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..render.camera import Camera
from ..render.composite import FPSOverlay, composite_frame, overlay_blit_device
from ..render.ibl import IBL
from ..render import rt as RT
from ..render.raster import RASTER_MODES, render_frame_raster
from ..ecs.world import chunk_local_to_world
from ..render.scene_geometry import flatten_frame
from .input import InputFrame, InputSystem

FIXED_DT = 1.0 / 60.0
MAX_SUBSTEPS = 4
PATHS = ("rt", "raster", "raster_pbr")


def _leaves(state):
    """The tensors of a NamedTuple of tensors (nested), in field order."""
    out = []
    for x in state:
        out.extend(_leaves(x) if isinstance(x, tuple) else [x])
    return out


def _rebuild(like, leaves):
    """``like``'s structure filled from the iterator ``leaves``."""
    return type(like)(*(_rebuild(x, leaves) if isinstance(x, tuple)
                        else next(leaves) for x in like))


def save_world_state(path: str, state, **scalars):
    """Checkpoint a WorldState (+ host scalars) to one .npz."""
    np.savez(path, *[x.cpu().numpy() for x in _leaves(state)], **scalars)


def load_world_state(path: str, like_state):
    """Restore a WorldState saved by save_world_state onto ``like_state``'s
    device and structure -> (state, the npz data for the scalars)."""
    data = np.load(path)
    like = _leaves(like_state)
    it = iter(torch.as_tensor(data[f"arr_{i}"], device=x.device)
              for i, x in enumerate(like))
    return _rebuild(like_state, it), data


def apply_intent(state, e: int, intent: dict):
    """Entity ``e``'s MoveIntent (InputSystem.update's dict) written into
    the state: velocity, yaw and the yaw flag replaced, jump and dodge
    OR-ed in. Each value is a fill of a one-element slice: assigning to a
    single element of a CUDA tensor from a Python number copies it from
    the host and syncs."""
    r = slice(e, e + 1)
    vel = state.intent_vel.clone()
    for i, v in enumerate(np.asarray(intent["desired_velocity"], np.float32)):
        vel[r, i] = float(v)
    yaw = state.intent_yaw.clone()
    yaw[r] = float(np.float32(intent["facing_yaw"]))
    has_yaw = state.intent_has_yaw.clone()
    has_yaw[r] = bool(intent["has_facing_yaw"])
    jump, dodge = state.intent_jump, state.intent_dodge
    if intent["jump_requested"]:
        jump = jump.clone()
        jump[r] = True
    if intent["dodge_requested"]:
        dodge = dodge.clone()
        dodge[r] = True
    return state._replace(intent_vel=vel, intent_yaw=yaw,
                          intent_has_yaw=has_yaw, intent_jump=jump,
                          intent_dodge=dodge)


class Engine:
    def __init__(self, scene, width: int = 640, height: int = 360,
                 path: str = "rt", rt_resolution_scale: float = 1.0,
                 max_layers: int = 3, shadow_layers: int = 4,
                 primary: str = "hybrid", raster_mode: str = "clusters",
                 layered: bool = True, shadow_prepass: bool = False,
                 device="cuda"):
        """``scene``: a scene.demo_scene.DemoWorld (or anything with its
        fields: geometry, transforms, palettes, lights, player_position,
        movement, and for a simulated world stepper, state, player) on
        ``device`` (the card unless asked otherwise).
        ``path``: "rt", "raster" or "raster_pbr" (see the module docstring).
        ``primary``, ``layered``, ``shadow_prepass``, ``max_layers`` and
        ``shadow_layers`` go to the RT frame (paths "rt", "raster_pbr"),
        ``raster_mode`` to the raster frame; each keeps the reference's
        default."""
        if path not in PATHS:
            raise ValueError(f"path must be one of {PATHS}, got {path!r}")
        if primary not in RT.PRIMARY_MODES:
            raise ValueError(f"primary must be one of {RT.PRIMARY_MODES}, "
                             f"got {primary!r}")
        if raster_mode not in RASTER_MODES:
            raise ValueError(f"raster_mode must be one of {RASTER_MODES}, "
                             f"got {raster_mode!r}")
        self.device = resolve_device(device)
        self.geometry = scene.geometry
        self.lights = scene.lights
        self.transforms = scene.transforms
        self.palettes = scene.palettes
        self.player_position = np.asarray(scene.player_position, np.float64)
        self.movement = scene.movement
        self.stepper = getattr(scene, "stepper", None)
        self.state = getattr(scene, "state", None)
        self.player = getattr(scene, "player", None)
        self.width, self.height = width, height
        self.path = path
        self.primary = primary
        self.raster_mode = raster_mode
        self.layered, self.shadow_prepass = layered, shadow_prepass
        self.max_layers, self.shadow_layers = max_layers, shadow_layers
        self.set_rt_resolution_scale(rt_resolution_scale)
        self.camera = Camera()
        self.input = InputSystem()
        self.ibl = IBL.build(self.device)
        self.overlay = FPSOverlay()
        self.accumulator = 0.0
        self.time = 0.0
        self.unscaled_time = 0.0
        # a render-only world is paused: it has nothing to step
        self.time_scale = 1.0 if self.stepper is not None else 0.0
        self.delta_time = 0.0
        self.unscaled_delta_time = 0.0
        self.frame_index = 0
        self.tone_mapping_exposure = 1.0
        self.intent = None      # the last frame's player MoveIntent
        self.substeps = 0       # substeps of the last frame
        self._snap = None       # the last frame's player snapshot (7,)
        self._dodge_active = False

    def set_rt_resolution_scale(self, scale: float):
        """rtResolutionScale (Renderer.swift:175,232-258): the RT target is
        (int(width * s), int(height * s)) with s >= 0.25."""
        self.rt_scale = max(float(scale), 0.25)
        self.rt_size = (max(int(self.width * self.rt_scale), 1),
                        max(int(self.height * self.rt_scale), 1))

    def _upscale(self, img):
        """RT target -> drawable, bilinear (engine.py:132-141): the
        reference's ``jax.image.resize(..., "bilinear")`` is half-pixel
        bilinear with renormalised edge weights, antialiased when it
        shrinks — ``F.interpolate(bilinear, align_corners=False)``, with
        ``antialias`` for s > 1."""
        if self.rt_size == (self.width, self.height):
            return img
        out = F.interpolate(img.permute(2, 0, 1)[None],
                            size=(self.height, self.width), mode="bilinear",
                            align_corners=False,
                            antialias=self.rt_scale > 1.0)
        return out[0].permute(1, 2, 0)

    def _advance_time(self, dt: float) -> float:
        """TimeSystem.update: returns the SCALED dt for the accumulator."""
        sdt = dt * self.time_scale
        self.unscaled_delta_time = dt
        self.delta_time = sdt
        self.unscaled_time += dt
        self.time += sdt
        self.frame_index += 1
        return sdt

    def _apply_exposure_input(self, dt: float):
        """DemoScene.swift:700-703: exposure += delta * dt in [0.1, 2.0]."""
        delta = self.input.exposure_delta
        if delta:
            self.tone_mapping_exposure = min(
                max(self.tone_mapping_exposure + delta * dt, 0.1), 2.0)

    def render(self, fg, ivp, vp) -> torch.Tensor:
        """The RT-target-size linear frame of ``self.path`` from the frame
        geometry ``fg`` and the camera's (inverse) view-projection at the RT
        size (scene/engine.py:155-169)."""
        rw, rh = self.rt_size
        if self.path == "raster":
            return render_frame_raster(
                self.geometry, fg, ivp, self.camera.position, rw, rh,
                view_proj=vp, raster_mode=self.raster_mode)
        bounce = self.path == "rt"
        return RT.render_frame(
            self.geometry, fg, self.ibl, self.lights, ivp,
            self.camera.position, rw, rh, max_layers=self.max_layers,
            shadow_layers=self.shadow_layers, view_proj=vp,
            enable_mirror=bounce, enable_refraction=bounce,
            primary=self.primary, layered=self.layered,
            shadow_prepass=self.shadow_prepass)

    def present(self, img) -> torch.Tensor:
        """RT-target frame -> drawable-size u8: the upscale, the composite
        where the path has one (not "raster", which tone-maps per
        material), u8 quantisation (scene/engine.py:226-238)."""
        img = self._upscale(img)
        if self.path != "raster":
            img = composite_frame(img, self.tone_mapping_exposure, True)
        return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)

    def _player_snapshot(self) -> np.ndarray:
        """The player's previous and current world position and its dodge
        flag (7 floats), read to the host."""
        st, e = self.state, self.player
        prev = chunk_local_to_world(st.wp_prev_chunk[e], st.wp_prev_local[e])
        curr = chunk_local_to_world(st.wp_chunk[e], st.wp_local[e])
        return torch.cat([prev, curr, st.dodge.active[e, None].float()]) \
            .cpu().numpy()

    def extract(self, alpha: float):
        """Camera-relative instance transforms and the palettes of the
        current state (render-only world: the fixed transforms rebased)."""
        cam_world = self.camera.world_position.astype(np.float32)
        if self.stepper is not None:
            return self.stepper.extract(self.state, alpha, cam_world)
        transforms = self.transforms.clone()
        transforms[:, :3, 3] -= torch.as_tensor(cam_world, device=self.device)
        return transforms, self.palettes

    def save_state(self, path: str):
        save_world_state(path, self.state, accumulator=self.accumulator,
                         time=self.time)

    def load_state(self, path: str):
        self.state, data = load_world_state(path, self.state)
        self.accumulator = float(data["accumulator"])
        self.time = float(data["time"])
        self._snap = None

    def frame(self, dt: float, pad: Optional[InputFrame] = None,
              with_overlay: bool = True) -> torch.Tensor:
        """One frame -> (H, W, 3) uint8 tensor on the engine's device."""
        dt = min(max(dt, 0.0), 0.1)  # Renderer.swift:161-163
        sdt = self._advance_time(dt)
        walk, run, thresh = self.movement
        self.intent = self.input.update(pad or InputFrame(), dt,
                                        self._dodge_active, walk, run, thresh)
        self._apply_exposure_input(dt)

        self.accumulator += sdt
        n = 0
        while self.accumulator >= FIXED_DT and n < MAX_SUBSTEPS:
            self.accumulator -= FIXED_DT
            n += 1
        if n == MAX_SUBSTEPS and self.accumulator >= FIXED_DT:
            self.accumulator = 0.0
        if n and self.stepper is None:
            raise NotImplementedError(
                "a render-only world (no stepper) cannot take a substep")
        alpha = min(max(self.accumulator / FIXED_DT, 0.0), 1.0)
        self.substeps = n

        # Chase camera from the previous frame's player snapshot (the
        # reference's one-frame lag); a render-only world's player stands
        # at its fixed position.
        if self.stepper is None:
            player = self.player_position
        else:
            if self._snap is None:
                self._snap = self._player_snapshot()
            snap = self._snap
            player = snap[0:3] + (snap[3:6] - snap[0:3]) * alpha
        self.input.update_camera(self.camera, player)
        rw, rh = self.rt_size
        ivp = self.camera.inv_view_proj(rw, rh)
        vp = self.camera.view_proj(rw, rh)
        fps = self.overlay.update(dt) if with_overlay else -1

        if self.stepper is not None:
            self.state = apply_intent(self.state, self.player, self.intent)
            for _ in range(n):
                self.state = self.stepper.substep(self.state, FIXED_DT)
        transforms, palettes = self.extract(alpha)
        fg = flatten_frame(self.geometry, transforms, palettes)
        dev = self.device
        u8 = self.present(self.render(fg, torch.as_tensor(ivp, device=dev),
                                      torch.as_tensor(vp, device=dev)))
        u8 = overlay_blit_device(u8, fps)
        if self.stepper is not None:
            self._snap = self._player_snapshot()
            self._dodge_active = bool(self._snap[6] > 0.5)
        return u8
