"""Engine: the host frame loop — port of swift_game_engine_tpu/scene/engine.py.

``frame(dt, pad)`` follows the reference's fused frame
(scene/engine.py:385-459) step for step: dt clamp <= 0.1, time advance
(scaled and unscaled) and the fixed-step accumulator, player intent and
exposure input, the chase camera, the camera-relative rebase of the
instance transforms (scene/step.py:387), ``flatten_frame``, the frame at
the RT target size, the bilinear upscale to the drawable, ``composite_frame``,
u8 quantisation and the FPS overlay. The frame is the reference's ``path``
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

The fixed-step simulation is not ported yet, so the Engine starts paused
(``time_scale = 0``): the accumulator receives scaled time and never asks
for a substep, while the camera, input and overlay run on unscaled time.
If it does ask (a time_scale above 0), ``frame`` raises instead of skipping
the substep.
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
from ..render.scene_geometry import flatten_frame
from .input import InputFrame, InputSystem

FIXED_DT = 1.0 / 60.0
MAX_SUBSTEPS = 4
PATHS = ("rt", "raster", "raster_pbr")


class Engine:
    def __init__(self, scene, width: int = 640, height: int = 360,
                 path: str = "rt", rt_resolution_scale: float = 1.0,
                 max_layers: int = 3, shadow_layers: int = 4,
                 primary: str = "hybrid", raster_mode: str = "clusters",
                 layered: bool = True, shadow_prepass: bool = False,
                 device="cuda"):
        """``scene``: a scene.demo_scene.DemoWorld (or anything with its
        fields: geometry, transforms, palettes, lights, player_position,
        movement) on ``device`` (the card unless asked otherwise).
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
        self.time_scale = 0.0   # paused: no fixed-step simulation yet
        self.delta_time = 0.0
        self.unscaled_delta_time = 0.0
        self.frame_index = 0
        self.tone_mapping_exposure = 1.0
        self.intent = None      # the last frame's player MoveIntent

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

    def frame(self, dt: float, pad: Optional[InputFrame] = None,
              with_overlay: bool = True) -> torch.Tensor:
        """One frame -> (H, W, 3) uint8 tensor on the engine's device."""
        dt = min(max(dt, 0.0), 0.1)  # Renderer.swift:161-163
        sdt = self._advance_time(dt)
        walk, run, thresh = self.movement
        self.intent = self.input.update(pad or InputFrame(), dt, False, walk,
                                        run, thresh)
        self._apply_exposure_input(dt)

        self.accumulator += sdt
        if self.accumulator >= FIXED_DT:
            raise NotImplementedError("fixed-step simulation is not ported yet")
        # Chase camera. The reference interpolates the player between the
        # previous and current snapshots by accumulator / FIXED_DT; with no
        # stepper the two agree, so the interpolant is the player position.
        self.input.update_camera(self.camera, self.player_position)
        rw, rh = self.rt_size
        ivp = self.camera.inv_view_proj(rw, rh)
        vp = self.camera.view_proj(rw, rh)
        cam_world = self.camera.world_position.astype(np.float32)
        fps = self.overlay.update(dt) if with_overlay else -1

        dev = self.device
        transforms = self.transforms.clone()
        transforms[:, :3, 3] -= torch.as_tensor(cam_world, device=dev)
        fg = flatten_frame(self.geometry, transforms, self.palettes)
        u8 = self.present(self.render(fg, torch.as_tensor(ivp, device=dev),
                                      torch.as_tensor(vp, device=dev)))
        return overlay_blit_device(u8, fps)
