"""Engine: the host frame loop — port of swift_game_engine_tpu/scene/engine.py.

``frame(dt, pad)`` follows the reference's fused frame
(scene/engine.py:198-262, 385-459) step for step: dt clamp <= 0.1, time
advance (scaled and unscaled) and the fixed-step accumulator (<=
``MAX_SUBSTEPS`` substeps, reset at the cap), the player's intent written
into its WorldState row (jump and dodge OR-ed in), the chase camera from
the player snapshot of the last completed frame interpolated by ``alpha``,
the substeps, then the frame program: render extraction
(``Stepper.extract``: camera-relative instance transforms) and the render
graph (``render/graph.py``), whose "rt" pass runs ``flatten_frame``, the
frame at the RT target size (``render_target``) and the bilinear upscale
to the drawable, and whose "composite" pass runs ``composite_frame``
(scene/engine.py:173-196); then u8 quantisation, the FPS overlay, and the
player snapshot the next frames' camera reads (prev and current world
position and the dodge flag: 7 floats). ``update(dt, pad)`` and
``render(alpha)`` are the reference's split of the same frame
(scene/engine.py:324-370): ``update`` takes the substeps and reads the
current player snapshot for the camera, ``render`` returns the float view.

The frame program reads the frame's values from one input buffer on the
device (``FRAME_INPUTS``: alpha, the camera's world position, the
(inverse) view-projection at the RT size, the camera position, exposure and
fps, -1 without the overlay), written each frame by one non-blocking copy
from pinned host memory (the caching host allocator hands a pinned block
out again only once the copy that read it has run, so frames in flight
never share one). On the card the program is one CUDA graph per RT size
(the reference's ``_program_cache``), captured at the first frame of that
size (``cuda_graph.capture``; ``programs`` holds them): a frame is its
substep replays, the input copy and one replay, with no host read from the
end of the substeps to the snapshot's copy. Every value the capture bakes
in is fixed for the Engine and the RT size (the RT size, the path, the
layer counts, the shadow mode, which the lane count and the tree fix, K5's
threads a ray); the rest comes from the buffer. A capture that fails
raises; for CPU tensors the same program runs eagerly.

The world state lives in buffers the Engine owns (``state``: a clone of
its world's state, so Engines built on one world step independently). On
the card they are the buffers of a ``SubstepGraph``: every substep is one
replay of a CUDA graph of ``Stepper._substep_impl`` (the reference's
``fori_loop`` over it inside ``_fused``), and the eager substep runs only
for CPU tensors. ``apply_intent`` and ``load_state`` write into the
buffers in place.

``pipeline_depth`` keeps that many frames in flight (scene/engine.py:51-61,
440-459): each frame starts its player snapshot's copy to the host
(pinned, non-blocking) and records an event; ``frame`` returns the oldest
frame once ``pipeline_depth`` are queued (zero frames before), and the
chase camera reads that frame's snapshot, ``pipeline_depth - 1`` frames
older than the last. Its image is the (H, W, 3) uint8 tensor on the
engine's device at every depth; at depth 1 each frame waits for its own
snapshot. ``set_rt_resolution_scale`` and ``load_state`` drop the frames
in flight and the snapshot.

The frame is the reference's ``path`` (scene/engine.py:143-177,226-237):

  * ``"rt"``: the RT ``render_frame`` (``primary`` "hybrid", "trace",
    "raster" or "peels") with its mirror and refraction bounces;
  * ``"raster_pbr"``: the same RT frame with both bounces off;
  * ``"raster"``: ``render_frame_raster`` (2 layers, ``raster_mode``
    "clusters" or "lists", ``raster_vis`` "tile" or "trace"), which
    tone-maps per material: no composite.

The reference's render schedules and knob paths are keyword arguments
with its defaults (never environment reads): ``deferred``,
``shadow_sort``, ``shadow_sort_mode``, ``lbatch``, ``layer_slots``,
``trans_subdiv``, ``unlit_fast``, ``unlit_split``, ``unlit_dense`` and
``packet_compact`` go to the RT frame, ``raster_vis`` to the raster frame;
the frame program bakes them in.

The RT target is ``rt_resolution_scale`` times the drawable (at least 0.25,
Renderer.swift:175); ``set_rt_resolution_scale`` changes it between frames
(Renderer.swift:232-258): the next frame takes the size's program, captured
then if the size is new.

A world with a ``stepper`` starts at ``time_scale = 1.0``, as the
reference does. A render-only world (no stepper: fixed ``transforms``)
starts paused (``time_scale = 0``): the accumulator receives scaled time
and never asks for a substep, while the camera, input and overlay run on
unscaled time; if it does ask (a time_scale above 0), ``frame`` raises
rather than skip the substep. ``save_state`` / ``load_state`` keep the
world state (and the accumulator and time) in one ``.npz``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ecs.world import (chunk_local_to_world, copy_state, rebuild_state,
                         state_leaves)
from ..render import rt as RT
from ..render.camera import Camera
from ..render.composite import FPSOverlay, composite_frame, overlay_blit_device
from ..render.graph import RenderGraph, RenderPass
from ..render.ibl import IBL
from ..render.raster import check_raster, render_frame_raster
from ..render.scene_geometry import flatten_frame
from .cuda_graph import capture
from .input import InputFrame, InputSystem
from .step import SubstepGraph

FIXED_DT = 1.0 / 60.0
MAX_SUBSTEPS = 4
PATHS = ("rt", "raster", "raster_pbr")
# The frame program's inputs, in the order of its input buffer (f32).
FRAME_INPUTS = (("alpha", ()), ("cam_world", (3,)), ("ivp", (4, 4)),
                ("vp", (4, 4)), ("cam_pos", (3,)), ("exposure", ()),
                ("fps", ()))


def save_world_state(path: str, state, **scalars):
    """Checkpoint a WorldState (+ host scalars) to one .npz."""
    np.savez(path, *[x.cpu().numpy() for x in state_leaves(state)],
             **scalars)


def load_world_state(path: str, like_state):
    """Restore a WorldState saved by save_world_state onto ``like_state``'s
    device and structure -> (state, the npz data for the scalars)."""
    data = np.load(path)
    like = state_leaves(like_state)
    it = iter(torch.as_tensor(data[f"arr_{i}"], device=x.device)
              for i, x in enumerate(like))
    return rebuild_state(like_state, it), data


def apply_intent(state, e: int, intent: dict):
    """Entity ``e``'s MoveIntent (InputSystem.update's dict) written into
    ``state``'s tensors in place: velocity, yaw and the yaw flag replaced,
    jump and dodge OR-ed in. Each value is a fill of a one-element slice:
    assigning to a single element of a CUDA tensor from a Python number
    copies it from the host and syncs."""
    r = slice(e, e + 1)
    for i, v in enumerate(np.asarray(intent["desired_velocity"], np.float32)):
        state.intent_vel[r, i].fill_(float(v))
    state.intent_yaw[r].fill_(float(np.float32(intent["facing_yaw"])))
    state.intent_has_yaw[r].fill_(bool(intent["has_facing_yaw"]))
    if intent["jump_requested"]:
        state.intent_jump[r].fill_(True)
    if intent["dodge_requested"]:
        state.intent_dodge[r].fill_(True)


class FrameProgram:
    """The frame after its substeps, ``body() -> (u8, snapshot or None)``,
    for one RT size. On the card it is captured once as a CUDA graph
    (``WARMUP`` eager runs first) and ``run()`` replays it, returning the
    graph's own output tensors (the next replay overwrites them); for CPU
    tensors ``run()`` is the eager body. ``eager()`` runs the body eagerly
    on the current inputs whatever the device: on the card, the frame the
    graph must equal bit for bit. ``mode``: the capture's error mode
    (``scene/cuda_graph.capture``; parallel/sharding.py's programs over a
    process group hold a collective)."""

    WARMUP = 2

    def __init__(self, body, device, mode: str = "global"):
        self.body = body
        self.captured, self.out = None, None
        if device.type == "cuda":
            self.captured, self.out = capture(body, body, self.WARMUP, mode)

    @property
    def capture_seconds(self) -> float:
        return 0.0 if self.captured is None else self.captured.seconds

    @property
    def pool_bytes(self) -> int:
        return 0 if self.captured is None else self.captured.pool_bytes

    def run(self):
        if self.captured is None:
            return self.body()
        self.captured.replay()
        return self.out

    def eager(self):
        return self.body()


class Engine:
    def __init__(self, scene, width: int = 640, height: int = 360,
                 path: str = "rt", rt_resolution_scale: float = 1.0,
                 max_layers: int = 3, shadow_layers: int = 4,
                 primary: str = "hybrid", raster_mode: str = "clusters",
                 layered: bool = True, shadow_prepass: bool = False,
                 deferred: bool = False, shadow_sort: bool = False,
                 shadow_sort_mode: str = "partition", lbatch: int = 2,
                 raster_vis: str = "tile", pipeline_depth: int = 1,
                 layer_slots: int = 0, trans_subdiv: int = 0,
                 unlit_fast: bool = True, unlit_split: bool = False,
                 unlit_dense: bool = False, packet_compact: bool = False,
                 device="cuda"):
        """``scene``: a scene.demo_scene.DemoWorld (or anything with its
        fields: geometry, transforms, palettes, lights, player_position,
        movement, and for a simulated world stepper, state, player) on
        ``device`` (the card unless asked otherwise).
        ``path``: "rt", "raster" or "raster_pbr" (see the module docstring).
        ``primary``, ``layered``, ``shadow_prepass``, ``deferred``,
        ``shadow_sort``, ``shadow_sort_mode``, ``lbatch``, ``max_layers``,
        ``shadow_layers`` and the knob paths (``layer_slots``,
        ``trans_subdiv``, ``unlit_fast``, ``unlit_split``, ``unlit_dense``,
        ``packet_compact``; see ``rt.render_frame``) go to the RT frame
        (paths "rt",
        "raster_pbr"), ``raster_mode`` and ``raster_vis`` to the raster
        frame; each keeps the reference's default. ``pipeline_depth``:
        frames in flight (at least 1)."""
        if path not in PATHS:
            raise ValueError(f"path must be one of {PATHS}, got {path!r}")
        RT.check_schedule(primary, shadow_sort_mode, lbatch)
        RT.check_knobs(layer_slots, trans_subdiv)
        check_raster(raster_mode, raster_vis)
        self.device = resolve_device(device)
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.programs = {}      # RT size -> FrameProgram
        n_in = sum(int(np.prod(shape)) for _, shape in FRAME_INPUTS)
        self._inputs = torch.zeros(n_in, device=self.device)
        self._pending = []      # frames in flight: (u8, snapshot, event)
        self._snap = None       # the last completed frame's snapshot (7,)
        self.geometry = scene.geometry
        self.lights = scene.lights
        self.transforms = scene.transforms
        self.palettes = scene.palettes
        self.player_position = np.asarray(scene.player_position, np.float64)
        self.movement = scene.movement
        self.stepper = getattr(scene, "stepper", None)
        self.player = getattr(scene, "player", None)
        self.state, self._sim = None, None
        if self.stepper is not None:
            self._sim = SubstepGraph(self.stepper, scene.state, FIXED_DT)
            self.state = self._sim.state
        self.width, self.height = width, height
        self.path = path
        self.primary = primary
        self.raster_mode, self.raster_vis = raster_mode, raster_vis
        self.schedule = dict(deferred=deferred, shadow_sort=shadow_sort,
                             shadow_sort_mode=shadow_sort_mode,
                             lbatch=lbatch, layer_slots=layer_slots,
                             trans_subdiv=trans_subdiv,
                             unlit_fast=unlit_fast, unlit_split=unlit_split,
                             unlit_dense=unlit_dense,
                             packet_compact=packet_compact)
        self.layered, self.shadow_prepass = layered, shadow_prepass
        self.max_layers, self.shadow_layers = max_layers, shadow_layers
        self.rt_scale = None
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
        self._dodge_active = False
        self.graph = self._render_graph()

    def set_rt_resolution_scale(self, scale: float):
        """rtResolutionScale (Renderer.swift:175,232-258): the RT target is
        (int(width * s), int(height * s)) with s >= 0.25. A new scale drops
        the frames in flight and the player snapshot (engine.py:107-114)."""
        scale = max(float(scale), 0.25)
        if scale == self.rt_scale:
            return
        self.rt_scale = scale
        self.rt_size = (max(int(self.width * scale), 1),
                        max(int(self.height * scale), 1))
        self._pending.clear()
        self._snap = None

    def _render_graph(self) -> RenderGraph:
        """The reference's two passes (scene/engine.py:173-196): "rt" (the
        frame geometry, the RT-target frame, the upscale) and "composite"
        (where the path has one) into the float view."""
        graph = RenderGraph()

        def rt_pass(res):
            fg = flatten_frame(self.geometry, res["transforms"],
                               res["palettes"])
            return {"rt_output": self._upscale(self.render_target(
                fg, res["ivp"], res["vp"], res["cam_pos"]))}

        def composite_pass(res):
            img = res["rt_output"]
            if self.path != "raster":
                img = composite_frame(img, res["exposure"], True)
            return {"view": img}

        graph.add_pass(RenderPass("rt", rt_pass,
                                  reads=("transforms", "palettes", "ivp",
                                         "vp", "cam_pos"),
                                  writes=("rt_output",)))
        graph.add_pass(RenderPass("composite", composite_pass,
                                  reads=("rt_output", "exposure"),
                                  target="view"))
        return graph

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

    def _begin(self, dt: float, pad: Optional[InputFrame]):
        """The frame's start, shared by ``frame`` and ``update``: time,
        input, exposure, the player's intent, the accumulator -> (clamped
        dt, substeps due, alpha)."""
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
        if self.stepper is not None:
            apply_intent(self.state, self.player, self.intent)
        self.substeps = n
        return dt, n, min(max(self.accumulator / FIXED_DT, 0.0), 1.0)

    def _step(self, n: int):
        """``n`` substeps: on the card ``n`` replays of the graph."""
        for _ in range(n):
            self._sim.step()

    def _follow(self, snap, alpha: float):
        """The chase camera onto the player interpolated by ``alpha``
        between a snapshot's previous and current position; a render-only
        world's player stands at its fixed position."""
        if self.stepper is None:
            player = self.player_position
        else:
            player = snap[0:3] + (snap[3:6] - snap[0:3]) * alpha
        self.input.update_camera(self.camera, player)

    def render_target(self, fg, ivp, vp, cam_pos) -> torch.Tensor:
        """The RT-target-size linear frame of ``self.path`` from the frame
        geometry ``fg``, the camera's (inverse) view-projection at the RT
        size and its position (scene/engine.py:155-169)."""
        rw, rh = self.rt_size
        if self.path == "raster":
            return render_frame_raster(
                self.geometry, fg, ivp, cam_pos, rw, rh, view_proj=vp,
                raster_mode=self.raster_mode, raster_vis=self.raster_vis)
        bounce = self.path == "rt"
        return RT.render_frame(
            self.geometry, fg, self.ibl, self.lights, ivp, cam_pos, rw, rh,
            max_layers=self.max_layers, shadow_layers=self.shadow_layers,
            view_proj=vp, enable_mirror=bounce, enable_refraction=bounce,
            primary=self.primary, layered=self.layered,
            shadow_prepass=self.shadow_prepass, **self.schedule)

    def _stage_inputs(self, alpha: float, fps: int):
        """The frame's values into the input buffer: one non-blocking copy
        from pinned host memory on the card."""
        rw, rh = self.rt_size
        cam = self.camera
        host = torch.from_numpy(np.concatenate([
            [alpha], cam.world_position, np.ravel(cam.inv_view_proj(rw, rh)),
            np.ravel(cam.view_proj(rw, rh)), cam.position,
            [self.tone_mapping_exposure, fps]]).astype(np.float32))
        if self._inputs.is_cuda:
            host = host.pin_memory()
        self._inputs.copy_(host, non_blocking=True)

    def frame_inputs(self) -> dict:
        """Views of the input buffer by name (``FRAME_INPUTS``)."""
        out, i = {}, 0
        for name, shape in FRAME_INPUTS:
            n = int(np.prod(shape))
            out[name] = self._inputs[i:i + n].reshape(shape)
            i += n
        return out

    def _view(self, x) -> torch.Tensor:
        """Extraction and the render graph on the frame inputs ``x``
        (``frame_inputs``) -> the (H, W, 3) float view."""
        if self.stepper is not None:
            transforms, palettes = self.stepper._extract(
                self.state, x["alpha"], x["cam_world"])
        else:
            transforms = self.transforms.clone()
            transforms[:, :3, 3] -= x["cam_world"]
            palettes = self.palettes
        return self.graph.execute(dict(
            transforms=transforms, palettes=palettes, ivp=x["ivp"],
            vp=x["vp"], cam_pos=x["cam_pos"],
            exposure=x["exposure"]))["view"]

    def _frame_body(self):
        """The frame program: the view, u8, the overlay and the player
        snapshot, all read from the input buffer and the state."""
        x = self.frame_inputs()
        u8 = (torch.clamp(self._view(x), 0.0, 1.0) * 255.0).to(torch.uint8)
        u8 = overlay_blit_device(u8, x["fps"])
        snap = self._snapshot_device() if self.stepper is not None else None
        return u8, snap

    def program(self) -> FrameProgram:
        """The frame program of the current RT size, captured at first
        use."""
        prog = self.programs.get(self.rt_size)
        if prog is None:
            prog = self.programs[self.rt_size] = FrameProgram(
                self._frame_body, self.device)
        return prog

    def _snapshot_device(self) -> torch.Tensor:
        """The player's previous and current world position and its dodge
        flag (7 floats) on the device."""
        st, e = self.state, self.player
        prev = chunk_local_to_world(st.wp_prev_chunk[e], st.wp_prev_local[e])
        curr = chunk_local_to_world(st.wp_chunk[e], st.wp_local[e])
        return torch.cat([prev, curr, st.dodge.active[e, None].float()])

    def _player_snapshot(self) -> np.ndarray:
        """The current player snapshot, read to the host."""
        return self._snapshot_device().cpu().numpy()

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
        """Restore a checkpoint into the Engine's buffers; drops the frames
        in flight and the player snapshot."""
        state, data = load_world_state(path, self.state)
        copy_state(self.state, state)
        self.accumulator = float(data["accumulator"])
        self.time = float(data["time"])
        self._pending.clear()
        self._snap = None

    def update(self, dt: float, pad: Optional[InputFrame] = None) -> float:
        """Simulation update (scene/engine.py:324-358): time, input, the
        fixed substeps, then the chase camera from the current player
        snapshot (one 7-float read) -> alpha."""
        _, n, alpha = self._begin(dt, pad)
        self._step(n)
        snap = None
        if self.stepper is not None:
            snap = self._player_snapshot()
            self._dodge_active = bool(snap[6] > 0.5)
        self._follow(snap, alpha)
        return alpha

    def render(self, alpha: float) -> torch.Tensor:
        """Render extraction + the render graph (scene/engine.py:360-370)
        -> the (H, W, 3) float view on the engine's device: the frame
        program's first part, run eagerly on the staged inputs."""
        self._stage_inputs(alpha, -1)
        return self._view(self.frame_inputs())

    def frame(self, dt: float, pad: Optional[InputFrame] = None,
              with_overlay: bool = True) -> torch.Tensor:
        """One frame -> (H, W, 3) uint8 tensor on the engine's device: the
        oldest frame in flight once ``pipeline_depth`` are queued, zeros
        before. On the card: the substep replays, the input copy and one
        replay of the RT size's frame program."""
        dt, n, alpha = self._begin(dt, pad)
        # Chase camera from the last completed frame's player snapshot (the
        # reference's one-frame lag at depth 1).
        if self.stepper is not None and self._snap is None:
            self._snap = self._player_snapshot()
        self._follow(self._snap, alpha)
        fps = self.overlay.update(dt) if with_overlay else -1
        self._step(n)
        self._stage_inputs(alpha, fps)
        u8, snap = self.program().run()
        # the next replay overwrites the graph's outputs: each frame keeps
        # its own image
        u8 = u8.clone()
        event = None
        if snap is not None:
            if snap.is_cuda:
                host = torch.empty(snap.shape, dtype=snap.dtype,
                                   pin_memory=True)
                host.copy_(snap, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                snap = host
        self._pending.append((u8, snap, event))
        if len(self._pending) < self.pipeline_depth:
            return torch.zeros_like(u8)
        u8, snap, event = self._pending.pop(0)
        if snap is not None:
            if event is not None:
                event.synchronize()
            self._snap = snap.numpy()
            self._dodge_active = bool(self._snap[6] > 0.5)
        return u8
