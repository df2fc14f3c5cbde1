"""The comparison that decides ``correct``.

The reference is ``frozen_port`` (a copy of the port at commit 74208b3
that runs plain PyTorch only) with ``visibility.BruteForce`` in place of
the port's BVH walks. It builds its own world from the same inputs (the
repository's assets, or the crowd placement drawn from the seed), so
nothing the program derived (trees, shadow clusters, captured programs,
packed rows) reaches it. It follows the program step by step: each sampled
answer is recomputed from the program's state just before it.

* ``state_gap``: the world state. The reference's initial state against the
  program's, and for each sampled frame or replay, the reference's
  substeps from the program's state before them against the program's
  state after them. Per leaf, a float leaf's largest difference over
  ``max(its largest magnitude, 1)``, another leaf's share of differing
  elements; the number is the worst leaf of any sample.
* ``pixel_miss``: the frame. For each sampled frame, ``pixels`` pixels drawn
  from the seed (outside the FPS overlay's band) are traced and shaded by
  the reference's flat-ray frame (``rt._render_rays``: the reference's
  intersector semantics) from the program's state and frame inputs, then
  dithered, tone-mapped and quantised as the frame program does; the
  number is the share of sampled pixels whose largest channel differs
  from the program's image by more than ``MISS_LEVELS``.

``dtype=torch.bfloat16`` (the control) computes the reference in bfloat16 storage: the state,
the frame inputs, the triangles and rays of every trace, and the linear
colour are rounded to bfloat16, the precision below the float32 that the
configuration states.
"""

from __future__ import annotations

import importlib
import os

import torch

from . import crowd
from .visibility import BruteForce

FROZEN = __name__.rsplit(".", 1)[0] + ".frozen_port"
MISS_LEVELS = 4        # u8 levels a pixel may differ by without a miss
FIXED_DT = 1.0 / 60.0  # the substep (Renderer.swift's fixed step)
# The frame program's input buffer (f32), in order: what the reference
# reads of it is the camera the program's host computed.
FRAME_INPUTS = (("alpha", ()), ("cam_world", (3,)), ("ivp", (4, 4)),
                ("vp", (4, 4)), ("cam_pos", (3,)), ("exposure", ()),
                ("fps", ()))


def frozen(name: str):
    return importlib.import_module(f"{FROZEN}.{name}" if name else FROZEN)


def _round(x, dtype):
    if dtype is None or not x.is_floating_point():
        return x
    return x.to(dtype).to(x.dtype)


def leaf_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    p = p.to(r.device)
    if p.shape != r.shape or p.dtype != r.dtype:
        return float("inf")
    if p.numel() == 0:
        return 0.0
    if not r.is_floating_point():
        return float((p != r).double().mean())
    pn, rn = torch.isnan(p), torch.isnan(r)
    if bool((pn != rn).any()):
        return float("inf")
    pd, rd = p.double(), r.double()
    same = (pd == rd) | pn          # equal values, infinities included
    diff = torch.where(same, 0.0, (pd - rd).abs())
    scale = torch.where(rn | torch.isinf(rd), 0.0, rd.abs()).max()
    return float(diff.max() / max(float(scale), 1.0))


def state_gap(prog_leaves, ref_leaves) -> float:
    if len(prog_leaves) != len(ref_leaves):
        return float("inf")
    return max((leaf_gap(p, r) for p, r in zip(prog_leaves, ref_leaves)),
               default=0.0)


def _state(world_mod, like, leaves, device, dtype):
    return world_mod.rebuild_state(
        like, iter(_round(x.to(device), dtype) for x in leaves))


def _substeps(stepper, world_mod, state, n, dt, dtype):
    for _ in range(n):
        state = stepper._substep_impl(state, dt)
        if dtype is not None:
            state = world_mod.rebuild_state(
                state, iter(_round(x, dtype)
                            for x in world_mod.state_leaves(state)))
    return state


class EngineReference:
    """The DemoScene world of an ``engine`` configuration, rebuilt by the
    frozen copy, and the checks of its frames."""

    def __init__(self, cfg: dict, root: str, device):
        self.cfg, self.device = cfg, device
        ds = frozen("scene.demo_scene")
        scene = dict(cfg["scene"])
        asset_dir = os.path.join(root, scene.pop("asset_dir"))
        self.world = ds.build_demo_scene(asset_dir, device, **scene)
        self.ibl = frozen("render.ibl").IBL.build(device)
        self.w = frozen("ecs.world")
        self.dt = FIXED_DT

    def initial_leaves(self):
        return self.w.state_leaves(self.world.state)

    def _inputs(self, buf):
        out, i = {}, 0
        for name, shape in FRAME_INPUTS:
            n = 1
            for s in shape:
                n *= s
            out[name] = buf[i:i + n].reshape(shape)
            i += n
        return out

    def _pixels(self, img_shape, px, py, gen, count):
        h, w = img_shape
        band = 0
        if self.cfg.get("overlay", True):
            comp = frozen("render.composite")
            pt = frozen("assets.procedural_textures")
            band = comp.FPSOverlay.MARGIN + \
                pt.DIGITS_CELL_H * int(comp.FPSOverlay.SCALE)
        ok = torch.nonzero((px < w) & (py < h) & (py >= band)).squeeze(1)
        pick = torch.randperm(ok.numel(), generator=gen)[:count]
        return ok[pick.to(ok.device)]

    def frame(self, sample: dict, seed: int, dtype=None):
        """(state gap of the frame's substeps, misses, pixels compared)."""
        w, dev = self.w, self.device
        st = _state(w, self.world.state, sample["pre"], dev, dtype)
        st = _substeps(self.world.stepper, w, st, sample["substeps"],
                       self.dt, dtype)
        gap = state_gap(sample["post"], w.state_leaves(st))
        misses, n = self._render(sample, seed, dtype)
        return gap, misses, n

    def _render(self, sample: dict, seed: int, dtype):
        """(misses, pixels compared) of one sampled frame."""
        gen = torch.Generator().manual_seed(
            (int(seed) * 1000003 + int(sample["index"])) % (2**63))
        ref, qx, qy = self.pixels(sample, dtype, gen,
                                  int(self.cfg["check"]["pixels"]))
        prog = sample["image"][qy.cpu(), qx.cpu()].to(ref.device)
        diff = (prog.int() - ref.int()).abs().amax(1)
        return int((diff > MISS_LEVELS).sum()), int(qx.numel())

    def pixels(self, sample: dict, dtype, gen, count: int):
        """The reference's u8 colour of ``count`` pixels of a sampled frame
        drawn by ``gen`` -> (u8 (count, 3), x, y)."""
        rt, rk = frozen("render.rt"), frozen("ops.rt_kernel")
        cam_m, shading = frozen("render.camera"), frozen("render.shading")
        comp, sg = frozen("render.composite"), frozen("render.scene_geometry")
        w, dev, cfg = self.w, self.device, self.cfg
        eng = cfg["engine"]
        width, height = int(eng["width"]), int(eng["height"])
        st = _state(w, self.world.state, sample["post"], dev, dtype)
        x = {k: _round(v, dtype) for k, v in
             self._inputs(sample["inputs"].to(dev)).items()}
        transforms, palettes = self.world.stepper._extract(
            st, x["alpha"], x["cam_world"])
        fg = sg.flatten_frame(self.world.geometry, transforms, palettes)
        ray_o, ray_d, px, py = cam_m.generate_rays_tiled(
            x["ivp"], x["cam_pos"], width, height)
        lanes = self._pixels((height, width), px, py, gen, count)
        bounce = eng.get("path", "rt") == "rt"
        keys = ("max_layers", "shadow_layers", "layered", "shadow_prepass",
                "shadow_sort", "shadow_sort_mode", "lbatch", "layer_slots",
                "unlit_fast", "unlit_split", "unlit_dense", "packet_compact")
        kw = {k: eng[k] for k in keys if k in eng}
        bf = BruteForce(rk, dtype)
        saved = rt.trace_batch
        rt.trace_batch = bf.trace_batch
        try:
            col = rt._render_rays(
                self.world.geometry, fg, self.ibl, self.world.lights,
                x["cam_pos"], ray_o[lanes].contiguous(),
                ray_d[lanes].contiguous(), enable_mirror=bounce,
                enable_refraction=bounce, **kw)
        finally:
            rt.trace_batch = saved
        col = _round(col, dtype)
        qx, qy = px[lanes], py[lanes]
        fx, fy = qx.to(torch.float32), qy.to(torch.float32)
        noise = shading.hash12(torch.stack([fx, fy], -1))
        col = torch.clamp(col + ((noise - 0.5) * (1.0 / 255.0))[:, None],
                          min=0.0)
        tm = comp.tone_map_aces(col * torch.clamp(x["exposure"], min=0.0))
        noise = shading.hash12(torch.stack([fx, fy], -1) * 0.5)
        view = tm + ((noise - 0.5) * (1.0 / 255.0))[:, None]
        return ((torch.clamp(view, 0.0, 1.0) * 255.0).to(torch.uint8),
                qx, qy)

    def numbers(self, initial, samples, seed: int, dtype=None) -> dict:
        gaps = [state_gap(initial, self.initial_leaves())]
        misses = pixels = 0
        for s in samples:
            gap, m, n = self.frame(s, seed, dtype)
            gaps.append(gap)
            misses, pixels = misses + m, pixels + n
        return {"state_gap": max(gaps),
                "pixel_miss": misses / pixels if pixels else float("inf")}


class CrowdReference:
    """The crowd of a ``crowd`` configuration, placed from the seed and
    built by the frozen copy, and the checks of its replays."""

    def __init__(self, cfg: dict, seed: int, device):
        self.device = device
        self.w = frozen("ecs.world")
        self.dt = FIXED_DT
        self.stepper, self.state = crowd.build(
            frozen(""), crowd.placement(int(cfg["agents"]), seed), device)

    def numbers(self, initial, samples, seed: int, dtype=None) -> dict:
        w = self.w
        gaps = [state_gap(initial, w.state_leaves(self.state))]
        for s in samples:
            st = _state(w, self.state, s["pre"], self.device, dtype)
            st = _substeps(self.stepper, w, st, s["substeps"], self.dt,
                           dtype)
            gaps.append(state_gap(s["post"], w.state_leaves(st)))
        return {"state_gap": max(gaps)}


def reference(cfg: dict, root: str, seed: int, device):
    if cfg["kind"] == "engine":
        return EngineReference(cfg, root, device)
    if cfg["kind"] == "crowd":
        return CrowdReference(cfg, seed, device)
    raise ValueError(f"no reference for configuration kind {cfg['kind']!r}")
