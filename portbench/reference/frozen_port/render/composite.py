"""Composite + UI overlay: RT output -> displayable frame with FPS digits.

Port of swift_game_engine_tpu/render/composite.py (reference:
Game/Renderer.swift:260-290, Game/FPSOverlaySystem.swift:11-96). Both run
inside the Engine's frame program: ``exposure`` and ``fps`` may be 0-d
tensors on the device, and the overlay picks its digits, their count and
their positions there (the reference's device version, composite.py:44-83:
three cells always blended, each kept only where it shows), so one captured
frame serves every fps value and ``fps < 0`` (no overlay).
"""

from __future__ import annotations

import numpy as np
import torch

from .shading import tone_map_aces, hash12
from ..assets import procedural_textures as pt


def _scalar(x, dtype, device):
    """A 0-d tensor on ``device``: a tensor as given, a host number by a
    fill (no copy from the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def composite_frame(rt_output, exposure=1.0, tone_map_enabled=True):
    """Tone-map + dither the linear RT output (H, W, 3): ACES on
    color * exposure, hash dither at half-pixel frequency
    (ShadersRaster.metalinc:93-99). ``exposure``: a number or a 0-d
    tensor on the device."""
    if not tone_map_enabled:
        return rt_output
    h, w = rt_output.shape[:2]
    e = _scalar(exposure, torch.float32, rt_output.device)
    tm = tone_map_aces(rt_output * torch.clamp(e, min=0.0))
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=rt_output.device),
        torch.arange(w, dtype=torch.float32, device=rt_output.device),
        indexing="ij")
    noise = hash12(torch.stack([gx, gy], -1) * 0.5)
    return tm + ((noise - 0.5) * (1.0 / 255.0))[..., None]


_ATLAS = {}


def _atlas(device):
    """The digit atlas as f32 on ``device``, scaled by ``FPSOverlay.SCALE``
    (nearest): built once per device."""
    key = str(device)
    if key not in _ATLAS:
        s = int(FPSOverlay.SCALE)
        a = np.asarray(pt.digits_atlas().pixels, np.float32)
        _ATLAS[key] = torch.as_tensor(a.repeat(s, 0).repeat(s, 1),
                                      device=device)
    return _ATLAS[key]


def overlay_blit_device(u8_img, fps):
    """Alpha-blend up to three FPS digits top-right of a (H, W, 3) uint8
    image (the UIPass); ``fps`` an int or a 0-d tensor on the image's
    device, clamped to -1..999; fps < 0 disables the overlay. Layout
    matches FPSOverlaySystem.update: margin from the top-right corner,
    digits left-to-right most-significant first, nearest x2 scaling; the
    cells' starts clamp as the reference's dynamic slices do."""
    cell_w, cell_h = pt.DIGITS_CELL_W, pt.DIGITS_CELL_H
    scale = int(FPSOverlay.SCALE)
    dw, dh = cell_w * scale, cell_h * scale
    sp, m = FPSOverlay.SPACING, FPSOverlay.MARGIN
    h, w = u8_img.shape[:2]
    if h < m + dh or w < m + dw:
        return u8_img
    dev = u8_img.device
    fps = torch.clamp(_scalar(fps, torch.int32, dev), -1, 999)
    atlas = _atlas(dev)
    atlas_w = atlas.shape[1] // scale
    digits = (fps % 10, (fps // 10) % 10, fps // 100)
    n = 1 + (fps >= 10).to(torch.int32) + (fps >= 100).to(torch.int32)
    x_left = torch.clamp(w - m - (n * dw + (n - 1) * sp), min=m)
    jj = torch.arange(dw, device=dev)
    out = u8_img.clone()
    band = out[m:m + dh]
    for k in range(3):  # k counts digits from the least-significant end
        src = torch.clamp(digits[k] * cell_w, 0, atlas_w - cell_w) * scale
        cell = atlas[:, src + jj]
        cols = torch.clamp(x_left + (n - 1 - k) * (dw + sp), 0, w - dw) + jj
        region = band[:, cols].to(torch.float32)
        a = cell[..., 3:4] * (1.0 / 255.0)
        blended = cell[..., :3] * a + region * (1.0 - a)
        band[:, cols] = torch.where(fps >= (0, 10, 100)[k], blended,
                                    region).to(torch.uint8)
    return out


class FPSOverlay:
    """EMA-smoothed FPS counter (0.9/0.1) and its host blit."""

    MARGIN = 12
    SPACING = 2
    SCALE = 2.0

    def __init__(self):
        self.fps_smoothed = 0.0
        self.cell_w = pt.DIGITS_CELL_W
        self.cell_h = pt.DIGITS_CELL_H
        self.atlas = pt.digits_atlas().pixels  # (12, 80, 4) uint8

    def blit(self, frame_u8: np.ndarray, fps_value: int) -> np.ndarray:
        """Alpha-blend the digits onto a (H, W, 3) uint8 numpy frame,
        top-right (composite.py:109-136: FPSOverlaySystem.update's layout,
        nearest scaling of the atlas cells); the host counterpart of
        ``overlay_blit_device``."""
        h, w = frame_u8.shape[:2]
        digits = [int(c) for c in str(max(fps_value, 0))]
        dw, dh = int(self.cell_w * self.SCALE), int(self.cell_h * self.SCALE)
        total = len(digits) * dw + max(0, len(digits) - 1) * self.SPACING
        x = int(max(self.MARGIN, w - self.MARGIN - total))
        y = self.MARGIN
        rows = ((np.arange(dh) + 0.5) * self.cell_h / dh).astype(np.int64)
        cols = ((np.arange(dw) + 0.5) * self.cell_w / dw).astype(np.int64)
        out = frame_u8.copy()
        for d in digits:
            img = self.atlas[:, d * self.cell_w:(d + 1) * self.cell_w][
                rows][:, cols]
            y0, y1 = y, min(y + dh, h)
            x0, x1 = x, min(x + dw, w)
            if y1 > y0 and x1 > x0:
                a = img[:y1 - y0, :x1 - x0, 3:4].astype(np.float32) / 255.0
                rgb = img[:y1 - y0, :x1 - x0, :3].astype(np.float32)
                dst = out[y0:y1, x0:x1].astype(np.float32)
                out[y0:y1, x0:x1] = (rgb * a + dst * (1 - a)).astype(np.uint8)
            x += dw + self.SPACING
        return out

    def update(self, dt: float) -> int:
        if dt <= 0:
            return int(round(self.fps_smoothed))
        inst = 1.0 / dt
        if self.fps_smoothed == 0:
            self.fps_smoothed = inst
        else:
            self.fps_smoothed = self.fps_smoothed * 0.9 + inst * 0.1
        return max(int(round(self.fps_smoothed)), 0)
