"""Camera (host numpy matrices) and primary rays in tile-major lane order.

Port of swift_game_engine_tpu/render/camera.py (reference:
Game/Camera.swift:10-56). The frame lives in PADDED TILE-MAJOR lane order:
lane l covers pixel (px, py) of the (tile_h x tile_w) screen tile
l // (tile_h * tile_w). The cluster rasterizer writes records in this order,
so the frame needs no permutation anywhere; ``untile_image`` crops at the
end. At 960x540 with 32x128 tiles that is 8 x 17 tiles = 557,056 lanes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import math3d as m3
from ..math3d import normalize

TILE_H = 32
TILE_W = 128


def _view_rot(position, target, up):
    eye = np.asarray(position, np.float32)
    f = np.asarray(target, np.float32) - eye
    f = f / np.float32(np.linalg.norm(f) + 1e-20)
    r = np.cross(f, np.asarray(up, np.float32))
    r = r / np.float32(np.linalg.norm(r) + 1e-20)
    u = np.cross(r, f)
    return eye, np.stack([r, u, -f])


@dataclass
class Camera:
    fov_degrees: float = 65.0
    near_z: float = 0.1
    far_z: float = 100.0
    position: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 8.0], np.float32))
    target: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    world_chunk: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.int64))
    world_local: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float64))

    def _proj_scales(self, width, height):
        aspect = max(width / max(height, 1.0), 1e-4)
        fov = np.float32(np.radians(self.fov_degrees))
        ys = np.float32(1.0) / np.tan(fov * np.float32(0.5))
        xs = ys / np.float32(aspect)
        zs = np.float32(self.far_z / (self.near_z - self.far_z))
        return xs, ys, zs

    def projection(self, width: float, height: float, device=None):
        """The perspective P (camera.py:29-32) as a (4, 4) tensor on
        ``device`` (torch's default if None)."""
        aspect = max(width / max(height, 1.0), 1e-4)
        return m3.mat4_perspective_rh(
            m3.radians_from_degrees(self.fov_degrees), aspect, self.near_z,
            self.far_z, device)

    def view(self, device=None):
        """The look-at view V (camera.py:34-37) as a (4, 4) tensor."""
        return m3.mat4_look_at_rh(*(torch.as_tensor(
            np.asarray(x, np.float32), device=device) for x in (
                self.position, self.target, self.up)))

    def inv_view_proj(self, width: float, height: float) -> np.ndarray:
        """inv(P @ V) = rigidInv(V) @ analyticInv(P), exact in f32."""
        xs, ys, zs = self._proj_scales(width, height)
        inv_p = np.zeros((4, 4), np.float32)
        inv_p[0, 0] = 1.0 / xs
        inv_p[1, 1] = 1.0 / ys
        inv_p[2, 3] = -1.0
        inv_p[3, 2] = 1.0 / (zs * np.float32(self.near_z))
        inv_p[3, 3] = 1.0 / np.float32(self.near_z)
        eye, rot = _view_rot(self.position, self.target, self.up)
        inv_v = np.eye(4, dtype=np.float32)
        inv_v[:3, :3] = rot.T
        inv_v[:3, 3] = eye
        return (inv_v @ inv_p).astype(np.float32)

    def view_proj(self, width: float, height: float) -> np.ndarray:
        """Forward P @ V, the exact inverse pair of inv_view_proj."""
        xs, ys, zs = self._proj_scales(width, height)
        p = np.zeros((4, 4), np.float32)
        p[0, 0] = xs
        p[1, 1] = ys
        p[2, 2] = zs
        p[2, 3] = zs * np.float32(self.near_z)
        p[3, 2] = -1.0
        eye, rot = _view_rot(self.position, self.target, self.up)
        v = np.eye(4, dtype=np.float32)
        v[:3, :3] = rot
        v[:3, 3] = -rot @ eye
        return (p @ v).astype(np.float32)

    @property
    def world_position(self) -> np.ndarray:
        """f64 world-space camera position (chunk*512 + local)."""
        return self.world_chunk.astype(np.float64) * 512.0 + self.world_local


def tile_permutation(width: int, height: int, tile: int | None = None):
    """The permutation from scanline ray order to square pixel tiles of
    ``tile`` (camera.py:107-126; default: the side of the reference's
    4,096-lane packet, 64) -> (perm, inv_perm) int32 numpy arrays of
    width * height. The frame itself runs in tile-major lanes
    (``tiled_pixels``)."""
    if tile is None:
        tile = max(int(np.sqrt(TILE_H * TILE_W)), 8)
    ys, xs = np.mgrid[0:height, 0:width]
    tile_id = (ys // tile) * ((width + tile - 1) // tile) + (xs // tile)
    key = tile_id.astype(np.int64) * (tile * tile) + \
        (ys % tile) * tile + (xs % tile)
    perm = np.argsort(key.reshape(-1), kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return perm.astype(np.int32), inv.astype(np.int32)


def tiled_pixels(width: int, height: int, tile_h: int = TILE_H,
                 tile_w: int = TILE_W, device=None):
    """(px, py) int64 per lane in padded tile-major order."""
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    per_tile = tile_h * tile_w
    lane = torch.arange(tiles_x * tiles_y * per_tile, device=device)
    tile = lane // per_tile
    within = lane % per_tile
    px = (tile % tiles_x) * tile_w + within % tile_w
    py = (tile // tiles_x) * tile_h + within // tile_w
    return px, py


def generate_rays_tiled(inv_view_proj, camera_position, width: int,
                        height: int, tile_h: int = TILE_H,
                        tile_w: int = TILE_W):
    """Primary rays in padded tile-major lane order. Padding lanes get real
    rays through their out-of-image pixel centers.

    Returns (o (P,3), d (P,3), px (P,), py (P,))."""
    ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32)
    cam = torch.as_tensor(camera_position, dtype=torch.float32,
                          device=ivp.device)
    px, py = tiled_pixels(width, height, tile_h, tile_w, device=ivp.device)
    ndc_x = (px.to(torch.float32) + 0.5) / width * 2.0 - 1.0
    ndc_y = (1.0 - (py.to(torch.float32) + 0.5) / height) * 2.0 - 1.0
    one = torch.ones_like(ndc_x)
    clip = torch.stack([ndc_x, ndc_y, one, one], -1)
    world = clip @ ivp.T
    p = world[..., :3] / world[..., 3:4]
    d = normalize(p - cam)
    o = cam.expand_as(d)
    return o, d, px, py


def generate_rays(inv_view_proj, camera_position, width: int, height: int):
    """Primary rays in scanline order, the raster path's lane order
    (camera.py:179, RayTracing.metalinc:225-229) -> (o (H*W,3),
    d (H*W,3))."""
    ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32)
    dev = ivp.device
    cam = torch.as_tensor(camera_position, dtype=torch.float32, device=dev)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / \
        height
    gy, gx = torch.meshgrid((1.0 - ys) * 2.0 - 1.0, xs * 2.0 - 1.0,
                            indexing="ij")
    one = torch.ones_like(gx)
    world = torch.stack([gx, gy, one, one], -1) @ ivp.T
    d = normalize(world[..., :3] / world[..., 3:4] - cam)
    return cam.expand_as(d).reshape(-1, 3), d.reshape(-1, 3)


def untile_image(flat, width: int, height: int, tile_h: int = TILE_H,
                 tile_w: int = TILE_W):
    """(P, C) tile-major lanes -> (H, W, C) image (reshape + crop)."""
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    c = flat.shape[-1]
    img = flat.reshape(tiles_y, tiles_x, tile_h, tile_w, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * tile_h,
                                             tiles_x * tile_w, c)
    return img[:height, :width]
