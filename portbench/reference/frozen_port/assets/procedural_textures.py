"""Procedural texture generators (RGBA8, vectorized numpy): the port's copy
of swift_game_engine_tpu/assets/procedural_textures.py.

Same generator set and pixel semantics as the reference
(reference: Game/ProceduralTextures.swift:29-386): solid, checkerboard,
5x7-pixel-font digits atlas (the FPS overlay's), flat normal,
metallic-roughness (glTF packing: G=roughness, B=metallic), occlusion
(solid/radial/grime fbm), emissive, and tangent-space normal maps from an
analytic height field or hashed value-noise fbm. Textures are (H, W, 4)
uint8 arrays plus an sRGB flag.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DIGITS_CELL_W = 8
DIGITS_CELL_H = 12


@dataclass(frozen=True)
class Texture:
    pixels: np.ndarray  # (H, W, 4) uint8
    srgb: bool = False

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]


def _u8(x):
    return np.clip(np.asarray(x) * 255.0, 0, 255).astype(np.uint8)


def solid(width: int, height: int, rgba, srgb: bool = False) -> Texture:
    px = np.empty((height, width, 4), np.uint8)
    px[:] = np.asarray(rgba, np.uint8)
    return Texture(px, srgb)


def checkerboard(width: int = 256, height: int = 256, cell: int = 32,
                 color_a: int = 230, color_b: int = 40, srgb: bool = False) -> Texture:
    y, x = np.mgrid[0:height, 0:width]
    on = ((x // cell) % 2) ^ ((y // cell) % 2) == 0
    c = np.where(on, np.uint8(color_a), np.uint8(color_b))
    px = np.stack([c, c, c, np.full_like(c, 255)], axis=-1).astype(np.uint8)
    return Texture(px, srgb)


_GLYPHS = [
    ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],  # 0
    ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],  # 1
    ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],  # 2
    ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],  # 3
    ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],  # 4
    ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],  # 5
    ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],  # 6
    ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],  # 7
    ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],  # 8
    ["01110", "10001", "10001", "01111", "00001", "00010", "11100"],  # 9
]


def digits_atlas() -> Texture:
    """10 digits in one row, 5x7 font centered in 8x12 cells, alpha-masked.

    reference: Game/ProceduralTextures.swift:77-124 (used by the FPS overlay).
    """
    atlas_w = DIGITS_CELL_W * 10
    atlas_h = DIGITS_CELL_H
    px = np.zeros((atlas_h, atlas_w, 4), np.uint8)
    pad_x = (DIGITS_CELL_W - 5) // 2
    pad_y = (DIGITS_CELL_H - 7) // 2
    for digit, rows in enumerate(_GLYPHS):
        glyph = np.array([[c == "1" for c in row] for row in rows])
        ox = digit * DIGITS_CELL_W + pad_x
        px[pad_y:pad_y + 7, ox:ox + 5][glyph] = 255
    return Texture(px)


def flat_normal(width: int = 4, height: int = 4) -> Texture:
    return solid(width, height, (128, 128, 255, 255))


def metallic_roughness(metallic: float, roughness: float,
                       width: int = 4, height: int = 4) -> Texture:
    m = int(np.clip(metallic * 255, 0, 255))
    r = int(np.clip(roughness * 255, 0, 255))
    return solid(width, height, (0, r, m, 255))


def occlusion(value: float, width: int = 4, height: int = 4) -> Texture:
    o = int(np.clip(value * 255, 0, 255))
    return solid(width, height, (o, o, o, 255))


def _smoothstep(a, b, x):
    t = np.clip((x - a) / np.maximum(b - a, 1e-4), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def occlusion_radial(width: int = 256, height: int = 256,
                     inner_radius: float = 0.2, outer_radius: float = 0.9) -> Texture:
    cx = (width - 1) * 0.5
    cy = (height - 1) * 0.5
    max_r = max(cx, cy)
    inner = float(np.clip(inner_radius, 0.0, 1.0))
    outer = float(np.clip(outer_radius, inner, 1.0))
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    r = np.sqrt(((x - cx) / max_r) ** 2 + ((y - cy) / max_r) ** 2)
    o = _u8(_smoothstep(inner, outer, r))
    px = np.stack([o, o, o, np.full_like(o, 255)], axis=-1)
    return Texture(px)


def emissive(color, width: int = 4, height: int = 4, srgb: bool = False) -> Texture:
    c = _u8(np.asarray(color, np.float32))
    return solid(width, height, (int(c[0]), int(c[1]), int(c[2]), 255), srgb)


def _encode_normal(dx, dy):
    n = np.stack([-dx, -dy, np.ones_like(dx)], axis=-1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    px = _u8(n * 0.5 + 0.5)
    alpha = np.full((*dx.shape, 1), 255, np.uint8)
    return Texture(np.concatenate([px, alpha], axis=-1))


def normal_map_from_height(width: int = 256, height: int = 256,
                           amplitude: float = 1.0, frequency: float = 6.0) -> Texture:
    def h(u, v):
        return np.sin(u * frequency * 2 * np.pi) * np.cos(v * frequency * 2 * np.pi) * 0.5 + 0.5

    du, dv = 1.0 / width, 1.0 / height
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u, v = x * du, y * dv
    dx = (h(u + du, v) - h(u - du, v)) * amplitude
    dy = (h(u, v + dv) - h(u, v - dv)) * amplitude
    return _encode_normal(dx, dy)


def _hash2(x, y):
    """Integer lattice hash matching the reference's constants."""
    ux = x.astype(np.int64) & 0xFFFFFFFF
    uy = y.astype(np.int64) & 0xFFFFFFFF
    n = (ux * 374761393 + uy * 668265263 + 0x9E3779B9) & 0xFFFFFFFF
    n ^= n >> 13
    n = (n * 1274126177) & 0xFFFFFFFF
    return (n & 0x00FFFFFF).astype(np.float32) / float(0x01000000)


def _value_noise(u, v):
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    tx = u - x0
    ty = v - y0
    tx = tx * tx * (3.0 - 2.0 * tx)
    ty = ty * ty * (3.0 - 2.0 * ty)
    a = _hash2(x0, y0)
    b = _hash2(x0 + 1, y0)
    c = _hash2(x0, y0 + 1)
    d = _hash2(x0 + 1, y0 + 1)
    ab = a + (b - a) * tx
    cd = c + (d - c) * tx
    return ab + (cd - ab) * ty


def _fbm(u, v, octaves: int = 4, base_amp: float = 0.5):
    total = np.zeros_like(u)
    amp = base_amp
    freq = 1.0
    for _ in range(max(octaves, 1)):
        total = total + _value_noise(u * freq, v * freq) * amp
        freq *= 2.0
        amp *= 0.5
    return total


def normal_map_noise(width: int = 256, height: int = 256, amplitude: float = 1.0,
                     frequency: float = 6.0, octaves: int = 4) -> Texture:
    du, dv = 1.0 / width, 1.0 / height
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u = x * du * frequency
    v = y * dv * frequency
    dx = (_fbm(u + du, v, octaves) - _fbm(u - du, v, octaves)) * amplitude
    dy = (_fbm(u, v + dv, octaves) - _fbm(u, v - dv, octaves)) * amplitude
    return _encode_normal(dx, dy)


def occlusion_grime(width: int = 256, height: int = 256,
                    frequency: float = 2.5, contrast: float = 1.6) -> Texture:
    du, dv = 1.0 / width, 1.0 / height
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    n = np.clip(_fbm(x * du * frequency, y * dv * frequency, 4, base_amp=0.6), 0.0, 1.0)
    occ = 1.0 - np.power(n, contrast) * 0.85
    o = _u8(occ)
    return Texture(np.stack([o, o, o, np.full_like(o, 255)], axis=-1))
