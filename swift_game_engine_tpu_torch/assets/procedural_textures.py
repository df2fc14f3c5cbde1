"""Textures (RGBA8 numpy) and the FPS overlay's digits atlas.

The port's copy of the parts of swift_game_engine_tpu/assets/
procedural_textures.py it uses (reference: Game/ProceduralTextures.swift:
77-124): the ``Texture`` record — an (H, W, 4) uint8 array plus an sRGB
flag — and the 5x7-pixel-font digits atlas.
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
