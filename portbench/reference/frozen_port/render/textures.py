"""Texture bank: one (X, S, S, 4) float32 array of all scene textures +
bilinear sampling.

Port of swift_game_engine_tpu/render/textures.py (reference:
Game/RTGeometryCache.swift:245-258). Every texture is resampled to S x S at
load (sRGB decoded to linear); id -1 means "no texture".
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..assets.procedural_textures import Texture


def srgb_to_linear(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


class TextureBank(NamedTuple):
    data: torch.Tensor   # (X, S, S, 4) float32 linear
    size: int

    @property
    def count(self):
        return int(self.data.shape[0])


class TextureBankBuilder:
    """Host-side accumulation of textures (numpy)."""

    def __init__(self, size: int = 512):
        self.size = size
        self._textures: list[np.ndarray] = []

    def add(self, tex: Optional[Texture]) -> int:
        """Returns texture id, or -1 for None."""
        if tex is None:
            return -1
        px = tex.pixels
        if px.shape[0] != self.size or px.shape[1] != self.size:
            from PIL import Image
            img = Image.fromarray(px, "RGBA").resize((self.size, self.size),
                                                     Image.BILINEAR)
            px = np.asarray(img, np.uint8)
        f = px.astype(np.float32) / 255.0
        if tex.srgb:
            f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]], -1)
        self._textures.append(f)
        return len(self._textures) - 1

    def build_np(self) -> np.ndarray:
        if not self._textures:
            return np.ones((1, self.size, self.size, 4), np.float32)
        return np.stack(self._textures)


def sample_bilinear(bank: TextureBank, tex_id, uv, default):
    """Bilinear sample with clamp-to-edge addressing and a -1 fallback.

    tex_id (...,) int; uv (..., 2); default (..., 4) or (4,)."""
    s = bank.size
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    u = torch.clamp(uv[..., 0], 0.0, 1.0) * (s - 1)
    v = torch.clamp(uv[..., 1], 0.0, 1.0) * (s - 1)
    x0 = torch.clamp(torch.floor(u).to(torch.int64), 0, s - 2)
    y0 = torch.clamp(torch.floor(v).to(torch.int64), 0, s - 2)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    d = bank.data.reshape(-1, bank.data.shape[-1])
    base = (tid * s + y0) * s + x0
    v00, v01 = d[base], d[base + 1]
    v10, v11 = d[base + s], d[base + s + 1]
    out = (v00 * (1 - fx) + v01 * fx) * (1 - fy) \
        + (v10 * (1 - fx) + v11 * fx) * fy
    return torch.where((tex_id >= 0)[..., None], out, default)
