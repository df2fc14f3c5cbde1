"""Image-based lighting: SH ambient, analytic prefiltered env, BRDF LUT.

Port of swift_game_engine_tpu/render/ibl.py (reference:
Game/IBLResources.swift:11-175, Game/RayTracingRenderer.swift:190-198).
The BRDF LUT is a host-side numpy precompute, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constant, resolve_device

ENV_MIP_COUNT = 8
ENV_SIZE = 128
LUT_SIZE = 128

_SKY = (0.65, 0.72, 0.9)
_GROUND = (0.12, 0.12, 0.14)
_SUN_DIR = (np.array([0.2, 0.9, 0.1]) / np.linalg.norm([0.2, 0.9, 0.1])
            ).astype(np.float32)

_C0, _C1 = 0.282095, 0.488603


def hemisphere_sh(device=None):
    """Ambient SH L0/L1 from the sky/ground hemisphere. (sh0 (3,), sh1 (3,))."""
    sky = torch.tensor([0.7, 0.8, 1.0], device=device)
    ground = torch.tensor([0.3, 0.25, 0.2], device=device)
    return (sky + ground) * 0.5 / _C0, (sky - ground) * 0.5 / _C1


def eval_env_sh(n, sh0, sh1):
    """L0 + y-linear L1 irradiance (only bands the reference populates)."""
    return sh0 * _C0 + sh1 * (_C1 * n[..., 1:2])


def sample_env(direction, roughness):
    """Analytic prefiltered environment (IBLResources.swift:106-121)."""
    d = direction
    sky, ground = constant(_SKY, d.device), constant(_GROUND, d.device)
    t = torch.clamp(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    color = ground + (sky - ground) * t
    ndotl = torch.clamp((d * constant(_SUN_DIR, d.device)).sum(-1), min=0.0)
    exponent = 800.0 + (30.0 - 800.0) * torch.clamp(roughness, 0.0, 1.0)
    sun = torch.pow(torch.clamp(ndotl, min=1e-6), exponent) * 4.0
    return torch.clamp(color + sun[..., None], 0.0, 1.0)


def _radical_inverse_vdc(bits):
    x = bits.astype(np.uint32)
    x = (x << 16) | (x >> 16)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return x.astype(np.float64) * 2.3283064365386963e-10


def integrate_brdf_lut(size: int = LUT_SIZE, samples: int = 256) -> np.ndarray:
    """GGX split-sum BRDF LUT, (size, size, 2): x=NoV, y=roughness
    (IBLResources.swift:123-175, Smith k = a^2/2, Hammersley)."""
    i = np.arange(samples)
    xi = np.stack([i / samples, _radical_inverse_vdc(i)], axis=-1)
    nov = np.maximum(np.arange(size) / (size - 1), 0.001)
    rough = np.maximum(np.arange(size) / (size - 1), 0.001)
    r = rough[:, None, None]
    a = r * r
    phi = 2.0 * np.pi * xi[None, None, :, 0]
    cos_t = np.sqrt((1.0 - xi[None, None, :, 1]) /
                    (1.0 + (a * a - 1.0) * xi[None, None, :, 1]))
    sin_t = np.sqrt(np.maximum(1.0 - cos_t ** 2, 0.0))
    h = np.stack([np.cos(phi) * sin_t, np.sin(phi) * sin_t,
                  np.broadcast_to(cos_t, np.broadcast_shapes(cos_t.shape,
                                                             phi.shape))],
                 axis=-1)
    nv = nov[None, :, None]
    v = np.stack([np.sqrt(np.maximum(1.0 - nv ** 2, 0.0)),
                  np.zeros_like(nv), nv], axis=-1)
    voh = np.maximum(np.sum(v * h, axis=-1), 0.0)
    l = 2.0 * voh[..., None] * h - v
    nol = np.maximum(l[..., 2], 0.0)
    noh = np.maximum(h[..., 2], 0.0)
    k = (r[..., 0] ** 2) * 0.5
    g_v = nv[..., 0] / (nv[..., 0] * (1.0 - k) + k)
    g_l = nol / (nol * (1.0 - k[..., None]) + k[..., None])
    g = g_v[..., None] * g_l
    g_vis = (g * voh) / np.maximum(noh * nv[..., 0][..., None], 1e-4)
    fc = (1.0 - voh) ** 5
    valid = nol > 0
    a_term = np.where(valid, (1.0 - fc) * g_vis, 0.0).mean(axis=-1)
    b_term = np.where(valid, fc * g_vis, 0.0).mean(axis=-1)
    return np.stack([a_term, b_term], axis=-1).astype(np.float32)


def sample_brdf_lut(lut, nov, roughness):
    """Bilinear LUT sample; lut (Y,X,2), coords clamped like GPU sampling."""
    size = lut.shape[0]
    x = torch.clamp(nov, 0.0, 1.0) * (size - 1)
    y = torch.clamp(roughness, 0.0, 1.0) * (size - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, size - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, size - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = lut.reshape(-1, lut.shape[-1])
    base = y0 * size + x0
    v00, v01 = flat[base], flat[base + 1]
    v10, v11 = flat[base + size], flat[base + size + 1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) \
        + (v10 * (1 - fx) + v11 * fx) * fy


def eval_spec_ibl(n, v, roughness, metallic, base, lut):
    """Split-sum specular IBL (RayTracing.metalinc:88-104)."""
    nv = (n * v).sum(-1)
    nov = torch.clamp(nv, 0.0, 1.0)
    r = 2.0 * nv[..., None] * n - v
    prefiltered = sample_env(r, roughness)
    brdf = sample_brdf_lut(lut, nov, roughness)
    f0 = 0.04 * (1.0 - metallic[..., None]) + base * metallic[..., None]
    return prefiltered * (f0 * brdf[..., 0:1] + brdf[..., 1:2])


# Env cube faces (the reference's parity export; on no frame's path).


def _cube_direction(face, u, v):
    """IBLResources.swift:93-104 face conventions: numpy (..., 3) unit
    directions of the face's (u, v) in [-1, 1]."""
    one = np.ones_like(u)
    d = np.stack({0: (one, -v, -u), 1: (-one, -v, u), 2: (u, one, v),
                  3: (u, -one, -v), 4: (u, -v, one)}.get(
                      face, (-u, -v, -one)), axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def make_env_cube(size: int = ENV_SIZE):
    """Every mip of the analytic environment's 6 faces, as float32 numpy
    arrays (mip, 6, s, s, 3) with the roughness of mip / (mips - 1)
    (ibl.py:172-186); ``sample_env`` on the host."""
    mips = []
    mip_count = int(np.log2(size)) + 1
    for mip in range(mip_count):
        s = max(size >> mip, 1)
        roughness = mip / (mip_count - 1) if mip_count > 1 else 0.0
        xs = (2.0 * (np.arange(s) + 0.5) / s) - 1.0
        u, v = np.meshgrid(xs, xs)  # v rows, u cols
        r = torch.full((), roughness, dtype=torch.float32)
        mips.append(np.stack([sample_env(torch.as_tensor(
            _cube_direction(face, u, v), dtype=torch.float32), r).numpy()
            for face in range(6)]))
    return mips


class IBL(NamedTuple):
    sh0: torch.Tensor
    sh1: torch.Tensor
    brdf_lut: torch.Tensor
    env_mip_count: int

    @staticmethod
    def build(device="cuda"):
        """The IBL tables on ``device`` (the card unless asked otherwise)."""
        device = resolve_device(device)
        sh0, sh1 = hemisphere_sh(device)
        return IBL(sh0=sh0, sh1=sh1,
                   brdf_lut=torch.as_tensor(integrate_brdf_lut(),
                                            device=device),
                   env_mip_count=ENV_MIP_COUNT)
