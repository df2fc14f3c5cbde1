"""PBR shading math: GGX BRDF, Fresnel, tone mapping, dither, normal mapping.

Port of swift_game_engine_tpu/render/shading.py (reference:
Game/RayTracing.metalinc:11-104, Game/ShadersRaster.metalinc:23-36). All
functions broadcast over leading ray/pixel dims.
"""

from __future__ import annotations

import torch

from ..math3d import normalize, cross

PI = 3.14159265


def fresnel_schlick(cos_theta, f0):
    """Scalar-F0 Schlick (RayTracing.metalinc:21-23)."""
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0),
                                       5.0)


def fresnel_schlick3(cos_theta, f0):
    """Vector F0 variant: cos_theta (...,), f0 (...,3)."""
    p = torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)[..., None]
    return f0 + (1.0 - f0) * p


def ggx_d(noh, alpha):
    a2 = alpha * alpha
    denom = (noh * noh) * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def ggx_g1(nov, alpha):
    a2 = alpha * alpha
    denom = nov + torch.sqrt(a2 + (1.0 - a2) * nov * nov)
    return 2.0 * nov / torch.clamp(denom, min=1e-4)


def eval_brdf(n, v, l, base, metallic, roughness):
    """Cook-Torrance GGX + Lambert diffuse (RayTracing.metalinc:42-59)."""
    nol = torch.clamp((n * l).sum(-1), 0.0, 1.0)
    nov = torch.clamp((n * v).sum(-1), 0.0, 1.0)
    h = normalize(v + l)
    noh = torch.clamp((n * h).sum(-1), 0.0, 1.0)
    voh = torch.clamp((v * h).sum(-1), 0.0, 1.0)
    alpha = roughness * roughness
    diff = base * ((1.0 - metallic) / PI)[..., None]
    d = ggx_d(noh, alpha)
    g = ggx_g1(nov, alpha) * ggx_g1(nol, alpha)
    f0 = 0.04 * (1.0 - metallic[..., None]) + base * metallic[..., None]
    f = fresnel_schlick3(voh, f0)
    spec = f * ((d * g) / torch.clamp(4.0 * nov * nol, min=1e-4))[..., None]
    lit = (nol > 0.0) & (nov > 0.0)
    return torch.where(lit[..., None], diff + spec, 0.0)


def shadow_bias(hit_distance):
    """RayTracing.metalinc:61-63."""
    return torch.clamp(hit_distance * 0.002, min=0.002)


def tone_map_aces(x):
    """ShadersRaster.metalinc:23-30."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def hash12(p):
    """Screen-space hash dither (ShadersRaster.metalinc:32-36). p: (...,2)."""
    p3 = torch.remainder(torch.stack([p[..., 0], p[..., 1], p[..., 0]], -1)
                         * 0.1031, 1.0)
    p3 = p3 + (p3 * (torch.roll(p3, -1, dims=-1) + 33.33)).sum(-1, keepdim=True)
    return torch.remainder((p3[..., 0] + p3[..., 1]) * p3[..., 2], 1.0)


def apply_normal_map(n_geom, n_shade, tangent, tangent_sign, n_tex,
                     normal_scale, view):
    """Tangent-space normal perturbation with grazing-angle attenuation
    (RayTracing.metalinc:283-316): scale soft-clamped above 4, xy scaled by
    smoothstep(0.05, 0.5, NoV), z rebuilt. ``n_tex``: raw rgb in [0,1]."""
    nov = torch.clamp((n_geom * view).sum(-1), 0.0, 1.0)
    t = torch.clamp((nov - 0.05) / 0.45, 0.0, 1.0)
    graze = t * t * (3.0 - 2.0 * t)
    ns = 4.0 + torch.clamp(normal_scale - 4.0, min=0.0) * 0.25
    decoded = n_tex * 2.0 - 1.0
    xy = decoded[..., :2] * (ns * graze)[..., None]
    z = torch.sqrt(torch.clamp(1.0 - (xy * xy).sum(-1), min=0.0))
    b = normalize(cross(n_shade, tangent)) * tangent_sign[..., None]
    return normalize(tangent * xy[..., 0:1] + b * xy[..., 1:2]
                     + n_shade * z[..., None])


def reflect(d, n):
    return d - 2.0 * (d * n).sum(-1, keepdim=True) * n


def refract(incident, n, eta):
    """Snell refraction; zero vector on total internal reflection."""
    cosi = -(incident * n).sum(-1)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    t = eta[..., None] * incident \
        + (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0)))[..., None] * n
    return torch.where((k >= 0.0)[..., None], t, 0.0)
