"""Raster render path: tile-rasterizer visibility + the raster shading model.

Port of swift_game_engine_tpu/render/raster.py (reference:
Game/ShadersRaster.metalinc:38-101, Game/RenderPasses.swift:10-77): the
nearest ``max_layers`` fragments per pixel, shaded with the raster fragment
model (normal-mapped hemispherical wrap diffuse toward a fixed light,
emissive, occlusion, the unlit branch, per-material ACES tone map) and
composed front to back by alpha — the reference's fixed-function blending
(PipelineBuilder.swift:37-45). Records and lanes are in scanline order
throughout.

Visibility binning (``raster_mode``, the reference's SGE_RASTER_MODE):

  * ``"clusters"`` (default): one cluster-raster pass (kernel K1) keeps
    every layer's fragments, with the raster's own opaque flag ending a
    pixel's walk;
  * ``"lists"``: per-tile candidate lists and a depth-peel loop of the list
    raster (kernel K9): each layer rasterizes the nearest fragment strictly
    behind the previous layer's view depth.

The reference's primary-ray visibility (SGE_RASTER_VIS=trace) is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constant
from ..math3d import normalize
from .camera import generate_rays
from .rt import BG_COLOR, _sample_material, opaque_tris
from .scene_geometry import FrameGeometry, SceneGeometry
from .shading import apply_normal_map, tone_map_aces
from .textures import sample_bilinear
from .tile_raster import BIG, rasterize, rasterize_clusters

# Fixed raster light direction (ShadersRaster.metalinc:89).
RASTER_L = (np.array([-0.2, 1.0, -0.4]) /
            np.linalg.norm([-0.2, 1.0, -0.4])).astype(np.float32)
RASTER_MODES = ("clusters", "lists")


def _interp(attr, tri_v, u, v):
    """Barycentric vertex-attribute interpolation: attr (V, C), tri_v
    (P, 3)."""
    w = (1.0 - u - v)[:, None]
    return attr[tri_v[:, 0]] * w + attr[tri_v[:, 1]] * u[:, None] \
        + attr[tri_v[:, 2]] * v[:, None]


def _raster_shade(geo: SceneGeometry, fg: FrameGeometry, d, tri, u, v,
                  active):
    """Fragment shading (ShadersRaster.metalinc:56-101) -> (color, alpha);
    inactive lanes are 0."""
    safe_tri = tri.clamp(min=0)
    tri_v = geo.tri[safe_tri]
    uv = _interp(geo.uv, tri_v, u, v)
    mats = geo.materials
    mid = geo.tri_material[safe_tri].clamp(min=0)
    m = _sample_material(geo, mid, uv, mats.unlit[mid])
    occlusion = torch.ones_like(m["alpha"])
    if geo.usage.occlusion:
        occ_t = sample_bilinear(geo.textures, mats.occlusion_tex[mid], uv,
                                constant((1.0,) * 4, uv.device))[:, 0]
        occlusion = 1.0 + (occ_t - 1.0) * torch.clamp(
            mats.occlusion_strength[mid], 0.0, 1.0)
    n = normalize(_interp(fg.nrm, tri_v, u, v))
    if geo.usage.normal:
        tan4 = _interp(fg.tan, tri_v, u, v)
        n_tex = sample_bilinear(
            geo.textures, mats.normal_tex[mid], uv,
            constant((0.5, 0.5, 1.0, 1.0), uv.device))[:, :3]
        n = apply_normal_map(n, n, normalize(tan4[:, :3]),
                             torch.sign(tan4[:, 3]), n_tex,
                             mats.normal_scale[mid], normalize(-d))
    light = constant(RASTER_L, n.device)
    nl = torch.clamp((n * light).sum(-1), 0.0, 1.0) * 0.85 + 0.15
    albedo, emissive = m["base"], m["emissive"]
    lit = albedo * (nl * occlusion)[:, None] + emissive
    color = torch.where(mats.unlit[mid][:, None], albedo + emissive, lit)
    tm = tone_map_aces(color * torch.clamp(mats.exposure[mid], min=0.0)[:,
                                                                        None])
    color = torch.where(mats.tone_mapped[mid][:, None], tm, color)
    return (torch.where(active[:, None], color, 0.0),
            torch.where(active, m["alpha"], 0.0))


def render_frame_raster(geo: SceneGeometry, fg: FrameGeometry, inv_view_proj,
                        cam_pos, width: int, height: int, max_layers: int = 2,
                        background=BG_COLOR, view_proj=None,
                        raster_mode: str = "clusters"):
    """Raster-path frame -> (H, W, 3). ``inv_view_proj`` and ``view_proj``
    are tensors on the geometry's device; ``cam_pos`` (3,) is host values
    or a tensor. ``raster_mode``: "clusters" or "lists" (see the module
    docstring)."""
    if raster_mode not in RASTER_MODES:
        raise ValueError(f"raster_mode must be one of {RASTER_MODES}, got "
                         f"{raster_mode!r}")
    dev = fg.pos.device
    ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32, device=dev)
    vp = torch.linalg.inv(ivp) if view_proj is None else \
        torch.as_tensor(view_proj, dtype=torch.float32, device=dev)
    cam = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    _, ray_d = generate_rays(ivp, cam, width, height)
    p = ray_d.shape[0]
    tris = (fg.bvh.v0, fg.bvh.v1, fg.bvh.v2)
    accum = torch.zeros((p, 3), device=dev)
    accum_alpha = torch.zeros(p, device=dev)
    live = torch.ones(p, dtype=torch.bool, device=dev)
    peels = None
    if raster_mode == "clusters":
        peels = rasterize_clusters(*tris, vp, width, height,
                                   layers=max_layers, opaque=opaque_tris(geo),
                                   cam_pos=cam)
    prev_w = None
    for layer in range(max_layers):
        hits = peels[layer] if peels is not None else \
            rasterize(*tris, vp, cam, width, height, prev_w=prev_w)
        found = hits.found & live & (accum_alpha < 0.99)
        color, alpha = _raster_shade(geo, fg, ray_d, hits.tri, hits.u,
                                     hits.v, found)
        contrib = torch.where(found, alpha * (1.0 - accum_alpha), 0.0)
        accum = accum + color * contrib[:, None]
        accum_alpha = accum_alpha + contrib
        live = found
        # a small relative margin, so that the just-shaded fragment's
        # divided-then-compared depth cannot re-win the next peel
        prev_w = torch.where(found, hits.w_depth * 1.000001, BIG)
    out = accum + constant(background, dev) * (1.0 - accum_alpha)[:, None]
    return out.reshape(height, width, 3)
