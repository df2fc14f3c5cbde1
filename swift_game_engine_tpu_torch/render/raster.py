"""Raster render path: tile-rasterizer visibility + the raster shading model.

Port of swift_game_engine_tpu/render/raster.py (reference:
Game/ShadersRaster.metalinc:38-101, Game/RenderPasses.swift:10-77): the
nearest ``max_layers`` fragments per pixel, shaded with the raster fragment
model (normal-mapped hemispherical wrap diffuse toward a fixed light,
emissive, occlusion, the unlit branch, per-material ACES tone map) and
composed front to back by alpha — the reference's fixed-function blending
(PipelineBuilder.swift:37-45). With the rasterizers, records and lanes
are in scanline order.

Visibility binning (``raster_mode``, the reference's SGE_RASTER_MODE):

  * ``"clusters"`` (default): one cluster-raster pass (kernel K1) keeps
    every layer's fragments, with the raster's own opaque flag ending a
    pixel's walk;
  * ``"lists"``: per-tile candidate lists and a depth-peel loop of the list
    raster (kernel K9): each layer rasterizes the nearest fragment strictly
    behind the previous layer's view depth.

Visibility source (``raster_vis``, the reference's SGE_RASTER_VIS):

  * ``"tile"`` (default): the rasterizers above;
  * ``"trace"``: primary-ray visibility (raster.py:163-189), max_layers
    dense closest-hit traces (kernel K4) of the live rays, each layer
    starting 2*bias past the last hit. The reference traces its scanline
    rays in square tiles (``camera.tile_permutation``) and permutes the
    image back; here the rays come in the RT frame's padded tile-major
    order (``generate_rays_tiled``) and ``untile_image`` crops the same
    (H, W) image: each ray's records are its own, so the order only
    groups the rays of a warp.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constant
from ..math3d import normalize
from ..ops.rt_kernel import trace_batch
from .camera import generate_rays, generate_rays_tiled, untile_image
from .rt import BG_COLOR, _next_origin, _sample_material, opaque_tris
from .scene_geometry import FrameGeometry, SceneGeometry
from .shading import apply_normal_map, tone_map_aces
from .textures import sample_bilinear
from .tile_raster import BIG, rasterize, rasterize_clusters

# Fixed raster light direction (ShadersRaster.metalinc:89).
RASTER_L = (np.array([-0.2, 1.0, -0.4]) /
            np.linalg.norm([-0.2, 1.0, -0.4])).astype(np.float32)
RASTER_MODES = ("clusters", "lists")
RASTER_VIS = ("tile", "trace")


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


def check_raster(raster_mode: str, raster_vis: str):
    """Raise on a binning or visibility source the raster frame does not
    know."""
    if raster_mode not in RASTER_MODES:
        raise ValueError(f"raster_mode must be one of {RASTER_MODES}, got "
                         f"{raster_mode!r}")
    if raster_vis not in RASTER_VIS:
        raise ValueError(f"raster_vis must be one of {RASTER_VIS}, got "
                         f"{raster_vis!r}")


def render_frame_raster(geo: SceneGeometry, fg: FrameGeometry, inv_view_proj,
                        cam_pos, width: int, height: int, max_layers: int = 2,
                        background=BG_COLOR, view_proj=None,
                        raster_mode: str = "clusters",
                        raster_vis: str = "tile"):
    """Raster-path frame -> (H, W, 3). ``inv_view_proj`` and ``view_proj``
    are tensors on the geometry's device; ``cam_pos`` (3,) is host values
    or a tensor. ``raster_mode``: "clusters" or "lists"; ``raster_vis``:
    "tile" or "trace" (see the module docstring)."""
    check_raster(raster_mode, raster_vis)
    dev = fg.pos.device
    ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32, device=dev)
    if raster_vis == "trace":
        return _render_trace(geo, fg, ivp, cam_pos, width, height,
                             max_layers, background)
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


def _render_trace(geo: SceneGeometry, fg: FrameGeometry, ivp, cam_pos,
                  width: int, height: int, max_layers: int, background):
    """Primary-ray visibility (raster.py:163-189): ``max_layers`` dense K4
    traces of the live rays, shaded with the raster model and composed
    front to back; a hit moves its ray's origin 2*bias past it."""
    dev = fg.pos.device
    cam = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    o, d, _, _ = generate_rays_tiled(ivp, cam, width, height)
    p = d.shape[0]
    accum = torch.zeros((p, 3), device=dev)
    accum_alpha = torch.zeros(p, device=dev)
    live = torch.ones(p, dtype=torch.bool, device=dev)
    for _ in range(max_layers):
        live = live & (accum_alpha < 0.99)
        t, tri, u, v, found = trace_batch(fg.bvh, o, d, live)
        color, alpha = _raster_shade(geo, fg, d, tri, u, v, found)
        contrib = torch.where(found, alpha * (1.0 - accum_alpha), 0.0)
        accum = accum + color * contrib[:, None]
        accum_alpha = accum_alpha + contrib
        o = torch.where(found[:, None],
                        _next_origin(o, d, torch.where(found, t, 1.0)), o)
        live = live & found
    out = accum + constant(background, dev) * (1.0 - accum_alpha)[:, None]
    return untile_image(out, width, height)
