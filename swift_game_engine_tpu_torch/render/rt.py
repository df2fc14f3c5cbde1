"""Ray-traced frame: port of swift_game_engine_tpu/render/rt.py.

The reference's RT frame at its config.py defaults, in its four primary
visibility modes (``render_frame(primary=...)``, the reference's
``SGE_RT_PRIMARY``):

  * ``"hybrid"`` (default): primary visibility from two cluster rasters
    (kernel K1): the opaque triangles (1 layer) and the translucent subset
    (max_layers peeled layers in front of the opaque depth), composed into
    per-layer hit records by the layered floor chain (incl. the 2*bias
    continuation skip);
  * ``"trace"``: the reference's intersector semantics. On a tree of at most
    ``WALK_MAX_ROWS`` rows one layered shared-origin walk (kernel K5) gives
    the nearest opaque hit and max_layers translucent hits per pixel, and
    the same floor chain makes the layer records; with ``layered=False``
    (the reference's SGE_RT_LAYERED=0) a dense shared-origin closest-hit
    trace (K6) gives layer 1 and each continuation layer re-traces the live
    camera rays with K6 past a per-lane t floor (t + 2*bias), compacted. On
    a larger tree a dense closest-hit trace (K4) gives layer 1 and the
    continuation layers re-trace from offset origins (K4), compacted.
    This mode is ``_render_rays`` (rt.py:1393), the flat-ray core that
    ``parallel/sharding.py`` runs on each shard's slice of the lanes;
  * ``"peels"``: one cluster raster (K1) of every triangle with max_layers
    peeled layers, opaque fragments ending a pixel's walk, gives every
    layer's records (t the ray distance from the barycentrics);
  * ``"raster"``: one cluster raster (K1) of every triangle, 1 layer, gives
    layer 1; the continuation layers re-trace from offset origins (K4),
    compacted, as on a large tree in "trace" mode.

Then, in every mode, the layer records are shaded by the schedule
``lbatch`` picks (the reference's SGE_RT_LBATCH; records the visibility
pass gives up front: "hybrid", "peels", the layered walk):

  * 2 (default): layer 1 shaded densely, continuation layers 2.. shaded
    together as one compacted record set, then the front-to-back alpha
    chain elementwise;
  * 1: every layer, layer 1 included, through that batched shade;
  * 0: layer 1 densely, then one compacted shade per continuation layer,
    gated by the chain;
  * 3: as 0, but each continuation layer shaded densely, gated by the
    chain ("hybrid" only, as in the reference; the others take 0).

With ``deferred=True`` (the reference's SGE_RT_DEFERRED) the "hybrid"
records are shaded by ``render/deferred.py`` instead: one G-buffer pass,
one merged bounce trace, one shadow sweep and one light pass for the frame.
Per shade call:

  * per hit: the static shade row gathers (SROW), the material sample with
    sparse texture taps, normal mapping, GGX direct light per directional
    light, SH ambient, split-sum specular IBL and the unlit fast path;
  * light-0 shadows, chosen per frame as the reference chooses them
    (rt.py:1420-1452): with 1..4 shadow layers, the split cluster sweeps
    (kernels K2 + K3, any-hit occlusion, alpha-payload records) for frames
    of at least ``SHADOW_CLUSTER_MIN_LANES`` padded lanes, else the
    shared-direction shadow walk (kernel K7) on a tree of at most
    ``WALK_MAX_ROWS`` rows — their records go through the reference's
    exact layer semantics elementwise (``_apply_shadow_records``); else
    the per-layer closest-hit loop (K4), any number of layers. With
    ``shadow_prepass=True`` (SGE_SHADOW_PREPASS=1) and a tree the walks
    serve, the loop starts after an any-hit pass over the opaque triangles
    (kernel K8): blocked lanes are in shadow and leave the loop;
  * one mirror bounce and one refraction bounce, traced with kernel K4.

The sorted shadow sweep (rt.py:424-491, ``_shadow_factor(sort=)``): in the
cluster mode a sorted call traces K2/K3 on its origins reordered, live
lanes first in their order (``shadow_sort_mode="partition"``) or by a
light-space Morton code ("morton"), and copies the records back to the
lanes' order. The records are per lane, so the factors equal the
unsorted sweep's bit for bit; the order only packs a warp's lanes. As in
the reference, the bounce shades and the compacted shades sort (their live
lanes are scattered among dead ones: bounce misses and light-gate
failures) and ``shadow_sort=True`` (SGE_SHADOW_SORT) sorts the dense calls
too; the walk and loop modes ignore it.

Compaction: wherever the reference runs ``_chunked`` (fixed-size chunks of
the set lanes, looped until drained), this port compacts the set lanes into
one chunk of fixed capacity, the site's whole lane universe (``p`` for a
shade batch's lanes, ``nl * p`` for the continuation records), with
``render/compact.py``: the set lanes in ascending order, then fill slots
that gathers clamp and scatters drop, and the count on the device. Nothing
is read back to the host: every loop runs its fixed count (all max_layers
layers, all shadow_layers shadow steps), a lane with nothing left to do is
parked, and the bodies run at their capacity while K4 and K6 skip the
lanes past the count. So the frame can be captured as one CUDA graph
(``scene/engine.py``). Every record is shaded independently of the others,
so any compaction order and chunking gives the same image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constant, resolve_device
from ..math3d import normalize
from ..ops import rt_kernel as RK
from ..ops.cluster_shadow import (_part1by1, build_shadow_split,
                                  trace_shadow_split)
from ..ops.rt_kernel import barycentrics, trace_batch
from ..spans import stage
from .camera import generate_rays_tiled, untile_image
from .compact import compact, gather, packets, scatter
from .ibl import IBL, eval_env_sh, eval_spec_ibl
from .scene_geometry import FrameGeometry, SceneGeometry
from .shading import (apply_normal_map, eval_brdf, fresnel_schlick,
                      fresnel_schlick3, hash12, reflect, refract, shadow_bias)
from .textures import sample_bilinear
from .tile_raster import CLUSTER, TRANS_CLUSTER, rasterize_clusters

BG_COLOR = (0.02, 0.02, 0.03)
AMBIENT_INTENSITY = 0.25  # RayTracingRenderer.swift:82
BIG = 3.0e38
# Frames of at least this many padded tile-major lanes take the cluster
# shadow sweeps (config.py:53 SGE_SHADOW_CLUSTER_MIN_LANES); smaller frames
# take the shadow walk (K7) or, on a large tree, the per-layer loop.
SHADOW_CLUSTER_MIN_LANES = 100_000
# Lanes of a traversal packet, the unit of packet compaction
# (config.py:25 SGE_RT_BLOCK): one 32x128 pixel tile of the tile-major
# lanes.
PACKET_BLOCK = 4096
PRIMARY_MODES = ("hybrid", "trace", "raster", "peels")
SHADOW_SORT_MODES = ("partition", "morton")
LBATCH_MODES = (0, 1, 2, 3)


class DirectionalLights(NamedTuple):
    """reference: Game/Lights.swift:10-28 / RTDirectionalLight."""

    direction: torch.Tensor     # (L,3)
    intensity: torch.Tensor     # (L,)
    color: torch.Tensor         # (L,3)
    enabled: torch.Tensor       # (L,) bool
    max_distance: torch.Tensor  # (L,)

    @staticmethod
    def default_sun(device="cuda") -> "DirectionalLights":
        """The reference's fallback sun (RayTracingRenderer.swift:163-168)
        on ``device`` (the card unless asked otherwise)."""
        return DirectionalLights.from_list([], device)

    @staticmethod
    def from_list(lights, device="cuda") -> "DirectionalLights":
        """From dicts with direction/intensity/color[/enabled/max_distance]
        on ``device`` (the card unless asked otherwise); an empty list gives
        the reference's fallback sun."""
        device = resolve_device(device)
        if not lights:
            lights = [dict(direction=(-0.2, -1.0, -0.4), intensity=2.6,
                           color=(1.0, 0.95, 0.85))]

        def t(key, default=None, dtype=torch.float32):
            return torch.tensor([l.get(key, default) for l in lights],
                                dtype=dtype, device=device)

        return DirectionalLights(direction=t("direction"),
                                 intensity=t("intensity"), color=t("color"),
                                 enabled=t("enabled", True, torch.bool),
                                 max_distance=t("max_distance", 200.0))


class _Frame(NamedTuple):
    """Per-frame constants every shade call reads."""

    geo: SceneGeometry
    fg: FrameGeometry
    ibl: IBL
    lights: DirectionalLights
    cam: torch.Tensor
    shadow: object            # light 0: ShadowSplit ("clusters"), (shadow
    shadow_layers: int        # rows, l) ("walk") or None ("loop")
    enable_mirror: bool
    enable_refraction: bool
    shadow_mode: str = "clusters"
    shadow_prepass: bool = False  # "loop": the K8 any-hit prepass first
    shadow_sort: bool = False     # sort the dense calls' sweeps too
    shadow_sort_mode: str = "partition"
    unlit_fast: bool = True       # unlit records: albedo + emissive, unlit
    unlit_split: bool = False     # the continuation shade's unlit passes
    unlit_dense: bool = False
    packet_compact: bool = False  # retraces compacted by whole packets


def _bg(device):
    return constant(BG_COLOR, device)


def _sparse_tap(textures, tex_ids, uv, default, active=None):
    """Bilinear taps only for lanes that bind a texture (tex_id >= 0),
    compacted; other lanes get ``default`` (4,)."""
    bound = tex_ids >= 0
    if active is not None:
        bound = bound & active
    c = compact(bound)
    taps = sample_bilinear(textures, gather(tex_ids, c), gather(uv, c),
                           default)
    return scatter(default.expand(tex_ids.shape[0], 4), c, taps)


def _sample_material(geo: SceneGeometry, mid, uv, unlit, active=None):
    """PBR material sample per hit (RayTracing.metalinc:132-176)."""
    mats, usage = geo.materials, geo.usage
    row = mats.packed[mid]
    base = row[:, 0:3]
    alpha = torch.clamp(row[:, 3], 0.0, 1.0)
    metallic = torch.clamp(row[:, 4], 0.0, 1.0)
    roughness = torch.clamp(row[:, 5], 0.05, 1.0)
    emissive = row[:, 6:9]
    occlusion = torch.clamp(row[:, 9], 0.0, 1.0)
    white = constant((1.0,) * 4, mid.device)
    if usage.base:
        t = _sparse_tap(geo.textures, row[:, 13].long(), uv, white, active)
        base = base * t[:, :3]
        alpha = alpha * t[:, 3]
    if usage.mr:
        t = _sparse_tap(geo.textures, row[:, 15].long(), uv, white, active)
        roughness = roughness * t[:, 1]
        metallic = metallic * t[:, 2]
    if usage.emissive:
        t = _sparse_tap(geo.textures, mats.emissive_tex[mid].long(), uv,
                        white, active)
        emissive = emissive * t[:, :3]
    if usage.occlusion:
        t = _sparse_tap(geo.textures, mats.occlusion_tex[mid].long(), uv,
                        white, active)
        occlusion = occlusion * t[:, 0]
    return dict(base=base, alpha=alpha, metallic=metallic,
                roughness=roughness, emissive=emissive, occlusion=occlusion,
                transmission=torch.clamp(row[:, 10], 0.0, 1.0),
                ior=torch.clamp(row[:, 11], min=1.0),
                normal_tex=row[:, 14].long(), normal_scale=row[:, 12],
                unlit=unlit)


def opaque_tris(geo: SceneGeometry):
    """Per-triangle 'fragment fully occludes' flag of the raster's early
    exit (rt.py:1139-1148 _opaque_tris): material alpha factor >= 0.99 and
    no alpha-carrying base texture bound."""
    mid = geo.tri_material.clamp(min=0)
    opaque = geo.materials.alpha[mid] >= 0.99
    if geo.usage.base and geo.usage.alpha_tex:
        opaque = opaque & (geo.materials.base_tex[mid] < 0)
    return opaque


def _sample_alpha(geo: SceneGeometry, tri, u, v, active=None):
    """Shadow-filter alpha (RayTracing.metalinc:178-195): the material
    factor, times the base texture's alpha where one carries alpha (tapped
    for the ``active`` lanes only, when given)."""
    srow = geo.tri_shade[tri.clamp(min=0)]
    mid = srow[:, 6].long()
    alpha = torch.clamp(geo.materials.alpha[mid], 0.0, 1.0)
    if not (geo.usage.base and geo.usage.alpha_tex):
        return alpha
    w = (1.0 - u - v)[:, None]
    uv = srow[:, 0:2] * w + srow[:, 2:4] * u[:, None] + srow[:, 4:6] * v[:, None]
    t = _sparse_tap(geo.textures, geo.materials.base_tex[mid].long(), uv,
                    constant((1.0,) * 4, tri.device), active)
    return alpha * t[:, 3]


def _apply_shadow_records(fr: _Frame, o_sh, l, t_opq, ts, ids, active,
                          max_dist, alpha_payload: bool):
    """The reference's exact shadow layer semantics over the records:
    nearest first, each translucent layer multiplies by (1 - alpha), stop
    at shadow <= 0.02 or after shadow_layers layers; an opaque hit inside
    the remaining budget zeroes the factor."""
    p = o_sh.shape[0]
    shadow = torch.ones(p, device=o_sh.device)
    applied = torch.zeros(p, dtype=torch.int32, device=o_sh.device)
    for k in range(fr.shadow_layers):
        t_k = ts[:, k]
        if alpha_payload:
            exist = ids[:, k] >= 0
            a_k = ids[:, k] - 2.0
        else:
            tri_k = torch.floor(ids[:, k]).long()
            exist = tri_k >= 0
            if fr.geo.usage.base and fr.geo.usage.alpha_tex:
                u_k, v_k, _ = barycentrics(fr.fg.bvh, o_sh, l.expand_as(o_sh),
                                           torch.where(exist, t_k, 0.0), tri_k)
            else:
                u_k = v_k = torch.zeros_like(t_k)
            a_k = _sample_alpha(fr.geo, tri_k, u_k, v_k)
        can = active & exist & (t_k < t_opq) & (t_k < max_dist) & \
            (shadow > 0.02)
        shadow = torch.where(can, shadow * (1.0 - a_k), shadow)
        applied = applied + can.to(torch.int32)
    opq_can = active & (t_opq < max_dist) & (shadow > 0.02) & \
        (applied < fr.shadow_layers)
    shadow = torch.where(opq_can, 0.0, shadow)
    return torch.where(active, shadow, 1.0)


def _shadow_mode(geo: SceneGeometry, fg: FrameGeometry, lights,
                 lanes: int, shadow_layers: int):
    """The frame's light-0 shadow source (rt.py:1420-1452) -> (mode, the
    per-frame constants its shade calls share). The record kernels hold 1..4
    slots; other layer counts take the loop. The mode depends on the lane
    count and the tree's row count alone, so it is fixed for a frame size;
    the walk's direction stays on the device, where K7 reads it."""
    if not 1 <= shadow_layers <= 4:
        return "loop", None
    l0 = normalize(-lights.direction[0])
    if lanes >= SHADOW_CLUSTER_MIN_LANES:
        bv = fg.bvh
        mid_t = geo.tri_material.clamp(min=0)
        return "clusters", build_shadow_split(
            bv.v0, bv.v1, bv.v2, l0, geo.tri_translucent,
            alpha=torch.clamp(geo.materials.alpha[mid_t], 0.0, 1.0),
            trans_idx=geo.translucent_idx)
    if RK.walk_available(fg.bvh.rows):
        return "walk", (RK.build_shadow_rows(fg.bvh.rows, l0,
                                             fg.bvh.wide.leaves), l0)
    return "loop", None


def _shadow_loop(fr: _Frame, o, l, max_dist, bias, active):
    """The per-layer shadow loop (rt.py:865-910): closest hit toward the
    light, multiply by (1 - alpha), continue past the surface, at most
    shadow_layers times while the factor stays above 0.02; after the
    any-hit prepass when the frame takes it. All shadow_layers steps run;
    each traces its live lanes compacted (K4 skips past their count), so a
    lane that is done is parked."""
    shadow = torch.ones(o.shape[0], device=o.device)
    act = active
    d = l.expand_as(o).contiguous()
    if fr.shadow_prepass:
        # rt.py:867-886: a lane with ANY opaque blocker has shadow 0
        # whatever the order of its hits; the loop resolves the rest
        t_lim = torch.where(active, torch.clamp(max_dist, max=BIG), 0.0)
        o_sh = torch.where(active[:, None], o, 1.0e9).contiguous()
        blocked = RK.trace_shadow_any(fr.fg.bvh.wide, fr.fg.bvh.rows, o_sh,
                                      d, t_lim.contiguous()) & active
        shadow = torch.where(blocked, 0.0, shadow)
        act = active & ~blocked
    for _ in range(fr.shadow_layers):
        c = compact(act & (shadow > 0.02))
        o_c, sh_c = gather(o, c), gather(shadow, c)
        # every lane's direction is l: d serves the compacted lanes as is
        t, tri, u, v, found = trace_batch(fr.fg.bvh, o_c, d, c.valid,
                                          c.count)
        found = found & (t < max_dist)
        a = _sample_alpha(fr.geo, tri, u, v)
        shadow = scatter(shadow, c, torch.where(found, sh_c * (1.0 - a), sh_c))
        sh_pos = o_c + l * t[:, None]
        step = l * (gather(bias, c) * 2.0)[:, None]
        o = scatter(o, c, torch.where(found[:, None], sh_pos + step, o_c))
        act = scatter(torch.zeros_like(act), c, found)
    return shadow


def _light_morton_order(basis, o, t_lim):
    """Permutation grouping shadow origins by light-space locality
    (rt.py:433-455): Morton codes of the (e1, e2) light-plane coordinates
    (``basis`` rows 0-1), 10 bits an axis over the live lanes' bounding
    rectangle; dead lanes (t_lim <= 0) sort last."""
    a = o @ basis[0]
    b = o @ basis[1]
    live = t_lim > 0.0

    def quantize(x):
        x0 = torch.where(live, x, BIG).amin()
        x1 = torch.where(live, x, -BIG).amax()
        q = (x - x0) / torch.clamp(x1 - x0, min=1e-6) * 1023.0
        return torch.clamp(q, 0.0, 1023.0).to(torch.int32)

    code = (_part1by1(quantize(b)) << 1) | _part1by1(quantize(a))
    code = torch.where(live, code, 1 << 22)
    return torch.argsort(code, stable=True)


def _live_first_order(live):
    """Stable permutation putting the live lanes first in their order
    (rt.py:468-482, which builds it by a cumsum and a scatter): one stable
    sort of the dead flags."""
    return torch.argsort((~live).to(torch.uint8), stable=True)


def _shadow_order(mode: str, basis, o, t_lim):
    """The order of a sorted sweep (rt.py:485-490): the live-first
    partition, or the light-space Morton order."""
    if mode == "partition":
        return _live_first_order(t_lim > 0.0)
    return _light_morton_order(basis, o, t_lim)


def _shadow_factor(fr: _Frame, hit_pos, n, light_dir, max_dist, bias,
                   active, sort=None):
    """Alpha-filtered shadow toward directional light 0
    (RayTracing.metalinc:332-372) from the frame's shadow source.
    ``sort`` (default: the frame's ``shadow_sort``): the cluster sweeps
    run on the origins in ``_shadow_order``'s order and their records are
    copied back to the lanes' order (rt.py:756-850); bit-equal records,
    since each lane's are its own. The copy back scatters by the order
    (``index_copy_``): on the card a gather of the (n, 4) slot records by
    the inverse permutation cost several times the sweep (PERF.md)."""
    l = normalize(-light_dir)
    o0 = hit_pos + n * bias[:, None]
    if fr.shadow_mode == "loop":
        return _shadow_loop(fr, o0, l, max_dist, bias, active)
    o_sh = torch.where(active[:, None], o0, 1.0e9).contiguous()
    if fr.shadow_mode == "walk":
        # rt.py:853-864: the t limit is the light's range alone
        t_lim = torch.where(active, torch.clamp(max_dist, max=BIG), 0.0)
        srows, l0 = fr.shadow
        t_opq, ts, ids = RK.trace_shadow_factor(
            fr.fg.bvh.wide, srows, l0, o_sh, t_lim.contiguous(),
            n_slots=fr.shadow_layers)
        return _apply_shadow_records(fr, o_sh, l, t_opq, ts, ids, active,
                                     max_dist, False)
    # Exact per-lane t limit: no triangle lies outside the root AABB, so a
    # shadow ray needs nothing past its AABB exit distance.
    bmin, bmax = fr.fg.bvh.bmin[0], fr.fg.bvh.bmax[0]
    safe_l = torch.where(l.abs() < 1e-12, 1e-12, l)
    tx0 = (bmin[None, :] - o0) / safe_l[None, :]
    tx1 = (bmax[None, :] - o0) / safe_l[None, :]
    t_exit = torch.maximum(tx0, tx1).amin(-1) + 1e-2
    t_lim = torch.where(active, torch.minimum(
        torch.clamp(max_dist, max=BIG), torch.clamp(t_exit, min=0.0)), 0.0)
    # alpha payload unless a bound base texture carries alpha
    ap = not (fr.geo.usage.base and fr.geo.usage.alpha_tex)
    t_lim = t_lim.contiguous()
    if fr.shadow_sort if sort is None else sort:
        order = _shadow_order(fr.shadow_sort_mode, fr.shadow.full.basis,
                              o_sh, t_lim)
        t_opq, ts, ids = (torch.empty_like(r).index_copy_(0, order, r)
                          for r in trace_shadow_split(
                              fr.shadow, o_sh[order], t_lim[order],
                              n_slots=fr.shadow_layers, alpha_payload=ap,
                              anyhit=True))
    else:
        t_opq, ts, ids = trace_shadow_split(fr.shadow, o_sh, t_lim,
                                            n_slots=fr.shadow_layers,
                                            alpha_payload=ap, anyhit=True)
    return _apply_shadow_records(fr, o_sh, l, t_opq, ts, ids, active,
                                 max_dist, ap)


def _gbuffer(fr: _Frame, ray_o, ray_d, t_hit, tri, u, v, active):
    """Shading normal (incl. normal mapping), hit position, shadow bias and
    the material sample of each record."""
    geo, fg = fr.geo, fr.fg
    t_hit = torch.where(active, t_hit, 1.0)
    safe_tri = tri.clamp(min=0)
    srow = geo.tri_shade[safe_tri]
    n_geom = fg.tri_nrm[safe_tri]
    wbar = (1.0 - u - v)[:, None]
    uv = srow[:, 0:2] * wbar + srow[:, 2:4] * u[:, None] \
        + srow[:, 4:6] * v[:, None]
    n_geom = torch.where((n_geom * ray_d).sum(-1, keepdim=True) > 0,
                         -n_geom, n_geom)
    view = normalize(-ray_d)
    m = _sample_material(geo, srow[:, 6].long(), uv, srow[:, 7] > 0.5,
                         active)
    n = n_geom
    if geo.usage.normal:
        c = compact((m["normal_tex"] >= 0) & active)
        tv = geo.tri[gather(safe_tri, c)]
        uc, vc = gather(u, c), gather(v, c)
        wc = (1.0 - uc - vc)[:, None]

        def interp(attr):
            return attr[tv[:, 0]] * wc + attr[tv[:, 1]] * uc[:, None] \
                + attr[tv[:, 2]] * vc[:, None]

        n_vert = normalize(interp(fg.nrm))
        tan4 = interp(fg.tan)
        n_tex = sample_bilinear(
            geo.textures, gather(m["normal_tex"], c), gather(uv, c),
            constant((0.5, 0.5, 1.0, 1.0), uv.device))[:, :3]
        n_mapped = apply_normal_map(gather(n_geom, c), n_vert,
                                    normalize(tan4[:, :3]),
                                    torch.sign(tan4[:, 3]), n_tex,
                                    gather(m["normal_scale"], c),
                                    gather(view, c))
        n_mapped = torch.where(
            (n_mapped * gather(ray_d, c)).sum(-1, keepdim=True) > 0,
            -n_mapped, n_mapped)
        n = scatter(n_geom, c, n_mapped)
    hit_pos = ray_o + ray_d * t_hit[:, None]
    return m, n, hit_pos, shadow_bias(t_hit)


def _light_gate(fr: _Frame, i: int, m, n, hit_pos, active):
    """Gate of directional light i (RayTracing.metalinc:320-330 + the unlit
    fast path: unlit records take no light and cast no shadow rays)."""
    lights = fr.lights
    max_dist = torch.where(lights.max_distance[i] > 0,
                           lights.max_distance[i], 1e6)
    l = normalize(-lights.direction[i])
    ndotl = torch.clamp((n * l).sum(-1), min=0.0)
    cam_dist = torch.linalg.vector_norm(hit_pos - fr.cam, dim=-1)
    gate = active & lights.enabled[i] & (cam_dist <= max_dist) & (ndotl > 0)
    if fr.unlit_fast:
        gate = gate & ~m["unlit"]
    return gate, ndotl, max_dist, l


def _light_records(fr: _Frame, ray_d, m, n, hit_pos, active,
                   with_ibl_spec: bool, shadow0=None, gates=None):
    """The lighting of G-buffer records (rt.py:1023-1063): GGX direct per
    light, SH ambient, split-sum specular IBL (``with_ibl_spec``), the
    unlit override, all elementwise. ``shadow0``: light 0's shadow factor
    per record (1 if None); ``gates``: the lights' ``_light_gate`` results
    (computed here if None). Inactive records are 0."""
    lights = fr.lights
    view = normalize(-ray_d)
    direct = torch.zeros_like(hit_pos)
    for i in range(lights.direction.shape[0]):
        gate, ndotl, _, l = gates[i] if gates is not None else \
            _light_gate(fr, i, m, n, hit_pos, active)
        shadow = shadow0 if i == 0 and shadow0 is not None else \
            torch.ones_like(ndotl)
        brdf = eval_brdf(n, view, l.expand_as(n), m["base"], m["metallic"],
                         m["roughness"])
        li = lights.color[i] * lights.intensity[i]
        direct = direct + torch.where(gate[:, None],
                                      brdf * li * (ndotl * shadow)[:, None],
                                      0.0)
    ambient = m["base"] * eval_env_sh(n, fr.ibl.sh0, fr.ibl.sh1) \
        * AMBIENT_INTENSITY * m["occlusion"][:, None]
    color = direct + ambient + m["emissive"]
    if with_ibl_spec:
        spec = eval_spec_ibl(n, view, m["roughness"], m["metallic"],
                             m["base"], fr.ibl.brdf_lut)
        color = color + spec * m["occlusion"][:, None]
    if fr.unlit_fast:   # unlit: albedo + emissive, the raster unlit branch
        color = torch.where(m["unlit"][:, None], m["base"] + m["emissive"],
                            color)
    return torch.where(active[:, None], color, 0.0)


def _shade_hit(fr: _Frame, ray_o, ray_d, t_hit, tri, u, v, active,
               with_ibl_spec: bool, sort=None):
    """Shade one hit batch -> (color, m, n, hit_pos, bias): ``_gbuffer``,
    the light gates, light 0's shadow (``sort``: see ``_shadow_factor``)
    and ``_light_records``; inactive lanes are sanitized and their color
    is 0."""
    m, n, hit_pos, bias = _gbuffer(fr, ray_o, ray_d, t_hit, tri, u, v, active)
    gates = [_light_gate(fr, i, m, n, hit_pos, active)
             for i in range(fr.lights.direction.shape[0])]
    gate0, _, max_dist0, _ = gates[0]
    with stage("sge.render.shadows"):
        shadow0 = _shadow_factor(fr, hit_pos, n, fr.lights.direction[0],
                                 max_dist0, bias, gate0, sort=sort)
    color = _light_records(fr, ray_d, m, n, hit_pos, active, with_ibl_spec,
                           shadow0, gates)
    return color, m, n, hit_pos, bias


def _retrace_lanes(fr: _Frame, mask):
    """The compaction of lanes that re-trace (the reference's
    ``_chunked_trace``, rt.py:319-326): whole packets of ``PACKET_BLOCK``
    lanes with ``packet_compact``, else the set lanes."""
    return packets(mask, PACKET_BLOCK) if fr.packet_compact else \
        compact(mask)


def _mirror_pass(fr: _Frame, d, n, hit_pos, bias, metallic, base, mask,
                 color):
    """One deterministic mirror bounce for the set lanes of ``mask``
    (RayTracing.metalinc:382-542), compacted."""
    c = _retrace_lanes(fr, mask)
    n_c, d_c = gather(n, c), gather(d, c)
    r_dir = normalize(reflect(d_c, n_c))
    r_o = gather(hit_pos, c) + n_c * gather(bias, c)[:, None]
    rt, rtri, ru, rv, rfound = trace_batch(fr.fg.bvh, r_o, r_dir, c.valid,
                                           c.count)
    r_color, r_m, _, _, _ = _shade_hit(fr, r_o, r_dir, rt, rtri, ru, rv,
                                       rfound, False, sort=True)
    refl_alpha = torch.where(rfound, r_m["alpha"], 0.0)
    refl = torch.where(rfound[:, None], r_color * refl_alpha[:, None], 0.0) \
        + _bg(d.device) * (1.0 - refl_alpha)[:, None]
    nov = torch.clamp((n_c * normalize(-d_c)).sum(-1), 0.0, 1.0)
    met = gather(metallic, c)[:, None]
    f = fresnel_schlick3(nov, 0.04 * (1.0 - met) + gather(base, c) * met)
    return scatter(color, c, gather(color, c) * (1.0 - f) + refl * f)


def refraction_setup(d, n, ior):
    """Refraction precompute (RayTracing.metalinc:546-556): eta flip for a
    back-facing shading normal, Snell refract, TIR gate via |T|.
    Returns (t_dir (unnormalized; zero on TIR), t_len, eta)."""
    view = normalize(-d)
    flip = (n * view).sum(-1) < 0
    n_r = torch.where(flip[:, None], -n, n)
    eta = torch.where(flip, ior, 1.0 / ior)
    t_dir = refract(-view, n_r, eta)
    return t_dir, torch.linalg.vector_norm(t_dir, dim=-1), eta


def _refraction_pass(fr: _Frame, d, n, hit_pos, bias, base, transmission,
                     ior, found, color):
    """One refraction bounce with a Fresnel mix for transmissive hits
    (RayTracing.metalinc:544-713), compacted."""
    t_dir, t_len, _ = refraction_setup(d, n, ior)
    c = _retrace_lanes(fr, found & (transmission > 0.001) & (t_len > 0))
    t_dir_c = gather(t_dir, c)
    t_dir_n = t_dir_c / torch.clamp(gather(t_len, c)[:, None], min=1e-20)
    t_o = gather(hit_pos, c) + t_dir_c * gather(bias, c)[:, None]
    ft, ftri, fu, fv, ffound = trace_batch(fr.fg.bvh, t_o, t_dir_n, c.valid,
                                           c.count)
    f_color, f_m, _, _, _ = _shade_hit(fr, t_o, t_dir_n, ft, ftri, fu, fv,
                                       ffound, False, sort=True)
    refr_alpha = torch.where(ffound, f_m["alpha"], 0.0)
    refr_bg = eval_env_sh(t_dir_n, fr.ibl.sh0, fr.ibl.sh1) * AMBIENT_INTENSITY
    refr = torch.where(ffound[:, None], f_color * refr_alpha[:, None], 0.0) \
        + refr_bg * (1.0 - refr_alpha)[:, None]
    view = normalize(-gather(d, c))
    f_s = fresnel_schlick(torch.clamp((gather(n, c) * view).sum(-1), 0.0,
                                      1.0), 0.04)[:, None]
    old = gather(color, c)
    mix = refr * gather(base, c) * (1.0 - f_s) + old * f_s
    return scatter(color, c,
                   old + (mix - old) * gather(transmission, c)[:, None])


def _shade_layer(fr: _Frame, o_l, d_l, t, tri, u, v, found, alpha_in,
                 compacted: bool = False):
    """Shade one layer's records incl. bounces -> (color, contrib).
    ``compacted``: the records are a compacted set, whose shadow sweep
    sorts (rt.py:1464-1475)."""
    color, m, n, hit_pos, bias = _shade_hit(fr, o_l, d_l, t, tri, u, v,
                                            found, True,
                                            sort=True if compacted else None)
    if fr.enable_mirror:
        with stage("sge.render.mirror"):
            mirror = found & (m["roughness"] <= 0.08) & (m["metallic"] >= 0.8)
            color = _mirror_pass(fr, d_l, n, hit_pos, bias, m["metallic"],
                                 m["base"], mirror, color)
    if fr.enable_refraction:
        with stage("sge.render.refraction"):
            color = _refraction_pass(fr, d_l, n, hit_pos, bias, m["base"],
                                     m["transmission"], m["ior"], found,
                                     color)
    return color, torch.where(found, m["alpha"] * (1.0 - alpha_in), 0.0)


def simple_unlit_tri(geo: SceneGeometry, enable_mirror: bool,
                     enable_refraction: bool):
    """(T,) bool: triangles whose shade is their material's factors alone
    (rt.py:664-686 _simple_unlit_tri): unlit, no texture that could change
    base, alpha or emissive or put the material into the mirror gate, no
    transmission. Under the unlit fast path such a record's full shade is
    base + emissive with the factor alpha."""
    mats, usage = geo.materials, geo.usage
    simple = mats.unlit.clone()
    if usage.base:
        simple = simple & (mats.base_tex < 0)
    if usage.emissive:
        simple = simple & (mats.emissive_tex < 0)
    if usage.mr:    # a bound MR texture could enter the mirror gate
        simple = simple & (mats.mr_tex < 0)
    if enable_refraction:
        simple = simple & (torch.clamp(mats.transmission, 0.0, 1.0) <= 0.0)
    if enable_mirror:
        simple = simple & ~((torch.clamp(mats.metallic, 0.0, 1.0) >= 0.8) &
                            (torch.clamp(mats.roughness, 0.05, 1.0) <= 0.08))
    return simple[geo.tri_material.clamp(min=0)]


def _simple_unlit_shade(geo: SceneGeometry, tri):
    """(color, alpha) of simple-unlit records from their triangles'
    material rows: base + emissive factors, the clamped alpha factor."""
    row = geo.materials.packed[geo.tri_material[tri.clamp(min=0)].clamp(
        min=0)]
    return row[:, 0:3] + row[:, 6:9], torch.clamp(row[:, 3], 0.0, 1.0)


def _shade_continuations(fr: _Frame, ray_o, d, recs, accum, accum_alpha,
                         live):
    """The layers ``recs`` (layers 2.., or all of them: SGE_RT_LBATCH 2 or
    1) shaded as one compacted record set (capacity nl * p, every record),
    then the alpha chain elementwise from ``accum``, ``accum_alpha`` and
    ``live`` (per-record color does not depend on the chain). Records
    without barycentrics (u is None: traced layers) get them on the
    compacted set (rt.py:1533-1536).

    Under the unlit fast path, simple-unlit records (``simple_unlit_tri``)
    may leave the full shade (rt.py:1550-1591): with ``unlit_dense`` their
    color and alpha come from one gather of a per-triangle table over
    every record, with ``unlit_split`` from a second compacted pass over
    them alone; the full shade then takes the other records. Either gives
    the same colors and alphas as the full shade."""
    nl, p = len(recs), ray_o.shape[0]
    dev = d.device
    t_s = torch.cat([r[0] for r in recs])
    tri_s = torch.cat([r[1] for r in recs])
    f_s = [r[4] for r in recs]
    chain_open = live & (accum_alpha < 0.99)
    flat = torch.cat([f & chain_open for f in f_s])
    heavy, simple = flat, None
    colors = torch.zeros((nl * p, 3), device=dev)
    alphas = torch.zeros(nl * p, device=dev)
    if fr.unlit_fast and (fr.unlit_dense or fr.unlit_split):
        simple_tri = simple_unlit_tri(fr.geo, fr.enable_mirror,
                                      fr.enable_refraction)
        if fr.unlit_dense:
            col_t, alpha_t = _simple_unlit_shade(fr.geo, torch.arange(
                simple_tri.shape[0], device=dev))
            tab = torch.cat([col_t, alpha_t[:, None],
                             simple_tri.to(torch.float32)[:, None]], 1)
            rec = tab[tri_s.clamp(min=0)]         # one (nl * p, 5) gather
            simple_d = flat & (rec[:, 4] > 0.5)
            heavy = flat & ~simple_d
            sd = simple_d.to(torch.float32)
            colors = rec[:, 0:3] * sd[:, None]
            alphas = rec[:, 3] * sd
        else:
            simple = flat & simple_tri[tri_s.clamp(min=0)]
            heavy = flat & ~simple
    c = compact(heavy)
    lane = c.safe % p
    oc, dc = ray_o[lane], d[lane]
    tc, tric = gather(t_s, c), gather(tri_s, c)
    if recs[0][2] is None:
        uc, vc, _ = barycentrics(fr.fg.bvh, oc, dc, tc, tric)
    else:
        uc = gather(torch.cat([r[2] for r in recs]), c)
        vc = gather(torch.cat([r[3] for r in recs]), c)
    color, alpha = _shade_layer(fr, oc, dc, tc, tric, uc, vc, c.valid,
                                torch.zeros_like(tc), compacted=True)
    colors = scatter(colors, c, color)
    alphas = scatter(alphas, c, alpha)
    if simple is not None:     # the split's second, cheap pass
        cs = compact(simple)
        color, alpha = _simple_unlit_shade(fr.geo, gather(tri_s, cs))
        colors = scatter(colors, cs, torch.where(cs.valid[:, None], color,
                                                 0.0))
        alphas = scatter(alphas, cs, torch.where(cs.valid, alpha, 0.0))
    colors = colors.reshape(nl, p, 3)
    alphas = alphas.reshape(nl, p)
    for li in range(nl):
        live = live & f_s[li] & (accum_alpha < 0.99)
        contrib = torch.where(live, alphas[li] * (1.0 - accum_alpha), 0.0)
        accum = accum + colors[li] * contrib[:, None]
        accum_alpha = accum_alpha + contrib
    return accum + _bg(dev) * (1.0 - accum_alpha)[:, None]


def _shade_layers_compacted(fr: _Frame, ray_o, d, recs, accum, accum_alpha,
                            live):
    """Layers 2.. one compacted shade per layer, gated by the chain
    (SGE_RT_LBATCH=0, rt.py:1667-1683, 1739-1756, 1792-1811); records
    without barycentrics get them on the compacted set."""
    for t_l, tri_l, u_l, v_l, f_l in recs:
        live = live & f_l & (accum_alpha < 0.99)
        c = compact(live)
        oc, dc = gather(ray_o, c), gather(d, c)
        tc = torch.where(c.valid, gather(t_l, c), 1.0)
        tric = torch.where(c.valid, gather(tri_l, c), -1)
        if u_l is None:
            uc, vc, _ = barycentrics(fr.fg.bvh, oc, dc, tc, tric)
        else:
            uc, vc = gather(u_l, c), gather(v_l, c)
        alpha_c = gather(accum_alpha, c)
        color, contrib = _shade_layer(fr, oc, dc, tc, tric, uc, vc, c.valid,
                                      alpha_c, compacted=True)
        accum = scatter(accum, c, gather(accum, c) + color * contrib[:, None])
        accum_alpha = scatter(accum_alpha, c, alpha_c + contrib)
    return accum + _bg(d.device) * (1.0 - accum_alpha)[:, None]


def _shade_layers_dense(fr: _Frame, ray_o, d, recs, accum, accum_alpha,
                        live):
    """Layers 2.. each shaded densely, the chain gate the shade mask
    (SGE_RT_LBATCH=3, rt.py:1654-1666)."""
    for t_l, tri_l, u_l, v_l, f_l in recs:
        live = live & f_l & (accum_alpha < 0.99)
        color, contrib = _shade_layer(fr, ray_o, d, t_l, tri_l, u_l, v_l,
                                      live, accum_alpha)
        accum = accum + color * contrib[:, None]
        accum_alpha = accum_alpha + contrib
    return accum + _bg(d.device) * (1.0 - accum_alpha)[:, None]


def _shade_records(fr: _Frame, ray_o, d, recs, lbatch: int, dense: bool):
    """Every layer's records shaded by the ``lbatch`` schedule (see the
    module docstring); ``dense``: mode 3 shades densely (the "hybrid"
    records), else it is mode 0."""
    p, dev = ray_o.shape[0], ray_o.device
    if lbatch == 1:
        with stage("sge.render.continuations"):
            return _shade_continuations(
                fr, ray_o, d, recs, torch.zeros((p, 3), device=dev),
                torch.zeros(p, device=dev), torch.ones(p, dtype=torch.bool,
                                                       device=dev))
    t1, tri1, u1, v1, f1 = recs[0]
    if u1 is None:                       # traced layer 1: dense barycentrics
        u1, v1, _ = barycentrics(fr.fg.bvh, ray_o, d, t1, tri1)
    with stage("sge.render.layer1"):
        color, contrib = _shade_layer(fr, ray_o, d, t1, tri1, u1, v1, f1,
                                      torch.zeros(p, device=dev))
    accum = color * contrib[:, None]
    if len(recs) == 1:
        return accum + _bg(dev) * (1.0 - contrib)[:, None]
    shade = _shade_continuations if lbatch == 2 else \
        _shade_layers_dense if lbatch == 3 and dense else \
        _shade_layers_compacted
    with stage("sge.render.continuations"):
        return shade(fr, ray_o, d, recs[1:], accum, contrib, f1)


def _layer_records(opq, trs, max_layers: int):
    """Per-layer records from the opaque hit + translucent records (raster
    peels, or the slots of the layered walk): layer L is the nearest
    translucent record past the floor and in front of the opaque hit, else
    the opaque hit once it clears the floor; the floor advances by
    t + 2*bias (the traced continuation's surface skip). Records carry
    (t, tri, u, v, found); u and v may be None (traced records), and are
    then None in the layer records too."""
    t_o, tri_o, u_o, v_o, f_o = opq
    p = t_o.shape[0]
    dev = t_o.device
    with_uv = u_o is not None
    t_opq = torch.where(f_o, t_o, BIG)
    floor = torch.zeros(p, device=dev)
    recs = []
    for _ in range(max_layers):
        tn = torch.full((p,), BIG, device=dev)
        idn = torch.full((p,), -1, dtype=torch.int64, device=dev)
        un = vn = None
        if with_uv:
            un = torch.zeros(p, device=dev)
            vn = torch.zeros(p, device=dev)
        for tk, trik, uk, vk, fk in reversed(trs):   # nearest eligible wins
            ok = fk & (tk > floor) & (tk < t_opq)
            tn = torch.where(ok, tk, tn)
            idn = torch.where(ok, trik, idn)
            if with_uv:
                un = torch.where(ok, uk, un)
                vn = torch.where(ok, vk, vn)
        use_opq = f_o & (t_opq > floor) & (tn >= BIG)
        found = use_opq | (tn < BIG)
        t_l = torch.where(found, torch.where(use_opq, t_opq, tn), BIG)
        tri_l = torch.where(found, torch.where(use_opq, tri_o, idn), -1)
        if with_uv:
            recs.append((t_l, tri_l, torch.where(use_opq, u_o, un),
                         torch.where(use_opq, v_o, vn), found))
        else:
            recs.append((t_l, tri_l, None, None, found))
        floor = torch.where(found, t_l + 2.0 * shadow_bias(t_l), floor)
    return recs


def _traced_records(fg: FrameGeometry, cam, d, max_layers: int,
                    layer_slots: int = 0):
    """Layer records of the camera rays ``d`` from ONE layered shared-origin
    walk (K5, rt.py:1687-1719): the nearest opaque hit and ``layer_slots``
    (0: max_layers) translucent hits per ray, through the floor chain.
    Fewer slots than layers tighten the walk's prune bound; the records
    then differ only where at least that many translucent surfaces lie in
    front of the opaque hit (rt.py:197-205). ``cam``: the origin on the
    device, where the kernel reads it."""
    p = d.shape[0]
    n_slots = layer_slots or max_layers
    srows = RK.build_origin_rows(fg.bvh.rows, cam, fg.bvh.wide.leaves)
    t_opq, otri, lts, lids = RK.trace_layers_so(
        fg.bvh.wide, srows, cam, d,
        torch.full((p,), BIG, device=d.device), n_slots=n_slots)
    trs = [(lts[:, k], torch.floor(lids[:, k]).long(), None, None,
            lids[:, k] >= 0) for k in range(n_slots)]
    return _layer_records((t_opq, otri.long(), None, None, t_opq < BIG), trs,
                          max_layers)


def _next_origin(o, d, t):
    """The continuation origin past a hit at t (rt.py:1495): the hit
    position, moved on by 2*bias along the ray."""
    hit_pos = o + d * t[:, None]
    return hit_pos + d * (shadow_bias(t) * 2.0)[:, None]


def _offset_tracer(bvh, ray_o, d, first=None):
    """Traced layers past the walks' row cap (rt.py:1779,1866-1896): a
    closest-hit trace (K4) from each lane's origin, which then moves past
    the hit (``_next_origin``). ``first``: layer 1's records (t, tri, u, v,
    found) from elsewhere (the "raster" primary, rt.py:1765-1784), which
    then only the continuations trace. Returns trace(lanes) for
    ``_trace_layers``."""
    o = ray_o

    def trace(c):
        nonlocal o
        if c is None:
            oc, dc, live, count = o, d, torch.ones(
                o.shape[0], dtype=torch.bool, device=o.device), None
        else:
            oc, dc, live, count = gather(o, c), gather(d, c), c.valid, c.count
        if c is None and first is not None:
            t, tri, u, v, found = first
        else:
            t, tri, u, v, found = trace_batch(bvh, oc, dc, live, count)
        nxt = torch.where(found[:, None], _next_origin(
            oc, dc, torch.where(found, t, 1.0)), oc)
        o = nxt if c is None else scatter(o, c, nxt)
        return oc, t, tri, u, v, found

    return trace


def _floor_tracer(fg: FrameGeometry, cam, ray_o, d):
    """Non-layered traced layers on a tree the walks serve (rt.py:1767-1777,
    1815-1865): the camera rays themselves, traced by the shared-origin
    closest-hit kernel (K6) past a per-lane t floor that moves to
    t + 2*bias after each hit. The live lanes of a continuation are
    compacted; the fill slots are parked by t_max 0 (not by their origin:
    a parked origin would break the baked leaf constants) and K6 skips
    them by the count. Returns trace(lanes) for ``_trace_layers``."""
    bv = fg.bvh
    srows = RK.build_origin_rows(bv.rows, cam, bv.wide.leaves)
    floor = None

    def trace(c):
        nonlocal floor
        if c is None:
            oc, dc, fl, count = ray_o, d, None, None
            t_max = torch.full((d.shape[0],), BIG, device=d.device)
        else:
            oc, dc, count = gather(ray_o, c), gather(d, c), c.count
            fl = gather(floor, c)
            t_max = torch.where(c.valid, BIG, 0.0)
        t, tri = RK.trace_rays_so(bv.wide, srows, cam, dc, t_max,
                                  t_floor=fl, count=count)
        u, v, found = barycentrics(bv, oc, dc, t, tri)
        found = found & (t < BIG)
        t = torch.where(found, t, BIG)
        tri = torch.where(found, tri.long(), -1)
        nxt = torch.where(found, t + 2.0 * shadow_bias(t), 0.0)
        floor = nxt if c is None else \
            scatter(floor, c, torch.where(found, nxt, fl))
        return oc, t, tri, u, v, found

    return trace


def _trace_layers(fr: _Frame, ray_o, d, max_layers: int, trace):
    """Traced layers one trace at a time: ``trace(None)`` gives every
    lane's layer-1 record, shaded densely; each continuation layer then
    re-traces the live lanes, ``trace(lanes)``, compacted
    (rt.py:1760-1898); all max_layers layers run. ``trace`` returns
    (shading origin, t, tri, u, v, found)."""
    p, dev = ray_o.shape[0], ray_o.device
    oc, t, tri, u, v, found = trace(None)
    with stage("sge.render.layer1"):
        color, contrib = _shade_layer(fr, oc, d, t, tri, u, v, found,
                                      torch.zeros(p, device=dev))
    accum = color * contrib[:, None]
    accum_alpha = contrib
    live = found
    with stage("sge.render.continuations"):
        for _ in range(1, max_layers):
            c = _retrace_lanes(fr, live & (accum_alpha < 0.99))
            oc, t, tri, u, v, found = trace(c)
            alpha_c = gather(accum_alpha, c)
            color, contrib = _shade_layer(fr, oc, gather(d, c), t, tri, u,
                                          v, found, alpha_c, compacted=True)
            accum = scatter(accum, c,
                            gather(accum, c) + color * contrib[:, None])
            accum_alpha = scatter(accum_alpha, c, alpha_c + contrib)
            live = scatter(torch.zeros_like(live), c, found)
    return accum + _bg(dev) * (1.0 - accum_alpha)[:, None]


def check_schedule(primary: str, shadow_sort_mode: str, lbatch: int):
    """Raise on a primary mode, sort order or layer schedule the frame
    does not know."""
    for name, value, known in (("primary", primary, PRIMARY_MODES),
                               ("shadow_sort_mode", shadow_sort_mode,
                                SHADOW_SORT_MODES),
                               ("lbatch", lbatch, LBATCH_MODES)):
        if value not in known:
            raise ValueError(f"{name} must be one of {known}, got "
                             f"{value!r}")


def check_knobs(layer_slots: int, trans_subdiv: int):
    """Raise on a slot count or a subdivision depth the frame does not
    take: K5 holds 1..3 slots (0: max_layers); a depth is >= 0."""
    if not 0 <= layer_slots <= 3:
        raise ValueError(f"layer_slots must be 0..3, got {layer_slots}")
    if trans_subdiv < 0:
        raise ValueError(f"trans_subdiv must be >= 0, got {trans_subdiv}")


def _check_layers(max_layers: int, shadow_layers: int):
    if not 1 <= max_layers <= 3:
        raise ValueError(f"max_layers must be 1..3, got {max_layers}")
    if shadow_layers < 0:
        raise ValueError(f"shadow_layers must be >= 0, got {shadow_layers}")


def _frame(geo, fg, ibl, lights, cam, lanes: int, shadow_layers: int,
           enable_mirror: bool, enable_refraction: bool,
           shadow_prepass: bool, shadow_sort: bool,
           shadow_sort_mode: str, **knobs) -> _Frame:
    """The per-frame constants of a batch of ``lanes`` lanes: the light-0
    shadow source its lane count selects (``_shadow_mode``) and its
    constants, shared by every shade call of the batch; ``knobs``: the
    ``_Frame`` switches (unlit_fast, unlit_split, unlit_dense,
    packet_compact)."""
    with stage("sge.render.shadows"):
        mode, shadow = _shadow_mode(geo, fg, lights, lanes, shadow_layers)
    return _Frame(geo=geo, fg=fg, ibl=ibl, lights=lights, cam=cam,
                  shadow=shadow, shadow_layers=shadow_layers,
                  enable_mirror=enable_mirror,
                  enable_refraction=enable_refraction, shadow_mode=mode,
                  shadow_prepass=shadow_prepass and mode == "loop" and
                  RK.walk_available(fg.bvh.rows), shadow_sort=shadow_sort,
                  shadow_sort_mode=shadow_sort_mode, **knobs)


def _render_rays(geo: SceneGeometry, fg: FrameGeometry, ibl: IBL,
                 lights: DirectionalLights, cam_pos, ray_o, ray_d,
                 max_layers: int = 3, shadow_layers: int = 4,
                 enable_mirror: bool = True, enable_refraction: bool = True,
                 layered: bool = True, shadow_prepass: bool = False,
                 shadow_sort: bool = False,
                 shadow_sort_mode: str = "partition",
                 lbatch: int = 2, layer_slots: int = 0,
                 unlit_fast: bool = True, unlit_split: bool = False,
                 unlit_dense: bool = False,
                 packet_compact: bool = False) -> torch.Tensor:
    """Trace and shade a flat batch of camera rays -> (P, 3) linear colour,
    no dither and no reshape (rt.py:1393, ``primary=None``): the shardable
    core of the traced frame (``parallel/sharding.py`` runs it on each
    rank's slice of the frame's lanes).

    ``cam_pos`` is the rays' shared origin (a tensor or host values): the
    shared-origin walks K5 and K6 read it, not ``ray_o``, whose rows the
    shading and the K4 traces past the walks' row cap read. On a tree of at
    most ``WALK_MAX_ROWS`` rows the layered walk (K5; ``layered=False``:
    K6 dense, then per continuation layer past a t floor) gives the layer
    records, else a dense K4 trace and K4 continuations from offset
    origins. The light-0 shadow source follows the batch's own lane count
    P (rt.py:1420-1423), so a shard of a frame may take another source
    than the whole frame. The knob keywords are ``render_frame``'s. Reads
    nothing back to the host."""
    dev = fg.pos.device
    cam = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    bv = fg.bvh
    recs = trace = None
    if RK.walk_available(bv.rows):
        # K5 and K6 read the origin from the device
        if layered:
            recs = _traced_records(fg, cam, ray_d, max_layers, layer_slots)
        else:
            trace = _floor_tracer(fg, cam, ray_o, ray_d)
    else:
        trace = _offset_tracer(bv, ray_o, ray_d)
    fr = _frame(geo, fg, ibl, lights, cam, ray_o.shape[0], shadow_layers,
                enable_mirror, enable_refraction, shadow_prepass,
                shadow_sort, shadow_sort_mode, unlit_fast=unlit_fast,
                unlit_split=unlit_split, unlit_dense=unlit_dense,
                packet_compact=packet_compact)
    if recs is None:
        return _trace_layers(fr, ray_o, ray_d, max_layers, trace)
    return _shade_records(fr, ray_o, ray_d, recs, lbatch, dense=False)


def render_frame(geo: SceneGeometry, fg: FrameGeometry, ibl: IBL,
                 lights: DirectionalLights, inv_view_proj, cam_pos,
                 width: int, height: int, max_layers: int = 3,
                 shadow_layers: int = 4, enable_mirror: bool = True,
                 enable_refraction: bool = True, view_proj=None,
                 primary: str = "hybrid", layered: bool = True,
                 shadow_prepass: bool = False, deferred: bool = False,
                 shadow_sort: bool = False,
                 shadow_sort_mode: str = "partition", lbatch: int = 2,
                 layer_slots: int = 0, trans_subdiv: int = 0,
                 unlit_fast: bool = True, unlit_split: bool = False,
                 unlit_dense: bool = False, packet_compact: bool = False):
    """Full RT frame -> (H, W, 3) linear color. ``inv_view_proj`` and
    ``view_proj`` are tensors on the geometry's device; ``cam_pos`` (3,) is
    host values (numpy) or a tensor. With all three on the device the frame
    reads nothing back to the host.
    ``primary`` is the primary visibility mode, "hybrid", "trace",
    "raster" or "peels" (see the module docstring); "trace" is
    ``_render_rays`` over the frame's lanes. ``layered``
    (SGE_RT_LAYERED) chooses the layered walk K5 over the per-layer K6
    traces of "trace" mode; ``shadow_prepass``
    (SGE_SHADOW_PREPASS) runs K8 in front of the per-layer shadow loop;
    ``deferred`` (SGE_RT_DEFERRED) shades the "hybrid" records with
    ``render/deferred.py``; ``shadow_sort`` (SGE_SHADOW_SORT) sorts the
    dense calls' shadow sweeps too, in the ``shadow_sort_mode``
    (SGE_SHADOW_SORT_MODE) order; ``lbatch`` (SGE_RT_LBATCH) is the layer
    schedule; ``layer_slots`` (SGE_RT_LAYER_SLOTS) gives the layered walk
    K5 that many slots (0: max_layers); ``trans_subdiv``
    (SGE_RASTER_TRANS_SUBDIV) splits the "hybrid" translucent subset into
    4**depth coplanar children before K1 where the gate
    (``SceneGeometry.trans_untextured``) holds; ``unlit_fast``
    (SGE_RT_UNLIT) shades unlit records as albedo + emissive, unlit;
    ``unlit_split`` / ``unlit_dense`` (SGE_RT_UNLIT_SPLIT /
    SGE_RT_UNLIT_DENSE, under the unlit fast path) take simple-unlit
    records out of the batched continuation shade; ``packet_compact``
    (SGE_RT_PACKET_COMPACT) compacts the retraced lanes (bounces, traced
    continuations) by whole packets of ``PACKET_BLOCK`` lanes. Each keeps
    the reference's default."""
    check_schedule(primary, shadow_sort_mode, lbatch)
    check_knobs(layer_slots, trans_subdiv)
    _check_layers(max_layers, shadow_layers)
    knobs = dict(unlit_fast=unlit_fast, unlit_split=unlit_split,
                 unlit_dense=unlit_dense, packet_compact=packet_compact)
    with stage("sge.render.primary"):
        dev = fg.pos.device
        ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32, device=dev)
        cam = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
        ray_o, ray_d, px, py = generate_rays_tiled(ivp, cam, width, height)
        if primary == "trace":
            out = _render_rays(geo, fg, ibl, lights, cam, ray_o, ray_d,
                               max_layers, shadow_layers, enable_mirror,
                               enable_refraction, layered=layered,
                               shadow_prepass=shadow_prepass,
                               shadow_sort=shadow_sort,
                               shadow_sort_mode=shadow_sort_mode,
                               lbatch=lbatch, layer_slots=layer_slots,
                               **knobs)
        else:
            recs, trace = _raster_records(geo, fg, ivp, view_proj, cam, ray_o,
                                          ray_d, width, height, max_layers,
                                          primary, trans_subdiv)
            fr = _frame(geo, fg, ibl, lights, cam, ray_o.shape[0],
                        shadow_layers, enable_mirror, enable_refraction,
                        shadow_prepass, shadow_sort, shadow_sort_mode, **knobs)
            if recs is None:
                out = _trace_layers(fr, ray_o, ray_d, max_layers, trace)
            elif deferred and primary == "hybrid":
                from .deferred import shade_deferred
                with stage("sge.render.deferred"):
                    out = shade_deferred(fr, ray_o, ray_d, recs)
            else:
                out = _shade_records(fr, ray_o, ray_d, recs, lbatch,
                                     dense=primary == "hybrid")
        # per-pixel hash dither in lane order, then one reshape to the image
        noise = hash12(torch.stack([px.to(torch.float32),
                                    py.to(torch.float32)], -1))
        out = torch.clamp(out + ((noise - 0.5) * (1.0 / 255.0))[:, None],
                          min=0.0)
        return untile_image(out, width, height)


def subdivide(v0, v1, v2, ids, depth: int):
    """``depth`` levels of midpoint subdivision (rt.py:1235-1247): each
    triangle becomes (A, M01, M20), (M01, B, M12), (M20, M12, C),
    (M01, M12, M20), the same winding, the children of a parent adjacent
    and carrying its id."""
    for _ in range(depth):
        m01, m12, m20 = (v0 + v1) * 0.5, (v1 + v2) * 0.5, (v2 + v0) * 0.5
        v0, v1, v2 = (torch.stack([v0, m01, m20, m01], 1).reshape(-1, 3),
                      torch.stack([m01, v1, m12, m12], 1).reshape(-1, 3),
                      torch.stack([m20, m12, v2, m20], 1).reshape(-1, 3))
        ids = ids.repeat_interleave(4)
    return v0, v1, v2, ids


def _raster_records(geo, fg, ivp, view_proj, cam, ray_o, ray_d, width,
                    height, max_layers, primary, trans_subdiv: int = 0):
    """The rasterized primaries ("hybrid", "raster", "peels") over the
    whole image plane -> (every layer's records, None), or for "raster"
    (None, the ``_trace_layers`` tracer of its K4 continuations).
    ``trans_subdiv``: the "hybrid" translucent subset's subdivision depth,
    taken where ``geo.trans_untextured`` holds (0 otherwise)."""
    dev = fg.pos.device
    bv = fg.bvh
    recs = trace = None
    vp = torch.linalg.inv(ivp) if view_proj is None else \
        torch.as_tensor(view_proj, dtype=torch.float32, device=dev)
    if primary in ("raster", "peels"):
        # K1 over every triangle, records in lane order with the ray t
        # resolved from the barycentrics (rt.py:1257-1281)
        hits = [(h.t, h.tri, h.u, h.v, h.found) for h in rasterize_clusters(
            bv.v0, bv.v1, bv.v2, vp, width, height,
            layers=max_layers if primary == "peels" else 1,
            opaque=opaque_tris(geo) if primary == "peels" else None,
            cluster=CLUSTER, cam_pos=cam, scanline=False)]
        if primary == "peels":   # every layer's records
            recs = hits
        else:                    # layer 1; the continuations trace (K4)
            trace = _offset_tracer(bv, ray_o, ray_d, first=hits[0])
    else:                        # "hybrid"
        # Exact w -> t for pinhole rays p = cam + d*t: the raster's view
        # depth is w = w(cam) + t * (vp[3,:3] . d).
        vp3 = vp[3]
        w_cam = (vp3[:3] * cam).sum() + vp3[3]
        wd = ray_d @ vp3[:3]
        inv_wd = 1.0 / torch.where(wd.abs() < 1e-12, 1e-12, wd)

        def rec_of(h):
            return (torch.where(h.found, (h.w_depth - w_cam) * inv_wd, BIG),
                    h.tri, h.u, h.v, h.found)

        oi = geo.opaque_idx
        h_o = rasterize_clusters(
            bv.v0[oi], bv.v1[oi], bv.v2[oi], vp, width, height, layers=1,
            opaque=torch.ones(oi.shape[0], dtype=torch.bool, device=dev),
            cluster=CLUSTER, ids=oi.to(torch.float32))[0]
        trs = []
        ti = geo.translucent_idx
        if ti.numel():
            v0t, v1t, v2t, ids_t = subdivide(
                bv.v0[ti], bv.v1[ti], bv.v2[ti], ti.to(torch.float32),
                trans_subdiv if geo.trans_untextured else 0)
            trs = [rec_of(h) for h in rasterize_clusters(
                v0t, v1t, v2t, vp, width, height, layers=max_layers,
                cluster=TRANS_CLUSTER, ids=ids_t, prior_w=h_o.w_depth)]
        recs = _layer_records(rec_of(h_o), trs, max_layers)
    return recs, trace
