"""Merged deferred shading: port of swift_game_engine_tpu/render/deferred.py.

``render_frame(..., deferred=True)`` (the reference's SGE_RT_DEFERRED)
shades the "hybrid" primary's layer records with every piece of the shade
machinery run once over a merged record stream:

  1. the record alphas and the transparency chain, elementwise: the chain
     weights and the records that need shading;
  2. one dense G-buffer pass over the L*p layer records (``rt._gbuffer``);
  3. the bounce setup, dense (reflect, ``rt.refraction_setup``); the mirror
     and refraction rays of every layer merge into one stream, compacted
     at its lane universe (``render/compact.py``) and traced by ONE K4
     call, which walks the lanes below the device count;
  4. one dense G-buffer pass over the bounce hits;
  5. ONE shadow sweep over every shadow origin of the frame (layer records
     ++ bounce hits), sorted (``rt._shadow_factor(sort=True)``);
  6. one light pass for each set (``rt._light_records``; split-sum IBL for
     the layer records only, the sequential shade's ``with_ibl_spec``);
  7. the bounce colors folded into their parents by the Fresnel mixes of
     ``rt._mirror_pass`` / ``rt._refraction_pass``;
  8. the chain composite with the weights of step 1.

A bounce segment no material can start is left out of the stream
(``SceneGeometry.bounces``, decided on the host when the geometry is
packed, so the frame reads nothing back). The per-record math is the
sequential shade's; the hit positions are computed densely rather than
gathered, so a grazing bounce may land on another triangle
(tests/test_deferred.py:67-80).

reference: Game/RayTracing.metalinc:197-730 — the bounces re-shade hits of
the same material model (382-542 mirror, 544-713 refraction) under the one
shadow-casting directional light (332-372), which makes one merged sweep
exact.
"""

from __future__ import annotations

import torch

from ..math3d import normalize
from ..ops.rt_kernel import trace_batch
from .compact import compact, gather, scatter
from .ibl import eval_env_sh
from .shading import fresnel_schlick, fresnel_schlick3, reflect
from . import rt as RT


def _tile(a, k: int):
    """(p, ...) -> (k*p, ...): ``a`` repeated along a new leading axis,
    flattened."""
    return a.expand(k, *a.shape).reshape(k * a.shape[0], *a.shape[1:])


def _trace_merged(fr, o_b, d_b, mask_b):
    """The merged bounce stream's one K4 call over its set lanes, compacted
    (capacity: the stream) -> (t (1 where missed), tri, u, v, found) per
    stream lane."""
    nb, dev = o_b.shape[0], o_b.device
    c = compact(mask_b)
    t, tri, u, v, found = trace_batch(fr.fg.bvh, gather(o_b, c),
                                      gather(d_b, c), c.valid, c.count)
    return (scatter(torch.ones(nb, device=dev), c, torch.where(found, t, 1.0)),
            scatter(torch.full((nb,), -1, dtype=torch.int64, device=dev), c,
                    tri),
            scatter(torch.zeros(nb, device=dev), c, u),
            scatter(torch.zeros(nb, device=dev), c, v),
            scatter(torch.zeros(nb, dtype=torch.bool, device=dev), c, found))


def shade_deferred(fr, ray_o, ray_d, recs):
    """The deferred shade of the per-layer records ``recs`` [(t, tri, u, v,
    found)], each (p,) with barycentrics (the hybrid records) -> (p, 3)
    colors before the dither."""
    p, dev = ray_o.shape[0], ray_o.device
    L = len(recs)
    R = L * p
    geo = fr.geo
    enable_mirror = fr.enable_mirror and geo.bounces.mirror
    enable_refraction = fr.enable_refraction and geo.bounces.refraction

    # ---- 1. record alphas and the transparency chain (elementwise)
    t_s, tri_s, u_s, v_s = (torch.cat([r[k] for r in recs]) for k in range(4))
    live = torch.ones(p, dtype=torch.bool, device=dev)
    accum_a = torch.zeros(p, device=dev)
    contribs, shade_m = [], []
    for t_l, tri_l, u_l, v_l, f_l in recs:
        a_l = RT._sample_alpha(geo, tri_l, u_l, v_l, active=f_l)
        live = live & f_l & (accum_a < 0.99)
        c_l = torch.where(live, a_l * (1.0 - accum_a), 0.0)
        contribs.append(c_l)
        shade_m.append(live)
        accum_a = accum_a + c_l
    shade_flat = torch.cat(shade_m)

    # ---- 2. the dense layer-record G-buffer
    o_rec, d_rec = _tile(ray_o, L), _tile(ray_d, L)
    m_l, n_l, hp_l, bias_l = RT._gbuffer(
        fr, o_rec, d_rec, t_s, torch.where(shade_flat, tri_s, -1), u_s, v_s,
        shade_flat)

    # ---- 3. the bounce setup and ONE merged trace
    segs = []                            # (origin, direction, mask)
    if enable_mirror:
        mirror_m = shade_flat & (m_l["roughness"] <= 0.08) & \
            (m_l["metallic"] >= 0.8)
        segs.append((hp_l + n_l * bias_l[:, None],
                     normalize(reflect(d_rec, n_l)), mirror_m))
    if enable_refraction:
        t_dir, t_len, _ = RT.refraction_setup(d_rec, n_l, m_l["ior"])
        t_dir_n = t_dir / torch.clamp(t_len[:, None], min=1e-20)
        refr_m = shade_flat & (m_l["transmission"] > 0.001) & (t_len > 0)
        segs.append((hp_l + t_dir * bias_l[:, None], t_dir_n, refr_m))
    hp_all, n_all, bias_all = hp_l, n_l, bias_l
    gate_l, _, max_d0, _ = RT._light_gate(fr, 0, m_l, n_l, hp_l, shade_flat)
    gate_all = gate_l
    if segs:
        o_b, d_b, mask_b = (torch.cat([s[k] for s in segs]) for k in range(3))
        bt, btri, bu, bv, bfound = _trace_merged(fr, o_b, d_b, mask_b)
        # ---- 4. the dense bounce-hit G-buffer
        m_b, n_b, hp_b, bias_b = RT._gbuffer(
            fr, o_b, d_b, bt, torch.where(bfound, btri, -1), bu, bv, bfound)
        gate_b, _, _, _ = RT._light_gate(fr, 0, m_b, n_b, hp_b, bfound)
        hp_all = torch.cat([hp_l, hp_b])
        n_all = torch.cat([n_l, n_b])
        bias_all = torch.cat([bias_l, bias_b])
        gate_all = torch.cat([gate_l, gate_b])

    # ---- 5. ONE shadow sweep over every origin, sorted
    shadow_all = RT._shadow_factor(fr, hp_all, n_all, fr.lights.direction[0],
                                   max_d0, bias_all, gate_all, sort=True)

    # ---- 6. one light pass for each set
    color_l = RT._light_records(fr, d_rec, m_l, n_l, hp_l, shade_flat, True,
                                shadow0=shadow_all[:R])
    if segs:
        color_b = RT._light_records(fr, d_b, m_b, n_b, hp_b, bfound, False,
                                    shadow0=shadow_all[R:])

    # ---- 7. the bounce colors folded into their parents
    view = normalize(-d_rec)
    nov = torch.clamp((n_l * view).sum(-1), 0.0, 1.0)
    off = 0
    if enable_mirror:
        found = bfound[off:off + R]
        refl_a = torch.where(found, m_b["alpha"][off:off + R], 0.0)
        refl = torch.where(found[:, None],
                           color_b[off:off + R] * refl_a[:, None], 0.0) \
            + RT._bg(dev) * (1.0 - refl_a)[:, None]
        off += R
        met = m_l["metallic"][:, None]
        f = fresnel_schlick3(nov, 0.04 * (1.0 - met) + m_l["base"] * met)
        color_l = torch.where(mirror_m[:, None],
                              color_l * (1.0 - f) + refl * f, color_l)
    if enable_refraction:
        found = bfound[off:off + R]
        refr_a = torch.where(found, m_b["alpha"][off:off + R], 0.0)
        refr_bg = eval_env_sh(t_dir_n, fr.ibl.sh0, fr.ibl.sh1) * \
            RT.AMBIENT_INTENSITY
        refr = torch.where(found[:, None],
                           color_b[off:off + R] * refr_a[:, None], 0.0) \
            + refr_bg * (1.0 - refr_a)[:, None]
        f_s = fresnel_schlick(nov, 0.04)[:, None]
        mix = refr * m_l["base"] * (1.0 - f_s) + color_l * f_s
        color_l = torch.where(
            refr_m[:, None],
            color_l + (mix - color_l) * m_l["transmission"][:, None],
            color_l)

    # ---- 8. the chain composite
    colors = color_l.reshape(L, p, 3)
    accum = torch.zeros((p, 3), device=dev)
    for li in range(L):
        accum = accum + colors[li] * contribs[li][:, None]
    return accum + RT._bg(dev) * (1.0 - accum_a)[:, None]
