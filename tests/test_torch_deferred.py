"""PyTorch port, the hybrid frame's other shading schedules vs the JAX
reference (CPU): the sorted shadow sweep, ``_light_records``, merged
deferred shading (``render/deferred.py``) and the LBATCH layer schedules.

The scene is tests/test_torch_trace_frame.py's (a mirror box, a glass box,
a translucent capsule, a normal-mapped box, an unlit emissive box, a
skinned body) at 96x54, the port through its plain twins. The JAX frames
run in this process with the suite's configuration (tests/conftest.py:
SGE_JAX_TRAVERSAL=1, the pure-JAX traversal and shadow loop; the hybrid
raster K1 in Pallas interpret mode); the knobs they need are module
globals the JAX frame reads when it runs, not at import (SGE_RT_PRIMARY,
SGE_RT_DEFERRED, SGE_RT_LBATCH), so they are set by monkeypatch, as
tests/test_torch_primary_raster.py sets SGE_RT_PRIMARY: a subprocess
each would add ~20 s of start-up and cold compiles a frame.

  * The shadow orders: the port's ``_live_first_order`` and
    ``_light_morton_order`` equal the reference's permutations on seeded
    origins with dead lanes (exactly).
  * The sorted sweep: at 8,192 lanes the frame takes the walk, so the
    cluster sweeps (K2/K3, twins here) are forced by setting the port's
    ``SHADOW_CLUSTER_MIN_LANES`` to 0. Every shade call's records and
    factors, sorted (both orders) and unsorted, are equal bit for bit; the
    compacted calls' partitions move lanes (their dead lanes lie among the
    live ones), so the check is not of the identity.
  * ``_shade_hit`` equals the composition it had before ``_light_records``
    was split out of it, bit for bit, on a frame's first shade batch.
  * The deferred hybrid frame with tests/test_deferred.py's bounds (the
    hit positions are computed densely rather than gathered, so a grazing
    bounce may land on another triangle): >= 99.5% of pixels within 1e-4,
    max difference < 0.1, means within 1e-3 relative; against the port's
    sequential frame (walk and cluster shadows; measured: equal bit for
    bit), and against the JAX frame with SGE_RT_DEFERRED=1 without the
    refraction bounce (measured: every pixel within 2.5e-5). With it, the
    refraction rays that start a bias inside the glass box differ between
    the port's and the pure-JAX traversal on 15 of the box's pixels by up
    to 0.33, as the two sequential frames differ there (by up to 0.22;
    the JAX package's own deferred frame differs from its sequential one
    there by 0.33, over tests/test_deferred.py's max bound), so the frame
    with the refraction bounce is held to tests/test_torch_trace_frame.py's
    tolerance against the pure-JAX frame: >= 99% of pixels within 1e-4,
    the means within 0.5% (measured 99.71%, 0.29%). Other primaries
    ignore ``deferred``: their images equal the sequential ones bit for
    bit.
  * LBATCH 0, 1 and 3 against the port's mode 2 for the hybrid, peels and
    layered traced records: >= 99.9% of pixels within 1e-4 and the means
    within 1e-4 relative (the records shade independently of the
    schedule); mode 3 against the JAX frame with SGE_RT_LBATCH=3, with
    tests/test_torch_trace_frame.py's tolerance against the pure-JAX
    frame: >= 99% of pixels within 1e-4, the means within 0.5% (the
    refraction rays that start a bias inside the glass box differ between
    the two traversals on a few pixels; measured 99.67%, 0.32%).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.render import deferred as p_def
from swift_game_engine_tpu_torch.render import rt as p_rt
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
from swift_game_engine_tpu_torch.render.shading import eval_brdf
from swift_game_engine_tpu_torch.render.ibl import eval_env_sh, eval_spec_ibl
from swift_game_engine_tpu_torch.scene.engine import Engine

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_trace_frame as T  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def scene():
    return T.build_scene()


def _render(scene, primary="hybrid", **kw):
    """The port's frame of the test scene with render_frame keywords."""
    orig = p_rt.render_frame
    p_rt.render_frame = functools.partial(orig, **kw)
    try:
        return T._port_render(scene, T.camera(), scene[1], primary=primary)
    finally:
        p_rt.render_frame = orig


def _deferred_bounds(out, ref):
    """tests/test_deferred.py's bounds."""
    assert out.shape == ref.shape and np.isfinite(out).all()
    diff = np.abs(out - ref)
    frac = float((diff.max(-1) < 1e-4).mean())
    print(f"{frac:.5f} of pixels within 1e-4, max {diff.max():.3e}, means "
          f"{out.mean():.6f} vs {ref.mean():.6f}")
    assert frac > 0.995, frac
    assert diff.max() < 0.1, diff.max()
    assert abs(out.mean() - ref.mean()) < 1e-3 * max(ref.mean(), 1e-3)


# ------------------------------------------------------------ the orders


def _origins(seed, n, dead):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    t_lim = rng.uniform(0.5, 60, n).astype(np.float32)
    t_lim[rng.uniform(size=n) < dead] = 0.0
    l = rng.normal(size=3).astype(np.float32)
    l /= np.linalg.norm(l)
    a = np.cross(l, [0.0, 1.0, 0.0] if abs(l[1]) < 0.9 else [1.0, 0.0, 0.0])
    a /= np.linalg.norm(a)
    basis = np.stack([a, np.cross(l, a), l]).astype(np.float32)
    return o, t_lim, basis


@pytest.mark.parametrize("seed,n,dead", [(0, 4096, 0.5), (1, 5000, 0.9),
                                         (2, 777, 0.0), (3, 3000, 1.0)])
def test_orders_match_reference(seed, n, dead):
    o, t_lim, basis = _origins(seed, n, dead)
    order = p_rt._live_first_order(torch.as_tensor(t_lim > 0))
    j_order, _ = j_rt._live_first_order(jnp.asarray(t_lim > 0))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    m = p_rt._light_morton_order(torch.as_tensor(basis), torch.as_tensor(o),
                                 torch.as_tensor(t_lim))
    j_m = j_rt._light_morton_order(jnp.asarray(basis), jnp.asarray(o),
                                   jnp.asarray(t_lim))
    np.testing.assert_array_equal(m.numpy(), np.asarray(j_m))
    for mode, want in zip(p_rt.SHADOW_SORT_MODES, (order, m)):
        assert torch.equal(p_rt._shadow_order(
            mode, torch.as_tensor(basis), torch.as_tensor(o),
            torch.as_tensor(t_lim)), want)


# ------------------------------------------------------ the sorted sweep


def _sweeps(scene, monkeypatch, sort, mode="partition"):
    """Every shade call's (records, factor) of a cluster-shadow hybrid
    frame with each call's sort forced to ``sort``."""
    monkeypatch.setattr(p_rt, "SHADOW_CLUSTER_MIN_LANES", 0)
    calls, factor, apply = [], p_rt._shadow_factor, p_rt._apply_shadow_records

    def forced(*a, sort=None, **k):
        out = factor(*a, sort=sort_to, **k)
        calls[-1].append(out)
        return out

    def records(fr, o_sh, l, t_opq, ts, ids, *a, **k):
        calls.append([t_opq, ts, ids])
        return apply(fr, o_sh, l, t_opq, ts, ids, *a, **k)

    sort_to = sort
    monkeypatch.setattr(p_rt, "_shadow_factor", forced)
    monkeypatch.setattr(p_rt, "_apply_shadow_records", records)
    img = _render(scene, shadow_sort_mode=mode)
    monkeypatch.setattr(p_rt, "_shadow_factor", factor)
    monkeypatch.setattr(p_rt, "_apply_shadow_records", apply)
    return calls, img


@pytest.mark.parametrize("mode", p_rt.SHADOW_SORT_MODES)
def test_sorted_sweep_equals_unsorted(scene, monkeypatch, mode):
    plain, img_p = _sweeps(scene, monkeypatch, False)
    moved, live_first = [], p_rt._live_first_order

    def order(live):
        out = live_first(live)
        moved.append(int((out != torch.arange(live.shape[0])).sum()))
        return out

    monkeypatch.setattr(p_rt, "_live_first_order", order)
    sorted_, img_s = _sweeps(scene, monkeypatch, True, mode)
    assert len(plain) == len(sorted_) >= 5
    for a, b in zip(plain, sorted_):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert np.array_equal(img_p, img_s)
    if mode == "partition":
        print(f"lanes the partition moved, by call: {moved}")
        assert len(moved) == len(plain) and sum(m > 0 for m in moved) >= 3


def test_bounce_and_compacted_calls_sort(scene, monkeypatch):
    """By default the bounce shades and the compacted continuation shade
    sort (rt.py:1315, 1373, 1475): five of the frame's six shade calls;
    ``shadow_sort=True`` sorts layer 1's dense call too."""
    monkeypatch.setattr(p_rt, "SHADOW_CLUSTER_MIN_LANES", 0)
    for shadow_sort, want in ((False, 5), (True, 6)):
        n = []
        order = p_rt._shadow_order

        def counted(*a, **k):
            n.append(1)
            return order(*a, **k)
        monkeypatch.setattr(p_rt, "_shadow_order", counted)
        _render(scene, shadow_sort=shadow_sort)
        monkeypatch.setattr(p_rt, "_shadow_order", order)
        assert len(n) == want, (shadow_sort, len(n))


# --------------------------------------------------- _shade_hit's split


def _shade_hit_before(fr, ray_o, ray_d, t_hit, tri, u, v, active,
                      with_ibl_spec):
    """The port's _shade_hit before _light_records was split out of it."""
    m, n, hit_pos, bias = p_rt._gbuffer(fr, ray_o, ray_d, t_hit, tri, u, v,
                                        active)
    lights = fr.lights
    gates = [p_rt._light_gate(fr, i, m, n, hit_pos, active)
             for i in range(lights.direction.shape[0])]
    gate0, _, max_dist0, _ = gates[0]
    shadow0 = p_rt._shadow_factor(fr, hit_pos, n, lights.direction[0],
                                  max_dist0, bias, gate0)
    view = p_rt.normalize(-ray_d)
    direct = torch.zeros_like(hit_pos)
    for i, (gate, ndotl, _, l) in enumerate(gates):
        shadow = shadow0 if i == 0 else torch.ones_like(ndotl)
        brdf = eval_brdf(n, view, l.expand_as(n), m["base"], m["metallic"],
                         m["roughness"])
        li = lights.color[i] * lights.intensity[i]
        direct = direct + torch.where(gate[:, None],
                                      brdf * li * (ndotl * shadow)[:, None],
                                      0.0)
    ambient = m["base"] * eval_env_sh(n, fr.ibl.sh0, fr.ibl.sh1) \
        * p_rt.AMBIENT_INTENSITY * m["occlusion"][:, None]
    color = direct + ambient + m["emissive"]
    if with_ibl_spec:
        spec = eval_spec_ibl(n, view, m["roughness"], m["metallic"],
                             m["base"], fr.ibl.brdf_lut)
        color = color + spec * m["occlusion"][:, None]
    color = torch.where(m["unlit"][:, None], m["base"] + m["emissive"], color)
    return torch.where(active[:, None], color, 0.0), m, n, hit_pos, bias


@pytest.mark.parametrize("clusters", [False, True])
def test_shade_hit_equals_its_composition_before(scene, monkeypatch,
                                                 clusters):
    if clusters:
        monkeypatch.setattr(p_rt, "SHADOW_CLUSTER_MIN_LANES", 0)
    batches, shade_hit = [], p_rt._shade_hit

    def keep(*a, **k):
        batches.append((a, k))
        return shade_hit(*a, **k)
    monkeypatch.setattr(p_rt, "_shade_hit", keep)
    _render(scene, lbatch=2)
    monkeypatch.setattr(p_rt, "_shade_hit", shade_hit)
    assert len(batches) >= 5
    for a, k in (batches[0], batches[1]):   # layer 1 with IBL; a bounce
        new = shade_hit(*a, **k)
        old = _shade_hit_before(*a)
        assert torch.equal(new[0], old[0])
        for x, y in zip(new[2:], old[2:]):
            assert torch.equal(x, y)


# ---------------------------------------------------------- deferred


@pytest.fixture(scope="module")
def sequential(scene):
    return _render(scene)


def _reference(scene, refraction=True, **knobs):
    """The JAX hybrid frame with its module knobs set (``_DEFERRED``,
    ``_LBATCH``: SGE_RT_DEFERRED, SGE_RT_LBATCH)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rt, "_RT_PRIMARY", "hybrid")
        for k, v in knobs.items():
            mp.setattr(j_rt, k, v)
        return np.asarray(T.reference_render(scene, T.camera(), scene[1],
                                             refraction=refraction))


@pytest.mark.parametrize("refraction", [False, True])
def test_deferred_matches_reference_deferred(scene, monkeypatch, refraction):
    ref = _reference(scene, refraction, _DEFERRED=True)
    monkeypatch.setattr(p_rt, "render_frame", functools.partial(
        p_rt.render_frame, deferred=True))
    out = T._port_render(scene, T.camera(), scene[1], primary="hybrid",
                         refraction=refraction)
    if refraction:   # test_torch_trace_frame.py's tolerance
        T._agree(out, ref, 0.99, 5e-3)
    else:
        _deferred_bounds(out, ref)


@pytest.mark.parametrize("clusters", [False, True])
def test_deferred_matches_sequential(scene, sequential, monkeypatch,
                                     clusters):
    """The cluster shadows (K2/K3 twins) take one sorted sweep of every
    origin of the frame: R layer records and, for each bounce segment, R
    bounce hits."""
    seq = sequential
    sweeps = []
    if clusters:
        monkeypatch.setattr(p_rt, "SHADOW_CLUSTER_MIN_LANES", 0)
        seq = _render(scene)
        order = p_rt._shadow_order

        def sized(mode, basis, o, t_lim):
            sweeps.append(o.shape[0])
            return order(mode, basis, o, t_lim)
        monkeypatch.setattr(p_rt, "_shadow_order", sized)
    out = _render(scene, deferred=True)
    _deferred_bounds(out, seq)
    if clusters:
        p = -(-T.W // 128) * 128 * -(-T.H // 32) * 32
        assert sweeps == [3 * T.LAYERS * p]


@pytest.mark.parametrize("bounces", [(True, False), (False, True),
                                     (False, False)])
def test_deferred_prunes_bounce_segments(scene, monkeypatch, bounces):
    """A bounce no material can start leaves the merged stream (decided
    when the geometry is packed); the frame equals the sequential frame
    with that bounce turned off."""
    geo, _, pal, lights, ibl = scene
    usage = interop.scene_geometry(geo, device="cpu").bounces
    assert usage == (True, True)
    mats = {k: np.asarray(getattr(geo.materials, k))
            for k in ("metallic", "roughness", "transmission")}
    assert p_sg.bounce_usage_np(mats) == usage
    traced = []
    merged = p_def._trace_merged

    def sized(fr, o_b, d_b, mask_b):
        traced.append(o_b.shape[0])
        return merged(fr, o_b, d_b, mask_b)
    monkeypatch.setattr(p_def, "_trace_merged", sized)
    build = interop.scene_geometry

    def pruned(*a, **k):
        return build(*a, **k)._replace(bounces=p_sg.BounceUsage(*bounces))
    monkeypatch.setattr(interop, "scene_geometry", pruned)
    out = _render(scene, deferred=True)
    r = T.LAYERS * (-(-T.W // 128) * 128 * -(-T.H // 32) * 32)
    assert traced == ([sum(bounces) * r] if any(bounces) else [])
    monkeypatch.setattr(p_rt, "render_frame", functools.partial(
        p_rt.render_frame, enable_mirror=bounces[0]))
    _deferred_bounds(out, T._port_render(scene, T.camera(), scene[1],
                                         primary="hybrid",
                                         refraction=bounces[1]))


@pytest.mark.parametrize("primary", ["trace", "peels"])
def test_other_primaries_ignore_deferred(scene, monkeypatch, primary):
    def no(*a, **k):
        raise AssertionError("only the hybrid records are deferred")
    monkeypatch.setattr(p_def, "shade_deferred", no)
    np.testing.assert_array_equal(
        _render(scene, primary, deferred=True),
        _render(scene, primary))


# ------------------------------------------------------------ LBATCH


@pytest.fixture(scope="module")
def mode2(scene):
    return {p: _render(scene, primary=p) for p in ("hybrid", "peels",
                                                   "trace")}


@pytest.mark.parametrize("primary", ["hybrid", "peels", "trace"])
@pytest.mark.parametrize("lbatch", [0, 1, 3])
def test_lbatch_matches_mode_2(scene, mode2, primary, lbatch, monkeypatch):
    calls = {}
    for name in ("_shade_continuations", "_shade_layers_compacted",
                 "_shade_layers_dense"):
        fn = getattr(p_rt, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(p_rt, name, counted)
    out = _render(scene, primary, lbatch=lbatch)
    want = {1: "_shade_continuations", 0: "_shade_layers_compacted",
            3: "_shade_layers_dense" if primary == "hybrid"
            else "_shade_layers_compacted"}[lbatch]
    assert calls == {want: 1}, calls
    ref = mode2[primary]
    frac = float((np.abs(out - ref).max(-1) < 1e-4).mean())
    assert frac >= 0.999, frac
    assert abs(out.mean() - ref.mean()) <= 1e-4 * ref.mean()


def test_lbatch_3_matches_reference(scene):
    T._agree(_render(scene, lbatch=3), _reference(scene, _LBATCH=3), 0.99,
             5e-3)


# ------------------------------------------------------------ Engine


def test_engine_takes_the_schedules(scene, monkeypatch):
    seen = []
    render = p_rt.render_frame

    def spy(*a, **k):
        seen.append({x: k[x] for x in ("deferred", "shadow_sort",
                                       "shadow_sort_mode", "lbatch")})
        return render(*a, **k)
    monkeypatch.setattr(p_rt, "render_frame", spy)
    world = T._port_world(scene, [0.0, 0.5, 1.0])
    kw = dict(deferred=True, shadow_sort=True, shadow_sort_mode="morton",
              lbatch=0)
    eng = Engine(world, T.W, T.H, max_layers=T.LAYERS,
                 shadow_layers=T.SHADOW_LAYERS, device="cpu", **kw)
    img = eng.frame(1 / 60)
    assert seen == [kw]
    assert img.shape == (T.H, T.W, 3) and float(img.float().std()) > 1.0
    u8, _ = eng.program().eager()
    assert torch.equal(u8, img)
    eng = Engine(world, T.W, T.H, device="cpu")
    eng.frame(1 / 60)
    assert seen[-1] == dict(deferred=False, shadow_sort=False,
                            shadow_sort_mode="partition", lbatch=2)
    for bad in (dict(lbatch=4), dict(shadow_sort_mode="hilbert"),
                dict(raster_vis="scan"), dict(primary="deferred")):
        with pytest.raises(ValueError):
            Engine(world, T.W, T.H, device="cpu", **bad)
