"""PyTorch port, the raster path's traced visibility
(``render_frame_raster(raster_vis="trace")``, the reference's
SGE_RASTER_VIS=trace, raster.py:163-189) vs the JAX reference (CPU).

The scene is tests/test_torch_trace_frame.py's at 96x54, the port through
its plain twins (the K4 twin). ``max_layers`` dense closest-hit traces of
the live rays, the raster fragment model, the front-to-back chain, each
layer starting 2*bias past the last hit.

  * Against the JAX frame (SGE_RASTER_VIS=trace; the suite's pure-JAX
    traversal, tests/conftest.py). ``_RASTER_VIS`` is a module global the
    JAX frame reads when it runs, so it is set by monkeypatch in this
    process, as tests/test_torch_primary_raster.py sets SGE_RT_PRIMARY.
    No refraction ray runs here, so the tolerance is
    tests/test_torch_so_prepass.py's for frames without one: >= 99.9% of
    pixels within 1e-4, the means within 1e-4 relative (measured: every
    pixel within 1e-4, means within 6.2e-7 at 1, 2 and 3 layers).
  * The pixel layout: the reference traces its scanline rays in square
    tiles (``camera.tile_permutation``) and permutes the image back; the
    port traces the RT frame's padded tile-major rays and crops
    (``untile_image``). The same trace in scanline order
    (``generate_rays``, reshaped) gives the port's image bit for bit: each
    ray's records are its own.
  * Launches: K4 exactly max_layers times a frame, no rasterizer.
  * Against the port's tile visibility ("clusters"): the two differ at
    sub-pixel triangle edges, so tests/test_rt_raster_primary.py's
    tolerance: more than 97% of pixels within 1e-4, the means within 1%.
  * The Engine takes ``raster_vis`` to the raster path's frame program.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swift_game_engine_tpu.render import raster as j_raster
from swift_game_engine_tpu.render import scene_geometry as j_sg
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.ops import rt_kernel as p_rk
from swift_game_engine_tpu_torch.render import raster as p_raster
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
from swift_game_engine_tpu_torch.render import tile_raster as p_tr
from swift_game_engine_tpu_torch.render.camera import generate_rays
from swift_game_engine_tpu_torch.render.rt import _next_origin
from swift_game_engine_tpu_torch.scene.engine import Engine

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_trace_frame as T  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def scene():
    return T.build_scene()


@pytest.fixture(scope="module")
def port(scene):
    geo, tf, pal, _, _ = scene
    pgeo = interop.scene_geometry(geo, device="cpu")
    return pgeo, p_sg.flatten_frame(pgeo, torch.as_tensor(tf),
                                    torch.as_tensor(pal))


def _port_raster(port, layers, vis="trace", w=T.W, h=T.H):
    cam = T.camera()
    pgeo, pfg = port
    return p_raster.render_frame_raster(
        pgeo, pfg, torch.as_tensor(cam.inv_view_proj(w, h)), cam.position,
        w, h, max_layers=layers, view_proj=torch.as_tensor(
            cam.view_proj(w, h)), raster_vis=vis).numpy()


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_traced_raster_matches_reference(scene, port, layers, monkeypatch):
    geo, tf, pal, _, _ = scene
    cam = T.camera()
    monkeypatch.setattr(j_raster, "_RASTER_VIS", "trace")
    fg = j_sg.flatten_frame(geo, jnp.asarray(tf), jnp.asarray(pal))
    ref = np.asarray(j_raster.render_frame_raster(
        geo, fg, jnp.asarray(cam.inv_view_proj(T.W, T.H)),
        jnp.asarray(cam.position), T.W, T.H, max_layers=layers))
    T._agree(_port_raster(port, layers), ref, 0.999, 1e-4)


def test_pixel_layout_is_the_scanline_trace(port):
    """The traced image equals the same trace over scanline rays."""
    pgeo, pfg = port
    cam = T.camera()
    o, d = generate_rays(torch.as_tensor(cam.inv_view_proj(T.W, T.H)),
                         cam.position, T.W, T.H)
    p = d.shape[0]
    accum = torch.zeros((p, 3))
    accum_alpha = torch.zeros(p)
    live = torch.ones(p, dtype=torch.bool)
    for _ in range(2):
        live = live & (accum_alpha < 0.99)
        t, tri, u, v, found = p_rk.trace_batch(pfg.bvh, o, d, live)
        color, alpha = p_raster._raster_shade(pgeo, pfg, d, tri, u, v, found)
        contrib = torch.where(found, alpha * (1.0 - accum_alpha), 0.0)
        accum = accum + color * contrib[:, None]
        accum_alpha = accum_alpha + contrib
        o = torch.where(found[:, None],
                        _next_origin(o, d, torch.where(found, t, 1.0)), o)
        live = live & found
    out = accum + torch.tensor(p_raster.BG_COLOR) * (1.0 - accum_alpha)[:,
                                                                        None]
    np.testing.assert_array_equal(_port_raster(port, 2),
                                  out.reshape(T.H, T.W, 3).numpy())


def test_traced_raster_launches_k4_alone(port, monkeypatch):
    calls = []
    trace_rays = p_rk.trace_rays

    def counted(*a, **k):
        calls.append(a[2].shape[0])
        return trace_rays(*a, **k)

    def no_raster(*a, **k):
        raise AssertionError("traced visibility rasterizes nothing")
    monkeypatch.setattr(p_rk, "trace_rays", counted)
    for name in ("cluster_raster", "list_raster", "rasterize",
                 "rasterize_clusters"):
        monkeypatch.setattr(p_tr, name, no_raster)
    monkeypatch.setattr(p_raster, "rasterize", no_raster)
    monkeypatch.setattr(p_raster, "rasterize_clusters", no_raster)
    _port_raster(port, 3)
    lanes = -(-T.W // 128) * 128 * -(-T.H // 32) * 32
    assert calls == [lanes] * 3


def test_traced_raster_near_tile_visibility(port):
    traced, tiled = _port_raster(port, 2), _port_raster(port, 2, "tile")
    same = float((np.abs(traced - tiled).max(-1) < 1e-4).mean())
    print(f"{same:.5f} of pixels within 1e-4 of the tile visibility")
    assert same > 0.97, same
    assert abs(traced.mean() - tiled.mean()) < 0.01 * tiled.mean()


def test_engine_takes_raster_vis(scene, monkeypatch):
    seen = []
    render = p_raster.render_frame_raster

    def spy(*a, **k):
        seen.append((k["raster_mode"], k["raster_vis"]))
        return render(*a, **k)
    from swift_game_engine_tpu_torch.scene import engine as p_engine
    monkeypatch.setattr(p_engine, "render_frame_raster", spy)
    world = T._port_world(scene, [0.0, 0.5, 1.0])
    eng = Engine(world, T.W, T.H, path="raster", raster_vis="trace",
                 device="cpu")
    img = eng.frame(1 / 60)
    assert seen == [("clusters", "trace")]
    assert img.shape == (T.H, T.W, 3) and float(img.float().std()) > 1.0
    u8, _ = eng.program().eager()
    assert torch.equal(u8, img)
    Engine(world, T.W, T.H, path="raster", device="cpu").frame(1 / 60)
    assert seen[-1] == ("clusters", "tile")
