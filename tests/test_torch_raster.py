"""PyTorch port, the raster path vs the JAX reference (CPU): the list
binning (``setup_lists``), the list rasterizers K9 and K10 through their
plain twins, ``render_frame_raster`` in both binning modes, and the
Engine's "raster" and "raster_pbr" paths. Each CUDA kernel is held against
its twin on the card by tests/test_torch_cuda_kernels.py.

The JAX rasterizers read SGE_RASTER_K and SGE_RASTER_MODE at import, so
those runs happen in a subprocess of their own (Pallas interpret mode) and
hand their arrays back as an .npz; the port reads the same module constant
as an argument (``setup_lists(k=...)``) or is patched to it.

  * ``setup_lists`` vs ``_setup`` on the 300-triangle soup of
    tests/test_tile_raster.py (one triangle crossing the near plane) at
    192x96 (6 tiles), with K = 512 and with K = 64, where tiles overflow:
    the candidate ids and counts and the overflowed tile count exactly; the
    rows' cofactors, which XLA's CPU build computes with fused
    multiply-adds, to 1e-5 relative of each row's largest entry (measured:
    4.5e-7).
  * K9 (``rasterize``) vs ``rasterize``, the first layer and the peel behind
    it, at K = 512 and at K = 64; K10 (``rasterize_peeled``) vs
    ``rasterize_peeled`` with 2 and 3 layers. Triangle ids on >= 99.9% of
    pixels (a pixel centre on a shared edge may go either way under the
    cofactors' last bits; measured: all); where they agree t and the view
    depth to 1e-5 relative (measured 2.5e-6) and the barycentrics to 1e-4
    absolute (measured 4e-5: the cofactors' last bits).
  * ``render_frame_raster`` in "clusters" and "lists" mode and the Engine
    paths on test_torch_trace_frame.py's scene at 96x54: frames >= 99.9% of
    pixels within 1e-4 and means within 1e-4 relative of the JAX frame;
    the "raster_pbr" Engine frame (traced visibility, both bounces off)
    against the reference chain with its pure-JAX traversal as
    test_torch_trace_frame.py holds the "rt" one: >= 97% of u8 pixels
    within 1 level.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift_game_engine_tpu.render import composite as j_comp
from swift_game_engine_tpu.render import raster as j_raster
from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu.render import scene_geometry as j_sg
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.render import raster as p_raster
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
from swift_game_engine_tpu_torch.render import tile_raster as TR
from swift_game_engine_tpu_torch.scene.engine import Engine

from test_torch_trace_frame import _port_world, build_scene, camera
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(__file__), "..")
W, H = 96, 54

# argv: the output path; SGE_RASTER_K is set by the caller
LISTS_CODE = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax.numpy as jnp
from swift_game_engine_tpu.render import tile_raster as TR
from swift_game_engine_tpu.render.camera import Camera

rng = np.random.default_rng(21)
T = 300
base = rng.uniform(-8, 8, (T, 3)).astype(np.float32)
v0 = base
v1 = base + rng.uniform(-2, 2, (T, 3)).astype(np.float32)
v2 = base + rng.uniform(-2, 2, (T, 3)).astype(np.float32)
# one triangle crossing the near plane / behind the camera
v0[0] = [-50, -2, 30]; v1[0] = [50, -2, 30]; v2[0] = [0, -2, -50]
cam = Camera()
cam.position = np.array([0.0, 3.0, 16.0], np.float32)
cam.target = np.array([0.0, 0.0, 0.0], np.float32)
W, H = 192, 96
vp = cam.view_proj(W, H)
j = [jnp.asarray(v) for v in (v0, v1, v2)]
cand, counts, over = TR._setup(*j, jnp.asarray(vp), W, H, 2, 3)
out = dict(v0=v0, v1=v1, v2=v2, vp=vp, cam=cam.position, cand=np.asarray(cand),
           counts=np.asarray(counts), over=np.asarray(over))
h1 = TR.rasterize(*j, jnp.asarray(vp), jnp.asarray(cam.position), W, H,
                  interpret=True)
prev = np.where(np.asarray(h1.found), np.asarray(h1.w_depth) * 1.000001,
                TR.BIG).astype(np.float32)
h2 = TR.rasterize(*j, jnp.asarray(vp), jnp.asarray(cam.position), W, H,
                  prev_w=jnp.asarray(prev), interpret=True)
out["prev"] = prev
for name, h in (("first", h1), ("peel", h2)):
    for f in ("t", "tri", "u", "v", "w_depth"):
        out[f"{name}_{f}"] = np.asarray(getattr(h, f))
for layers in (2, 3):
    for l, h in enumerate(TR.rasterize_peeled(*j, jnp.asarray(vp),
                                              jnp.asarray(cam.position), W,
                                              H, layers, interpret=True)):
        for f in ("t", "tri", "u", "v", "w_depth"):
            out[f"peeled{layers}_{l}_{f}"] = np.asarray(getattr(h, f))
np.savez(sys.argv[1], **out)
"""

# The JAX raster frame of test_torch_trace_frame.py's scene; argv: the output
# path; SGE_RASTER_MODE is set by the caller.
RASTER_FRAME = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import numpy as np
import test_torch_raster as T
np.save(sys.argv[1], T.reference_raster())
"""


def reference_raster():
    """The JAX raster frame of the test scene (SGE_RASTER_MODE as set)."""
    geo, tf, pal, _, _ = build_scene()
    cam = camera()
    fg = j_sg.flatten_frame(geo, jnp.asarray(tf), jnp.asarray(pal))
    return np.asarray(j_raster.render_frame_raster(
        geo, fg, jnp.asarray(cam.inv_view_proj(W, H)),
        jnp.asarray(cam.position), W, H,
        view_proj=jnp.asarray(cam.view_proj(W, H))))


def _run(tmp_path_factory, code, name, **env):
    """Run ``code`` in a subprocess with ``env`` set; it writes ``name``."""
    out = str(tmp_path_factory.mktemp("ref") / name)
    full = dict(os.environ, PYTHONPATH=os.path.abspath(REPO), **env)
    proc = subprocess.run([sys.executable, "-c", code, out],
                          cwd=os.path.abspath(REPO), env=full,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


@pytest.fixture(scope="module", params=[512, 64], ids=["k512", "k64"])
def lists(request, tmp_path_factory):
    k = request.param
    path = _run(tmp_path_factory, LISTS_CODE, f"lists{k}.npz",
                SGE_RASTER_K=str(k))
    return k, dict(np.load(path))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _tris(ref):
    return [_t(ref[k]) for k in ("v0", "v1", "v2")]


def test_setup_lists_matches_reference(lists):
    k, ref = lists
    cand, counts, over = TR.setup_lists(*_tris(ref), _t(ref["vp"]), 192, 96,
                                        k=k)
    cand = cand.numpy()
    np.testing.assert_array_equal(counts.numpy(), ref["counts"])
    assert int(over) == int(ref["over"])
    if k == 64:
        assert int(over) > 0           # the case exercises overflow
    np.testing.assert_array_equal(cand[..., 12], ref["cand"][..., 12])
    scale = np.abs(ref["cand"]).max(-1, keepdims=True)
    assert (np.abs(cand - ref["cand"]) <= 1e-5 * scale).all()


def _records_agree(hits, ref, prefix):
    tri = hits.tri.numpy()
    same = tri == ref[f"{prefix}_tri"]
    assert same.mean() >= 0.999, same.mean()
    assert (tri >= 0).sum() > 200                 # hits exercised
    for f, rtol, atol in (("t", 1e-5, 0), ("w_depth", 1e-5, 0),
                          ("u", 0, 1e-4), ("v", 0, 1e-4)):
        got, want = getattr(hits, f).numpy(), ref[f"{prefix}_{f}"]
        np.testing.assert_allclose(got[same], want[same], rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("peel", [False, True], ids=["first", "peel"])
def test_k9_twin_matches_reference(lists, monkeypatch, peel):
    """K9 (the list raster) at K = 512, and at K = 64 where tiles overflow
    and keep their first 64 candidates by triangle index."""
    k, ref = lists
    monkeypatch.setattr(TR, "RASTER_K", k)
    hits = TR.rasterize(*_tris(ref), _t(ref["vp"]), ref["cam"], 192, 96,
                        prev_w=_t(ref["prev"]) if peel else None)
    assert int(hits.overflow) == int(ref["over"])
    _records_agree(hits, ref, "peel" if peel else "first")


@pytest.mark.parametrize("layers", [2, 3])
def test_k10_twin_matches_reference(lists, monkeypatch, layers):
    k, ref = lists
    monkeypatch.setattr(TR, "RASTER_K", k)
    peels = TR.rasterize_peeled(*_tris(ref), _t(ref["vp"]), ref["cam"], 192,
                                96, layers)
    assert len(peels) == layers
    for l, hits in enumerate(peels):
        _records_agree(hits, ref, f"peeled{layers}_{l}")


def _port_raster(raster_mode):
    geo, tf, pal, _, _ = build_scene()
    pgeo = interop.scene_geometry(geo, device="cpu")
    pfg = p_sg.flatten_frame(pgeo, torch.as_tensor(tf), torch.as_tensor(pal))
    cam = camera()
    return p_raster.render_frame_raster(
        pgeo, pfg, torch.as_tensor(cam.inv_view_proj(W, H)), cam.position, W,
        H, view_proj=torch.as_tensor(cam.view_proj(W, H)),
        raster_mode=raster_mode).numpy()


def _equal(out, ref):
    """>= 99.9% of pixels within 1e-4, means within 1e-4 relative."""
    assert out.shape == ref.shape and np.isfinite(out).all()
    frac = float((np.abs(out - ref).max(-1) < 1e-4).mean())
    gap = abs(out.mean() - ref.mean()) / ref.mean()
    print(f"{frac:.5f} of pixels within 1e-4, mean gap {gap:.3e}")
    assert frac >= 0.999, frac
    assert gap <= 1e-4, (out.mean(), ref.mean())


@pytest.mark.parametrize("raster_mode", ["clusters", "lists"])
def test_raster_frame_matches_reference(tmp_path_factory, raster_mode):
    """Clusters: one K1 pass with the raster's opaque flag; lists: the K9
    peel loop (SGE_RASTER_MODE=lists)."""
    path = _run(tmp_path_factory, RASTER_FRAME, f"raster_{raster_mode}.npy",
                SGE_RASTER_MODE=raster_mode)
    _equal(_port_raster(raster_mode), np.load(path))


def test_opaque_flag_matches_reference():
    geo = build_scene()[0]
    np.testing.assert_array_equal(
        p_raster.opaque_tris(
            interop.scene_geometry(geo, device="cpu")).numpy(),
        np.asarray(j_rt._opaque_tris(geo)))


def _engine_u8(path, **kw):
    scene = build_scene()
    eng = Engine(_port_world(scene, [0.0, 0.5, 1.0]), W, H, path=path,
                 device="cpu", **kw)
    u8 = eng.frame(1 / 60).numpy()
    rebased = scene[1].copy()
    rebased[:, :3, 3] -= eng.camera.world_position.astype(np.float32)
    return scene, eng.camera, rebased, u8


def _u8_close(u8, img, frac):
    ref = (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    ref = np.asarray(j_comp.overlay_blit_device(ref, 60))
    assert u8.shape == ref.shape == (H, W, 3) and u8.dtype == np.uint8
    close = np.abs(u8.astype(int) - ref.astype(int)).max(-1) <= 1
    assert close.mean() >= frac, close.mean()


def test_engine_raster_path_matches_reference_chain():
    """path="raster": render_frame_raster (2 layers, clusters), no
    composite, u8 + overlay (scene/engine.py:165-169,235-240)."""
    scene, cam, rebased, u8 = _engine_u8("raster")
    geo, _, pal, _, _ = scene
    fg = j_sg.flatten_frame(geo, jnp.asarray(rebased), jnp.asarray(pal))
    img = j_raster.render_frame_raster(
        geo, fg, jnp.asarray(cam.inv_view_proj(W, H)),
        jnp.asarray(cam.position), W, H,
        view_proj=jnp.asarray(cam.view_proj(W, H)))
    _u8_close(u8, img, 0.999)


def test_engine_raster_pbr_path_matches_reference_chain():
    """path="raster_pbr": the RT frame with both bounces off, composite,
    u8 + overlay (scene/engine.py:143-163,226-234)."""
    scene, cam, rebased, u8 = _engine_u8("raster_pbr", primary="trace",
                                         shadow_layers=2)
    geo, _, pal, lights, ibl = scene
    fg = j_sg.flatten_frame(geo, jnp.asarray(rebased), jnp.asarray(pal))
    img = j_rt.render_frame(
        geo, fg, ibl, lights, jnp.asarray(cam.inv_view_proj(W, H)),
        jnp.asarray(cam.position), W, H, max_layers=3, shadow_layers=2,
        view_proj=jnp.asarray(cam.view_proj(W, H)), enable_mirror=False,
        enable_refraction=False)
    img = j_comp.composite_frame(img, 1.0, True)
    _u8_close(u8, img, 0.97)
