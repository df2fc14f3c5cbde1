"""PyTorch port, the non-layered traced frame and the shadow prepass vs the
JAX reference (CPU): kernels K6 (shared-origin closest hit with a t floor)
and K8 (any-hit opaque occlusion) through their plain twins, and the frames
that run them. Each CUDA kernel is held against its twin on the card by
tests/test_torch_cuda_kernels.py.

The JAX kernels and frames read their knobs at import, so every JAX run
happens in a subprocess of its own (SGE_RT_BLOCK=1024, Pallas interpret
mode), as tests/test_torch_trace_kernels.py and
tests/test_torch_trace_frame.py run them.

  * K6 twin vs trace_rays_so on the 250-triangle soup of
    test_torch_trace_kernels.py (two fifths translucent), 512 rays from one
    origin, a seventeenth of them inactive, with the default floor and with
    a per-lane floor past the first hit (as tests/test_so_kernel.py builds
    it). The TPU kernel orders a packet's children by the packet's nearest
    entry and the twin by the ray's own; the closest hit does not depend on
    the order except at exactly equal t, so the triangle ids agree on all
    but at most one ray in 512, and t to 1e-5 relative where they agree.
  * K8 twin vs trace_shadow_any on the 400-triangle soup, half of it
    translucent, 256 rays in random directions, some with t_limit 0 and
    some with a short limit: "any opaque hit within the limit" does not
    depend on the order, so every lane agrees.
  * The traced frame of test_torch_trace_frame.py's scene at 96x54 with
    ``layered=False`` (SGE_RT_LAYERED=0), and with ``shadow_layers`` 5 (with
    and without ``shadow_prepass``, SGE_SHADOW_PREPASS=1) and 0, all
    non-layered: at 8,192 lanes and these layer counts the shadows take the
    per-layer K4 loop on both sides. Without the refraction bounce (whose
    rays start a bias inside the glass box, where any two traversals
    differ on a few pixels: see test_torch_trace_frame.py), measured: every
    pixel within 1e-4 of the JAX kernel frame. Held: >= 99.9% of pixels
    within 1e-4 and the means within 1e-4 relative.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.ops import rt_kernel as RK
from swift_game_engine_tpu_torch.render import rt as p_rt
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg

from test_torch_trace_frame import build_scene, camera
from test_torch_trace_kernels import SOUP, _reference, _t

REPO = os.path.join(os.path.dirname(__file__), "..")
W, H, LAYERS = 96, 54, 3

K6_CODE = SOUP + r"""
rng, kb = soup(7, 250, 8.0, 0.4)
o = np.array([0.0, 1.0, 20.0], np.float32)
targets = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
d = targets - o
d /= np.linalg.norm(d, axis=1, keepdims=True)
t_max = np.full(512, K.BIG, np.float32)
t_max[::17] = 0.0
so = K.build_origin_rows(kb.rows, o)
t1, tri1 = K.trace_rays_so(so, o, jnp.asarray(d), jnp.asarray(t_max),
                           interpret=True)
t1, tri1 = np.asarray(t1), np.asarray(tri1)
floor = np.where(tri1 >= 0, t1 + 1e-3, 1e-4).astype(np.float32)
t2, tri2 = K.trace_rays_so(so, o, jnp.asarray(d), jnp.asarray(t_max),
                           t_floor=jnp.asarray(floor), interpret=True)
np.savez(sys.argv[1], rows=np.asarray(kb.rows), o=o, d=d, t_max=t_max,
         floor=floor, t1=t1, tri1=tri1, t2=np.asarray(t2),
         tri2=np.asarray(tri2))
"""

K8_CODE = SOUP + r"""
rng, kb = soup(7, 400, 10.0, 0.5)
o = rng.uniform(-12, 12, (256, 3)).astype(np.float32)
d = rng.normal(size=(256, 3)).astype(np.float32)
d /= np.linalg.norm(d, axis=1, keepdims=True)
t_lim = np.full(256, 60.0, np.float32)
t_lim[:32] = 0.0
t_lim[32:96] = 4.0
blocked = K.trace_shadow_any(kb, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t_lim), interpret=True)
np.savez(sys.argv[1], rows=np.asarray(kb.rows), o=o, d=d, t_lim=t_lim,
         blocked=np.asarray(blocked))
"""

# The JAX traced frame on its Pallas kernels; argv: the output path, the
# shadow layer count, then KEY=VALUE knobs, set before the package reads
# them at import.
FRAME = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["SGE_RT_BLOCK"] = "1024"
os.environ["SGE_JAX_TRAVERSAL"] = "0"
os.environ["SGE_RT_PRIMARY"] = "trace"
os.environ.update(a.split("=", 1) for a in sys.argv[3:])
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import numpy as np
import jax.numpy as jnp
import test_torch_trace_frame as T
from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu.render import scene_geometry as j_sg
geo, tf, pal, lights, ibl = T.build_scene()
cam = T.camera()
fg = j_sg.flatten_frame(geo, jnp.asarray(tf), jnp.asarray(pal))
img = j_rt.render_frame(
    geo, fg, ibl, lights, jnp.asarray(cam.inv_view_proj(96, 54)),
    jnp.asarray(cam.position), 96, 54, max_layers=3,
    shadow_layers=int(sys.argv[2]), view_proj=jnp.asarray(cam.view_proj(96, 54)),
    enable_refraction=False)
np.save(sys.argv[1], np.asarray(img))
"""


# --------------------------------------------------------------------- K6


@pytest.fixture(scope="module")
def k6(tmp_path_factory):
    return _reference(tmp_path_factory, K6_CODE, "k6")


@pytest.mark.parametrize("floor", [False, True], ids=["no_floor", "floor"])
def test_k6_twin_matches_reference(k6, floor):
    so = RK.build_origin_rows(_t(k6["rows"]), _t(k6["o"]))
    t_floor = _t(k6["floor"]) if floor else None
    t, tri = RK.trace_rays_so(so, k6["o"].tolist(), _t(k6["d"]),
                              _t(k6["t_max"]), t_floor=t_floor)
    rt, rtri = (k6["t2"], k6["tri2"]) if floor else (k6["t1"], k6["tri1"])
    t, tri = t.numpy(), tri.numpy()
    same = tri == rtri
    assert (~same).sum() <= 1, np.nonzero(~same)
    np.testing.assert_allclose(t[same], rt[same], rtol=1e-5)
    assert (rtri >= 0).sum() > (40 if floor else 150)    # hits exercised
    inactive = k6["t_max"] <= 0
    assert (t[inactive] == 0).all() and (tri[inactive] == -1).all()
    if floor:   # the continuation lies past the floor
        hit = tri >= 0
        assert (t[hit] > k6["floor"][hit]).all()


# --------------------------------------------------------------------- K8


def test_k8_twin_matches_reference(tmp_path_factory):
    ref = _reference(tmp_path_factory, K8_CODE, "k8")
    blocked = RK.trace_shadow_any(_t(ref["rows"]), _t(ref["o"]), _t(ref["d"]),
                                  _t(ref["t_lim"]))
    np.testing.assert_array_equal(blocked.numpy(), ref["blocked"])
    assert ref["blocked"][:32].all()                       # t_limit 0
    assert 10 < ref["blocked"][32:].sum() < 200            # both outcomes


# ---------------------------------------------------------------- frames


def _jax_frame(tmp_path, shadow_layers, *knobs):
    out = str(tmp_path / "frame.npy")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.run([sys.executable, "-c", FRAME, out,
                           str(shadow_layers), *knobs],
                          cwd=os.path.abspath(REPO), env=env,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(out)


def _port_frame(monkeypatch, **kw):
    """The port's traced frame without refraction -> (image, calls per
    kernel wrapper)."""
    calls = {}
    for name in ("trace_layers_so", "trace_rays_so", "trace_shadow_any",
                 "trace_shadow_factor"):
        orig = getattr(RK, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(RK, name, spy)
    geo, tf, pal, lights, ibl = build_scene()
    pgeo = interop.scene_geometry(geo)
    pfg = p_sg.flatten_frame(pgeo, torch.as_tensor(tf), torch.as_tensor(pal))
    cam = camera()
    img = p_rt.render_frame(
        pgeo, pfg, interop.ibl(ibl), interop.lights(lights),
        torch.as_tensor(cam.inv_view_proj(W, H)), cam.position, W, H,
        max_layers=LAYERS, view_proj=torch.as_tensor(cam.view_proj(W, H)),
        primary="trace", enable_refraction=False, **kw)
    return img.numpy(), calls


def _equal(out, ref):
    """>= 99.9% of pixels within 1e-4, means within 1e-4 relative."""
    assert out.shape == ref.shape and np.isfinite(out).all()
    frac = float((np.abs(out - ref).max(-1) < 1e-4).mean())
    gap = abs(out.mean() - ref.mean()) / ref.mean()
    print(f"{frac:.5f} of pixels within 1e-4, mean gap {gap:.3e}")
    assert frac >= 0.999, frac
    assert gap <= 1e-4, (out.mean(), ref.mean())


def test_non_layered_frame_matches_reference(tmp_path, monkeypatch):
    """layered=False: K6 for layer 1 and each continuation layer; the
    file's 2 shadow layers take the shadow walk K7."""
    ref = _jax_frame(tmp_path, 2, "SGE_RT_LAYERED=0")
    img, calls = _port_frame(monkeypatch, layered=False, shadow_layers=2)
    assert "trace_layers_so" not in calls and calls["trace_rays_so"] >= 2
    assert calls["trace_shadow_factor"] >= 1
    _equal(img, ref)


@pytest.mark.parametrize("shadow_layers,prepass", [(5, False), (5, True),
                                                   (0, False)],
                         ids=["5", "5_prepass", "0"])
def test_shadow_loop_frame_matches_reference(tmp_path, monkeypatch,
                                             shadow_layers, prepass):
    """Shadow layer counts outside 1..4 take the per-layer K4 loop, behind
    the K8 prepass with shadow_prepass=True. With the prepass the image may
    differ from the no-prepass frame by design (an opaque blocker behind
    shadow_layers translucent hits shades the lane), so it is held against
    the JAX frame with SGE_SHADOW_PREPASS=1."""
    knobs = ["SGE_RT_LAYERED=0"] + (["SGE_SHADOW_PREPASS=1"] if prepass
                                    else [])
    ref = _jax_frame(tmp_path, shadow_layers, *knobs)
    img, calls = _port_frame(monkeypatch, layered=False,
                             shadow_layers=shadow_layers,
                             shadow_prepass=prepass)
    assert "trace_shadow_factor" not in calls
    assert (calls.get("trace_shadow_any", 0) > 0) == prepass
    _equal(img, ref)
