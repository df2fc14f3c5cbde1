"""PyTorch port, the non-layered traced frame and the shadow prepass vs the
JAX reference (CPU): kernels K6 (shared-origin closest hit with a t floor)
and K8 (any-hit opaque occlusion), instances of the wide walk, through
their plain twins, and the frames that run them. Each CUDA kernel is held
against its twin on the card by tests/test_torch_cuda_kernels.py.

The JAX kernels and frames read their knobs at import, so every JAX run
happens in a subprocess of its own (SGE_RT_BLOCK=1024, Pallas interpret
mode), as tests/test_torch_trace_kernels.py and
tests/test_torch_trace_frame.py run them.

  * K6 twin vs trace_rays_so on the 250-triangle soup of
    test_torch_trace_kernels.py (two fifths translucent), 512 rays from one
    origin, a seventeenth of them inactive, on the reference's origin rows,
    with the default floor, with a per-lane floor past the first hit (as
    tests/test_so_kernel.py builds it) and with the floor exactly at the
    first hit's t. The TPU kernel walks the binary tree, ordering a
    packet's children by the packet's nearest entry; the twin walks the
    wide tree rebuilt from the reference's rows, each ray in its own order;
    the closest hit does not depend on the order except at exactly equal t,
    so the triangle ids agree on all but at most one ray in 512, and t to
    1e-5 relative where they agree. With the floor at the first hit, which
    hits come back is decided by the last bit of t*dnp: the twin fuses the
    slot test's dot products as XLA fuses the reference's, so that it
    decides as the reference does. The twin on the binary tree, which
    counts the work of that walk, is held to the same tolerance.
  * K6 twin with the floor exactly at each ray's first hit: no hit comes
    back below the floor, and every hit returned passes the contract's
    tn_s > t_floor*dnp in f32 -- the first hit itself comes back only
    where t*dnp rounds below tn_s (it then lies at t = floor).
  * K8 twin vs trace_shadow_any on the 400-triangle soup, half of it
    translucent, 256 rays in random directions, some with t_limit 0 and
    some with a short limit: "any opaque hit within the limit" does not
    depend on the order, so every lane agrees (the binary twin too).
  * K8 twin on two stacked planes, translucent over opaque: a ray with only
    the translucent plane before its limit is not blocked, one whose limit
    reaches the opaque plane is.
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
from swift_game_engine_tpu_torch.assets.materials import Material
from swift_game_engine_tpu_torch.assets.mesh_api import MeshDescriptor
from swift_game_engine_tpu_torch.ops import rt_kernel as RK
from swift_game_engine_tpu_torch.render import rt as p_rt
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
from swift_game_engine_tpu_torch.render.scene_geometry import \
    RenderGeometryBuilder

from test_torch_trace_frame import build_scene, camera
from test_torch_trace_kernels import SOUP, _reference, _t
from torch_threads import one_thread  # noqa: E402,F401

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
floor3 = np.where(tri1 >= 0, t1, 1e-4).astype(np.float32)
t3, tri3 = K.trace_rays_so(so, o, jnp.asarray(d), jnp.asarray(t_max),
                           t_floor=jnp.asarray(floor3), interpret=True)
np.savez(sys.argv[1], rows=np.asarray(kb.rows), srows=np.asarray(so[1]),
         o=o, d=d, t_max=t_max, floor=floor, t1=t1, tri1=tri1, t2=np.asarray(t2),
         tri2=np.asarray(tri2), floor3=floor3, t3=np.asarray(t3),
         tri3=np.asarray(tri3))
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


def _k6_twin(k6, t_floor, walk="wide"):
    """K6 on the reference's rows and origin rows (build_origin_rows is
    held against the reference's in test_torch_trace_kernels.py): the
    wrapper (the wide walk's twin here), or the binary walk's twin."""
    rows = _t(k6["rows"])
    args = (k6["o"].tolist(), _t(k6["d"]), _t(k6["t_max"]), t_floor)
    if walk == "binary":
        return RK.trace_rays_so_binary(
            (RK.binary_header(rows), _t(k6["srows"])), *args)
    return RK.trace_rays_so(RK.wide_tree(rows), _t(k6["srows"]), *args)


# the three reference runs: (t, tri, floor key) of each
K6_CASES = {"no_floor": ("t1", "tri1", None), "floor": ("t2", "tri2", "floor"),
            "floor_at_hit": ("t3", "tri3", "floor3")}


def _k6_check(k6, case, t, tri):
    t_key, tri_key, floor_key = K6_CASES[case]
    rt, rtri = k6[t_key], k6[tri_key]
    t, tri = t.numpy(), tri.numpy()
    same = tri == rtri
    assert (~same).sum() <= 1, np.nonzero(~same)
    np.testing.assert_allclose(t[same], rt[same], rtol=1e-5)
    assert (rtri >= 0).sum() > (40 if floor_key else 150)  # hits exercised
    inactive = k6["t_max"] <= 0
    assert (t[inactive] == 0).all() and (tri[inactive] == -1).all()
    if floor_key:   # the continuation lies past the floor (or at it, for
        hit = tri >= 0   # the first hit where t*dnp rounds below tn_s)
        fl = k6[floor_key][hit]
        assert (t[hit] > fl).all() if case == "floor" else \
            (t[hit] >= fl).all()


def _k6_floor(k6, case):
    floor_key = K6_CASES[case][2]
    return _t(k6[floor_key]) if floor_key else None


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_twin_matches_reference(k6, case):
    _k6_check(k6, case, *_k6_twin(k6, _k6_floor(k6, case)))


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_binary_twin_matches_reference(k6, case):
    _k6_check(k6, case, *_k6_twin(k6, _k6_floor(k6, case), "binary"))


def test_k6_floor_at_a_hit(k6):
    """The floor exactly at each ray's first hit t: the contract is
    tn_s > t_floor*dnp in f32, so the first hit comes back only where
    t*dnp rounds below tn_s, and then at t = floor."""
    tree = RK.wide_tree(_t(k6["rows"]))
    srows = _t(k6["srows"])
    d, t_max = _t(k6["d"]), _t(k6["t_max"])
    t1, tri1 = RK.trace_rays_so(tree, srows, k6["o"].tolist(), d, t_max)
    hit1 = tri1 >= 0
    floor = torch.where(hit1, t1, 1e-4)
    t2, tri2 = RK.trace_rays_so(tree, srows, k6["o"].tolist(), d, t_max,
                                t_floor=floor)
    hit2 = tri2 >= 0
    assert int(hit1.sum()) > 150 and int(hit2.sum()) > 40
    assert bool((t2[hit2] >= floor[hit2]).all())       # none below the floor
    # each hit returned, recomputed from its own slot: floor*dnp < tn_s
    base = RK.SO_SLOT_F * RK.SLOT_N
    ids = srows[:, base:].floor()                  # translucent: id + 0.5
    lane = torch.nonzero(hit2).squeeze(1)
    row, j = (torch.nonzero(ids[None] == tri2[lane, None, None].float())
              [:, 1:].T)
    slot = srows[row, :base].reshape(-1, RK.SLOT_N, RK.SO_SLOT_F)[
        torch.arange(lane.numel()), j]
    t, dnp, _, _, tn_s = RK._so_slot(d[lane], slot, fused=True)
    assert bool((tn_s > floor[lane] * dnp).all())
    assert torch.equal(t, t2[lane])
    again = lane[tri2[lane] == tri1[lane]]            # the first hit again
    assert bool((t2[again] == floor[again]).all())
    assert again.numel() < 0.2 * int(hit1.sum())


# --------------------------------------------------------------------- K8


def test_k8_twin_matches_reference(tmp_path_factory):
    ref = _reference(tmp_path_factory, K8_CODE, "k8")
    rows = _t(ref["rows"])
    rays = [_t(ref[k]) for k in ("o", "d", "t_lim")]
    blocked = RK.trace_shadow_any(RK.wide_tree(rows), rows, *rays)
    np.testing.assert_array_equal(blocked.numpy(), ref["blocked"])
    np.testing.assert_array_equal(
        RK.trace_shadow_any_binary(rows, *rays).numpy(), ref["blocked"])
    assert ref["blocked"][:32].all()                       # t_limit 0
    assert 10 < ref["blocked"][32:].sum() < 200            # both outcomes


def test_k8_translucent_in_front_does_not_block():
    """A translucent plane (y = 5) over an opaque one (y = 0), both 40
    units wide: rays up through the translucent plane, down to it with a
    limit short of the opaque plane, and down with a limit past it."""
    quad = np.array([[-20, 0, -20], [20, 0, -20], [20, 0, 20], [-20, 0, 20]],
                    np.float32)
    b = RenderGeometryBuilder(texture_size=4)
    for y, mat in ((0.0, Material(name="floor")),
                   (5.0, Material(name="glass", alpha=0.4))):
        b.add_static_mesh(MeshDescriptor(
            positions=quad + np.float32([0, y, 0]),
            indices=np.array([0, 1, 2, 0, 2, 3], np.int32)), mat,
            instance=0)
    fg = p_sg.flatten_frame(b.build(device="cpu"), torch.eye(4)[None],
                            torch.zeros((1, 1, 4, 4)))
    rng = np.random.default_rng(14)
    n = 96
    o = np.concatenate([rng.uniform(-10, 10, (n, 1)), np.full((n, 1), 3.0),
                        rng.uniform(-10, 10, (n, 1))], 1).astype(np.float32)
    o[n // 3:, 1] = 8.0                                  # above both planes
    d = np.tile(np.float32([0.1, 1.0, -0.2]), (n, 1))
    d[n // 3:, 1] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_lim = np.full(n, 6.0, np.float32)                  # up: glass only
    t_lim[n // 3:2 * n // 3] = 5.0                       # down: glass only
    t_lim[2 * n // 3:] = 20.0                            # down: both
    blocked = RK.trace_shadow_any(fg.bvh.wide, fg.bvh.rows, torch.as_tensor(o),
                                  torch.as_tensor(d), torch.as_tensor(t_lim))
    want = np.arange(n) >= 2 * n // 3
    np.testing.assert_array_equal(blocked.numpy(), want)


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
    pgeo = interop.scene_geometry(geo, device="cpu")
    pfg = p_sg.flatten_frame(pgeo, torch.as_tensor(tf), torch.as_tensor(pal))
    cam = camera()
    img = p_rt.render_frame(
        pgeo, pfg, interop.ibl(ibl, device="cpu"),
        interop.lights(lights, device="cpu"),
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
