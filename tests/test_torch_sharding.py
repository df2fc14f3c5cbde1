"""PyTorch port, the multi-device path (parallel/sharding.py) and the flat-ray
core ``rt._render_rays`` vs the JAX reference (CPU).

The scene is tests/test_torch_trace_frame.py's procedural one at 96x54
(8,192 padded lanes: the frame and every shard take the shadow walk, K7's
plain twin, below the 100,000-lane cluster threshold). The port renders
with its plain twins on CPU tensors; the reference is the JAX package's
``sharded_render`` on meshes of 1 and 8 of the virtual CPU devices that
tests/conftest.py provisions, in process, under that file's
``SGE_JAX_TRAVERSAL=1`` (the pure-JAX traversal and the per-layer shadow
loop), as tests/test_multichip.py runs it. Tolerance: the traversal
tolerance of test_torch_trace_frame.py
(``test_traced_frame_matches_reference_traversal``): >= 99% of pixels
within 1e-4 and the means within 0.5%.

The port's shards are virtual (``sharded_render`` with an int group: the
shards rendered in turn, concatenated in rank order) or one real gloo
group of 2 ranks in two processes (``tests/torch_shard_worker.py``,
``file://`` rendezvous in the test's directory). The shadow source follows
each shard's own lane count: the JAX side cannot show that in process (its
pure-JAX traversal never takes the cluster sweep), so the port's rule is
held to the reference's rule (rt.py:1420-1452) directly, with the lane
threshold moved between the 2-shard and the 8-shard lane counts.

The fused sharded step runs on the DemoScene without its imported assets
(``include_imported_assets=False``), built by both packages from the
synthetic rig's directory (tests/torch_pose_rig.py: the reference's
DemoScene needs the skeleton and profiles, which the repository lacks).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from swift_game_engine_tpu.parallel import sharding as JSH
from swift_game_engine_tpu.render.camera import Camera
from swift_game_engine_tpu.render.ibl import IBL
from swift_game_engine_tpu.scene.demo_scene import DemoScene
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.ops import rt_kernel as p_rk
from swift_game_engine_tpu_torch.parallel import sharding as SH
from swift_game_engine_tpu_torch.render import rt as p_rt
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
from swift_game_engine_tpu_torch.render.camera import (generate_rays_tiled,
                                                       untile_image)
from swift_game_engine_tpu_torch.render.shading import hash12
from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_trace_frame as T  # noqa: E402
import torch_pose_rig as R  # noqa: E402
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "..", "assets")
SHARDS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def scene():
    return T.build_scene()


@pytest.fixture(scope="module")
def port(scene):
    geo, tf, pal, lights, ibl = scene
    return dict(geo=interop.scene_geometry(geo, device="cpu"),
                ibl=interop.ibl(ibl, device="cpu"),
                lights=interop.lights(lights, device="cpu"),
                transforms=torch.as_tensor(tf), palettes=torch.as_tensor(pal))


def _frame_args(port, w, h):
    cam = T.camera()
    return (port["transforms"], port["palettes"],
            torch.as_tensor(cam.inv_view_proj(w, h)), cam.position)


def _port_sharded(port, shards, w=T.W, h=T.H):
    render = SH.sharded_render(shards, port["geo"], port["ibl"],
                               port["lights"], w, h, T.LAYERS,
                               T.SHADOW_LAYERS, device="cpu")
    return render(*_frame_args(port, w, h)).numpy()


def _jax_sharded(scene, n_dev, w=T.W, h=T.H):
    geo, tf, pal, lights, ibl = scene
    cam = T.camera()
    render = JSH.sharded_render(JSH.make_mesh(jax.devices()[:n_dev]), geo,
                                ibl, lights, w, h, max_layers=T.LAYERS,
                                shadow_layers=T.SHADOW_LAYERS)
    return np.asarray(render(jnp.asarray(tf), jnp.asarray(pal),
                             jnp.asarray(cam.inv_view_proj(w, h)),
                             jnp.asarray(cam.position)))


@pytest.fixture(scope="module")
def whole(port):
    """``_render_rays`` over the frame's whole batch, as an image."""
    geo, fg = port["geo"], p_sg.flatten_frame(port["geo"],
                                              port["transforms"],
                                              port["palettes"])
    cam = T.camera()
    o, d, _, _ = generate_rays_tiled(torch.as_tensor(cam.inv_view_proj(
        T.W, T.H)), cam.position, T.W, T.H)
    out = p_rt._render_rays(geo, fg, port["ibl"], port["lights"],
                            cam.position, o, d, T.LAYERS, T.SHADOW_LAYERS)
    return untile_image(out, T.W, T.H).numpy()


@pytest.fixture(scope="module")
def reference(scene):
    """The JAX sharded frame on 1 and on 8 virtual devices."""
    assert len(jax.devices()) >= 8, "conftest must provision 8 CPU devices"
    return {n: _jax_sharded(scene, n) for n in (1, 8)}


def test_render_rays_is_the_traced_frame_before_its_dither(port):
    """render_frame(primary="trace") is _render_rays over its lanes, then
    the per-pixel dither and the untiling: bit for bit."""
    geo = port["geo"]
    fg = p_sg.flatten_frame(geo, port["transforms"], port["palettes"])
    cam = T.camera()
    ivp = torch.as_tensor(cam.inv_view_proj(T.W, T.H))
    img = p_rt.render_frame(geo, fg, port["ibl"], port["lights"], ivp,
                            cam.position, T.W, T.H, max_layers=T.LAYERS,
                            shadow_layers=T.SHADOW_LAYERS, primary="trace")
    o, d, px, py = generate_rays_tiled(ivp, cam.position, T.W, T.H)
    out = p_rt._render_rays(geo, fg, port["ibl"], port["lights"],
                            cam.position, o, d, T.LAYERS, T.SHADOW_LAYERS)
    noise = hash12(torch.stack([px.float(), py.float()], -1))
    out = torch.clamp(out + ((noise - 0.5) * (1.0 / 255.0))[:, None],
                      min=0.0)
    assert torch.equal(untile_image(out, T.W, T.H), img)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_render_matches_reference(port, reference, whole, shards):
    """Each shard count's image against the JAX sharded frame on 1 and on
    8 devices (traversal tolerance), and against the whole batch's
    ``_render_rays`` (every shard takes the walk, as the whole batch does:
    within 1e-5)."""
    img = _port_sharded(port, shards)
    assert img.shape == (T.H, T.W, 3) and img.std() > 1e-3
    np.testing.assert_allclose(img, whole, rtol=0, atol=1e-5)
    for ref in reference.values():
        T._agree(img, ref, 0.99, 5e-3)


def test_sharded_render_pads_rays(port, scene):
    """60x28 (test_multichip.py's width that no shard count divides): 8
    shards against the JAX frame on 8 devices; 3 shards pad the 4,096
    lanes by 2 rays parked far outside the scene, which the crop drops and
    which change no other lane's colour (the whole batch's within 1e-5)."""
    w, h = 60, 28
    img8 = _port_sharded(port, 8, w, h)
    T._agree(img8, _jax_sharded(scene, 8, w, h), 0.99, 5e-3)
    img3 = _port_sharded(port, 3, w, h)
    assert img3.shape == (h, w, 3)
    np.testing.assert_allclose(img3, _port_sharded(port, 1, w, h), rtol=0,
                               atol=1e-5)


def test_sharded_render_reads_each_call_inputs(port, scene):
    """One ``sharded_render`` (3 shards: padded rays) called at two
    cameras, the CPU run of the body the card captures at its first call:
    each image is the JAX sharded frame's at that camera (8 devices,
    traversal tolerance), so no host value of the first call is kept.
    The second camera arrives as device tensors, the first as host
    values; ``eager`` at the second camera equals the call bit for bit."""
    geo, tf, pal, lights, ibl = scene
    cam_b = T.camera()
    cam_b.position = np.array([-3.0, 6.0, 9.0], np.float32)
    cam_b.target = np.array([1.0, 0.5, -1.0], np.float32)
    render = SH.sharded_render(3, port["geo"], port["ibl"], port["lights"],
                               T.W, T.H, T.LAYERS, T.SHADOW_LAYERS,
                               device="cpu")
    jrender = JSH.sharded_render(JSH.make_mesh(jax.devices()[:8]), geo, ibl,
                                 lights, T.W, T.H, max_layers=T.LAYERS,
                                 shadow_layers=T.SHADOW_LAYERS)
    imgs = []
    for cam, as_tensor in ((T.camera(), False), (cam_b, True)):
        ivp, pos = cam.inv_view_proj(T.W, T.H), cam.position
        args = (port["transforms"], port["palettes"],
                torch.as_tensor(ivp) if as_tensor else ivp,
                torch.as_tensor(pos) if as_tensor else pos)
        img = render(*args)
        want = np.asarray(jrender(jnp.asarray(tf), jnp.asarray(pal),
                                  jnp.asarray(ivp), jnp.asarray(pos)))
        assert img.shape == (T.H, T.W, 3) and float(img.std()) > 1e-3
        T._agree(img.numpy(), want, 0.99, 5e-3)
        imgs.append(img)
    assert torch.equal(render.eager(*args), imgs[1])
    assert float((imgs[0] - imgs[1]).abs().max()) > 0.1


@pytest.mark.parametrize("world", [3, 8])
def test_shard_rays_pads_as_reference(world):
    """Origin 0 and direction +y on the padding rays (sharding.py:31-40);
    the ranks' slices in order are the reference's padded arrays."""
    rng = np.random.default_rng(world)
    o = rng.normal(size=(10, 3)).astype(np.float32)
    d = rng.normal(size=(10, 3)).astype(np.float32)
    mesh = JSH.make_mesh(jax.devices()[:world])
    jo, jd, jn = JSH.shard_rays(mesh, jnp.asarray(o), jnp.asarray(d))
    parts = [SH.shard_rays(torch.as_tensor(o), torch.as_tensor(d), r, world)
             for r in range(world)]
    assert all(n == jn == 10 for _, _, n in parts)
    assert all(p[0].shape[0] == parts[0][0].shape[0] for p in parts)
    np.testing.assert_array_equal(torch.cat([p[0] for p in parts]).numpy(),
                                  np.asarray(jo))
    np.testing.assert_array_equal(torch.cat([p[1] for p in parts]).numpy(),
                                  np.asarray(jd))


def test_shadow_source_follows_the_shard(port, whole, monkeypatch):
    """With the lane threshold between the 8-shard (1,024 lanes) and the
    2-shard (4,096) lane counts, each shard takes the source the
    reference's rule gives for its own lane count: the 2 shards and the
    whole batch the cluster sweeps, the 8 shards the walk. The 2-shard
    image is the whole batch's (within 1e-5); the 8-shard image, whose
    shards take another shadow source, meets it at the traversal
    tolerance."""
    threshold = 3000
    monkeypatch.setattr(p_rt, "SHADOW_CLUSTER_MIN_LANES", threshold)
    taken, shadow_mode = [], p_rt._shadow_mode

    def logged(geo, fg, lights, lanes, shadow_layers):
        mode, consts = shadow_mode(geo, fg, lights, lanes, shadow_layers)
        taken.append((lanes, mode))
        return mode, consts
    monkeypatch.setattr(p_rt, "_shadow_mode", logged)
    fg = p_sg.flatten_frame(port["geo"], port["transforms"],
                            port["palettes"])
    imgs = {}
    for shards in (1, 2, 8):
        taken.clear()
        imgs[shards] = _port_sharded(port, shards)
        lanes = 8192 // shards
        rule = "clusters" if lanes >= threshold else \
            "walk" if p_rk.walk_available(fg.bvh.rows) else "loop"
        assert taken == [(lanes, rule)] * shards, taken
    np.testing.assert_allclose(imgs[2], imgs[1], rtol=0, atol=1e-5)
    T._agree(imgs[8], imgs[1], 0.99, 5e-3)
    # the whole batch's sweep and walk frames agree as closely
    T._agree(imgs[1], whole, 0.99, 5e-3)


def test_gloo_group_renders_the_in_process_shards(port, tmp_path):
    """Two ranks of a real gloo group, one process each: every rank's
    gathered image is the in-process 2-shard image bit for bit."""
    inputs = str(tmp_path / "inputs.pt")
    ivp, cam = _frame_args(port, T.W, T.H)[2:]
    torch.save(dict(geo=port["geo"], ibl=port["ibl"], lights=port["lights"],
                    transforms=port["transforms"], palettes=port["palettes"],
                    ivp=ivp, cam=torch.as_tensor(cam), width=T.W,
                    height=T.H, max_layers=T.LAYERS,
                    shadow_layers=T.SHADOW_LAYERS), inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_shard_worker.py"),
         str(r), "2", str(tmp_path / "store"), inputs,
         str(tmp_path / f"img{r}.pt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    want = _port_sharded(port, 2)
    for r in range(2):
        img = torch.load(str(tmp_path / f"img{r}.pt")).numpy()
        assert img.dtype == want.dtype and np.array_equal(img, want), r


@pytest.fixture(scope="module")
def small_worlds(tmp_path_factory):
    """The DemoScene without its imported assets, from the synthetic
    rig's directory: (the reference's scene dict, the port's world)."""
    rig = R.write_rig(str(tmp_path_factory.mktemp("rig")), ASSETS)
    return (DemoScene(asset_dir=rig, include_imported_assets=False).build(),
            build_demo_scene(rig, device="cpu",
                             include_imported_assets=False))


def test_demo_scene_without_imported_assets_matches_reference(small_worlds):
    """17-Cheese, Semla and their hulls left out (the mirror is absent
    either way): the same triangles, entities and collision triangles,
    the same initial state, and one substep within 1e-4."""
    js, pw = small_worlds
    full = build_demo_scene(ASSETS, device="cpu")
    assert pw.geometry.tri.shape[0] == js["geometry"].tri.shape[0] == 20_240
    assert pw.geometry.tri.shape[0] < full.geometry.tri.shape[0]
    assert pw.spec.n_entities == js["spec"].n_entities == 13
    assert int(pw.collision.valid.sum()) == \
        int(np.asarray(js["collision"].valid).sum()) == 202
    assert pw.spec.names == js["spec"].names
    W.compare_states(js["state"], pw.state, atol=0, rtol=0)
    W.compare_states(js["stepper"].substep(js["state"], W.DT),
                     pw.stepper.substep(pw.state, W.DT), atol=1e-4)


def test_sharded_fused_step_matches_reference(small_worlds):
    """The fused sharded step on the small DemoScene world (one substep,
    the extraction, the flatten, the sharded render; 2 virtual shards)
    against the JAX one on the 8-device mesh: the state within 1e-4, the
    image at the traversal tolerance."""
    js, pw = small_worlds
    w, h = 64, 32
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 14.0], np.float32)
    cam.target = np.array([0.0, 0.0, 0.0], np.float32)
    ivp = cam.inv_view_proj(w, h)
    ibl = IBL.build()
    jstep = JSH.sharded_fused_step(JSH.make_mesh(jax.devices()[:8]), js, ibl,
                                   w, h, n_substeps=1, max_layers=1,
                                   shadow_layers=1)
    jst, jimg = jstep(js["state"], jnp.asarray(ivp),
                      jnp.asarray(cam.position), jnp.zeros(3))
    step = SH.sharded_fused_step(2, pw, interop.ibl(ibl, device="cpu"), w,
                                 h, device="cpu")
    pst, img = step(pw.state, torch.as_tensor(ivp), cam.position,
                    torch.zeros(3))
    W.compare_states(jst, pst, atol=1e-4)
    assert img.shape == (h, w, 3) and float(img.std()) > 1e-3
    T._agree(img.numpy(), np.asarray(jimg), 0.99, 5e-3)
    # a second call starts from the state it is given
    pst2, _ = step(pst, torch.as_tensor(ivp), cam.position, torch.zeros(3))
    W.compare_states(jstep(jst, jnp.asarray(ivp), jnp.asarray(cam.position),
                           jnp.zeros(3))[0], pst2, atol=1e-4)


def test_sharded_entry_points_need_a_device_without_cuda(port):
    """make_group, sharded_render and sharded_fused_step name the card by
    default; without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults use it")
    calls = [
        lambda: SH.make_group(0, 1, "file:///nonexistent/store"),
        lambda: SH.sharded_render(1, port["geo"], port["ibl"],
                                  port["lights"], T.W, T.H),
        lambda: SH.sharded_fused_step(1, None, port["ibl"], T.W, T.H),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
