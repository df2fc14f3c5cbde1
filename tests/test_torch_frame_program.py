"""PyTorch port, the frame program without a host read (CPU): the
fixed-capacity compaction, the overlay on the device, the walk kernels'
per-frame values from device tensors, and the Engine's frames, each held
against the JAX package.

  * ``render/compact.py`` against the reference's ``_chunked``
    (swift_game_engine_tpu/render/rt.py:329-352) with a gather -> scale ->
    scatter body, on seeded masks with 0, 1, 37% and all lanes set, at a
    capacity of all the lanes and of a quarter (four chunks, the
    reference's loop drained by a fixed count): equal outputs;
  * ``overlay_blit_device`` with ``fps`` a device tensor and an int against
    the JAX ``overlay_blit_device`` on a seeded u8 image: bit-equal;
  * the K5, K6 and K7 twins given their origin or direction as a tensor
    equal the same twin given host floats; K4's and K6's twins given a
    lane count equal the full call on the lanes below it and keep the miss
    record past it;
  * CPU Engine frames against the JAX ``Engine(pipeline_depth=1)`` on the
    world of ``test_torch_engine_loop.py`` (``engine_scenes``): the camera
    turns between frames, the RT scale changes once, the overlay is on;
    frames as that file holds them (>= 97% of pixels within one u8 level:
    the reference traces visibility on the CPU, the port rasterises it),
    snapshots within 1e-4 and states by ``compare_states``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu.render.composite import \
    overlay_blit_device as j_overlay
from swift_game_engine_tpu.scene.engine import Engine as JEngine
from swift_game_engine_tpu.scene.input import InputFrame as JInput
from swift_game_engine_tpu_torch.ops import rt_kernel as RK
from swift_game_engine_tpu_torch.render.compact import (chunks, compact,
                                                        gather, scatter)
from swift_game_engine_tpu_torch.render.composite import overlay_blit_device
from swift_game_engine_tpu_torch.render.scene_geometry import flatten_frame
from swift_game_engine_tpu_torch.scene.engine import Engine
from swift_game_engine_tpu_torch.scene.input import InputFrame

sys.path.insert(0, os.path.dirname(__file__))
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

P = 1000


# -- the compaction helper ----------------------------------------------------

def _mask(kind):
    rng = np.random.default_rng(7)
    m = np.zeros(P, bool)
    if kind == "one":
        m[613] = True
    elif kind == "37pct":
        m[rng.permutation(P)[:370]] = True
    elif kind == "all":
        m[:] = True
    return m


@pytest.mark.parametrize("cap", [P, P // 4], ids=["cap_all", "cap_quarter"])
@pytest.mark.parametrize("kind", ["none", "one", "37pct", "all"])
def test_compaction_matches_reference_chunked(kind, cap):
    m = _mask(kind)
    x = np.random.default_rng(3).normal(size=(P, 3)).astype(np.float32)

    def j_body(idx, valid, carry):
        g = carry[jnp.minimum(idx, P - 1)] * 3.0
        return carry.at[idx].set(g)          # fill slots (idx = P) drop

    ref = np.asarray(j_rt._chunked(jnp.asarray(m), j_body, jnp.asarray(x),
                                   cap=cap))
    out = torch.as_tensor(x)
    parts = chunks(torch.as_tensor(m), cap)
    assert len(parts) == -(-P // cap)       # the fixed trip count
    for c in parts:
        assert c.idx.shape == (cap,) and c.count.dtype == torch.int32
        out = scatter(out, c, gather(out, c) * 3.0)
    np.testing.assert_array_equal(out.numpy(), ref)
    # one chunk of the lane universe: the set lanes ascending, filled
    # with P, the count on the device, as jnp.nonzero(size=P, fill=P)
    c = compact(torch.as_tensor(m))
    want = np.asarray(jnp.nonzero(jnp.asarray(m), size=P, fill_value=P)[0])
    np.testing.assert_array_equal(c.idx.numpy(), want)
    assert torch.equal(c.valid, c.idx < P) and int(c.count) == m.sum()


# -- the overlay on the device ------------------------------------------------

@pytest.mark.parametrize("fps", [-1, 0, 7, 42, 999, 1234])
def test_overlay_matches_reference(fps):
    img = np.random.default_rng(5).integers(0, 256, (72, 160, 3),
                                            dtype=np.uint8)
    ref = np.asarray(j_overlay(img, np.int32(fps)))
    for value in (torch.tensor(float(fps)), fps):
        out = overlay_blit_device(torch.as_tensor(img), value).numpy()
        np.testing.assert_array_equal(out, ref)
    assert (ref != img).any() == (fps >= 0)


# -- the walks' per-frame values from device tensors --------------------------

@pytest.fixture(scope="module")
def walk_bvh():
    """The refit tree of the tiny world's render geometry (its topology's
    leaf index rides along)."""
    world = W.port_engine_world(torch.device("cpu"))
    fg = flatten_frame(world.geometry, world.transforms, world.palettes)
    assert RK.walk_available(fg.bvh.rows) and fg.bvh.wide.leaves is not None
    return fg.bvh


def _rays(bvh, n=300, seed=4):
    rng = np.random.default_rng(seed)
    lo = bvh.bmin[0].numpy()
    hi = bvh.bmax[0].numpy()
    o = np.float32(lo + (hi - lo) * [0.5, 0.9, 0.1]) + np.float32([0, 2, -3])
    tgt = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(o), torch.as_tensor(d)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("walk", ["K5", "K6", "K7", "K4_count", "K6_count"])
def test_walk_twins_take_device_values(walk_bvh, walk):
    bvh = walk_bvh
    o, d = _rays(bvh)
    n = d.shape[0]
    t_max = torch.full((n,), RK.BIG)
    t_max[::11] = 0.0
    srows = RK.build_origin_rows(bvh.rows, o, bvh.wide.leaves)
    # the topology's leaf index gives the rows the rows' own leaves give
    assert torch.equal(srows, RK.build_origin_rows(bvh.rows, o))
    if walk == "K5":
        dev = RK.trace_layers_so(bvh.wide, srows, o, d, t_max, 3)
        host = RK.trace_layers_so(bvh.wide, srows, o.tolist(), d, t_max, 3)
        assert int((dev[1] >= 0).sum()) > n // 4
        _equal(dev, host)
    elif walk == "K6":
        fl = torch.full((n,), 0.5)
        dev = RK.trace_rays_so(bvh.wide, srows, o, d, t_max, fl)
        host = RK.trace_rays_so(bvh.wide, srows, o.tolist(), d, t_max, fl)
        assert int((dev[1] >= 0).sum()) > n // 4
        _equal(dev, host)
    elif walk == "K7":
        l = torch.tensor([0.3, 0.8, -0.2])
        l = l / torch.linalg.vector_norm(l)
        shrows = RK.build_shadow_rows(bvh.rows, l, bvh.wide.leaves)
        assert torch.equal(shrows, RK.build_shadow_rows(bvh.rows, l))
        pts = o + d * 3.0
        dev = RK.trace_shadow_factor(bvh.wide, shrows, l, pts, t_max, 4)
        host = RK.trace_shadow_factor(bvh.wide, shrows, l.tolist(), pts,
                                      t_max, 4)
        _equal(dev, host)
    else:
        count = torch.tensor(n // 3, dtype=torch.int32)
        if walk == "K4_count":
            oo = o.expand(n, 3).contiguous()
            full = RK.trace_rays(bvh.wide, bvh.rows, oo, d, t_max)
            cut = RK.trace_rays(bvh.wide, bvh.rows, oo, d, t_max, count)
        else:
            full = RK.trace_rays_so(bvh.wide, srows, o, d, t_max)
            cut = RK.trace_rays_so(bvh.wide, srows, o, d, t_max, count=count)
        k = n // 3
        assert int((full[1][:k] >= 0).sum()) > k // 10
        _equal([x[:k] for x in cut], [x[:k] for x in full])
        assert torch.equal(cut[0][k:], t_max[k:])        # the miss record
        assert bool((cut[1][k:] == -1).all())


# -- the Engine's frames against the JAX Engine -------------------------------

W_, H_ = 64, 36


def _u8(view):
    return np.asarray(view, np.uint8)


def _close_frames(out, ref):
    assert out.shape == ref.shape == (H_, W_, 3)
    close = np.abs(out.astype(int) - ref.astype(int)).max(-1) <= 1
    assert close.mean() >= 0.97, close.mean()


@pytest.mark.parametrize("path", ["rt"])
def test_engine_frames_match_reference(path):
    jscene, world = W.engine_scenes()
    kw = dict(path=path, max_layers=2, shadow_layers=1)
    jeng = JEngine(jscene, W_, H_, **kw)
    peng = Engine(world, W_, H_, **kw, device="cpu")
    for i in range(5):
        if i == 3:                               # a new RT size, once
            jeng.set_rt_resolution_scale(0.5)
            peng.set_rt_resolution_scale(0.5)
        pad = dict(ly=1.0, rx=0.6)               # the camera turns
        ref = _u8(jeng.frame(1 / 60, JInput(**pad)))
        out = peng.frame(1 / 60, InputFrame(**pad)).numpy()
        assert peng.substeps == 1 and peng.rt_size == jeng.rt_size
        _close_frames(out, ref)
        np.testing.assert_allclose(peng._snap, np.asarray(jeng._snap),
                                   atol=1e-4)
        np.testing.assert_allclose(peng.camera.position,
                                   jeng.camera.position, atol=1e-4)
    assert set(peng.programs) == {(W_, H_), (W_ // 2, H_ // 2)}
    W.compare_states(jeng.state, peng.state,
                     lambda: W.soup_tris(jeng.state, jscene["stepper"]))
