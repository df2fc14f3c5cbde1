"""PyTorch port, the reference's last knob paths of render/rt.py as
``render_frame`` keywords vs the JAX reference (CPU): ``layer_slots``
(SGE_RT_LAYER_SLOTS), ``trans_subdiv`` (SGE_RASTER_TRANS_SUBDIV),
``unlit_split`` / ``unlit_dense`` (SGE_RT_UNLIT_SPLIT / _DENSE),
``packet_compact`` (SGE_RT_PACKET_COMPACT) and ``unlit_fast``
(SGE_RT_UNLIT).

The scene is tests/torch_knob_scene.py's (tests/test_torch_trace_frame.py's
with the capsule an unlit hull and a translucent pane in front of it) at
96x54, the port through its plain twins. The JAX frames run in this
process with the suite's configuration (SGE_JAX_TRAVERSAL=1, the hybrid
raster's K1 in Pallas interpret mode) and the knob set by monkeypatch of
the JAX module's global, which the frame reads when it is traced; the JAX
compile caches are cleared first, so that no frame traced with another
value is reused. The layered walk exists only on the JAX kernels, so
``layer_slots`` is held against the JAX kernel frame in a subprocess
(SGE_JAX_TRAVERSAL=0, SGE_RT_PRIMARY=trace, SGE_RT_LAYER_SLOTS=2, the
kernels in interpret mode, as tests/test_torch_trace_frame.py runs it).

Tolerances, port against JAX, without the refraction bounce (whose rays
start a bias inside the glass box and part the two traversals there):
the hybrid frames with tests/test_deferred.py's bounds (>= 99.5% of
pixels within 1e-4, max difference < 0.1, means within 1e-3 relative;
measured 99.92% within 1e-4, max 0.042, the default frames' own gap);
the traced kernel frame with tests/test_torch_trace_frame.py's (>= 99.9%
of pixels within 1e-4, means within 1e-4 relative). The
reference reports identical images for ``unlit_split``, ``unlit_dense``,
``packet_compact`` and ``trans_subdiv`` under its gate: the port's frame
with each is held to its default frame bit for bit, on the primaries
each reaches. At their defaults the keywords leave every primary's frame
the same whether named or not, and that frame meets the JAX frame of the
primary with the knobs unset, at the hybrid frames' bounds.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.render import compact as p_compact
from swift_game_engine_tpu_torch.render import rt as p_rt
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
from swift_game_engine_tpu_torch.scene.engine import Engine

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_trace_frame as T  # noqa: E402
import torch_knob_scene as K  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PRIMARIES = ("hybrid", "peels", "raster", "trace")
DEFAULTS = dict(layer_slots=0, trans_subdiv=0, unlit_fast=True,
                unlit_split=False, unlit_dense=False, packet_compact=False)


@pytest.fixture(scope="module")
def scene():
    return K.build_scene()


@pytest.fixture(scope="module")
def inputs(scene):
    return K.port_inputs(scene)


@pytest.fixture(scope="module")
def defaults(inputs):
    return {p: K.port_render(inputs, p) for p in PRIMARIES}


def _reference(scene, primary="hybrid", **knobs):
    """The JAX frame of ``primary`` without the refraction bounce, with
    module knobs set."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rt, "_RT_PRIMARY", primary)
        for k, v in knobs.items():
            mp.setattr(j_rt, k, v)
        out = K.reference_render(scene, refraction=False)
    jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def reference_default(scene):
    return _reference(scene)


def _bounds(out, ref):
    """tests/test_deferred.py's bounds."""
    assert out.shape == ref.shape and np.isfinite(out).all()
    diff = np.abs(out - ref)
    frac = float((diff.max(-1) < 1e-4).mean())
    print(f"{frac:.5f} of pixels within 1e-4, max {diff.max():.3e}")
    assert frac > 0.995, frac
    assert diff.max() < 0.1, diff.max()
    assert abs(out.mean() - ref.mean()) < 1e-3 * max(ref.mean(), 1e-3)


@pytest.mark.parametrize("primary", PRIMARIES)
def test_defaults_leave_the_frame_unchanged(scene, inputs, defaults,
                                            reference_default, primary):
    """Each primary's frame at the default keywords, named or not, is the
    same frame bit for bit, and without the refraction bounce meets the
    JAX frame of that primary with its knobs unset."""
    img = defaults[primary]
    assert np.array_equal(K.port_render(inputs, primary, **DEFAULTS), img)
    ref = reference_default if primary == "hybrid" else \
        _reference(scene, primary)
    _bounds(K.port_render(inputs, primary, refraction=False, **DEFAULTS),
            ref)


# The keyword, the JAX global it mirrors, and the primaries it reaches.
EXACT = [
    (dict(unlit_split=True), dict(_UNLIT_SPLIT=True),
     ("hybrid", "trace", "peels")),
    (dict(unlit_dense=True), dict(_UNLIT_DENSE=True),
     ("hybrid", "trace", "peels")),
    (dict(packet_compact=True), dict(_PACKET_COMPACT=True),
     ("hybrid", "trace", "raster")),
    (dict(trans_subdiv=1), dict(_TRANS_SUBDIV=1), ("hybrid",)),
]


@pytest.mark.parametrize("kw,knobs,primaries", EXACT,
                         ids=[next(iter(e[0])) for e in EXACT])
def test_exact_knob_frames(scene, inputs, defaults, reference_default, kw,
                           knobs, primaries):
    """The keyword's frame is the default frame bit for bit on every
    primary it reaches (the reference reports identical images), and the
    hybrid frame meets the JAX frame with the knob set, which equals the
    JAX default frame."""
    for primary in primaries:
        assert np.array_equal(K.port_render(inputs, primary, **kw),
                              defaults[primary]), primary
    ref = _reference(scene, **knobs)
    assert np.array_equal(ref, reference_default)
    _bounds(K.port_render(inputs, "hybrid", refraction=False, **kw), ref)


@pytest.mark.parametrize("mode", ["split", "dense"])
def test_unlit_records_leave_the_full_shade(inputs, monkeypatch, mode):
    """The hull's back faces behind its front faces are simple-unlit
    continuation records: with the split (its second pass) or the dense
    form (its table) the batched continuation shade takes fewer records
    than by default; without the unlit fast path as many."""
    taken = []
    shade = p_rt._shade_layer

    def spy(fr, o, d, t, tri, u, v, found, alpha_in, compacted=False):
        if compacted:
            taken.append(int(found.sum()))
        return shade(fr, o, d, t, tri, u, v, found, alpha_in, compacted)
    monkeypatch.setattr(p_rt, "_shade_layer", spy)
    counts = {}
    for name, kw in (("default", {}), ("knob", {f"unlit_{mode}": True}),
                     ("unlit off", dict(unlit_fast=False,
                                        **{f"unlit_{mode}": True}))):
        taken.clear()
        K.port_render(inputs, "hybrid", **kw)
        counts[name] = taken[0]
    print(counts)
    simple = p_rt.simple_unlit_tri(inputs[0], True, True)
    assert 0 < int(simple.sum()) < simple.numel()
    assert counts["knob"] < counts["default"] == counts["unlit off"]


def test_simple_unlit_tri_matches_reference(scene, inputs):
    from swift_game_engine_tpu.render.scene_geometry import texture_usage
    geo = scene[0]
    for mirror in (False, True):
        for refraction in (False, True):
            want = np.asarray(j_rt._simple_unlit_tri(
                geo, texture_usage(geo), mirror, refraction))
            got = p_rt.simple_unlit_tri(inputs[0], mirror, refraction)
            np.testing.assert_array_equal(got.numpy(), want)


def test_unlit_fast_off_matches_reference(scene, inputs, defaults):
    """``unlit_fast=False`` (SGE_RT_UNLIT=0): unlit hits take full PBR and
    cast shadow rays, as the reference's intersector does; the frame
    changes (the hull and the emissive box) and meets the JAX frame with
    the knob off."""
    out = K.port_render(inputs, "hybrid", refraction=False, unlit_fast=False)
    changed = np.abs(out - K.port_render(inputs, "hybrid",
                                         refraction=False)).max(-1) > 1e-3
    assert changed.sum() > 100, changed.sum()
    _bounds(out, _reference(scene, _UNLIT_FAST=False))


def test_trans_subdiv_gate_and_children(scene, inputs, monkeypatch):
    """The gate is the reference's ``_trans_subdiv_ok`` on both scenes;
    under it K1's translucent call takes 4**depth children a triangle
    (carrying its id), and with a textured translucent material the frame
    keeps the whole triangles."""
    textured = K.build_scene(textured=True)
    for s, want in ((scene, True), (textured, False)):
        assert j_rt._trans_subdiv_ok(s[0], np.asarray(
            s[0].tri_translucent)) == want
    assert inputs[0].trans_untextured
    tgeo = interop.scene_geometry(textured[0], device="cpu")
    assert not tgeo.trans_untextured
    seen = []
    raster = p_rt.rasterize_clusters

    def spy(v0, v1, v2, *a, ids=None, **k):
        seen.append((v0.shape[0], ids))
        return raster(v0, v1, v2, *a, ids=ids, **k)
    monkeypatch.setattr(p_rt, "rasterize_clusters", spy)
    n_t = int(inputs[0].translucent_idx.numel())
    for geo, depth, n in ((inputs[0], 2, 16 * n_t), (tgeo, 2, None)):
        seen.clear()
        fg = p_sg.flatten_frame(geo, torch.as_tensor(scene[1]),
                                torch.as_tensor(scene[2]))
        K.port_render((geo, fg) + inputs[2:], "hybrid", trans_subdiv=depth)
        trans = seen[1]
        if n is None:
            assert trans[0] == int(geo.translucent_idx.numel())
        else:
            assert trans[0] == n
            assert torch.equal(trans[1], inputs[0].translucent_idx.to(
                torch.float32).repeat_interleave(16))


def test_subdivide_matches_reference_midpoints():
    """One level: the children's corners are the reference's (rt.py:1235-
    1247), in its order."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 5, 3)).astype(np.float32)
    got = p_rt.subdivide(*(torch.as_tensor(x) for x in v),
                         torch.arange(5.0), 1)
    a, b, c = v
    m01, m12, m20 = (a + b) * 0.5, (b + c) * 0.5, (c + a) * 0.5
    want = (np.stack([a, m01, m20, m01], 1).reshape(-1, 3),
            np.stack([m01, b, m12, m12], 1).reshape(-1, 3),
            np.stack([m20, m12, c, m20], 1).reshape(-1, 3))
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[3].numpy(), np.repeat(np.arange(5.0),
                                                             4))


@pytest.mark.parametrize("seed,p,block,frac", [
    (0, 4096, 1024, 0.01), (1, 8192, 1024, 0.2), (2, 4096, 512, 0.0),
    (3, 4000, 1024, 0.1), (4, 1024, 1024, 0.5)])
def test_packets_match_reference(seed, p, block, frac, monkeypatch):
    """``compact.packets`` gives the slots of the reference's
    ``_chunked_packets`` with every packet in one chunk: the same lane in
    every slot, the same fill and validity (its lane fallback where the
    block does not divide the lanes or covers them)."""
    import jax.numpy as jnp
    from swift_game_engine_tpu.ops import rt_kernel as j_rk
    monkeypatch.setattr(j_rk, "BLOCK", block)
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=p) < frac
    chunks = []

    def body(idx, valid, carry):
        chunks.append((np.asarray(idx), np.asarray(valid)))
        return carry
    with jax.disable_jit():
        j_rt._chunked_packets(jnp.asarray(mask), body, jnp.int32(0),
                              cap_packets=p // block or 1)
    c = p_compact.packets(torch.as_tensor(mask), block)
    if not mask.any():
        assert not chunks and not bool(c.valid.any()) and int(c.count) == 0
        return
    assert len(chunks) == 1
    idx, valid = chunks[0]
    n = idx.shape[0]
    np.testing.assert_array_equal(c.valid.numpy()[:n], valid)
    np.testing.assert_array_equal(c.idx.numpy()[:n], idx)
    assert not bool(c.valid[n:].any())
    if p % block == 0 and p > block:
        assert int(c.count) == block * int(mask.reshape(-1, block).any(
            1).sum())


# The JAX kernel frame with knobs set at import; argv: the output path,
# then KEY=VALUE knobs.
KERNEL_FRAME = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["SGE_RT_BLOCK"] = "1024"
os.environ["SGE_JAX_TRAVERSAL"] = "0"
os.environ.update(a.split("=", 1) for a in sys.argv[2:])
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import numpy as np
import torch_knob_scene as K
np.save(sys.argv[1], K.reference_render(K.build_scene(), refraction=False))
"""


def test_layer_slots_matches_reference_kernels(inputs, defaults, tmp_path):
    """``layer_slots=2`` of 3 layers: the traced frame meets the JAX kernel
    frame with SGE_RT_LAYER_SLOTS=2 (tests/test_torch_trace_frame.py's
    tolerance without refraction) and parts from the full walk only where
    at least 3 translucent surfaces lie in front of the opaque hit (the
    pane's and the hull's, printed); 3 slots are the default's frame bit
    for bit. Other primaries have no layered walk: unchanged."""
    out_path = str(tmp_path / "slots.npy")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", KERNEL_FRAME, out_path,
         "SGE_RT_PRIMARY=trace", "SGE_RT_LAYER_SLOTS=2"],
        cwd=os.path.abspath(REPO), env=env, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = K.port_render(inputs, "trace", refraction=False, layer_slots=2)
    T._agree(out, np.load(out_path), 0.999, 1e-4)
    two = K.port_render(inputs, "trace", layer_slots=2)
    share = float((np.abs(two - defaults["trace"]).max(-1) > 0).mean())
    print(f"layer_slots=2: {share:.4f} of pixels differ from 3 slots")
    assert 0 < share < 0.1
    assert np.array_equal(K.port_render(inputs, "trace", layer_slots=3),
                          defaults["trace"])
    assert np.array_equal(K.port_render(inputs, "hybrid", layer_slots=2),
                          defaults["hybrid"])


def test_engine_takes_the_knobs(inputs, monkeypatch):
    """``Engine`` passes the keywords to every RT frame it renders (its
    frame program bakes them in) and refuses a value the frame does not
    take."""
    seen = []
    render = p_rt.render_frame

    def spy(*a, **k):
        seen.append({x: k[x] for x in DEFAULTS})
        return render(*a, **k)
    monkeypatch.setattr(p_rt, "render_frame", spy)
    scene = T.build_scene()
    world = T._port_world(scene, [0.0, 0.5, 1.0])
    kw = dict(layer_slots=2, trans_subdiv=1, unlit_fast=False,
              unlit_split=True, unlit_dense=True, packet_compact=True)
    eng = Engine(world, T.W, T.H, max_layers=T.LAYERS,
                 shadow_layers=T.SHADOW_LAYERS, device="cpu", **kw)
    img = eng.frame(1 / 60)
    assert seen == [kw]
    u8, _ = eng.program().eager()
    assert torch.equal(u8, img)
    Engine(world, T.W, T.H, device="cpu").frame(1 / 60)
    assert seen[-1] == DEFAULTS
    for bad in (dict(layer_slots=4), dict(layer_slots=-1),
                dict(trans_subdiv=-1)):
        with pytest.raises(ValueError):
            Engine(world, T.W, T.H, device="cpu", **bad)
    with pytest.raises(ValueError):
        render(*inputs[:4], torch.eye(4), np.zeros(3), 8, 8, layer_slots=5)
