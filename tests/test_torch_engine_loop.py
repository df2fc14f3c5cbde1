"""PyTorch port, the Engine's frame program vs the JAX reference's Engine
(CPU): the RenderGraph, ``update`` / ``render``, time scale, exposure,
``pipeline_depth``, ``load_state`` and the Engine's own state buffers.

The world is the tiny one of tests/torch_sim_worlds.py with render meshes
(``engine_scenes``): built by the reference and carried across with
``interop``. States are held as tests/test_torch_sim_step.py holds them
(floats within 1e-4, integer and bool fields equal, ties that f32 rounding
decides named by ``compare_states``); float views are quantised to u8 and
held as tests/test_torch_sim_engine.py holds frames (>= 97% of pixels
within one level: the reference traces visibility on the CPU, the port
rasterises it). Each Engine takes at most 8 frames or updates that
substep, at 64x36.
"""

import os
import sys

import numpy as np
import pytest
import torch

from swift_game_engine_tpu.render import graph as j_graph
from swift_game_engine_tpu.scene.engine import Engine as JEngine
from swift_game_engine_tpu.scene.input import InputFrame as JInput
from swift_game_engine_tpu_torch.ecs.world import clone_state, state_leaves
from swift_game_engine_tpu_torch.render import graph as p_graph
from swift_game_engine_tpu_torch.scene.engine import Engine
from swift_game_engine_tpu_torch.scene.input import InputFrame

sys.path.insert(0, os.path.dirname(__file__))
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

W_, H_ = 64, 36
LAYERS, SHADOW_LAYERS = 2, 1
KW = dict(path="rt", max_layers=LAYERS, shadow_layers=SHADOW_LAYERS)


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene dict, port DemoWorld). Engines leave both unchanged: the
    JAX state is immutable and each port Engine clones its world's state."""
    return W.engine_scenes()


def engines(scenes, **kw):
    jscene, world = scenes
    return (JEngine(jscene, W_, H_, **KW, **kw),
            Engine(world, W_, H_, **KW, device="cpu", **kw))


def same_state(jeng, peng, scenes):
    W.compare_states(jeng.state, peng.state,
                     lambda: W.soup_tris(jeng.state, scenes[0]["stepper"]))


def u8(view):
    return (np.clip(np.asarray(view, np.float32), 0.0, 1.0) * 255.0).astype(
        np.uint8)


def close_frames(out, ref):
    assert out.shape == ref.shape == (H_, W_, 3)
    close = np.abs(out.astype(int) - ref.astype(int)).max(-1) <= 1
    assert close.mean() >= 0.97, close.mean()


# -- RenderGraph -------------------------------------------------------------

def _graph_case(mod, case, log):
    """One pass set in ``mod``'s RenderGraph; each pass logs its name and
    writes the sum of what it reads plus its number."""
    RP = mod.RenderPass

    def p(name, reads=(), writes=(), target=None, external=False, k=0):
        def run(res):
            log.append(name)
            v = sum(float(res[r]) for r in reads) + k
            return {w: torch.tensor(v) for w in
                    tuple(writes) + ((target,) if target else ())}
        return RP(name, run, reads=reads, writes=writes, target=target,
                  external=external)

    g = mod.RenderGraph()
    if case == "prune_and_order":
        # declared out of order; "unused" and "dead" feed nothing
        g.add_pass(p("composite", ("lit", "ui"), target="view", k=1))
        g.add_pass(p("unused", ("gbuf",), ("junk",), k=2))
        g.add_pass(p("light", ("gbuf", "shadow"), ("lit",), k=3))
        g.add_pass(p("gbuffer", ("scene",), ("gbuf",), k=4))
        g.add_pass(p("dead", ("junk",), ("junk2",), k=5))
        g.add_pass(p("shadow", ("scene",), ("shadow",), k=6))
        g.add_pass(p("ui", (), ("ui",), k=7))
        g.add_pass(p("capture", ("lit",), ("capture",), external=True, k=8))
    elif case == "cycle":
        g.add_pass(p("a", ("y",), ("x",)))
        g.add_pass(p("b", ("x",), ("y",)))
        g.add_pass(p("c", ("x",), target="view"))
    elif case == "missing_writer":
        g.add_pass(p("c", ("scene", "nobody"), target="view"))
    elif case == "temporaries":
        g.add_temporary("scratch", lambda: torch.tensor(10.0))
        g.add_pass(p("a", ("scene", "scratch"), ("x",), k=1))
        g.add_pass(p("c", ("x", "scratch"), target="view", k=2))
    return g


@pytest.mark.parametrize("case", ["prune_and_order", "cycle",
                                  "missing_writer", "temporaries"])
def test_render_graph_matches_reference(case):
    out = {}
    for name, mod in (("jax", j_graph), ("port", p_graph)):
        log = []
        g = _graph_case(mod, case, log)
        try:
            res = g.execute({"scene": torch.tensor(1.0)})
            out[name] = (log, {k: float(v) for k, v in res.items()}, None)
        except RuntimeError as err:
            out[name] = (log, None, str(err))
    assert out["port"] == out["jax"]
    log, res, err = out["port"]
    if case == "prune_and_order":
        assert "unused" not in log and "dead" not in log
        assert log.index("gbuffer") < log.index("light") < \
            log.index("composite")
        assert "capture" in log and res["view"] == (5 + 7 + 3) + 7 + 1
    elif case == "temporaries":
        assert res["view"] == (1 + 10 + 1) + 10 + 2
    else:
        assert err is not None and res is None


# -- update / render ---------------------------------------------------------

def test_update_render_match_reference(scenes):
    jeng, peng = engines(scenes)
    for i in range(3):
        pad = dict(ly=1.0, rx=0.5 if i else 0.0, jump=i == 1)
        ja = jeng.update(1 / 60, JInput(**pad))
        pa = peng.update(1 / 60, InputFrame(**pad))
        assert pa == pytest.approx(ja, abs=1e-6) and peng.substeps == 1
        same_state(jeng, peng, scenes)
        np.testing.assert_allclose(peng.camera.position,
                                   jeng.camera.position, atol=1e-4)
        view = peng.render(pa)
        assert view.dtype == torch.float32
        close_frames(u8(view.numpy()), u8(jeng.render(ja)))


# -- time scale and exposure (tests/test_time_scale.py on this world) -------

def test_time_scale_freezes_substeps_camera_animates(scenes):
    jeng, peng = engines(scenes)
    pos0 = peng.state.wp_local.clone()
    for eng in (jeng, peng):
        eng.time_scale = 0.0
    for _ in range(5):
        jeng.update(1 / 30, JInput(lx=1.0, ly=1.0, rx=1.0))
        peng.update(1 / 30, InputFrame(lx=1.0, ly=1.0, rx=1.0))
        assert peng.substeps == 0
    assert peng.time == 0.0 and peng.accumulator == 0.0
    assert peng.delta_time == 0.0
    assert peng.unscaled_time == pytest.approx(5 / 30, abs=1e-6)
    assert peng.unscaled_delta_time == pytest.approx(1 / 30, abs=1e-6)
    assert torch.equal(peng.state.wp_local, pos0)   # nothing moved
    assert abs(peng.input.yaw) > 0.1                # the camera turned
    assert peng.input.yaw == pytest.approx(jeng.input.yaw)
    for f in ("time", "unscaled_time", "accumulator"):
        assert getattr(peng, f) == pytest.approx(getattr(jeng, f), abs=1e-9)
    same_state(jeng, peng, scenes)


def test_time_scale_half_speed(scenes):
    jeng, peng = engines(scenes)
    for eng in (jeng, peng):
        eng.time_scale = 0.5
    steps = 0
    for _ in range(4):
        jeng.update(1 / 60, JInput())
        peng.update(1 / 60, InputFrame())
        steps += peng.substeps
    assert steps == 2                                # half the substeps
    assert peng.time == pytest.approx(0.5 * 4 / 60, abs=1e-6)
    assert peng.unscaled_time == pytest.approx(4 / 60, abs=1e-6)
    assert peng.accumulator == pytest.approx(jeng.accumulator, abs=1e-9)
    same_state(jeng, peng, scenes)


def test_exposure_input_integrates_and_clamps(scenes):
    """DemoScene.swift:700-703: exposure += exposureDelta * dt in [0.1, 2],
    on unscaled dt even when the simulation is frozen."""
    jeng, peng = engines(scenes)
    seq = [(1.0, 0.1, 1.0, 1.1), (0.0, 0.1, -1.0, 1.0)] + \
        [(0.0, 0.1, 1.0, None)] * 12 + [(0.0, 0.1, -1.0, None)] * 22
    for scale, dt, delta, want in seq:
        for eng in (jeng, peng):
            eng.time_scale = scale
        jeng.update(dt, JInput(exposure_delta=delta))
        peng.update(dt, InputFrame(exposure_delta=delta))
        assert peng.tone_mapping_exposure == pytest.approx(
            jeng.tone_mapping_exposure, abs=1e-9)
        if want is not None:
            assert peng.tone_mapping_exposure == pytest.approx(want,
                                                               abs=1e-6)
        if delta > 0 and want is None:
            top = peng.tone_mapping_exposure
    assert top == pytest.approx(2.0, abs=1e-6)
    assert peng.tone_mapping_exposure == pytest.approx(0.1, abs=1e-6)
    same_state(jeng, peng, scenes)


# -- pipeline_depth ----------------------------------------------------------

def test_pipeline_depth_shifts_render_only_frames(scenes):
    """A render-only world: depth 3 returns depth 1's frame k at call k+2,
    bit for bit, after two zero frames; a new RT scale drops the frames in
    flight."""
    world = scenes[1]._replace(spec=None, state=None, stepper=None,
                               player=None)
    frames = {}
    for depth in (1, 3):
        eng = Engine(world, W_, H_, **KW, pipeline_depth=depth, device="cpu")
        frames[depth] = [eng.frame(1 / 60, InputFrame(rx=0.8)).clone()
                         for _ in range(6)]
        assert all(f.dtype == torch.uint8 and f.shape == (H_, W_, 3)
                   for f in frames[depth])
    assert int(frames[3][0].max()) == 0 == int(frames[3][1].max())
    for k in range(4):
        assert torch.equal(frames[3][k + 2], frames[1][k]), k
    assert not torch.equal(frames[1][0], frames[1][3])
    assert len(eng._pending) == 2
    eng.set_rt_resolution_scale(0.5)
    assert eng._pending == [] and eng._snap is None
    assert int(eng.frame(1 / 60).max()) == 0


def test_pipeline_depth_matches_reference(scenes):
    jeng, peng = engines(scenes, pipeline_depth=3)
    for i in range(6):
        ref = np.asarray(jeng.frame(1 / 60, JInput(ly=1.0)))
        out = peng.frame(1 / 60, InputFrame(ly=1.0)).numpy()
        if i < 2:
            assert out.max() == 0 == ref.max()
            continue
        close_frames(out, ref)
        np.testing.assert_allclose(peng._snap, np.asarray(jeng._snap),
                                   atol=1e-4)
    same_state(jeng, peng, scenes)


# -- the Engine's state buffers ----------------------------------------------

def test_load_state_restores_into_buffers(scenes, tmp_path):
    world = scenes[1]
    eng = Engine(world, W_, H_, **KW, device="cpu")
    buffers = [x.data_ptr() for x in state_leaves(eng.state)]
    for _ in range(2):
        eng.update(1 / 60, InputFrame(ly=1.0))
    eng.save_state(str(tmp_path / "w.npz"))
    saved = clone_state(eng.state)
    acc, t = eng.accumulator, eng.time
    for _ in range(2):
        eng.frame(1 / 60, InputFrame(lx=1.0, jump=True))
    assert not torch.equal(eng.state.body_pos, saved.body_pos)
    eng.load_state(str(tmp_path / "w.npz"))
    assert [x.data_ptr() for x in state_leaves(eng.state)] == buffers
    for a, b in zip(state_leaves(eng.state), state_leaves(saved)):
        assert torch.equal(a, b)
    assert (eng.accumulator, eng.time) == (acc, t)
    assert eng._pending == [] and eng._snap is None


def test_engines_on_one_world_do_not_share_state(scenes):
    world = scenes[1]
    start = clone_state(world.state)
    a = Engine(world, W_, H_, **KW, device="cpu")
    b = Engine(world, W_, H_, **KW, device="cpu")
    for _ in range(3):
        a.update(1 / 60, InputFrame(ly=1.0))
    for x, y, z in zip(state_leaves(world.state), state_leaves(b.state),
                       state_leaves(start)):
        assert torch.equal(x, z) and torch.equal(y, z)
    p = world.player
    assert not torch.equal(a.state.body_pos[p], start.body_pos[p])
    assert all(x.data_ptr() != y.data_ptr() for x, y in
               zip(state_leaves(a.state), state_leaves(b.state))
               if x.numel())
