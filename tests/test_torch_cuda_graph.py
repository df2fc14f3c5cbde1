"""PyTorch port: the fixed substep (``SubstepGraph``) and the Engine's
frame program as CUDA graphs, on the card.

The machine with the card has no JAX, and tests/conftest.py imports it, so
this file imports no jax and runs there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda_graph.py -q

Here (no CUDA device) every test skips. A replay launches the kernels that
the eager substep launches, on the same inputs, and no op of the substep
uses atomics, so replays equal the eager ``Stepper.substep`` bit for bit:
on the tiny world of tests/torch_sim_worlds.py (built by the port alone),
on that world with its player posed (the synthetic rig of
tests/torch_pose_rig.py: the locomotion FSM, the action clock and the pose
stack in the graph, a dodge among the intents) and on chip_smoke.py's
256-agent crowd (the separation grid), over 30 substeps of changing player
intents; after ``load_state`` into the
captured buffers; and two Engines built on one world each step their own
buffers.

The frame program (extract, flatten, render, composite, u8, overlay,
snapshot) replays the kernels that its eager run launches, so each replay
equals the frame program run eagerly at the same inputs bit for bit: on
each path of the tiny world, with the camera turning (the extraction
rebases the geometry on the camera's world position, so the trees, the
origin and shadow rows and the rays change between replays), the
exposure and the fps digits changing; across two RT scales (one graph
each, the first reused); and at ``pipeline_depth=3``, where each call
returns the frame of two calls before, in order. The Engine renders in
camera-relative space, so its K5 and K6 origin is always 0: a graph of
K5, K6 (with a lane count) and K7 alone shows that each replay reads the
origin, the count and the light direction from device memory.
"""

import os

import numpy as np
import pytest
import torch

from swift_game_engine_tpu_torch.assets.materials import Material
from swift_game_engine_tpu_torch.assets.mesh_api import MeshDescriptor
from swift_game_engine_tpu_torch.ecs.world import clone_state, state_leaves
from swift_game_engine_tpu_torch.ops import rt_kernel as RK
from swift_game_engine_tpu_torch.render.scene_geometry import (
    RenderGeometryBuilder, flatten_frame)
from swift_game_engine_tpu_torch.scene.engine import (FIXED_DT, Engine,
                                                      apply_intent)
from swift_game_engine_tpu_torch.scene.input import InputFrame, InputSystem
from swift_game_engine_tpu_torch.scene.cuda_graph import capture
from swift_game_engine_tpu_torch.scene.step import SubstepGraph
import torch_sim_worlds as W

pytestmark = pytest.mark.cuda

STEPS = 30


@pytest.fixture
def cuda():
    """The card, or a skip: a CUDA graph exists only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured on the card")
    return torch.device("cuda")


def _pads():
    """Player input over the substeps: walking, turning, two jumps, a
    dodge."""
    return [InputFrame(ly=1.0, lx=0.6 if i >= 10 else 0.0, jump=i in (5, 20),
                       dodge=i == 14) for i in range(STEPS)]


def _bits(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def assert_bit_equal(a, b, what):
    for i, (x, y) in enumerate(zip(state_leaves(a), state_leaves(b))):
        assert x.shape == y.shape and x.dtype == y.dtype, (what, i)
        gap = (x.double() - y.double()).abs().max()
        assert torch.equal(_bits(x), _bits(y)), \
            f"{what}: leaf {i} differs by {gap}"


def _world(name, dev, tmp_path):
    """-> (Stepper, state, player) of a test world on ``dev``."""
    if name == "tiny":
        _, state, stepper, h = W.port_world(W.tiny, dev)
        return stepper, state, h["player"]
    if name == "posed_tiny":
        import torch_pose_rig
        rig = torch_pose_rig.write_rig(str(tmp_path / "rig"), os.path.join(
            os.path.dirname(__file__), "..", "assets"))
        _, state, stepper, h = W.posed_port_world(rig, dev)
        return stepper, state, h["player"]
    from swift_game_engine_tpu_torch.examples import bench_crowd
    stepper, state = bench_crowd.build(256, device=dev)
    return stepper, state, stepper.player_idx


@pytest.mark.parametrize("name", ["tiny", "posed_tiny", "crowd_256"])
def test_replays_equal_eager_substeps(cuda, name, tmp_path):
    stepper, state, player = _world(name, cuda, tmp_path)
    g = SubstepGraph(stepper, state, FIXED_DT)
    assert g.graph is not None and g.capture_seconds > 0
    assert_bit_equal(g.state, state, "capture left the state")
    eager = clone_state(state)
    inp = InputSystem()
    for i, pad in enumerate(_pads()):
        intent = inp.update(pad, FIXED_DT, False, 4.5, 12.5, 0.78)
        apply_intent(g.state, player, intent)
        apply_intent(eager, player, intent)
        eager = stepper.substep(eager, FIXED_DT)
        g.step()
        assert_bit_equal(g.state, eager, f"{name} substep {i}")
    moved = (g.state.body_pos - state.body_pos).abs().amax(1)
    assert float(moved[player]) > 0.1
    assert bool(torch.isfinite(g.state.body_pos).all())
    if name == "posed_tiny":     # the pose stack ran in the graph
        assert bool(torch.isfinite(g.state.palettes).all())
        assert not torch.equal(g.state.palettes, state.palettes)
        assert float(g.state.action.weight[player]) > 0


def test_load_state_after_capture(cuda, tmp_path):
    world = W.port_engine_world(cuda)
    eng = Engine(world, 64, 36, device=cuda)
    for _ in range(3):
        eng.update(FIXED_DT, InputFrame(ly=1.0))
    eng.save_state(str(tmp_path / "w.npz"))
    saved = clone_state(eng.state)
    buffers = [x.data_ptr() for x in state_leaves(eng.state)]
    for _ in range(5):
        eng.update(FIXED_DT, InputFrame(lx=1.0))
    eng.load_state(str(tmp_path / "w.npz"))
    assert [x.data_ptr() for x in state_leaves(eng.state)] == buffers
    assert_bit_equal(eng.state, saved, "load_state")
    eager = clone_state(saved)
    for i in range(5):
        eng.update(FIXED_DT, InputFrame(ly=1.0))
        apply_intent(eager, eng.player, eng.intent)
        eager = eng.stepper.substep(eager, FIXED_DT)
        assert eng.substeps == 1
        assert_bit_equal(eng.state, eager, f"after load_state, substep {i}")


def test_two_engines_on_one_world_step_independently(cuda):
    world = W.port_engine_world(cuda)
    start = clone_state(world.state)
    a = Engine(world, 64, 36, device=cuda)
    b = Engine(world, 64, 36, device=cuda)
    for _ in range(6):
        a.update(FIXED_DT, InputFrame(ly=1.0))
    assert_bit_equal(world.state, start, "the world's own state")
    assert_bit_equal(b.state, start, "the idle Engine's state")
    p = world.player
    assert float((a.state.body_pos[p] - start.body_pos[p]).abs().max()) > 0.1
    for _ in range(6):
        b.update(FIXED_DT, InputFrame(lx=1.0))
    assert not torch.equal(a.state.body_pos, b.state.body_pos)
    assert np.isfinite(b.state.body_pos.cpu().numpy()).all()


# -- the frame program --------------------------------------------------------

FRAME_W, FRAME_H = 160, 90
PATH_KW = {
    "rt_hybrid": dict(path="rt"),
    "trace": dict(path="rt", primary="trace"),
    "trace_so_prepass": dict(path="rt", primary="trace", layered=False,
                             shadow_layers=5, shadow_prepass=True),
    "raster_pbr": dict(path="raster_pbr"),
    "raster_lists": dict(path="raster", raster_mode="lists"),
    "rt_deferred": dict(path="rt", deferred=True),
    "rt_lbatch_0": dict(path="rt", lbatch=0),
    "raster_trace": dict(path="raster", raster_vis="trace"),
}


def _frame_pads(n):
    """The camera turns, the exposure moves, dt (so the fps digits)
    changes."""
    return [(1 / (30 + 40 * (i % 3)),
             InputFrame(ly=1.0, rx=0.8 - 0.3 * i,
                        exposure_delta=(1.0, -1.0)[i % 2]))
            for i in range(n)]


def _replays_equal_eager(eng, frames):
    for i, (dt, pad) in enumerate(_frame_pads(frames)):
        img = eng.frame(dt, pad)
        u8_e, snap_e = eng.program().eager()
        u8_g, snap_g = eng.program().out
        assert torch.equal(img, u8_g) and torch.equal(u8_g, u8_e), i
        assert torch.equal(_bits(snap_g), _bits(snap_e)), i
    return img


@pytest.mark.parametrize("path", list(PATH_KW))
def test_frame_replays_equal_eager_frames(cuda, path):
    world = W.port_engine_world(cuda)
    eng = Engine(world, FRAME_W, FRAME_H, max_layers=3, device=cuda,
                 **PATH_KW[path])
    seen = []
    for _ in range(2):
        _replays_equal_eager(eng, 3)
        seen.append(eng.frame_inputs()["cam_world"].clone())
    assert eng.program().captured is not None and len(eng.programs) == 1
    assert not torch.equal(seen[0], seen[1])          # the camera moved
    assert float(eng.frame_inputs()["fps"]) > 0


@pytest.mark.parametrize("shadows", ["walk", "clusters"])
def test_deferred_frame_graph(cuda, monkeypatch, shadows):
    """The deferred shade (render/deferred.py: one merged K4 call where a
    material starts a bounce, one sorted sweep) in the frame graph:
    replays equal the eager card frames
    bit for bit, and a whole frame under
    ``torch.cuda.set_sync_debug_mode("error")`` reads nothing back; with
    the lane threshold at 0 its one sweep is the sorted K2/K3 pair."""
    from swift_game_engine_tpu_torch.ops import cluster_shadow as CS
    from swift_game_engine_tpu_torch.render import rt as RT
    if shadows == "clusters":
        monkeypatch.setattr(RT, "SHADOW_CLUSTER_MIN_LANES", 0)
    world = W.port_engine_world(cuda)
    eng = Engine(world, FRAME_W, FRAME_H, max_layers=3, deferred=True,
                 device=cuda)
    _replays_equal_eager(eng, 3)
    before = (CS.occl_launches, CS.slots_launches, RK.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = eng.frame(1 / 60, InputFrame(ly=1.0, rx=0.3))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert float(img.float().std()) > 1.0
    k2, k3, k4 = (a - b for a, b in zip(
        (CS.occl_launches, CS.slots_launches, RK.launches), before))
    # the tiny world's materials start no bounce (pruned: no K4 call) and
    # it has no translucent triangle (no K3 sweep)
    assert k4 == int(any(world.geometry.bounces)), k4
    trans = int(world.geometry.translucent_idx.numel() > 0)
    assert (k2, k3) == ((1, trans) if shadows == "clusters" else (0, 0))


def test_frame_graph_two_scales(cuda):
    world = W.port_engine_world(cuda)
    eng = Engine(world, FRAME_W, FRAME_H, primary="trace", device=cuda)
    _replays_equal_eager(eng, 2)
    first = eng.program()
    eng.set_rt_resolution_scale(0.5)
    img = _replays_equal_eager(eng, 2)
    assert img.shape == (FRAME_H, FRAME_W, 3)
    assert eng.rt_size == (FRAME_W // 2, FRAME_H // 2)
    eng.set_rt_resolution_scale(1.0)
    _replays_equal_eager(eng, 2)
    assert eng.program() is first and len(eng.programs) == 2


def test_frame_graph_pipeline_depth_3_in_order(cuda):
    """Each call returns the frame submitted two calls before: the eager
    card frame of that call's inputs, bit for bit; the first two are
    zero."""
    world = W.port_engine_world(cuda)
    eng = Engine(world, FRAME_W, FRAME_H, pipeline_depth=3, device=cuda)
    eager = []
    for i, (dt, pad) in enumerate(_frame_pads(7)):
        img = eng.frame(dt, pad)
        eager.append(eng.program().eager()[0])
        if i < 2:
            assert int(img.max()) == 0
        else:
            assert torch.equal(img, eager[i - 2]), i
    assert not torch.equal(eager[2], eager[5])


def test_walks_read_their_values_at_replay(cuda):
    """K5, K6 (with a lane count) and K7, and the origin and shadow rows,
    captured in one graph over a 4,000-triangle soup (a fifth translucent):
    after the origin, the light direction and the count change in device
    memory, each replay equals the eager calls at the new values bit for
    bit, and the records changed with them."""
    rng = np.random.default_rng(9)
    base = rng.uniform(-14, 14, (4000, 3)).astype(np.float32)
    pos = np.stack([base] + [base + rng.uniform(-2, 2, (4000, 3)).astype(
        np.float32) for _ in range(2)], 1).reshape(-1, 3)
    cut = 3 * 3200
    b = RenderGeometryBuilder(texture_size=4)
    for mat, p in ((Material(name="opaque"), pos[:cut]),
                   (Material(name="glass", alpha=0.4), pos[cut:])):
        b.add_static_mesh(MeshDescriptor(
            positions=p, indices=np.arange(len(p), dtype=np.int32)), mat,
            instance=0)
    bvh = flatten_frame(b.build(cuda), torch.eye(4, device=cuda)[None],
                        torch.zeros((1, 1, 4, 4), device=cuda)).bvh
    n = 20000
    d = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                        device=cuda)
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).contiguous()
    pts = torch.as_tensor(rng.uniform(-16, 16, (n, 3)).astype(np.float32),
                          device=cuda)
    t_max = torch.full((n,), RK.BIG, device=cuda)
    t_lim = torch.full((n,), 60.0, device=cuda)
    origin = torch.zeros(3, device=cuda)
    light = torch.zeros(3, device=cuda)
    count = torch.zeros((), dtype=torch.int32, device=cuda)

    def calls():
        srows = RK.build_origin_rows(bvh.rows, origin, bvh.wide.leaves)
        l = light / torch.linalg.vector_norm(light)
        shrows = RK.build_shadow_rows(bvh.rows, l, bvh.wide.leaves)
        return (*RK.trace_layers_so(bvh.wide, srows, origin, d, t_max, 3),
                *RK.trace_rays_so(bvh.wide, srows, origin, d, t_max,
                                  count=count),
                *RK.trace_shadow_factor(bvh.wide, shrows, l, pts, t_lim, 4))

    def set_values(i):
        origin.copy_(torch.tensor([3.0 * i - 4.0, 2.0 * i, 30.0 - 5.0 * i]))
        light.copy_(torch.tensor([0.3 - 0.2 * i, 0.8, 0.1 * i - 0.2]))
        count.fill_(n - 4000 * i)

    set_values(0)
    cap, out = capture(calls, calls, 2)
    before = [x.clone() for x in out]
    for i in range(1, 4):
        set_values(i)
        cap.replay()
        eager = calls()
        for a, e in zip(out, eager):
            assert torch.equal(_bits(a), _bits(e)), i
    assert not torch.equal(out[0], before[0])          # K5 moved
    assert not torch.equal(out[4], before[4])          # K6 moved
    assert not torch.equal(out[6], before[6])          # K7 turned
    assert bool((out[5][n - 4000 * 3:] == -1).all())   # K6 past the count
