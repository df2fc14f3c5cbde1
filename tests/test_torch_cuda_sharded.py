"""PyTorch port: the multi-device path's programs (parallel/sharding.py) as
CUDA graphs, on the card.

The machine with the card has no JAX, and tests/conftest.py imports it, so
this file imports no jax and runs there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda_sharded.py -q

Here (no CUDA device) every test skips. Each program's replays are held
bit for bit to its body run eagerly on the card at the same inputs, over
several steps with the camera and the player's intents changing:

  * ``sharded_render`` on 1, 3 and 4 virtual shards of the tiny world
    (tests/torch_sim_worlds.py), its transforms from a substep graph
    stepping the world, the camera given as host values and as device
    tensors in turn;
  * ``EntityShardedSubstep`` on 3 and 4 virtual shards of the 256-agent
    crowd (``examples/bench_crowd.build``: separation's grid branch): its
    replays against its eager substeps, and its state against the
    replicated ``SubstepGraph``'s;
  * ``sharded_fused_step`` on a one-rank NCCL group (a ``file://`` store
    in ``tmp_path``), on the replicated and on the entity-sharded state:
    every step's replays (the substep graphs and the frame graph, with
    NCCL's all-gathers inside) against ``eager``, which runs the same step
    with every substep and the frame eager;
  * the same on a 2-rank NCCL group, this file run as one process a card
    (``python tests/test_torch_cuda_sharded.py RANK WORLD STORE OUT``);
    skipped where the machine has fewer than two cards.
"""

import gc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from swift_game_engine_tpu_torch.ecs.world import state_leaves
from swift_game_engine_tpu_torch.examples import bench_crowd
from swift_game_engine_tpu_torch.parallel import sharding as SH
from swift_game_engine_tpu_torch.render.camera import Camera
from swift_game_engine_tpu_torch.render.ibl import IBL
from swift_game_engine_tpu_torch.scene.engine import FIXED_DT, apply_intent
from swift_game_engine_tpu_torch.scene.input import InputFrame, InputSystem
from swift_game_engine_tpu_torch.scene.step import SubstepGraph

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sim_worlds as W  # noqa: E402

pytestmark = pytest.mark.cuda

FRAME_W, FRAME_H, STEPS = 160, 90, 5


@pytest.fixture
def cuda():
    """The card, or a skip: a CUDA graph exists only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured on the card")
    return torch.device("cuda")


def _bits(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b, what):
    """Two tensors, or two states leaf by leaf, equal bit for bit."""
    xs = state_leaves(a) if not isinstance(a, torch.Tensor) else [a]
    ys = state_leaves(b) if not isinstance(b, torch.Tensor) else [b]
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert x.shape == y.shape and x.dtype == y.dtype, (what, i)
        gap = (x.double() - y.double()).abs().max()
        assert torch.equal(_bits(x), _bits(y)), \
            f"{what}: leaf {i} differs by {gap}"


def _camera(i):
    """The camera of step ``i``: it circles the world and looks at it."""
    cam = Camera()
    a = 0.7 * i
    cam.position = np.array([8.0 * np.sin(a), 3.0 + 0.5 * i,
                             8.0 * np.cos(a)], np.float32)
    cam.target = np.array([0.0, 0.5, 0.0], np.float32)
    return cam


def _intents(n):
    """The player's MoveIntent a step: walking, turning, a jump, a dodge."""
    inp = InputSystem()
    return [inp.update(InputFrame(ly=1.0, lx=0.6 if i >= 2 else -0.3,
                                  jump=i == 1, dodge=i == 3),
                       FIXED_DT, False, 4.5, 12.5, 0.78) for i in range(n)]


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_sharded_render_replays_equal_eager(cuda, shards):
    world = W.port_engine_world(cuda)
    render = SH.sharded_render(shards, world.geometry, IBL.build(cuda),
                               world.lights, FRAME_W, FRAME_H, 3, 2,
                               device=cuda)
    sim = SubstepGraph(world.stepper, world.state, FIXED_DT)
    origin = torch.zeros(3, device=cuda)
    images = []
    for i, intent in enumerate(_intents(STEPS)):
        apply_intent(sim.state, world.player, intent)
        sim.step()
        tf, pal = world.stepper._extract(sim.state, 1.0, origin)
        cam = _camera(i)
        ivp, pos = cam.inv_view_proj(FRAME_W, FRAME_H), cam.position
        if i % 2:
            ivp, pos = (torch.as_tensor(x, device=cuda) for x in (ivp, pos))
        img = render(tf, pal, ivp, pos)
        _same(img, render.eager(tf, pal, ivp, pos), f"render {i}")
        assert img.shape == (FRAME_H, FRAME_W, 3)
        assert bool(torch.isfinite(img).all()) and float(img.std()) > 1e-3
        images.append(img)
    assert render.program.captured is not None
    assert not torch.equal(images[0], images[-1])


@pytest.mark.parametrize("shards", [3, 4])
def test_entity_sharded_substep_replays_equal_eager(cuda, shards):
    stepper, state = bench_crowd.build(256, device=cuda)
    sharded = SH.shard_world_state(shards, state)
    graph = SH.EntityShardedSubstep(stepper, sharded, FIXED_DT, shards)
    eager = SH.EntityShardedSubstep(stepper, sharded, FIXED_DT, shards)
    whole = SubstepGraph(stepper, state, FIXED_DT)
    assert graph.graph is not None and graph.capture_seconds > 0
    player = stepper.player_idx
    for i, intent in enumerate(_intents(2 * STEPS)):
        for sim in (graph, eager, whole):
            apply_intent(sim.state, player, intent)
        graph.step()
        eager.eager()
        whole.step()
        _same(graph.state, eager.state, f"{shards} shards, substep {i}")
    for x, y in zip(state_leaves(graph.state), state_leaves(whole.state)):
        if not torch.equal(x, y):
            assert x.dtype.is_floating_point
            assert float((x - y).abs().max()) <= 1e-5
    moved = (graph.state.body_pos - state.body_pos).abs().amax(1)
    assert float(moved[player]) > 0.1


def _fused_steps(group, dev, sharded, steps=STEPS):
    """``steps`` steps of ``sharded_fused_step`` (2 substeps, 3 layers, 2
    shadow layers) on the tiny world over ``group``, each replayed and run
    eagerly from the same state, asserted equal bit for bit -> (the last
    state, image)."""
    world = W.port_engine_world(dev)
    step = SH.sharded_fused_step(group, world, IBL.build(dev), FRAME_W,
                                 FRAME_H, n_substeps=2, max_layers=3,
                                 shadow_layers=2, device=dev)
    state = SH.shard_world_state(group, world.state) if sharded else \
        world.state
    origin = torch.zeros(3, device=dev)
    for i, intent in enumerate(_intents(steps)):
        apply_intent(state.state if sharded else state, world.player, intent)
        cam = _camera(i)
        args = (torch.as_tensor(cam.inv_view_proj(FRAME_W, FRAME_H),
                                device=dev),
                torch.as_tensor(cam.position, device=dev), origin)
        out, img = step(state, *args)
        out_e, img_e = step.eager(state, *args)
        _same(img, img_e, f"image {i}")
        _same(out.state if sharded else out, out_e.state if sharded else
              out_e, f"state {i}")
        assert bool(torch.isfinite(img).all()) and float(img.std()) > 1e-3
        state = out
    assert step.sim.graph is not None and step.program.captured is not None
    assert isinstance(state, SH.ShardedWorldState) == sharded
    return state.state if sharded else state, img


@pytest.mark.parametrize("sharded", [False, True])
def test_fused_step_on_one_nccl_rank(cuda, tmp_path, sharded):
    group = SH.make_group(0, 1, "file://" + str(tmp_path / "store"))
    try:
        _fused_steps(group, cuda, sharded)
    finally:
        _destroy()


def test_fused_step_on_two_nccl_ranks(cuda, tmp_path):
    """Two ranks, one process a card: every rank's replays equal its eager
    steps (asserted in the rank), and the ranks end with the same state and
    image, within 1e-5 of the 2-virtual-shard run here."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: one NCCL rank a card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, (root, os.environ.get("PYTHONPATH")))))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2",
         str(tmp_path / "store"), str(tmp_path / f"out{r}.pt")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    outs = [torch.load(str(tmp_path / f"out{r}.pt")) for r in range(2)]
    for a, b in zip(outs[0]["leaves"], outs[1]["leaves"]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0]["image"], outs[1]["image"])
    state, img = _fused_steps(2, cuda, True)
    assert float((img.cpu() - outs[0]["image"]).abs().max()) <= 1e-5
    for a, b in zip(state_leaves(state), outs[0]["leaves"]):
        assert torch.allclose(a.cpu(), b, rtol=0, atol=1e-5) \
            if a.dtype.is_floating_point else torch.equal(a.cpu(), b)


def _destroy():
    """The group destroyed once no graph that captured its collectives is
    left: NCCL's communicator waits for them."""
    gc.collect()
    torch.cuda.synchronize()
    torch.distributed.destroy_process_group()


def _rank(rank, world, store, out):
    dev = torch.device("cuda", rank)
    group = SH.make_group(rank, world, "file://" + store)
    state, img = _fused_steps(group, dev, True)
    torch.save(dict(leaves=[x.cpu() for x in state_leaves(state)],
                    image=img.cpu()), out)
    _destroy()


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
