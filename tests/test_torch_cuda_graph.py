"""PyTorch port: the fixed substep as a CUDA graph (``SubstepGraph``), on
the card.

The machine with the card has no JAX, and tests/conftest.py imports it, so
this file imports no jax and runs there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda_graph.py -q

Here (no CUDA device) every test skips. A replay launches the kernels that
the eager substep launches, on the same inputs, and no op of the substep
uses atomics, so replays equal the eager ``Stepper.substep`` bit for bit:
on the tiny world of tests/torch_sim_worlds.py (built by the port alone)
and on chip_smoke.py's 256-agent crowd (the separation grid), over 30
substeps of changing player intents; after ``load_state`` into the
captured buffers; and two Engines built on one world each step their own
buffers.
"""

import os
import sys

import numpy as np
import pytest
import torch

from swift_game_engine_tpu_torch.ecs.world import clone_state, state_leaves
from swift_game_engine_tpu_torch.scene.engine import (FIXED_DT, Engine,
                                                      apply_intent)
from swift_game_engine_tpu_torch.scene.input import InputFrame, InputSystem
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
    """Player input over the substeps: walking, turning, two jumps."""
    return [InputFrame(ly=1.0, lx=0.6 if i >= 10 else 0.0, jump=i in (5, 20))
            for i in range(STEPS)]


def _bits(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def assert_bit_equal(a, b, what):
    for i, (x, y) in enumerate(zip(state_leaves(a), state_leaves(b))):
        assert x.shape == y.shape and x.dtype == y.dtype, (what, i)
        gap = (x.double() - y.double()).abs().max()
        assert torch.equal(_bits(x), _bits(y)), \
            f"{what}: leaf {i} differs by {gap}"


def _world(name, dev):
    """-> (Stepper, state, player) of a test world on ``dev``."""
    if name == "tiny":
        _, state, stepper, h = W.port_world(W.tiny, dev)
        return stepper, state, h["player"]
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import build_crowd
    stepper, state = build_crowd(dev)
    return stepper, state, stepper.player_idx


@pytest.mark.parametrize("name", ["tiny", "crowd_256"])
def test_replays_equal_eager_substeps(cuda, name):
    stepper, state, player = _world(name, cuda)
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
