"""PyTorch port, the DemoScene's simulation world vs the JAX reference (CPU).

The port builds the DemoScene world itself (``build_demo_scene``); its
staged components and collision meshes are replayed into the reference's
WorldBuilder and CollisionWorldBuilder, so both packages hold the same
world: the initial states must agree exactly. Then both step 30 substeps
with the intents the InputSystem makes of ``InputFrame(ly=1.0)`` (the
bench headline's input) through the reference's ``Stepper`` (no pose
engine) and the port's: positions within 1e-3 every substep, the
reference's ties proven and named as in tests/test_torch_sim_trajectory.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

from swift_game_engine_tpu.ecs.world import WorldBuilder as JWB
from swift_game_engine_tpu.physics.collision_world import \
    CollisionWorldBuilder as JCB
from swift_game_engine_tpu.scene.step import Stepper as JStepper
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene
from swift_game_engine_tpu_torch.scene.input import InputFrame, InputSystem

sys.path.insert(0, os.path.dirname(__file__))
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def demo():
    world = build_demo_scene(os.path.join(REPO, "assets"), device="cpu")
    wb, cb = world.world_builder, world.collision_builder
    jwb = JWB()
    for name, alive in zip(wb.names, wb.alive):
        jwb.create_entity(name, alive=alive)
    for comp, ents in wb.c.items():
        for e, kw in ents.items():
            jwb.add(e, comp, **kw)
    jcb = JCB()
    for m in cb.meshes:
        pos = np.stack([m["p0"], m["p1"], m["p2"]], 1).reshape(-1, 3)
        jcb.add_mesh(pos, np.arange(len(pos)), entity=int(m["entity"][0]),
                     layer=int(m["layer"][0]),
                     per_tri_materials=np.stack(
                         [m["mu_s"], m["mu_k"], m["flatten"]], 1))
    jspec, jstate = jwb.build()
    jlocal = jcb.build()
    return world, jspec, jstate, JStepper(jspec, jlocal, pose_engine=None)


def test_demo_world_replays_into_reference(demo):
    world, jspec, jstate, jstep = demo
    W.compare_states(jstate, world.state, atol=0, rtol=0)
    ref = interop.local_triangles(jstep.collision, device="cpu")
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(world.collision, f)), f
    assert jspec.names == world.spec.names
    p = world.player
    assert world.spec.names[p] == "player" and jspec.is_player[p]
    # the player carries no pose components (their files are absent)
    for comp in ("motion_profile", "locomotion", "action", "dodge"):
        assert p not in world.world_builder.c.get(comp, {})
    assert world.spec.names[world.spec.follow_target.argmax()] == \
        "player_overlay"


def test_demo_world_steps_as_reference(demo):
    """30 substeps with InputFrame(ly=1.0): the player falls onto
    17-Cheese and walks, the NPCs land, the platforms and the oscillating
    NPC move."""
    world, jspec, jstate, jstep = demo
    pstep = world.stepper
    p = world.player
    pstate = world.state
    inp = InputSystem()
    walk, run, thresh = world.movement
    y0 = float(pstate.body_pos[p, 1])
    for i in range(30):
        it = inp.update(InputFrame(ly=1.0), W.DT, False, walk, run, thresh)
        jstate = W.set_player_intent(jstate, p, it["desired_velocity"],
                                     yaw=it["facing_yaw"]
                                     if it["has_facing_yaw"] else None)
        pstate = interop.world_state(jstate, device="cpu")._replace(
            **{f: getattr(pstate, f) for f in pstate._fields
               if not f.startswith("intent_")})
        j_before, p_before = jstate, pstate
        jstate = jstep.substep(jstate, W.DT)
        pstate = pstep.substep(pstate, W.DT)
        gap, e = W.position_gap(jstate, pstate)
        if gap > 1e-3:
            how = W.reference_reaches(jstep, j_before, p_before, pstate)
            assert how is not None, (i, e, gap)
            print(f"substep {i}: entity {e} parts by {gap:.3g}; the "
                  f"reference reaches the port's result from {how}")
            pstate = interop.world_state(jstate, device="cpu")
    ties = W.compare_states(jstate, pstate,
                            lambda: W.soup_tris(jstate, jstep), atol=1e-3,
                            rtol=0, float_fields=W.POSITIONS)
    for e, name, a, b in ties:
        print(f"tie at the end: entity {e}, {name}: reference {a}, port {b}")
    pos = pstate.body_pos.numpy()
    assert np.isfinite(pos).all()
    assert pos[p, 1] < y0 - 1.0                   # it fell
    assert np.abs(pos[p, [0, 2]] - [0.0, 0.0]).max() > 0.05   # and walks
