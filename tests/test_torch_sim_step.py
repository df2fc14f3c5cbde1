"""PyTorch port, one fixed substep vs the JAX reference (CPU), from many
states along a trajectory.

The reference's Stepper runs a trajectory (falls, walks, a jump, the
player sliding along a wall, a rider on the elevator, an oscillating NPC
pushing two others, an agent on the flattenGround ramp); at every state
the port takes one substep from the same state (carried across with
``interop``) and is held against the reference's next state: every float
field within atol 1e-4 + rtol 1e-5 (f32 rounding: the reference's XLA
build fuses multiply-adds, the port's eager ops do not), every integer
and bool field equal, but for the ties that f32 rounding decides, which
``compare_states`` lists and the tests print by agent: a ground triangle
on the shared edge of two, and the work counters of a grounded agent
moving parallel to the ground. Where a substep disagrees beyond that, the
test proves a tie of the reference or fails: the reference's own substep
must reach the port's result from its state with the diverging agent
moved by at most 5e-5 (``reference_reaches``; a contact on the edge two
triangles share has one TOI for both, and rounding picks the triangle).
"""

import os
import sys

import numpy as np

from swift_game_engine_tpu_torch import interop

sys.path.insert(0, os.path.dirname(__file__))
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


def _one_step_each(recipe, steps, intents):
    jspec, state, jstep, h, local = W.jax_world(recipe)
    pstep = W.port_stepper(jspec, local)
    ties = []
    for i in range(steps):
        state = intents(state, i, h)
        nxt = jstep.substep(state, W.DT)
        port = pstep.substep(interop.world_state(state, device="cpu"), W.DT)
        try:
            ties += W.compare_states(nxt, port,
                                     lambda: W.soup_tris(nxt, jstep))
        except AssertionError as e:
            how = W.reference_reaches(
                jstep, state, interop.world_state(state, device="cpu"), port)
            if how is None:
                raise AssertionError(f"substep {i}: {e}") from None
            print(f"substep {i}: {e}; the reference reaches the port's "
                  f"result from {how}")
        state = nxt
    return state, h, ties


def _print_ties(ties):
    for e, name, a, b in ties:
        print(f"tie: entity {e}, {name}: reference {a}, port {b}")


def _tiny_intents(state, i, h):
    if i == 60:
        state = W.set_player_intent(state, h["player"], [4.5, 0, 0],
                                    yaw=np.pi / 2)
    if i == 75:
        state = W.set_player_intent(state, h["player"], [4.5, 0, 0],
                                    yaw=np.pi / 2, jump=True)
    return state


def test_one_substep_tiny_world():
    """test_world_step.py's world: the player falls and lands (60), walks
    +x (60-90) and jumps (75); the elevator moves throughout."""
    state, h, ties = _one_step_each(W.tiny, 90, _tiny_intents)
    assert float(state.body_pos[h["player"]][0]) > 0.5
    _print_ties(ties)


def _multi_intents(state, i, h):
    if i == 20:       # walk into the wall at x = 3
        state = W.set_player_intent(state, h["player"], [6.0, 0, 2.0],
                                    yaw=1.2)
    if i == 40:
        state = W.set_player_intent(state, h["player"], [6.0, 0, 2.0],
                                    yaw=1.2, jump=True)
    return state


def test_one_substep_multi_agent_world():
    """The multi-agent world: wall slide, jump, elevator carry, the
    oscillating NPC's pushes (separation), the ramp, a dormant slot."""
    state, h, ties = _one_step_each(W.multi, 60, _multi_intents)
    grounded = np.asarray(state.ctrl.grounded)
    assert grounded[h["rider"]] and grounded[h["npc_ramp"]]
    _print_ties(ties)
