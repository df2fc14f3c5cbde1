"""PyTorch port, whole trajectories vs the JAX reference's Stepper (CPU).

Both packages start from one state (carried across with ``interop``) and
each runs its own substeps; positions (body, transform, chunk-local) stay
within atol 1e-3 of the reference at every substep (the bound
tests/test_world_step.py:67-68 uses), and at the end the integer and bool
fields are equal, but for the rounding ties ``compare_states`` names
(printed by agent).

The mover has ties where the reference itself jumps: thresholds (snap
and sweep clamps, near-ground tests, the snap gate v_y <= 0 on a residual
velocity of rounding size) and contacts on the edge two triangles share,
whose TOIs agree to rounding; a change of 1e-7 in its state then moves an
agent by up to 0.34 in the next substep. Where the two trajectories part
by more than the tolerance, the test proves that this is such a place:
the two states before the substep agree within 1e-4, and the reference's
own substep reaches the port's result from an input within the
one-substep tolerance of its state (``reference_reaches``: the port's
state, or the agent moved by at most 5e-5). It prints the agent and the
substep, sets the port back onto the reference's state and goes on; a
divergence without that proof fails.
"""

import os
import sys

import numpy as np

from swift_game_engine_tpu.ecs import world as JW
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.ecs import world as PW

sys.path.insert(0, os.path.dirname(__file__))
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

POS_TOL = 1e-3


def run_both(recipe, steps, events=None, **kw):
    """Run ``steps`` substeps in both packages; ``events(i, jstate,
    pstate, handles) -> (jstate, pstate)`` edits both before substep i.
    Returns (jstate, pstate, handles, ties)."""
    jspec, jstate, jstep, h, local = W.jax_world(recipe, **kw)
    pstep = W.port_stepper(jspec, local)
    pstate = interop.world_state(jstate, device="cpu")
    for i in range(steps):
        if events is not None:
            jstate, pstate = events(i, jstate, pstate, h)
        j_before, p_before = jstate, pstate
        jstate = jstep.substep(jstate, W.DT)
        pstate = pstep.substep(pstate, W.DT)
        gap, e = W.position_gap(jstate, pstate)
        if gap > POS_TOL:
            assert W.position_gap(j_before, p_before)[0] <= 1e-4, i
            how = W.reference_reaches(jstep, j_before, p_before, pstate)
            assert how is not None, (
                f"substep {i}: entity {e} parts by {gap:.3g} and the "
                f"reference does not reach the port's result")
            print(f"substep {i}: entity {e} parts by {gap:.3g}; the "
                  f"reference reaches the port's result from {how}")
            pstate = interop.world_state(jstate, device="cpu")
        for f in ("wp_chunk", "alive"):
            np.testing.assert_array_equal(getattr(pstate, f).numpy(),
                                          np.asarray(getattr(jstate, f)))
    ties = W.compare_states(jstate, pstate, lambda: W.soup_tris(jstate,
                                                                jstep),
                            atol=POS_TOL, rtol=0, float_fields=W.POSITIONS)
    for e, name, a, b in ties:
        print(f"tie at the end: entity {e}, {name}: reference {a}, port {b}")
    return jstate, pstate, h, ties


def _intent(at, vel, yaw, jump_at=None):
    def events(j, js, ps, h):
        if j == at or j == jump_at:
            js = W.set_player_intent(js, h["player"], vel, yaw=yaw,
                                     jump=j == jump_at)
            ps = interop.world_state(js, device="cpu")._replace(
                **{f: getattr(ps, f) for f in ps._fields
                   if not f.startswith("intent_")})
        return js, ps
    return events


def test_trajectory_tiny_world():
    """90 substeps of test_world_step.py's world: fall, land, walk, jump."""
    js, ps, h, _ = run_both(W.tiny, 90, _intent(60, [4.5, 0, 0], np.pi / 2,
                                                jump_at=75))
    assert float(ps.body_pos[h["player"], 0]) > 0.5
    assert float(ps.body_pos[h["player"], 1]) > -0.5      # in the air


def test_trajectory_multi_agent_with_spawn_and_despawn():
    """The multi-agent world for 70 substeps; npc_a is despawned at 20,
    the dormant slot spawned at 30 and npc_a respawned at 40, in both
    packages by their own spawn_entity/despawn_entity."""
    walk = _intent(5, [5.0, 0, 1.5], 1.3, jump_at=45)

    def events(i, js, ps, h):
        js, ps = walk(i, js, ps, h)
        if i == 20:
            js = JW.despawn_entity(js, h["npc_a"])
            ps = PW.despawn_entity(ps, h["npc_a"])
        if i == 30:
            js = JW.spawn_entity(js, h["dormant"], position=[3.3, 1.2, 13.4])
            ps = PW.spawn_entity(ps, h["dormant"], position=[3.3, 1.2, 13.4])
        if i == 40:
            js = JW.spawn_entity(js, h["npc_a"])
            ps = PW.spawn_entity(ps, h["npc_a"])
        return js, ps

    js, ps, h, _ = run_both(W.multi, 70, events)
    assert bool(ps.alive[h["dormant"]]) and bool(ps.alive[h["npc_a"]])
    assert bool(ps.ctrl.grounded[h["rider"]])
