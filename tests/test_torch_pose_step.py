"""PyTorch port, the posed fixed substep vs the JAX reference (CPU).

The port builds the posed DemoScene from the synthetic rig's directory
(tests/torch_pose_rig.py: the skeleton and five profiles the reference's
player reads, beside the repository's assets), so ``build_demo_scene``
takes its posed branch. Its staged components and collision meshes are
replayed into the reference's builders, and the reference's ``Stepper``
gets the JAX ``PoseEngine``, profile bank, dodge action profile and the
skin's inverse binds loaded from the same files, as scene/demo_scene.py
builds them:

  * the initial states agree exactly;
  * one posed substep from one state (the player mid-blend and mid-action)
    agrees on every field within 1e-4 (integers and bools equal);
  * 30 substeps of ``InputFrame(ly=1.0)`` with one dodge: positions
    within 1e-3 every substep (a tie of the reference, which f32 rounding
    decides, is proven as tests/test_torch_sim_demo.py proves it and
    printed); at the end the palettes within 1e-3, the locomotion and
    action clocks within 1e-4, their states and flags equal.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swift_game_engine_tpu.anim import pose as JP
from swift_game_engine_tpu.assets import motion_profile as jmp
from swift_game_engine_tpu.assets import skeleton as jskel
from swift_game_engine_tpu.assets import skinned_mesh as jskin
from swift_game_engine_tpu.ecs.world import WorldBuilder as JWB
from swift_game_engine_tpu.physics.collision_world import \
    CollisionWorldBuilder as JCB
from swift_game_engine_tpu.scene.step import Stepper as JStepper
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.scene.demo_scene import (POSE_PROFILES,
                                                          build_demo_scene,
                                                          has_pose_assets)
from swift_game_engine_tpu_torch.scene.input import InputFrame, InputSystem

sys.path.insert(0, os.path.dirname(__file__))
import torch_pose_rig as R  # noqa: E402
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
DODGE_AT = 22          # the substep whose intent carries the dodge


@pytest.fixture(scope="module")
def posed(tmp_path_factory):
    d = R.write_rig(str(tmp_path_factory.mktemp("rig")), ASSETS)
    world = build_demo_scene(d, device="cpu")
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
    sk = jskel.load_skeleton(os.path.join(d, "YBot.skeleton.json"))
    prof = {n: jmp.load_motion_profile(os.path.join(
        d, f"{n}.motionProfile.json")) for n in POSE_PROFILES}
    eng = JP.PoseEngine(sk)
    bank = eng.make_bank(*(jmp.pack_profile(prof[n], sk)
                           for n in POSE_PROFILES[:4]))
    act = eng.make_action(jmp.pack_profile(prof["StandingDodgeBackward"], sk))
    skin = jskin.load_skinned_mesh(os.path.join(d, "YBot.skinned.json"), sk)
    jstep = JStepper(jspec, jcb.build(), eng, bank, act,
                     inv_bind_override=skin.inv_bind_model[None])
    return world, jstate, jstep


def test_posed_world_replays_into_reference(posed):
    world, jstate, jstep = posed
    assert world.posed and world.stepper.pose_engine is not None
    W.compare_states(jstate, world.state, atol=0, rtol=0)
    p = world.player
    for comp in ("motion_profile", "locomotion", "action", "dodge"):
        assert p in world.world_builder.c[comp], comp
    spec = world.spec
    assert spec.has_loco[p] and spec.has_action[p] and spec.has_dodge[p]
    np.testing.assert_allclose(spec.dodge_cfg["end_time"][p], 34 / 60,
                               rtol=1e-6)
    assert spec.loco_tuning.idle_exit_speed[p] == np.float32(0.3)
    assert spec.loco_tuning.fall_min_drop_height[p] == 50.0
    assert world.state.palettes.shape == (1, 52, 4, 4)
    assert world.stepper.inv_bind_override.shape == (1, 52, 4, 4)
    assert spec.controller_params.agent_mass_weight[p] == 3.0
    # the stand-in without the rig's files (test_torch_sim_demo.py) is
    # not posed
    assert not has_pose_assets(ASSETS)


def _mid_blend(jstate, p):
    """The player walking into a run, blending, mid-dodge-clip."""
    lo, ac = jstate.loco, jstate.action
    return jstate._replace(
        loco=lo._replace(
            state=lo.state.at[p].set(JP.RUN),
            from_state=lo.from_state.at[p].set(JP.WALK),
            times=lo.times.at[p].set(jnp.array([0.3, 0.41, 0.12, 0.7])),
            blend_t=lo.blend_t.at[p].set(0.35),
            is_blending=lo.is_blending.at[p].set(True)),
        action=ac._replace(active=ac.active.at[p].set(True),
                           time=ac.time.at[p].set(0.25),
                           weight=ac.weight.at[p].set(0.6)),
        body_vel=jstate.body_vel.at[p].set(jnp.array([3.0, -1.0, -6.5])))


def test_posed_substep_matches_reference(posed):
    world, jstate, jstep = posed
    start = _mid_blend(jstate, world.player)
    ref = jstep.substep(start, W.DT)
    got = world.stepper.substep(interop.world_state(start, device="cpu"),
                                W.DT)
    W.compare_states(ref, got, lambda: W.soup_tris(start, jstep), atol=1e-4,
                     rtol=1e-5)
    p = world.player
    assert bool(got.action.active[p]) and float(got.action.weight[p]) > 0.6
    assert not torch.equal(got.palettes, world.state.palettes)


def test_posed_demo_steps_as_reference(posed):
    """30 substeps with InputFrame(ly=1.0) and a dodge at DODGE_AT: the
    player falls, lands on 17-Cheese and runs (the FSM goes idle -> walk
    -> run), the dodge starts the action clip; palettes follow."""
    world, jstate, jstep = posed
    pstep, p, pstate = world.stepper, world.player, world.state
    inp = InputSystem()
    walk, run, thresh = world.movement
    states = {int(pstate.loco.state[p])}
    for i in range(30):
        it = inp.update(InputFrame(ly=1.0, dodge=i == DODGE_AT), W.DT,
                        bool(jstate.dodge.active[p]), walk, run, thresh)
        jstate = W.set_player_intent(jstate, p, it["desired_velocity"],
                                     yaw=it["facing_yaw"]
                                     if it["has_facing_yaw"] else None)
        if it["dodge_requested"]:
            jstate = jstate._replace(
                intent_dodge=jstate.intent_dodge.at[p].set(True))
        pstate = interop.world_state(jstate, device="cpu")._replace(
            **{f: getattr(pstate, f) for f in pstate._fields
               if not f.startswith("intent_")})
        j_before, p_before = jstate, pstate
        jstate = jstep.substep(jstate, W.DT)
        pstate = pstep.substep(pstate, W.DT)
        states.add(int(pstate.loco.state[p]))
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
    np.testing.assert_allclose(pstate.palettes.numpy(),
                               np.asarray(jstate.palettes), atol=1e-3)
    for part in ("loco", "action"):
        for f, a in getattr(jstate, part)._asdict().items():
            a, b = np.asarray(a), getattr(getattr(pstate, part), f).numpy()
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b.astype(a.dtype), a,
                                              f"{part}.{f}")
            else:
                np.testing.assert_allclose(b, a, atol=1e-4,
                                           err_msg=f"{part}.{f}")
    np.testing.assert_allclose(pstate.pose_phase.numpy(),
                               np.asarray(jstate.pose_phase), atol=1e-4)
    print(f"locomotion states met: {sorted(states)}; action weight "
          f"{float(pstate.action.weight[p]):.4f}")
    assert {JP.IDLE, JP.WALK, JP.RUN} <= states
    assert bool(pstate.action.active[p])
    pal = pstate.palettes[0, :, :3, :3]
    assert float((torch.det(pal) - 1).abs().max()) < 1e-3
