"""PyTorch port, the ECS world and the per-substep systems vs the JAX
reference (CPU).

The same staging calls go into both packages' WorldBuilders; the port's
own build must give the reference's spec arrays and initial state exactly
(f32 tables, int32 chunks, bool masks; uint32 layer masks as int64).
The systems of physics/systems.py and the chunk arithmetic run on the same
random inputs in both (f32 rounding: 1e-5).
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swift_game_engine_tpu.ecs import world as JW
from swift_game_engine_tpu.physics import systems as JS
from swift_game_engine_tpu.physics.collision_world import \
    CollisionWorldBuilder as JCB
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.ecs import world as PW
from swift_game_engine_tpu_torch.physics import systems as PS
from swift_game_engine_tpu_torch.physics.collision_world import \
    CollisionWorldBuilder as PCB
from swift_game_engine_tpu_torch.scene.step import Stepper

sys.path.insert(0, os.path.dirname(__file__))
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5


def _build_both(recipe):
    jwb, jcb, pwb, pcb = JW.WorldBuilder(), JCB(), PW.WorldBuilder(), PCB()
    recipe(jwb, jcb)
    handles = recipe(pwb, pcb)
    return jwb.build(), pwb.build(device="cpu"), handles


@pytest.mark.parametrize("recipe", ["tiny", "multi", "chunk_edge"])
def test_world_builder_matches_reference(recipe):
    (jspec, jstate), (pspec, pstate), _ = _build_both(getattr(W, recipe))
    W.compare_states(jstate, pstate, atol=0, rtol=0)
    ref = interop.scene_spec(jspec, device="cpu")
    for f in ("n_entities", "names", "gravity"):
        assert getattr(pspec, f) == getattr(ref, f), f
    for f in ("has_body", "body_type", "has_controller", "has_intent",
              "has_movement", "has_loco", "has_action", "has_dodge",
              "has_osc", "has_spin", "has_platform", "has_wp", "is_player",
              "character_slot", "follow_target"):
        np.testing.assert_array_equal(getattr(pspec, f), getattr(ref, f), f)
    for f in ("movement", "osc", "spin", "platform", "dodge_cfg",
              "action_cfg"):
        for k, v in getattr(ref, f).items():
            np.testing.assert_array_equal(getattr(pspec, f)[k], v, f"{f}.{k}")
    for a, b in ((pspec.controller_params, ref.controller_params),
                 (pspec.loco_params, ref.loco_params),
                 (pspec.loco_tuning, ref.loco_tuning)):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), f


def test_interop_world_state_keeps_dtypes():
    (jspec, jstate), (_, pstate), _ = _build_both(W.multi)
    carried = interop.world_state(jstate, device="cpu")
    for (name, a), (_, b) in zip(W.leaves(carried), W.leaves(pstate)):
        assert a.dtype == b.dtype, name
    assert carried.wp_chunk.dtype == torch.int32
    assert carried.ctrl.manifold_tri.dtype == torch.int32
    assert interop.controller_params(jspec.controller_params, device="cpu") \
        .collision_mask.dtype == torch.int64


def test_chunk_conversion_matches_reference():
    rng = np.random.default_rng(2)
    w = np.concatenate([rng.uniform(-3000, 3000, (200, 3)),
                        np.array([[256.0, -256.0, 767.99], [255.999, 0, 0]])
                        ]).astype(np.float32)
    jc, jl = JW.world_to_chunk_local(jnp.asarray(w))
    pc, pl = PW.world_to_chunk_local(torch.as_tensor(w))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    chunk = rng.integers(-4, 4, (200, 3)).astype(np.int32)
    local = rng.uniform(-700, 700, (200, 3)).astype(np.float32)
    jc, jl = JW.canonicalize(jnp.asarray(chunk), jnp.asarray(local))
    pc, pl = PW.canonicalize(torch.as_tensor(chunk), torch.as_tensor(local))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(
        PW.chunk_local_to_world(pc, pl).numpy(),
        np.asarray(JW.chunk_local_to_world(jc, jl)), rtol=0, atol=0)


def test_spawn_despawn_match_reference():
    (jspec, jstate), _, h = _build_both(W.multi)
    pstate = interop.world_state(jstate, device="cpu")
    j = JW.despawn_entity(jstate, h["npc_a"])
    p = PW.despawn_entity(pstate, h["npc_a"])
    W.compare_states(j, p, atol=0, rtol=0)
    j = JW.spawn_entity(j, h["dormant"], position=[5.0, 1.0, -7.0])
    p = PW.spawn_entity(p, h["dormant"], position=[5.0, 1.0, -7.0])
    W.compare_states(j, p, atol=0, rtol=0)
    j = JW.spawn_entity(j, h["npc_a"])
    p = PW.spawn_entity(p, h["npc_a"])
    W.compare_states(j, p, atol=0, rtol=0)


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _close(port, ref, tol=TOL):
    for a, b in zip(port if isinstance(port, tuple) else (port,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=tol)


def test_systems_match_reference():
    rng = np.random.default_rng(6)
    n, dt = 64, np.float32(1 / 60)
    f = np.float32
    v = rng.normal(0, 5, (n, 3)).astype(f)
    q = rng.normal(size=(n, 4)).astype(f)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    target = rng.normal(0, 6, (n, 3)).astype(f)
    yaw = rng.uniform(-3, 3, n).astype(f)
    b = [rng.random(n) < 0.5 for _ in range(6)]
    acc, dec = rng.uniform(5, 30, (2, n)).astype(f)
    _close(PS.physics_intent(*_t(v, q, target, yaw, b[0], b[1], b[2], acc,
                                 dec), float(dt), torch.as_tensor(b[3])),
           JS.physics_intent(v, q, target, yaw, b[0], b[1], b[2], acc, dec,
                             dt, b[3]))
    _close(PS.gravity_step(*_t(v, b[0], b[1], b[2]), float(dt)),
           JS.gravity_step(v, b[0], b[1], b[2], dt))
    _close(PS.jump_step(*_t(v, b[0], b[1])), JS.jump_step(v, b[0], b[1]))

    ds = JS.DodgeState(active=b[4], time=rng.uniform(0, 0.5, n).astype(f),
                       duration=np.full(n, 0.5, f), distance=np.full(n, 8, f),
                       start_time=np.zeros(n, f),
                       end_time=rng.uniform(0, 0.6, n).astype(f),
                       direction=rng.normal(size=(n, 3)).astype(f),
                       facing_yaw=yaw)
    jd, jov = JS.dodge_step(ds, q, b[5], dt)
    pd, pov = PS.dodge_step(PS.DodgeState(*_t(*ds)), torch.as_tensor(q),
                            torch.as_tensor(b[5]), float(dt))
    _close(tuple(pd), tuple(jd))
    _close(tuple(pov.values()), tuple(jov.values()))

    axis = rng.normal(size=(n, 3)).astype(f)
    axis[::7] = 0.0
    amp, speed, phase, time = rng.uniform(0.5, 4, (4, n)).astype(f)
    _close(PS.kinematic_platform_motion(*_t(target, axis, amp, speed, phase,
                                            time), float(dt),
                                        torch.as_tensor(b[0])),
           JS.kinematic_platform_motion(target, axis, amp, speed, phase, time,
                                        dt, b[0]))
    _close(PS.oscillate_move(*_t(axis, amp, speed, time), float(dt),
                             torch.as_tensor(b[1])),
           JS.oscillate_move(target, axis, amp, speed, time, dt, b[1]))
    _close(PS.spin_step(*_t(q, speed, axis + 0.1), float(dt)),
           JS.spin_step(q, speed, axis + 0.1, dt))
    w = rng.normal(0, 2, (n, 3)).astype(f)
    w[::5] = 0.0
    _close(PS.integrate_bodies(*_t(target, q, v, w, b[2] & ~b[3]), float(dt)),
           JS.integrate_bodies(target, q, v, w, b[2], b[3], dt))

    # the action clock: running, at its end (the dodge's end time or the
    # cycle), exiting, restarted by a trigger
    clock = JS.ActionClock(active=b[0], time=rng.uniform(0, 1.2, n).astype(f),
                           weight=rng.uniform(0, 1, n).astype(f),
                           exiting=b[1] & (rng.random(n) < 0.5))
    cycle = rng.uniform(0.5, 1.5, n).astype(f)
    end = np.where(b[2], rng.uniform(0.3, 0.8, n), 0.0).astype(f)
    rate, blend_in, blend_out = rng.uniform(0.5, 1.5, (3, n)).astype(f) * \
        np.array([[1.0], [0.08], [0.12]], f)
    _close(tuple(PS.action_animation_step(
        PS.ActionClock(*_t(*clock)), *_t(cycle, end, b[3]), float(dt),
        playback_rate=torch.as_tensor(rate),
        blend_in_time=torch.as_tensor(blend_in),
        blend_out_half_life=torch.as_tensor(blend_out),
        trigger=torch.as_tensor(b[4]))),
           tuple(JS.action_animation_step(
               clock, cycle, end, b[3], dt, playback_rate=rate,
               blend_in_time=blend_in, blend_out_half_life=blend_out,
               trigger=b[4])))


def test_stepper_refuses_pose(tmp_path):
    """A Stepper takes pose parts (it no longer refuses them). Without them
    it skips the pose systems, as the reference's substep does
    (scene/step.py:253-290): the locomotion and action clocks and the
    palettes stay as they were; with the posed player of the synthetic rig
    it runs them: clocks advance and the palettes leave the identity."""
    import torch_pose_rig
    (jspec, jstate), _, _ = _build_both(W.tiny)
    spec = interop.scene_spec(jspec, device="cpu")
    state = interop.world_state(jstate, device="cpu")
    local = PCB().build(device="cpu")
    out = Stepper(spec, local).substep(state, 1 / 60)
    for part in ("loco", "action"):
        for a, b in zip(getattr(out, part), getattr(state, part)):
            assert torch.equal(a, b), part
    assert torch.equal(out.palettes, state.palettes)
    rig = torch_pose_rig.write_rig(str(tmp_path / "rig"), os.path.join(
        os.path.dirname(__file__), "..", "assets"))
    _, pstate, stepper, ph = W.posed_port_world(rig)
    out = stepper.substep(pstate, 1 / 60)
    p = ph["player"]
    assert float(out.loco.times[p].sum()) > 0
    assert bool(torch.isfinite(out.palettes).all())
    assert not torch.equal(out.palettes, pstate.palettes)
