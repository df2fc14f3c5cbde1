"""PyTorch port, the pose stack (M4b) vs the JAX reference (CPU).

On the synthetic rig of tests/torch_pose_rig.py (the skin's 52 bones, five
seeded motion profiles in the reference's schemas):

  * the port's loaders, ``pack_profile`` and the skin's inverse binds give
    the JAX package's arrays exactly;
  * math3d's pose functions, ``fourier``, ``fk``, the single-clip path
    and ``locomotion_fsm_step`` agree with JAX's (f32 rounding of the same
    expressions: 2e-6 on values of order 1, 1e-5 on translations and
    model matrices that reach 3; the FSM's integer and bool fields equal);
  * ``PoseEngine.step_character`` agrees with the JAX ``PoseEngine``,
    jitted and vmapped, in the seven cases of tests/test_pose.py (one
    parametrised test): palettes, model matrices and phase within 1e-4,
    the loco state's integers and bools equal, its floats within 1e-5;
    two of the cases are also held against tests/oracle_pose.py with
    test_pose.py's own tolerance (5e-3).
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from swift_game_engine_tpu import math3d as jm3
from swift_game_engine_tpu.anim import fk as jfk
from swift_game_engine_tpu.anim import fourier as jfourier
from swift_game_engine_tpu.anim import locomotion as jloco
from swift_game_engine_tpu.anim import pose as JP
from swift_game_engine_tpu.assets import motion_profile as jmp
from swift_game_engine_tpu.assets import procedural_meshes as jpm
from swift_game_engine_tpu.assets import skeleton as jskel
from swift_game_engine_tpu.assets import skinned_mesh as jskin
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch import math3d as pm3
from swift_game_engine_tpu_torch.anim import fk as pfk
from swift_game_engine_tpu_torch.anim import fourier as pfourier
from swift_game_engine_tpu_torch.anim import locomotion as ploco
from swift_game_engine_tpu_torch.anim import pose as PP
from swift_game_engine_tpu_torch.assets import motion_profile as pmp
from swift_game_engine_tpu_torch.assets import nputil as pnp
from swift_game_engine_tpu_torch.assets import procedural_meshes as ppm
from swift_game_engine_tpu_torch.assets import skeleton as pskel
from swift_game_engine_tpu_torch.assets import skinned_mesh as pskin

sys.path.insert(0, os.path.dirname(__file__))
import oracle_pose as O  # noqa: E402
import torch_pose_rig as R  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
LOCO = ("Idle", "Walking", "Running", "FallingIdle")


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    d = R.write_rig(str(tmp_path_factory.mktemp("rig")), ASSETS)
    jsk = jskel.load_skeleton(os.path.join(d, "YBot.skeleton.json"))
    psk = pskel.load_skeleton(os.path.join(d, "YBot.skeleton.json"))
    names = [n for n, _ in R.PROFILES]
    jprof = {n: jmp.load_motion_profile(os.path.join(
        d, f"{n}.motionProfile.json")) for n in names}
    pprof = {n: pmp.load_motion_profile(os.path.join(
        d, f"{n}.motionProfile.json")) for n in names}
    jeng = JP.PoseEngine(jsk)
    jbank = jeng.make_bank(*(jmp.pack_profile(jprof[n], jsk) for n in LOCO))
    jact = jeng.make_action(jmp.pack_profile(
        jprof["StandingDodgeBackward"], jsk))
    peng = PP.PoseEngine(psk, device="cpu")
    pbank = peng.make_bank(*(pmp.pack_profile(pprof[n], psk) for n in LOCO))
    pact = peng.make_action(pmp.pack_profile(
        pprof["StandingDodgeBackward"], psk))
    step = jax.jit(jax.vmap(
        lambda lo, pa, a, i, dt: jeng.step_character(jbank, jact, lo, pa, a,
                                                     i, dt),
        in_axes=(0, 0, 0, 0, None)))
    return dict(dir=d, jsk=jsk, psk=psk, jprof=jprof, pprof=pprof,
                jeng=jeng, jbank=jbank, jact=jact, peng=peng, pbank=pbank,
                pact=pact, jstep=step)


# ------------------------------------------------------------ assets


def test_loaders_and_packing_match_reference(rig):
    jsk, psk = rig["jsk"], rig["psk"]
    for f in ("parent", "bind_local", "inv_bind_model", "rest_translation",
              "raw_rest_translation", "pre_rotation_degrees", "pre_rot",
              "root_rotation_fix"):
        np.testing.assert_array_equal(getattr(psk, f), getattr(jsk, f), f)
    assert psk.names == jsk.names and psk.unit_scale == jsk.unit_scale
    assert psk.semantic == jsk.semantic and \
        psk.index_by_name == jsk.index_by_name
    assert len(psk.levels) == len(jsk.levels)
    for a, b in zip(psk.levels, jsk.levels):
        np.testing.assert_array_equal(a, b)
    assert psk.semantic["pelvis"] == 0 and "spine3" in psk.semantic
    assert pskel._resolve_root_rule("AUTO", "mixamo") == "zero_root"
    assert interop.skeleton(jsk).semantic == psk.semantic
    for n in rig["jprof"]:
        jp = jmp.pack_profile(rig["jprof"][n], jsk)
        pp = pmp.pack_profile(rig["pprof"][n], psk)
        np.testing.assert_array_equal(pp.coeffs, jp.coeffs)
        np.testing.assert_array_equal(pp.has_channel, jp.has_channel)
        assert (pp.order, pp.duration, pp.cycle) == \
            (jp.order, jp.duration, jp.cycle)
    # the dangling coefficient the rig writes is dropped by both
    assert rig["pprof"]["Idle"].bones[psk.names[1]]["rotation"]["z"][-1] \
        == 0.5
    phase = np.linspace(-0.2, 1.2, 17, dtype=np.float32)
    np.testing.assert_array_equal(pmp.fourier_basis_np(phase, 4),
                                  jmp.fourier_basis_np(phase, 4))
    coeffs = rig["pprof"]["Walking"].bones[psk.names[3]]["rotation"]["x"]
    assert pmp.evaluate_fourier(coeffs, 0.3, 4) == \
        jmp.evaluate_fourier(coeffs, 0.3, 4)
    # interop carries the JAX bank and action profile across as the
    # port's loaders build them
    for a, b in zip(interop.profile_bank(rig["jbank"], device="cpu"),
                    rig["pbank"]):
        assert torch.equal(a, b)
    for a, b in zip(interop.action_profile(rig["jact"], device="cpu"),
                    rig["pact"]):
        assert torch.equal(a, b)
    # the skinned bodies: the rig's capsules (the posed DemoScene's body
    # without a skin file) and the test humanoid
    for a, b in ((ppm.skeleton_capsules(psk, radius=0.05),
                  jpm.skeleton_capsules(jsk, radius=0.05)),
                 (ppm.humanoid_skinned(), jpm.humanoid_skinned())):
        for f in ("positions", "normals", "uvs", "joints", "weights",
                  "indices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    # the rig's rest pose is the skin's bind pose: the palette at rest is
    # the identity within f32
    skin = os.path.join(rig["dir"], "YBot.skinned.json")
    jsm = jskin.load_skinned_mesh(skin, jsk)
    psm = pskin.load_skinned_mesh(skin, psk)
    np.testing.assert_array_equal(psm.inv_bind_model, jsm.inv_bind_model)
    model = pnp.fk_model_transforms(psk.parent, psk.bind_local)
    np.testing.assert_allclose(model @ psm.inv_bind_model,
                               np.broadcast_to(np.eye(4), model.shape),
                               atol=1e-5)


# ------------------------------------------------------------ math, FK


def test_math3d_pose_functions_match_reference():
    rng = np.random.default_rng(1)
    deg = rng.uniform(-180, 180, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pm3.quat_from_euler_xyz_degrees(torch.as_tensor(deg)).numpy(),
        np.asarray(jm3.quat_from_euler_xyz_degrees(deg)), atol=2e-6)
    np.testing.assert_allclose(pm3.radians_from_degrees(
        torch.as_tensor(deg)).numpy(), np.asarray(
            jm3.radians_from_degrees(deg)), rtol=1e-7, atol=0)
    # rotation matrices whose largest term is each of the four candidates
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:16, 3] *= 8
    q[16:32, 0] *= 8
    q[32:48, 1] *= 8
    q[48:, 2] *= 8
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    r = np.array(jm3.mat3_from_quat(q))
    np.testing.assert_allclose(
        pm3.quat_from_mat3(torch.as_tensor(r)).numpy(),
        np.asarray(jm3.quat_from_mat3(r)), atol=2e-6)
    np.testing.assert_allclose(pm3.mat4_from_quat(torch.as_tensor(q)).numpy(),
                               np.asarray(jm3.mat4_from_quat(q)), atol=1e-6)
    np.testing.assert_array_equal(pm3.quat_conj(torch.as_tensor(q)).numpy(),
                                  np.asarray(jm3.quat_conj(q)))
    t = rng.uniform(0, 1, 64).astype(np.float32)
    np.testing.assert_allclose(pm3.smootherstep01(torch.as_tensor(t)).numpy(),
                               np.asarray(jm3.smootherstep01(t)), atol=1e-6)
    # slerp: generic pairs, nearly parallel pairs (the nlerp branch) and
    # opposite hemispheres
    q1 = q + rng.normal(size=q.shape).astype(np.float32) * np.where(
        np.arange(64) % 2 == 0, 1e-7, 0.3)[:, None].astype(np.float32)
    q1[::3] *= -1
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    np.testing.assert_allclose(
        pm3.quat_slerp(torch.as_tensor(q), torch.as_tensor(q1),
                       torch.as_tensor(t)).numpy(),
        np.asarray(jm3.quat_slerp(q, q1, t)), atol=2e-6)


def test_fourier_matches_reference(rig):
    bank = rig["jbank"]
    phase = np.array([-0.1, 0.0, 0.13, 0.5, 0.77, 1.0, 1.3], np.float32)
    np.testing.assert_allclose(
        pfourier.fourier_basis(torch.as_tensor(phase), 4).numpy(),
        np.asarray(jfourier.fourier_basis(phase, 4)), atol=1e-6)
    rest = rig["jsk"].raw_rest_translation
    for k in range(4):
        coeffs, has = np.array(bank.coeffs[k]), np.array(
            bank.has_channel[k])
        tr, rot = pfourier.evaluate_packed(
            torch.as_tensor(coeffs), torch.as_tensor(has),
            torch.as_tensor(phase), 4, torch.as_tensor(rest))
        for i, p in enumerate(phase):
            jt, jr = jfourier.evaluate_packed(coeffs, has, p, 4, rest)
            np.testing.assert_allclose(tr[i].numpy(), np.asarray(jt),
                                       rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(rot[i].numpy(), np.asarray(jr),
                                       atol=2e-5)


def test_fk_matches_reference(rig):
    jsk = rig["jsk"]
    rng = np.random.default_rng(2)
    n, b = 5, jsk.bone_count
    t = (rng.normal(size=(n, b, 3)) * 0.5).astype(np.float32)
    q = rng.normal(size=(n, b, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    jsolver = jfk.FKSolver(jsk.parent, jsk.levels)
    psolver = pfk.FKSolver(jsk.parent, jsk.levels, device="cpu")
    jt, jq = jax.vmap(jsolver.model_tq)(t, q)
    pt, pq = psolver.model_tq(torch.as_tensor(t), torch.as_tensor(q))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=2e-6)
    jm = jax.vmap(jsolver.model_matrices)(t, q)
    pm = psolver.model_matrices(torch.as_tensor(t), torch.as_tensor(q))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), atol=1e-5)
    inv = jsk.inv_bind_model
    np.testing.assert_allclose(
        pfk.palette_from_model(pm, torch.as_tensor(inv)).numpy(),
        np.asarray(jfk.palette_from_model(jm, inv)), atol=1e-5)


def test_single_profile_matches_reference(rig):
    """The single-clip playback path (ProceduralPoseSystem.swift:224-276),
    as tests/test_pose_single.py drives it: the Walking clip, two
    characters (one past the cycle, wrapping), one step."""
    jsk = rig["jsk"]
    packed = jmp.pack_profile(rig["jprof"]["Walking"], jsk)
    time0 = np.array([0.2, 1.06], np.float32)
    jp = JP.LocoParams.default((2,))
    ref = jax.vmap(lambda t, pa: JP.single_profile_pose_tq(
        jnp.asarray(packed.coeffs), jnp.asarray(packed.has_channel),
        jnp.float32(packed.cycle), t, pa, rig["jeng"].arrays, packed.order,
        rig["jeng"].unit_scale, np.float32(1 / 60)))(time0, jp)
    peng = rig["peng"]
    got = PP.single_profile_pose_tq(
        torch.as_tensor(packed.coeffs), torch.as_tensor(packed.has_channel),
        torch.tensor(np.float32(packed.cycle)), torch.as_tensor(time0),
        interop.loco_params(jp, device="cpu"), peng.arrays, packed.order,
        peng.unit_scale, float(np.float32(1 / 60)))
    for a, b, tol in zip(got, ref, (1e-5, 2e-6, 1e-6, 1e-6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
    assert float(got[3][1]) < 0.1          # the second clock wrapped


def test_locomotion_fsm_matches_reference(rig):
    """Every transition of the state machine: speeds drawn around each
    threshold (never on one), grounded and airborne, low and high drops,
    from every state, blending or not."""
    rng = np.random.default_rng(3)
    n = 256
    tune = jloco.LocomotionTuning.default((n,))
    state = rng.integers(0, 4, n).astype(np.int32)
    speeds = rng.choice([0.1, 0.2, 0.28, 4.0, 5.5, 7.0], n) + \
        rng.uniform(-0.02, 0.02, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    vel = np.stack([np.cos(ang) * speeds, rng.normal(size=n),
                    np.sin(ang) * speeds], 1).astype(np.float32)
    near = rng.uniform(size=n) < 0.6
    drop = rng.choice([3.0, 20.0], n).astype(np.float32)
    loco = JP.LocoState(
        state=jnp.asarray(state),
        from_state=jnp.asarray(rng.integers(0, 4, n).astype(np.int32)),
        times=jnp.asarray(rng.uniform(0, 2, (n, 4)).astype(np.float32)),
        blend_t=jnp.asarray(rng.uniform(0, 1, n).astype(np.float32)),
        idle_inertia=jnp.asarray(rng.uniform(0, 1, n).astype(np.float32)),
        is_blending=jnp.asarray(rng.uniform(size=n) < 0.5))
    ref = jloco.locomotion_fsm_step(loco, rig["jbank"], tune, vel, near, drop)
    got = ploco.locomotion_fsm_step(
        interop.loco_state(loco, device="cpu"),
        interop.profile_bank(rig["jbank"], device="cpu"),
        ploco.LocomotionTuning(*(torch.as_tensor(np.array(x))
                                 for x in tune)),
        torch.as_tensor(vel), torch.as_tensor(near), torch.as_tensor(drop))
    assert len(set(np.asarray(ref.state).tolist())) == 4
    assert int((np.asarray(ref.state) != state).sum()) > 50
    for f in JP.LocoState._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b.astype(a.dtype), a, f)
        else:
            np.testing.assert_allclose(b, a, atol=1e-6, err_msg=f)


# ------------------------------------------------------------ the pose step

# tests/test_pose.py's seven cases: (loco state, steps, action state,
# inputs); "batch" is its vmapped case (four characters).
CASES = {
    "idle_no_blend": (dict(state=JP.IDLE), 3, None, None),
    "walk_phase_advance": (dict(state=JP.WALK, times=(0.3, 0.5, 0.1, 0.0)),
                           5, None, None),
    "walk_to_run_blend": (dict(state=JP.RUN, from_state=JP.WALK,
                               times=(0.0, 0.37, 0.12, 0.0), blend_t=0.0,
                               is_blending=True), 4, None, None),
    "run_to_idle_inertia_blend": (
        dict(state=JP.IDLE, from_state=JP.RUN, times=(0.2, 0.1, 0.8, 0.0),
             blend_t=0.0, idle_inertia=1.0, is_blending=True), 6, None,
        None),
    "action_layer": (dict(state=JP.WALK, from_state=JP.WALK,
                          times=(0.0, 0.22, 0.0, 0.0)), 1,
                     dict(time=0.2, weight=0.7, active=True), None),
    "ground_align_and_lean": (
        dict(state=JP.RUN, from_state=JP.RUN, times=(0, 0, 0.4, 0)), 1, None,
        dict(forward=[0.6, 0.0, -0.8],
             ground_normal=(np.array([0.25, 1.0, 0.1]) /
                            np.linalg.norm([0.25, 1.0, 0.1])).tolist(),
             grounded_near=True)),
    "batch": (None, 1, None, None),
}
ORACLE_CASES = ("walk_to_run_blend", "action_layer")


def _jax_inputs(case):
    loco_kw, steps, action_kw, inputs_kw = CASES[case]
    if loco_kw is None:          # test_pose.py test_vmapped_batch
        n = 4
        loco = JP.LocoState(
            state=jnp.array([0, 1, 2, 3], jnp.int32),
            from_state=jnp.array([0, 0, 1, 2], jnp.int32),
            times=jnp.tile(jnp.array([0.1, 0.2, 0.3, 0.05], jnp.float32),
                           (n, 1)),
            blend_t=jnp.array([1.0, 1.0, 0.3, 0.5], jnp.float32),
            idle_inertia=jnp.zeros(n, jnp.float32),
            is_blending=jnp.array([False, False, True, True]))
        return (loco, JP.LocoParams.default((n,)),
                JP.ActionState.inactive((n,)), JP.PoseInputs.default((n,)),
                steps)
    kw = dict(state=JP.IDLE, from_state=JP.IDLE, times=(0, 0, 0, 0),
              blend_t=1.0, idle_inertia=0.0, is_blending=False)
    kw.update(loco_kw)
    loco = JP.LocoState(
        state=jnp.array([kw["state"]], jnp.int32),
        from_state=jnp.array([kw["from_state"]], jnp.int32),
        times=jnp.asarray([kw["times"]], jnp.float32),
        blend_t=jnp.array([kw["blend_t"]], jnp.float32),
        idle_inertia=jnp.array([kw["idle_inertia"]], jnp.float32),
        is_blending=jnp.array([kw["is_blending"]]))
    astate = JP.ActionState.inactive((1,))
    if action_kw:
        astate = JP.ActionState(time=jnp.array([action_kw["time"]],
                                               jnp.float32),
                                weight=jnp.array([action_kw["weight"]],
                                                 jnp.float32),
                                active=jnp.array([action_kw["active"]]))
    inputs = JP.PoseInputs.default((1,))
    if inputs_kw:
        inputs = JP.PoseInputs(
            forward=jnp.asarray([inputs_kw["forward"]], jnp.float32),
            ground_normal=jnp.asarray([inputs_kw["ground_normal"]],
                                      jnp.float32),
            grounded_near=jnp.array([inputs_kw["grounded_near"]]))
    return loco, JP.LocoParams.default((1,)), astate, inputs, steps


def _port(tree, cls):
    return cls(*(torch.as_tensor(np.array(x)) for x in tree))


@pytest.mark.parametrize("case", list(CASES))
def test_step_character_matches_reference(rig, case):
    loco, params, astate, inputs, steps = _jax_inputs(case)
    ploco_s = interop.loco_state(loco, device="cpu")
    pparams = interop.loco_params(params, device="cpu")
    pastate = _port(astate, PP.ActionState)
    pinputs = _port(inputs, PP.PoseInputs)
    dt = np.float32(1 / 60)
    for _ in range(steps):
        ref = rig["jstep"](loco, params, astate, inputs, dt)
        loco = ref.loco
        got = rig["peng"].step_character(rig["pbank"], rig["pact"], ploco_s,
                                         pparams, pastate, pinputs, 1 / 60)
        ploco_s = got.loco
        for f in ("palette", "model", "local"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       atol=1e-4, err_msg=f)
        np.testing.assert_allclose(got.phase.numpy(), np.asarray(ref.phase),
                                   atol=1e-6)
        for f in JP.LocoState._fields:
            a, b = np.asarray(getattr(ref.loco, f)), \
                getattr(got.loco, f).numpy()
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b.astype(a.dtype), a, f)
            else:
                np.testing.assert_allclose(b, a, atol=1e-5, err_msg=f)
    pal = got.palette[..., :3, :3]
    assert torch.isfinite(got.palette).all()
    assert float((torch.det(pal) - 1).abs().max()) < 1e-3
    if case in ORACLE_CASES:
        _against_oracle(rig, case, got, steps)


def _against_oracle(rig, case, got, steps):
    """tests/oracle_pose.py's scalar loop, as tests/test_pose.py runs it."""
    loco_kw, _, action_kw, inputs_kw = CASES[case]
    o_state = {"state": loco_kw.get("state", JP.IDLE),
               "from_state": loco_kw.get("from_state", JP.IDLE),
               "times": np.asarray(loco_kw.get("times", (0, 0, 0, 0)),
                                   np.float64),
               "blend_t": loco_kw.get("blend_t", 1.0),
               "idle_inertia": loco_kw.get("idle_inertia", 0.0),
               "is_blending": loco_kw.get("is_blending", False)}
    o_params = {"playback_rate": 1.0, "loop": True, "in_place": True,
                "blend_time": 0.2, "idle_half_life": 0.18}
    o_action = None
    if action_kw:
        o_action = dict(action_kw, in_place=True)
    ik = inputs_kw or {}
    for _ in range(steps):
        o = O.oracle_pose_step(
            rig["jsk"], [rig["jprof"][n] for n in LOCO], o_state, o_params,
            1 / 60, action_profile=rig["jprof"]["StandingDodgeBackward"]
            if action_kw else None, action_state=o_action,
            forward=ik.get("forward", (0, 0, -1)),
            ground_normal=ik.get("ground_normal", (0, 1, 0)),
            grounded_near=ik.get("grounded_near", False))
        o_state = o["state"]
    np.testing.assert_allclose(got.palette[0].numpy(), o["palette"],
                               atol=5e-3)
    np.testing.assert_allclose(got.model[0].numpy(), o["model"], atol=5e-3)
    assert float(got.phase[0]) == pytest.approx(float(o["phase"]), abs=1e-4)


def test_pose_entry_points_need_a_device_without_cuda(rig):
    """``PoseEngine`` and ``FKSolver`` put their tensors on the card unless
    the caller names another device; without CUDA a call that names none
    raises, and ``device="cpu"`` builds them on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults use it")
    psk = rig["psk"]
    for call in (lambda: PP.PoseEngine(psk),
                 lambda: pfk.FKSolver(psk.parent, psk.levels)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = PP.PoseEngine(psk, device="cpu")
    assert eng.device.type == "cpu" and eng.fk.perm.device.type == "cpu"
    assert pfk.FKSolver(psk.parent, psk.levels,
                        device="cpu").perm.device.type == "cpu"
