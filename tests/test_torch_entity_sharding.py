"""PyTorch port, the entity axis of the multi-device path
(parallel/sharding.py ``shard_world_state`` / ``EntityShardedSubstep``
over ``Stepper._begin`` / ``_move`` / ``_separate`` / ``_end``) vs the
replicated substep and the JAX reference (CPU).

The world is the DemoScene without its imported assets, built by both
packages from the synthetic rig's directory (tests/torch_pose_rig.py), its
entity table padded with dormant slots to a multiple of 8
(``pad_entities_to=8``, as tests/test_multichip.py:157 builds it). The
port steps it on 1, 2, 4 and 8 virtual shards (stepped in turn in this
process) and on a 2-rank gloo group (two ``tests/torch_shard_worker.py``
processes), against its own replicated run: each rank's rows get the
replicated substep's row math, so the states are held bit for bit (the
bound of test_multichip.py:172-174, 1e-5, is the fallback the card's
check takes; these tests report which held). The 70-agent crowd
(``examples/bench_crowd.build``: separation's grid branch) on 3 shards
checks a count that does not divide.

Against the JAX reference: the JAX ``Stepper._substep_impl`` on
``shard_world_state(make_mesh(jax.devices()[:8]), state)`` (GSPMD) from
each state the port's 8 shards reach, at the one-substep simulation
tolerance of ROADMAP §3 (1e-4), with ``reference_reaches`` where a tie of
f32 rounding parts them (the other shard counts and the gloo group reach
the 8 shards' states bit for bit, so the comparison holds for each); and
the entity-sharded ``sharded_fused_step`` at test_multichip.py:177's
setting (64x32, 2 substeps, max_layers 1,
shadow_layers 1): the state at 1e-4, the image at the traversal tolerance
of tests/test_torch_sharding.py.

The unsharded substep (no entity range) of two crowds and of the posed
small DemoScene equals its stages composed over one range that spans every
entity, bit for bit (its anchors to the JAX substep are
tests/test_torch_sim_crowd.py and tests/test_torch_pose_step.py).
``build_demo_scene(texture_size=)`` is held to the reference's
SGE_TEX_SIZE.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from swift_game_engine_tpu.parallel import sharding as JSH
from swift_game_engine_tpu.render.camera import Camera
from swift_game_engine_tpu.render.ibl import IBL
from swift_game_engine_tpu.scene.demo_scene import DemoScene
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.ecs.world import state_leaves
from swift_game_engine_tpu_torch.examples import bench_crowd
from swift_game_engine_tpu_torch.parallel import sharding as SH
from swift_game_engine_tpu_torch.physics.separation import GRID_MIN_N
from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene
from swift_game_engine_tpu_torch.scene.engine import FIXED_DT
from swift_game_engine_tpu_torch.scene.step import SubstepGraph

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_trace_frame as T  # noqa: E402
import torch_pose_rig as R  # noqa: E402
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "..", "assets")
PAD, SUBSTEPS = 8, 4
SHARDS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    return R.write_rig(str(tmp_path_factory.mktemp("rig")), ASSETS)


@pytest.fixture(scope="module")
def worlds(rig):
    """The padded small DemoScene: (the reference's scene dict, the port's
    world)."""
    return (DemoScene(asset_dir=rig, include_imported_assets=False,
                      pad_entities_to=PAD).build(),
            build_demo_scene(rig, device="cpu", include_imported_assets=False,
                             pad_entities_to=PAD))


def _run(sim, n=SUBSTEPS):
    states = []
    for _ in range(n):
        sim.step()
        states.append([x.clone() for x in state_leaves(sim.state)])
    return states


@pytest.fixture(scope="module")
def replicated(worlds):
    """The port's replicated run: the state's leaves after each substep."""
    pw = worlds[1]
    return _run(SubstepGraph(pw.stepper, pw.state, FIXED_DT))


def _same(a, b):
    """(bit-equal, the differing leaves' count); asserts the 1e-5 bound
    where the bits differ."""
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    for i in differ:
        np.testing.assert_allclose(b[i].double().numpy(),
                                   a[i].double().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"leaf {i}")
    return not differ, len(differ)


def test_padded_scene_matches_reference(worlds):
    """pad_entities_to=8 appends dormant slots (alive False) until the
    count divides: the reference's entity table and state, which
    ``interop.world_state`` carries across unchanged."""
    js, pw = worlds
    n = pw.spec.n_entities
    assert n == js["spec"].n_entities and n % PAD == 0 and n > 13
    assert pw.spec.names == js["spec"].names
    alive = pw.state.alive.numpy()
    assert alive[:13].all() and not alive[13:].any()
    W.compare_states(js["state"], pw.state, atol=0, rtol=0)
    carried = interop.world_state(js["state"], device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(state_leaves(carried), state_leaves(pw.state)))


def test_texture_size_matches_reference(rig, monkeypatch):
    """``build_demo_scene(texture_size=)`` is the reference's SGE_TEX_SIZE
    (scene/demo_scene.py:121, read when the scene is built): the same
    texture bank, texel for texel."""
    monkeypatch.setenv("SGE_TEX_SIZE", "64")
    js = DemoScene(asset_dir=rig, include_imported_assets=False).build()
    pw = build_demo_scene(rig, device="cpu", include_imported_assets=False,
                          texture_size=64)
    want = np.asarray(js["geometry"].textures.data)
    assert want.shape[1] == pw.geometry.textures.size == 64
    np.testing.assert_array_equal(pw.geometry.textures.data.numpy(), want)


@pytest.mark.parametrize("shards", SHARDS)
def test_virtual_shards_equal_replicated(worlds, replicated, shards):
    """1, 2, 4 and 8 virtual shards: the state after every substep is the
    replicated run's, bit for bit (else within 1e-5, reported)."""
    pw = worlds[1]
    sharded = SH.shard_world_state(shards, pw.state)
    assert len(sharded.ranges) == shards
    assert sharded.ranges[0][0] == 0 and \
        sharded.ranges[-1][1] == pw.spec.n_entities
    got = _run(SH.EntityShardedSubstep(pw.stepper, sharded, FIXED_DT,
                                       shards))
    for k, (a, b) in enumerate(zip(replicated, got)):
        bits, n_diff = _same(a, b)
        print(f"{shards} shards, substep {k + 1}: "
              f"{'bit-equal' if bits else f'{n_diff} leaves within 1e-5'}")
        assert bits, f"substep {k + 1}: {n_diff} leaves differ in bits"


def test_gloo_group_equals_replicated(rig, replicated, tmp_path):
    """A 2-rank gloo group, one process each: ``EntityShardedSubstep``
    over the group leaves every rank holding the replicated run's state,
    bit for bit."""
    inputs = str(tmp_path / "inputs.pt")
    torch.save(dict(substeps=SUBSTEPS, asset_dir=rig, pad_entities_to=PAD),
               inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_shard_worker.py"),
         str(r), "2", str(tmp_path / "store"), inputs,
         str(tmp_path / f"out{r}.pt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    want = replicated[-1]
    for r in range(2):
        out = torch.load(str(tmp_path / f"out{r}.pt"))
        assert len(out["ranges"]) == 2
        bits, n_diff = _same(want, out["sim"])
        assert bits, (r, n_diff)


def test_sharded_substeps_match_reference(worlds):
    """8 virtual shards against the JAX entity-sharded substep on the
    8-device mesh, one substep at a time from the port's state (1e-4;
    ``reference_reaches`` where a tie parts them)."""
    js, pw = worlds
    assert len(jax.devices()) >= 8, "conftest must provision 8 CPU devices"
    mesh = JSH.make_mesh(jax.devices()[:8])
    jstep = js["stepper"]
    jsub = jax.jit(lambda st: jstep._substep_impl(st, jnp.float32(W.DT)))
    sim = SH.EntityShardedSubstep(pw.stepper,
                                  SH.shard_world_state(8, pw.state),
                                  FIXED_DT, 8)
    before = W.to_jax(pw.state, js["state"])
    p_before = pw.state
    for k in range(SUBSTEPS):
        sim.step()
        p_after = sim.state
        want = jsub(JSH.shard_world_state(mesh, before))
        try:
            W.compare_states(want, p_after,
                             lambda: W.soup_tris(before, jstep), atol=1e-4)
        except AssertionError as err:
            how = W.reference_reaches(jstep, before, p_before, p_after)
            assert how is not None, f"substep {k + 1}: {err}"
            print(f"substep {k + 1}: a tie; the reference reaches the "
                  f"port's state from {how}")
        p_before = [x.clone() for x in state_leaves(p_after)]
        p_before = type(pw.state)(*_rebuild(pw.state, p_before))
        before = W.to_jax(p_before, js["state"])


def _rebuild(like, leaves):
    from swift_game_engine_tpu_torch.ecs.world import rebuild_state
    return rebuild_state(like, iter(leaves))


def test_crowd_three_shards_equal_replicated():
    """The 70-agent crowd (separation's grid branch) on 3 shards, a count
    that 3 does not divide (24/23/23 rows): bit for bit the replicated
    run's after every substep."""
    stepper, state = bench_crowd.build(70, device="cpu")
    assert state.alive.shape[0] % 3 and int(
        stepper.spec.controller_params.active.sum()) > GRID_MIN_N
    want = _run(SubstepGraph(stepper, state, FIXED_DT))
    sharded = SH.shard_world_state(3, state)
    assert [hi - lo for lo, hi in sharded.ranges] == [27, 26, 26]
    got = _run(SH.EntityShardedSubstep(stepper, sharded, FIXED_DT, 3))
    for k, (a, b) in enumerate(zip(want, got)):
        bits, n_diff = _same(a, b)
        assert bits, f"substep {k + 1}: {n_diff} leaves differ in bits"


def test_entity_ranges():
    assert SH.entity_ranges(8, 8) == tuple((i, i + 1) for i in range(8))
    assert SH.entity_ranges(10, 4) == ((0, 3), (3, 6), (6, 8), (8, 10))
    with pytest.raises(ValueError):
        SH.entity_ranges(3, 4)


def test_entity_sharded_fused_step_matches_reference(worlds, replicated):
    """``sharded_fused_step`` on an entity-sharded state (2 virtual
    shards, for entities and rays) at test_multichip.py:177's setting
    against the JAX one on the 8-device mesh: the state at 1e-4, the image
    at the traversal tolerance. Its state is the replicated run's after 2
    substeps bit for bit (so its extraction and image are the
    replicated-state step's), and keeps its partition."""
    js, pw = worlds
    w, h = 64, 32
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 14.0], np.float32)
    cam.target = np.array([0.0, 0.0, 0.0], np.float32)
    ivp = cam.inv_view_proj(w, h)
    ibl = IBL.build()
    mesh = JSH.make_mesh(jax.devices()[:8])
    jstep = JSH.sharded_fused_step(mesh, js, ibl, w, h, n_substeps=2,
                                   max_layers=1, shadow_layers=1)
    jst, jimg = jstep(JSH.shard_world_state(mesh, js["state"]),
                      jnp.asarray(ivp), jnp.asarray(cam.position),
                      jnp.zeros(3))
    step = SH.sharded_fused_step(2, pw, interop.ibl(ibl, device="cpu"), w,
                                 h, n_substeps=2, device="cpu")
    pst, img = step(SH.shard_world_state(2, pw.state), torch.as_tensor(ivp),
                    cam.position, torch.zeros(3))
    assert isinstance(pst, SH.ShardedWorldState) and len(pst.ranges) == 2
    assert all(torch.equal(a, b) for a, b in
               zip(replicated[1], state_leaves(pst.state)))
    W.compare_states(jst, pst.state, atol=1e-4)
    assert img.shape == (h, w, 3) and float(img.std()) > 1e-3
    T._agree(img.numpy(), np.asarray(jimg), 0.99, 5e-3)


def _unsharded(stepper, state, dts):
    """``Stepper._substep_impl`` (no entity range) and, from the same
    state, the stages over one range that spans every entity
    (``EntityShardedSubstep`` on one virtual shard: ``_move`` and
    ``_separate`` with rows (0, n)), asserted bit for bit equal after
    every substep."""
    whole, staged = [state], [state]
    for dt in dts:
        whole.append(stepper._substep_impl(whole[-1], dt))
        sim = SH.EntityShardedSubstep(
            stepper, SH.shard_world_state(1, staged[-1]), dt, 1)
        assert sim.ranges == ((0, int(state.alive.shape[0])),)
        sim.step()
        staged.append(sim.state)
    for k, (a, b) in enumerate(zip(whole, staged)):
        assert all(torch.equal(x, y) for x, y in zip(state_leaves(a),
                                                       state_leaves(b))), \
            f"substep {k}: the staged substep differs in bits"


@pytest.mark.parametrize("agents", [16, 70])
def test_unsharded_substep_unchanged(agents):
    """The unsharded substep of the reference's crowd (16 agents: the
    dense separation; 70: the grid) is its stages composed over one range
    that spans every agent, bit for bit after every one of 4 substeps.
    The unsharded substep's own anchor to the JAX one is
    tests/test_torch_sim_crowd.py."""
    stepper, st = bench_crowd.build(agents, device="cpu")
    _unsharded(stepper, st, [FIXED_DT] * SUBSTEPS)


def test_unsharded_posed_substep_unchanged(rig):
    """The small DemoScene posed from the synthetic rig (the pose systems
    in the substep), unpadded: 3 substeps of 1/60 s and 3 of 1/24 s
    (``dt`` rounded to f32), the unsharded substep equal to its stages
    over one range bit for bit. Its anchor to the JAX substep is
    tests/test_torch_pose_step.py."""
    dts = [1 / 60] * 3 + [1 / 24] * 3
    w = build_demo_scene(rig, device="cpu", include_imported_assets=False)
    _unsharded(w.stepper, w.state, dts)
