"""PyTorch port: ``sharded_fused_step`` on an entity-sharded state, the
body the card captures (parallel/sharding.py ``ShardedFusedStep``: the
substep graph and the graph of the extraction and the sharded render) run
eagerly on the CPU, against the JAX reference's fused step.

The world is tests/test_torch_entity_sharding.py's: the DemoScene without
its imported assets, built by both packages from the synthetic rig's
directory (tests/torch_pose_rig.py), padded to a multiple of 8 entities.
The port steps it over 3 virtual shards and over a one-rank gloo group,
four steps of one substep with the player's intent changed before each;
the JAX ``sharded_fused_step`` on the 8-device mesh starts each step from
the port's state with the same intent. Tolerances are that file's: the
state at 1e-4 (``reference_reaches`` where a tie of f32 rounding parts
them), the image at the traversal tolerance of
tests/test_torch_sharding.py.
"""

import os
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
from swift_game_engine_tpu_torch.parallel import sharding as SH
from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_trace_frame as T  # noqa: E402
import torch_pose_rig as R  # noqa: E402
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "assets")
PAD = 8


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The padded small DemoScene: (the reference's scene dict, the port's
    world)."""
    rig = R.write_rig(str(tmp_path_factory.mktemp("rig")), ASSETS)
    return (DemoScene(asset_dir=rig, include_imported_assets=False,
                      pad_entities_to=PAD).build(),
            build_demo_scene(rig, device="cpu", include_imported_assets=False,
                             pad_entities_to=PAD))


# the player's MoveIntent before each fused step: (velocity, yaw, jump)
INTENTS = (((0.0, 0.0, 2.0), 0.0, False), ((1.5, 0.0, 1.0), 0.6, False),
           ((-1.0, 0.0, 0.5), -0.4, True), ((0.0, 0.0, -2.5), 3.0, False))


def _set_intent(state, e, vel, yaw, jump):
    """The port state's entity ``e`` MoveIntent, as
    ``W.set_player_intent`` sets the JAX one."""
    state.intent_vel[e] = torch.tensor(vel)
    state.intent_jump[e] = jump
    state.intent_has_yaw[e] = True
    state.intent_yaw[e] = yaw


@pytest.fixture(scope="module")
def jax_fused(worlds):
    """The JAX ``sharded_fused_step`` (one substep) on the 8-device mesh at
    test_multichip.py:177's setting, its camera and IBL."""
    js, _ = worlds
    w, h = 64, 32
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 14.0], np.float32)
    cam.target = np.array([0.0, 0.0, 0.0], np.float32)
    ibl = IBL.build()
    mesh = JSH.make_mesh(jax.devices()[:8])
    return dict(mesh=mesh, cam=cam, ivp=cam.inv_view_proj(w, h), ibl=ibl,
                w=w, h=h, step=JSH.sharded_fused_step(
                    mesh, js, ibl, w, h, n_substeps=1, max_layers=1,
                    shadow_layers=1))


@pytest.mark.parametrize("group", ["virtual_3", "gloo_1"])
def test_fused_steps_with_intents_match_reference(worlds, jax_fused, group,
                                                  tmp_path):
    """The body the card captures, run eagerly: one ``sharded_fused_step``
    on a ShardedWorldState over 3 virtual shards, and over a one-rank gloo
    group (``make_group(..., device="cpu")``), for 4 steps of one substep
    with the player's intents changing between them, each against the
    JAX fused step from the same state with the same intents: the state at
    1e-4 (``reference_reaches`` where a tie of f32 rounding parts them),
    the image at the traversal tolerance. The step keeps its partition."""
    js, pw = worlds
    j = jax_fused
    g = SH.make_group(0, 1, "file://" + str(tmp_path / "store"),
                      device="cpu") if group == "gloo_1" else 3
    try:
        step = SH.sharded_fused_step(g, pw, interop.ibl(j["ibl"],
                                                        device="cpu"),
                                     j["w"], j["h"], n_substeps=1,
                                     device="cpu")
        state = SH.shard_world_state(g, pw.state)
        assert len(state.ranges) == (3 if group == "virtual_3" else 1)
        for k, (vel, yaw, jump) in enumerate(INTENTS):
            before = state.state._replace(**{
                f: getattr(state.state, f).clone() for f in (
                    "intent_vel", "intent_jump", "intent_has_yaw",
                    "intent_yaw")})
            _set_intent(before, pw.player, vel, yaw, jump)
            jbefore = W.set_player_intent(W.to_jax(before, js["state"]),
                                          pw.player, vel, yaw, jump)
            state, img = step(SH.ShardedWorldState(before, state.ranges),
                              torch.as_tensor(j["ivp"]), j["cam"].position,
                              torch.zeros(3))
            assert isinstance(state, SH.ShardedWorldState)
            jst, jimg = j["step"](JSH.shard_world_state(j["mesh"], jbefore),
                                  jnp.asarray(j["ivp"]),
                                  jnp.asarray(j["cam"].position),
                                  jnp.zeros(3))
            try:
                W.compare_states(jst, state.state, atol=1e-4)
            except AssertionError as err:
                how = W.reference_reaches(js["stepper"], jbefore, before,
                                          state.state)
                assert how is not None, f"step {k + 1}: {err}"
                print(f"step {k + 1}: a tie; the reference reaches the "
                      f"port's state from {how}")
            assert img.shape == (j["h"], j["w"], 3) and \
                float(img.std()) > 1e-3
            T._agree(img.numpy(), np.asarray(jimg), 0.99, 5e-3)
        moved = state.state.body_pos[pw.player] - pw.state.body_pos[pw.player]
        assert float(moved.abs().max()) > 1e-3
        with pytest.raises(ValueError, match="entity partition"):
            step(SH.shard_world_state(2 if group == "virtual_3" else 3,
                                      pw.state) if group == "virtual_3"
                 else pw.state, torch.as_tensor(j["ivp"]),
                 j["cam"].position, torch.zeros(3))
    finally:
        if group == "gloo_1":
            torch.distributed.destroy_process_group()
