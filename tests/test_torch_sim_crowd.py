"""PyTorch port, trajectories of a crowd above the separation grid's
threshold and of a chunk crossing, vs the JAX reference (CPU).

72 agents (more than ``GRID_MIN_N`` = 64: the separation sorts them into
the XZ grid, ``torch.argsort(stable=True)`` as ``jnp.argsort``) packed
into a 30x30 patch with obstacles, a third of them oscillating; and a
player walking across the chunk border x = 256 while a box four chunks
away stays outside the active radius. Held as
tests/test_torch_sim_trajectory.py holds trajectories (positions within
1e-3 every substep, every field at the end, the reference's ties proven
and named).
"""

import os
import sys

import numpy as np
import torch

from swift_game_engine_tpu.physics import separation as JSep
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.physics import separation as PSep

sys.path.insert(0, os.path.dirname(__file__))
import torch_sim_worlds as W  # noqa: E402
from test_torch_sim_trajectory import run_both  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


def test_separation_grid_matches_dense_threshold():
    """The port's grid cutoff and cell cap are the reference's defaults."""
    assert PSep.GRID_MIN_N == JSep._GRID_MIN_N == 64
    assert PSep.CELL_CAP == JSep._CELL_CAP


def test_separation_grid_step_matches_reference():
    """One separation pass of 72 overlapping agents, grid path in both."""
    jspec, jstate, jstep, h, local = W.jax_world(W.crowd)
    from swift_game_engine_tpu.physics.collision_world import transform_soup
    from swift_game_engine_tpu.scene.step import _trs_matrices
    import jax.numpy as jnp
    hb = jnp.asarray(jspec.has_body)[:, None]
    jsoup = transform_soup(local, _trs_matrices(
        jnp.where(hb, jstate.body_pos, jstate.trs_t),
        jnp.where(hb, jstate.body_rot, jstate.trs_r), jstate.trs_s))
    from swift_game_engine_tpu_torch.physics.collision_world import \
        TriangleSoup
    psoup = TriangleSoup(*(interop._keep(np.asarray(x), "cpu")
                           for x in jsoup))
    cp = jspec.controller_params
    ref = JSep.separate_agents(jsoup, jstate.body_pos, jstate.body_vel,
                               jstate.ctrl, cp)
    port = PSep.separate_agents(
        psoup, torch.as_tensor(np.asarray(jstate.body_pos)),
        torch.as_tensor(np.asarray(jstate.body_vel)),
        interop.world_state(jstate, device="cpu").ctrl,
        interop.controller_params(cp, device="cpu"))
    moved = np.abs(np.asarray(ref[0]) - np.asarray(jstate.body_pos)).max(-1)
    assert (moved > 1e-3).sum() >= 10          # the grid found pairs
    gap = np.maximum(np.abs(port[0].numpy() - np.asarray(ref[0])).max(-1),
                     np.abs(port[1].numpy() - np.asarray(ref[1])).max(-1))
    bad = np.nonzero(gap > 1e-4)[0]
    if len(bad):
        # a rounding tie of the reference: its op-by-op run (no fused
        # multiply-adds) gives the port's result for those agents (the
        # re-snap cast's region check at a triangle's edge)
        import jax
        with jax.disable_jit():
            eager = JSep.separate_agents(jsoup, jstate.body_pos,
                                         jstate.body_vel, jstate.ctrl, cp)
        for e in bad:
            np.testing.assert_allclose(port[0][e].numpy(),
                                       np.asarray(eager[0])[e], atol=1e-4)
            print(f"agent {e}: the jitted reference parts by {gap[e]:.3g}; "
                  f"its op-by-op run gives the port's result")
    assert len(bad) <= 2
    for f in ("grounded", "grounded_near", "ground_tri", "query_casts"):
        x, y = getattr(port[2], f).numpy(), np.asarray(getattr(ref[2], f))
        assert all(e in bad for e in np.nonzero(x != y)[0]), f


def test_trajectory_crowd_grid():
    """30 substeps of the 72-agent crowd: falls, landings, pushes."""
    js, ps, h, _ = run_both(W.crowd, 30)
    assert int(ps.ctrl.grounded.sum()) >= 60


def test_trajectory_chunk_crossing():
    """The player walks +x across x = 256 (chunk 0 -> 1): the chunk and
    local position of both packages follow, and the far box stays out of
    the active set (its collision drops out)."""
    def walk(i, js, ps, h):
        if i == 0:
            js = W.set_player_intent(js, h["player"], [12.0, 0, 0],
                                     yaw=-np.pi / 2)
            ps = interop.world_state(js, device="cpu")
        return js, ps

    js, ps, h, _ = run_both(W.chunk_edge, 40, walk)
    p = h["player"]
    assert int(ps.wp_chunk[p, 0]) == 1 and int(js.wp_chunk[p, 0]) == 1
    assert float(ps.wp_local[p, 0]) < -200.0    # just past the border
