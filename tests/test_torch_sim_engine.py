"""PyTorch port, the stepping ``Engine.frame`` vs the JAX reference's Engine
(``pipeline_depth=1``) on the CPU.

One small world (test_world_step.py's ground, player and elevator, with
render meshes for each: ``torch_sim_worlds.engine_scenes``) is built by
the reference and carried across with ``interop``. Both Engines take
three 1/60 s frames of ``InputFrame(ly=1.0)`` at 64x36: one substep each,
the chase camera from the previous frame's player snapshot, extraction,
render, composite. The
reference renders with its CPU test configuration (traced visibility,
tests/conftest.py sets SGE_JAX_TRAVERSAL=1), the port with hybrid raster
visibility; they differ by design at sub-pixel triangle edges, so the u8
frames are held as tests/test_torch_frame.py holds them (>= 97% of pixels
within one level). The player snapshots (previous and current world
position, dodge flag) agree within 1e-4.
"""

import os
import sys

import numpy as np
import pytest

from swift_game_engine_tpu.scene.engine import Engine as JEngine
from swift_game_engine_tpu.scene.input import InputFrame as JInput
from swift_game_engine_tpu_torch.scene.engine import Engine
from swift_game_engine_tpu_torch.scene.input import InputFrame

sys.path.insert(0, os.path.dirname(__file__))
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

W_, H_ = 64, 36
LAYERS, SHADOW_LAYERS = 2, 1


def test_stepping_engine_frames_match_reference():
    jscene, world = W.engine_scenes()
    jeng = JEngine(jscene, W_, H_, path="rt", max_layers=LAYERS,
                   shadow_layers=SHADOW_LAYERS, pipeline_depth=1)
    peng = Engine(world, W_, H_, path="rt", max_layers=LAYERS,
                  shadow_layers=SHADOW_LAYERS, device="cpu")
    assert peng.time_scale == 1.0 == jeng.time_scale
    for i in range(3):
        ref = np.asarray(jeng.frame(1 / 60, JInput(ly=1.0)))
        out = peng.frame(1 / 60, InputFrame(ly=1.0)).numpy()
        assert peng.substeps == 1
        assert out.shape == ref.shape == (H_, W_, 3)
        close = np.abs(out.astype(int) - ref.astype(int)).max(-1) <= 1
        assert close.mean() >= 0.97, (i, close.mean())
        np.testing.assert_allclose(peng._snap, np.asarray(jeng._snap),
                                   atol=1e-4)
    assert peng.accumulator == pytest.approx(jeng.accumulator, abs=1e-9)
    assert peng.time == pytest.approx(jeng.time)
