"""PyTorch port, the RT frame's "raster" and "peels" primaries (CPU).

``render_frame(primary="raster")`` takes layer 1's visibility from one
cluster raster (K1) of every triangle and traces the continuation layers
from offset origins (K4); ``primary="peels"`` takes every layer's records
from one peeled cluster raster (K1, max_layers layers, opaque fragments
ending a pixel's walk). On tests/test_torch_trace_frame.py's scene at 96x54
(the port through its plain twins) each is held:

  * against the JAX frame of the same mode (the reference's
    ``_RT_PRIMARY`` set by monkeypatch; the suite's pure-JAX traversal
    for the continuation and shadow rays), with test_torch_trace_frame's
    tolerance against that traversal: >= 99% of pixels within 1e-4, the
    means within 0.5%;
  * against the port's own "trace" frame with tests/test_rt_raster_
    primary.py's tolerance: more than 97% of pixels within 1e-4 (the rest
    are sub-pixel triangle edges), the means within 1%.

Both primaries also run through the Engine (``Engine(primary=...)``,
whose frame program is the captured frame on the card).
"""

import os
import sys

import numpy as np
import pytest
import torch

from swift_game_engine_tpu.render import rt as j_rt
from swift_game_engine_tpu_torch.render import tile_raster as p_tr
from swift_game_engine_tpu_torch.scene.engine import Engine

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_trace_frame as T  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def scene():
    return T.build_scene()


@pytest.fixture(scope="module")
def traced(scene):
    return T._port_render(scene, T.camera(), scene[1], primary="trace")


@pytest.mark.parametrize("primary", ["raster", "peels"])
def test_primary_matches_reference_frame(scene, traced, primary,
                                         monkeypatch):
    layers = []
    cluster_raster = p_tr.cluster_raster

    def counted(*a, **k):
        layers.append(a[5])
        return cluster_raster(*a, **k)

    monkeypatch.setattr(p_tr, "cluster_raster", counted)
    out = T._port_render(scene, T.camera(), scene[1], primary=primary)
    # K1 once, over every triangle
    assert layers == [T.LAYERS if primary == "peels" else 1]
    monkeypatch.setattr(j_rt, "_RT_PRIMARY", primary)
    ref = np.asarray(T.reference_render(scene, T.camera(), scene[1]))
    T._agree(out, ref, 0.99, 5e-3)
    same = float((np.abs(out - traced).max(-1) < 1e-4).mean())
    print(f"{same:.5f} of pixels within 1e-4 of the port's traced frame")
    assert same > 0.97, same
    assert abs(out.mean() - traced.mean()) < 0.01 * traced.mean()


@pytest.mark.parametrize("primary", ["raster", "peels"])
def test_engine_takes_primary(scene, primary):
    world = T._port_world(scene, [0.0, 0.5, 1.0])
    eng = Engine(world, T.W, T.H, primary=primary, max_layers=T.LAYERS,
                 shadow_layers=T.SHADOW_LAYERS, device="cpu")
    img = eng.frame(1 / 60)
    assert img.shape == (T.H, T.W, 3) and img.dtype == torch.uint8
    assert float(img.float().std()) > 1.0
    u8, _ = eng.program().eager()
    assert torch.equal(u8, img)
