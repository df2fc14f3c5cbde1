"""PyTorch port: the patch cull of the list rasters K9 and K10 (CPU).

The kernels (csrc/raster_lists.cu) run a warp per 8x4 pixel patch and skip
a candidate row for the whole patch when they have proved that no pixel of
the patch can pass the f32 ``inside`` test: one edge form > 0 and another
< 0 at every pixel, each bounded over the patch's samples and widened by a
rounding margin. ``tile_raster.list_patch_cull_plain`` is that cull in plain
PyTorch. On seeded adversarial inputs, through the port's own list binning
(``setup_lists``) or as rows built directly (tests/torch_list_cases.py),
the test holds that no culled (tile, patch, row) has a pixel that passes
the twins' f32 ``inside`` test. Both twins act only on fragments that are
live and inside (K9's nearest-behind test, K10's insertion network), so a
row skipped where it is inside at no pixel changes no record: the culled
kernels keep the unculled twins' records, bit for bit.

The twins are held against the JAX kernels by tests/test_torch_raster.py,
and the CUDA kernels against the twins on the card, on the same
adversarial lists, by tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

from swift_game_engine_tpu_torch.render import tile_raster as TR
from swift_game_engine_tpu_torch.render.camera import Camera
from torch_list_cases import borderline_rows, triangles
from torch_threads import one_thread  # noqa: E402,F401

W, H = 256, 96


CASES = ["soup", "far_slivers", "crossing_w0", "screen_filling",
         "coplanar_ties", "borderline_rows"]


@pytest.fixture(scope="module", params=CASES)
def lists(request):
    """(case, counts, cand_rows, keep) at W x H."""
    case = request.param
    if case == "borderline_rows":
        cand, counts = borderline_rows(W, H, 128)
    else:
        cam = Camera()
        cam.position = np.array([0.0, 4.0, 22.0], np.float32)
        vp = torch.as_tensor(cam.view_proj(W, H))
        cand, counts, _ = TR.setup_lists(
            *(torch.as_tensor(v) for v in triangles(case)), vp, W, H, k=256)
    keep = TR.list_patch_cull_plain(counts, cand, W, H)
    return case, counts, cand, keep


def test_cull_never_drops_an_inside_pixel(lists):
    """No culled (tile, patch, row) has a pixel that passes ``inside``; the
    cull drops rows (most of a soup's) and keeps the inside ones."""
    case, counts, cand, keep = lists
    lanes = TR._patch_lanes("cpu")
    culled = inside_n = 0
    for j, (live, inside, *_) in enumerate(TR._list_candidates(
            counts, cand, W, H)):
        hit = (live & inside)[:, lanes].any(-1)          # (tiles, patches)
        dropped = ~keep[:, :, j] & live                  # live: (tiles, 1)
        assert not bool((dropped & hit).any()), (case, j)
        culled += int(dropped.sum())
        inside_n += int(hit.sum())
    live_n = int(counts.sum()) * TR.N_PATCHES
    assert inside_n > 0 and culled > 0
    if case == "soup":
        assert culled > 0.8 * live_n
