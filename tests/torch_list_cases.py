"""Adversarial candidate lists of the list rasters K9 and K10, shared by
the CPU tests of their patch cull (tests/test_torch_list_cull.py) and the
card tests of the kernels (tests/test_torch_cuda_kernels.py): seeded
world-space triangles of each adversarial case, for the port's list binning
(``setup_lists``), and rows built directly whose edge forms vanish at a
patch corner to a few ulps. Imports no jax, so the card tests can use it
without the conftest.
"""

import numpy as np
import torch

from swift_game_engine_tpu_torch.render import tile_raster as TR


def _soup(rng, t, spread=10.0, size=2.0):
    base = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    return (base,
            base + rng.uniform(-size, size, (t, 3)).astype(np.float32),
            base + rng.uniform(-size, size, (t, 3)).astype(np.float32))


def _quad(z, dup):
    """Two triangles of the plane z, each repeated ``dup`` times in a row
    (coplanar fragments at equal depth)."""
    a, b, c, d = ([-40, -30, z], [40, -30, z], [40, 40, z], [-40, 40, z])
    return [t for t in ((a, b, c), (a, c, d)) for _ in range(dup)]


def triangles(case):
    """Seeded world-space triangles (v0, v1, v2) of one adversarial case,
    seen from a camera at (0, 4, 22) looking at the origin."""
    rng = np.random.default_rng(61)
    if case == "soup":
        return _soup(rng, 2000)
    if case == "far_slivers":
        # far (w ~ 300) needles and specks, ill-conditioned edge forms,
        # among far triangles a few pixels wide
        n = 1500
        base = rng.uniform([-150, -80, -320], [150, 80, -280],
                           (n, 3)).astype(np.float32)
        v1 = base + rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        v2 = v1 + rng.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32)
        speck = rng.uniform(-1e-2, 1e-2, (n, 3)).astype(np.float32)
        v2[n // 3:] = base[n // 3:] + speck[n // 3:]
        v1[n // 3:] = base[n // 3:] - speck[n // 3:, ::-1]
        v2[2 * n // 3:] = base[2 * n // 3:] + rng.uniform(
            -8, 8, (n - 2 * n // 3, 3)).astype(np.float32)
        near = _soup(rng, 300, size=0.02)
        return tuple(np.concatenate([a, b]) for a, b in
                     zip((base, v1, v2), near))
    if case == "crossing_w0":
        # a vertex behind the camera plane (z > 22), or all three
        v0, v1, v2 = _soup(rng, 600)
        v2[:300, 2] = rng.uniform(23, 60, 300)
        v0[300:340, 2] = rng.uniform(23, 60, 40)
        v1[300:340, 2] = rng.uniform(23, 60, 40)
        v2[300:340, 2] = rng.uniform(23, 60, 40)
        return v0, v1, v2
    if case == "screen_filling":
        # one triangle behind everything covers the screen, one crosses
        # the camera plane; degenerate (collinear) triangles among a soup
        v0, v1, v2 = _soup(rng, 800)
        v2[:100] = v0[:100] + 2.0 * (v1[:100] - v0[:100])
        big = np.array([[[-900, -900, -40], [900, -900, -40], [0, 900, -40]],
                        [[-50, -2, 30], [50, -2, 30], [0, -2, -50]]],
                       np.float32)
        return tuple(np.concatenate([v, big[:, i]])
                     for i, v in enumerate((v0, v1, v2)))
    assert case == "coplanar_ties"
    tris = np.array([t for z in np.arange(4) * -1.5 for t in _quad(z, 2)],
                    np.float32)
    near = _soup(rng, 400)
    return tuple(np.concatenate([tris[:, i], near[i]]) for i in range(3))


def borderline_rows(width, height, k):
    """Rows built directly, (tiles, k, 16) with every tile full: one edge
    form of each row vanishes, to within a few ulps, at a corner sample of
    some patch (a*x_c + b*y_c + c rounded in f32, c nudged by -3..3 ulps),
    the other two are -1 everywhere, so the corner pixel is inside exactly
    when the rounded form there is <= 0, and a cull off by one rounding or
    one comparison there drops it; among them all-zero rows, rows with inf or NaN coefficients, huge
    ones (up to 1e37, whose bounds are used, and 8e37, whose are not) and
    tiny (1e-38) ones. A row's vertex w's are all 1, 2 or 3, so its
    inside fragments lie at that depth: ties at every depth."""
    rng = np.random.default_rng(62)
    _, n_tiles, _, _ = TR._grid(width, height)
    x, y = (v.numpy() for v in TR._samples(width, height, "cpu"))
    lanes = TR._patch_lanes("cpu").numpy()
    rows = np.zeros((n_tiles, k, 16), np.float32)
    rows[:, :, 9:12] = rng.integers(1, 4, (n_tiles, k, 1))
    for t in range(n_tiles):
        patch = rng.integers(0, TR.N_PATCHES, k)
        corner = rng.choice([0, 7, 24, 31], k)
        xc = x[t, lanes[patch, corner]]
        yc = y[t, lanes[patch, corner]]
        a = (rng.choice([-1, 1], k) * 10.0 ** rng.uniform(-2, 4, k)).astype(
            np.float32)
        b = (rng.choice([-1, 1], k) * 10.0 ** rng.uniform(-2, 4, k)).astype(
            np.float32)
        c = -((a * xc) + (b * yc))
        for _ in range(3):
            step = rng.integers(-1, 2, k)
            c = np.where(step > 0, np.nextafter(c, np.float32(np.inf)),
                         np.where(step < 0,
                                  np.nextafter(c, np.float32(-np.inf)), c))
        slot = rng.integers(0, 3, k)
        form = np.tile(np.array([0, 0, -1], np.float32), (k, 3, 1))
        form[np.arange(k), slot] = np.stack([a, b, c], -1)
        rows[t, :, :9] = form.reshape(k, 9)
        special = rng.permutation(k)[:30]
        rows[t, special[0:5], :9] = 0.0
        rows[t, special[5:10], 0] = np.inf
        rows[t, special[10:15], 4] = np.nan
        rows[t, special[15:18], :9] = rng.uniform(-1e37, 1e37, (3, 9))
        rows[t, special[18:20], :9] = rng.uniform(-8e37, 8e37, (2, 9))
        rows[t, special[20:25], :9] = rng.uniform(-1e-38, 1e-38, (5, 9))
        rows[t, special[25:30], 2] = -np.inf
        rows[t, :, 12] = np.arange(k)
    counts = np.full(n_tiles, k, np.int32)
    return torch.from_numpy(rows), torch.from_numpy(counts)
