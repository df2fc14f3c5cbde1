"""Procedural mesh generators.

The port's copy of the primitives of swift_game_engine_tpu/assets/
procedural_meshes.py that the DemoScene uses (reference:
Game/ProceduralMeshes.swift:130-738) — plane, box, ramp, dome and capsule,
with the same geometry, built vectorized in numpy.
"""

from __future__ import annotations

import numpy as np

from .mesh_api import MeshDescriptor

TWO_PI = 2.0 * np.pi


def _mesh(name, positions, normals, uvs, indices) -> MeshDescriptor:
    return MeshDescriptor(
        positions=np.asarray(positions, np.float32).reshape(-1, 3),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        indices=np.asarray(indices, np.int32).reshape(-1),
        name=name)


def _face_quads(quads, name):
    """Build a mesh from a list of (normal, p0, p1, p2, p3) flat-shaded quads."""
    pos, nrm, uv, idx = [], [], [], []
    for n, p0, p1, p2, p3 in quads:
        base = len(pos)
        pos += [p0, p1, p2, p3]
        nrm += [n] * 4
        uv += [(0, 0), (1, 0), (1, 1), (0, 1)]
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return pos, nrm, uv, idx


def _tri_normal(a, b, c):
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    n = np.cross(b - a, c - a)
    return (n / np.linalg.norm(n)).astype(np.float32)


def plane(size: float = 20.0) -> MeshDescriptor:
    s = size * 0.5
    pos = [(-s, 0, s), (s, 0, s), (s, 0, -s), (-s, 0, -s)]
    return _mesh("plane", pos, [(0, 1, 0)] * 4,
                 [(0, 0), (1, 0), (1, 1), (0, 1)], [0, 1, 2, 0, 2, 3])


def box(size: float = 4.0) -> MeshDescriptor:
    s = size * 0.5
    quads = [
        ((0, 0, 1), (-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)),
        ((0, 0, -1), (s, -s, -s), (-s, -s, -s), (-s, s, -s), (s, s, -s)),
        ((1, 0, 0), (s, -s, s), (s, -s, -s), (s, s, -s), (s, s, s)),
        ((-1, 0, 0), (-s, -s, -s), (-s, -s, s), (-s, s, s), (-s, s, -s)),
        ((0, 1, 0), (-s, s, s), (s, s, s), (s, s, -s), (-s, s, -s)),
        ((0, -1, 0), (-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)),
    ]
    return _mesh("box", *_face_quads(quads, "box"))


def ramp(width: float = 8.0, depth: float = 8.0, height: float = 4.0) -> MeshDescriptor:
    w, d, h = width * 0.5, depth * 0.5, height * 0.5
    fl, fr = (-w, -h, d), (w, -h, d)
    bl, br = (-w, -h, -d), (w, -h, -d)
    blt, brt = (-w, h, -d), (w, h, -d)
    pos, nrm, uv, idx = [], [], [], []

    def tri(a, b, c):
        n = _tri_normal(a, b, c)
        base = len(pos)
        pos.extend([a, b, c]); nrm.extend([n] * 3)
        uv.extend([(0, 0), (1, 0), (0.5, 1)])
        idx.extend([base, base + 1, base + 2])

    def quad(p0, p1, p2, p3):
        n = _tri_normal(p0, p1, p2)
        base = len(pos)
        pos.extend([p0, p1, p2, p3]); nrm.extend([n] * 4)
        uv.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
        idx.extend([base, base + 1, base + 2, base, base + 2, base + 3])

    quad(fl, fr, br, bl)        # bottom
    quad(bl, br, brt, blt)      # back
    quad(blt, brt, fr, fl)      # sloped top
    tri(bl, blt, fl)            # left
    tri(fr, brt, br)            # right
    return _mesh("ramp", pos, nrm, uv, idx)


def dome(radius: float = 4.0, radial_segments: int = 32,
         ring_segments: int = 12) -> MeshDescriptor:
    slices = max(radial_segments, 3)
    rings = max(ring_segments, 2)

    t = np.linspace(0.0, 1.0, rings + 1, dtype=np.float32)[:, None]
    theta = t * (np.pi * 0.5)
    u = np.linspace(0.0, 1.0, slices + 1, dtype=np.float32)[None, :]
    phi = u * TWO_PI
    y = np.cos(theta) * radius
    ring_r = np.sin(theta) * radius
    x = np.cos(phi) * ring_r
    z = np.sin(phi) * ring_r
    yy = np.broadcast_to(y, x.shape)
    pos = np.stack([x, yy, z], axis=-1).reshape(-1, 3)
    nrm = pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True), 1e-8)
    uvs = np.stack(np.broadcast_arrays(u, 1.0 - t), axis=-1).reshape(-1, 2)

    stride = slices + 1
    r_idx = np.arange(rings)[:, None]
    s_idx = np.arange(slices)[None, :]
    i0 = r_idx * stride + s_idx
    i1 = (r_idx + 1) * stride + s_idx
    i2 = (r_idx + 1) * stride + s_idx + 1
    i3 = r_idx * stride + s_idx + 1
    idx = np.stack([i0, i1, i2, i0, i2, i3], axis=-1).reshape(-1)

    # Flat base disk.
    base_center = len(pos)
    cphi = phi[0]
    bx = np.cos(cphi) * radius
    bz = np.sin(cphi) * radius
    base_pos = np.concatenate([np.zeros((1, 3), np.float32),
                               np.stack([bx, np.zeros_like(bx), bz], axis=-1)])
    base_uv = np.concatenate([np.array([[0.5, 0.5]], np.float32),
                              np.stack([0.5 + 0.5 * np.cos(cphi), 0.5 + 0.5 * np.sin(cphi)], axis=-1)])
    base_nrm = np.tile(np.array([[0, -1.0, 0]], np.float32), (len(base_pos), 1))
    s = np.arange(slices)
    base_idx = np.stack([np.full(slices, base_center),
                         base_center + 1 + s + 1,
                         base_center + 1 + s], axis=-1).reshape(-1)

    return _mesh("dome",
                 np.concatenate([pos, base_pos]),
                 np.concatenate([nrm, base_nrm]),
                 np.concatenate([uvs, base_uv]),
                 np.concatenate([idx, base_idx]))


def capsule(radius: float = 1.5, half_height: float = 1.0,
            radial_segments: int = 24, hemisphere_segments: int = 8) -> MeshDescriptor:
    """Y-axis capsule: hemisphere caps + cylinder band, seamless rings.

    Geometry parity with Game/ProceduralMeshes.swift:648-725 (rings top
    hemisphere -> optional bottom equator -> bottom hemisphere; normals from
    the relevant sphere center / cylinder axis; slice wrap via modulo).
    """
    slices = max(radial_segments, 3)
    hemi = max(hemisphere_segments, 2)

    ring_y, ring_r, ring_cy = [], [], []
    for i in range(hemi + 1):
        th = (i / hemi) * (np.pi * 0.5)
        ring_y.append(half_height + np.cos(th) * radius)
        ring_r.append(np.sin(th) * radius)
        ring_cy.append(half_height)
    if half_height > 0:
        ring_y.append(-half_height)
        ring_r.append(radius)
        ring_cy.append(None)
    for i in range(hemi - 1, -1, -1):
        th = (i / hemi) * (np.pi * 0.5)
        ring_y.append(-half_height - np.cos(th) * radius)
        ring_r.append(np.sin(th) * radius)
        ring_cy.append(-half_height)

    y_arr = np.asarray(ring_y, np.float32)
    min_y, max_y = y_arr.min(), y_arr.max()
    inv_range = 1.0 / (max_y - min_y) if max_y > min_y else 0.0

    u = np.arange(slices, dtype=np.float32) / slices
    ang = u * TWO_PI
    ca, sa = np.cos(ang), np.sin(ang)

    pos, nrm, uvs = [], [], []
    for y, r, cy in zip(ring_y, ring_r, ring_cy):
        x = ca * r
        z = sa * r
        p = np.stack([x, np.full(slices, y, np.float32), z], axis=-1)
        if cy is None:
            n = np.stack([x, np.zeros(slices, np.float32), z], axis=-1)
        else:
            n = np.stack([x, np.full(slices, y - cy, np.float32), z], axis=-1)
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-8)
        pos.append(p); nrm.append(n)
        uvs.append(np.stack([u, np.full(slices, (y - min_y) * inv_range, np.float32)], axis=-1))

    ring_count = len(ring_y)
    r_idx = np.arange(ring_count - 1)[:, None]
    s_idx = np.arange(slices)[None, :]
    s1 = (s_idx + 1) % slices
    a = r_idx * slices + s_idx
    b = r_idx * slices + s1
    c = (r_idx + 1) * slices + s_idx
    d = (r_idx + 1) * slices + s1
    idx = np.stack([a, c, b, b, c, d], axis=-1).reshape(-1)

    return _mesh("capsule", np.concatenate(pos), np.concatenate(nrm),
                 np.concatenate(uvs), idx)
