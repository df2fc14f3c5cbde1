"""Procedural mesh generators.

The port's copy of the primitives of swift_game_engine_tpu/assets/
procedural_meshes.py (reference: Game/ProceduralMeshes.swift:130-738) —
plane, box, tetrahedron, triangular prism, ramp, quad, dome and capsule,
with the same geometry — and its two skinned
bodies: ``skeleton_capsules``, the posed DemoScene player's body when the
skin file is absent, and ``humanoid_skinned``, a small posed test body.
"""

from __future__ import annotations

import numpy as np

from . import nputil
from .mesh_api import MeshDescriptor, SkinnedMeshDescriptor
from .skeleton import Skeleton

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


def tetrahedron(size: float = 4.0) -> MeshDescriptor:
    s = size * 0.5
    p0, p1, p2, p3 = (0, s, 0), (-s, -s, s), (s, -s, s), (0, -s, -s)
    pos, nrm, uv, idx = [], [], [], []
    for a, b, c in [(p0, p1, p2), (p0, p2, p3), (p0, p3, p1), (p1, p3, p2)]:
        n = _tri_normal(a, b, c)
        base = len(pos)
        pos += [a, b, c]
        nrm += [n] * 3
        uv += [(0, 0), (1, 0), (0.5, 1)]
        idx += [base, base + 1, base + 2]
    return _mesh("tetrahedron", pos, nrm, uv, idx)


def triangular_prism(size: float = 4.0, height: float = 3.0) -> MeshDescriptor:
    s, h = size * 0.5, height * 0.5
    a0, b0, c0 = (-s, -h, s), (s, -h, s), (0, -h, -s)
    a1, b1, c1 = (-s, h, s), (s, h, s), (0, h, -s)
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

    tri(a1, b1, c1)
    tri(a0, c0, b0)
    quad(a0, b0, b1, a1)
    quad(b0, c0, c1, b1)
    quad(c0, a0, a1, c1)
    return _mesh("triangularPrism", pos, nrm, uv, idx)


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


def quad(width: float = 1.0, height: float = 1.0,
         uv_min=(0.0, 0.0), uv_max=(1.0, 1.0)) -> MeshDescriptor:
    """UV-sub-rect quad in the XY plane (used by the FPS digit overlay)."""
    u0, v0 = uv_min
    u1, v1 = uv_max
    pos = [(0, 0, 0), (width, 0, 0), (width, height, 0), (0, height, 0)]
    return _mesh("quad", pos, [(0, 0, 1)] * 4,
                 [(u0, v0), (u1, v0), (u1, v1), (u0, v1)], [0, 1, 2, 0, 2, 3])


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


# ---------------------------------------------------------------------------
# Skinned test bodies


def _cylinder_grid(center, radius, height, radial_segs, height_segs):
    """Open cylinder grid with duplicated seam column; returns pos/nrm/uv/(t per row)."""
    slices = max(radial_segs, 3)
    stacks = max(height_segs, 1)
    t = np.linspace(0.0, 1.0, stacks + 1, dtype=np.float32)
    yy = center[1] - height * 0.5 + height * t
    u = np.linspace(0.0, 1.0, slices + 1, dtype=np.float32)
    theta = u * TWO_PI
    x = np.cos(theta) * radius + center[0]
    z = np.sin(theta) * radius + center[2]

    pos = np.stack([np.broadcast_to(x, (stacks + 1, slices + 1)),
                    np.broadcast_to(yy[:, None], (stacks + 1, slices + 1)),
                    np.broadcast_to(z, (stacks + 1, slices + 1))], axis=-1)
    n = np.stack([x - center[0], np.zeros_like(x), z - center[2]], axis=-1)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    nrm = np.broadcast_to(n, pos.shape)
    uv = np.stack(np.broadcast_arrays(u[None, :], t[:, None]), axis=-1)

    ring = slices + 1
    yi = np.arange(stacks)[:, None]
    si = np.arange(slices)[None, :]
    i0 = yi * ring + si
    i1 = (yi + 1) * ring + si
    i2 = (yi + 1) * ring + si + 1
    i3 = yi * ring + si + 1
    idx = np.stack([i0, i1, i2, i0, i2, i3], axis=-1).reshape(-1)

    t_per_vert = np.broadcast_to(t[:, None], (stacks + 1, slices + 1)).reshape(-1)
    return (pos.reshape(-1, 3).astype(np.float32), nrm.reshape(-1, 3).astype(np.float32),
            uv.reshape(-1, 2).astype(np.float32), idx.astype(np.int64), t_per_vert)


def humanoid_skinned(leg_height=1.8, leg_radius=0.35, torso_height=2.0,
                     torso_radius=0.5, hip_separation=0.45,
                     radial_segments=12, height_segments=4) -> SkinnedMeshDescriptor:
    """Procedural skinned test body: torso + two legs, simple 2-bone blends.

    Bone indices follow the reference's hard-coded test-rig layout
    (Game/ProceduralMeshes.swift:415-472): pelvis=0 spine=1 head=2 chest=7,
    thighs/calves = 3/4 (L) and 5/6 (R).
    """
    positions, normals, uvs_l, joints, weights, indices = [], [], [], [], [], []

    def add(center, radius, height, weight_fn):
        base = sum(len(p) for p in positions)
        p, n, uv, idx, t = _cylinder_grid(center, radius, height,
                                          radial_segments, height_segments)
        j, w = weight_fn(t)
        positions.append(p); normals.append(n); uvs_l.append(uv)
        joints.append(j); weights.append(w)
        indices.append(idx + base)

    def torso_weights(t):
        j = np.tile(np.array([0, 1, 7, 2], np.int32), (len(t), 1))
        w = np.zeros((len(t), 4), np.float32)
        lo = t < 0.4
        mid = (t >= 0.4) & (t < 0.7)
        hi = t >= 0.7
        a_lo = t / 0.4
        a_mid = (t - 0.4) / 0.3
        a_hi = (t - 0.7) / 0.3
        w[:, 0] = np.where(lo, 1 - a_lo, 0)
        w[:, 1] = np.where(lo, a_lo, np.where(mid, 1 - a_mid, 0))
        w[:, 2] = np.where(mid, a_mid, np.where(hi, 1 - a_hi, 0))
        w[:, 3] = np.where(hi, a_hi, 0)
        return j, w

    def leg_weights(thigh, calf):
        def fn(t):
            a = np.clip(t, 0, 1)
            j = np.tile(np.array([thigh, calf, 0, 0], np.int32), (len(t), 1))
            w = np.stack([a, 1 - a, np.zeros_like(a), np.zeros_like(a)], axis=-1)
            return j, w.astype(np.float32)
        return fn

    add((0.0, torso_height * 0.5, 0.0), torso_radius, torso_height, torso_weights)
    add((-hip_separation, -leg_height * 0.5, 0.0), leg_radius, leg_height, leg_weights(3, 4))
    add((hip_separation, -leg_height * 0.5, 0.0), leg_radius, leg_height, leg_weights(5, 6))

    return SkinnedMeshDescriptor(
        positions=np.concatenate(positions),
        normals=np.concatenate(normals),
        uvs=np.concatenate(uvs_l),
        joints=np.concatenate(joints).astype(np.int32),
        weights=np.concatenate(weights),
        indices=np.concatenate(indices).astype(np.int32),
        name="humanoidSkinned")


def _rotation_from_to(f, t):
    """Quaternion rotating unit vector f to t (reference ProceduralMeshes.swift:131-146)."""
    f = f / np.linalg.norm(f)
    t = t / np.linalg.norm(t)
    d = float(np.clip(np.dot(f, t), -1.0, 1.0))
    if d > 0.999:
        return np.array([0.0, 0, 0, 1])
    if d < -0.999:
        axis = np.cross(f, np.array([1.0, 0, 0]))
        if np.linalg.norm(axis) < 1e-4:
            axis = np.array([0.0, 0, 1])
        axis = axis / np.linalg.norm(axis)
        return np.array([*(axis * np.sin(np.pi / 2)), np.cos(np.pi / 2)])
    axis = np.cross(f, t)
    axis = axis / np.linalg.norm(axis)
    ang = np.arccos(d)
    return np.array([*(axis * np.sin(ang / 2)), np.cos(ang / 2)])


def _quat_mat3(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def skeleton_capsules(skeleton: Skeleton, radius: float = 0.03,
                      radial_segments: int = 10,
                      hemisphere_segments: int = 6) -> SkinnedMeshDescriptor:
    """One capsule per bone segment, skinned to (parent, bone) by height.

    reference: Game/ProceduralMeshes.swift:493-581 — debug visualization of a
    rig as capsules between each bone and its parent in bind pose.
    """
    bind_model = nputil.fk_model_transforms(skeleton.parent, skeleton.bind_local)
    positions, normals, uvs_l, joints, weights, indices = [], [], [], [], [], []
    total = 0

    for bone in range(skeleton.bone_count):
        parent = int(skeleton.parent[bone])
        if parent < 0:
            continue
        p_pos = bind_model[parent][:3, 3]
        b_pos = bind_model[bone][:3, 3]
        d = b_pos - p_pos
        length = float(np.linalg.norm(d))
        if length < 1e-4:
            continue
        axis = d / length
        half_len = length * 0.5
        r = min(radius, half_len)
        half_h = max(0.0, half_len - r)

        cap = capsule(radius=r, half_height=half_h,
                      radial_segments=radial_segments,
                      hemisphere_segments=hemisphere_segments)
        rot = _quat_mat3(_rotation_from_to(np.array([0.0, 1, 0]), axis))
        center = p_pos + axis * half_len
        world_pos = cap.positions @ rot.T + center
        world_nrm = cap.normals @ rot.T
        world_nrm = world_nrm / np.maximum(np.linalg.norm(world_nrm, axis=1, keepdims=True), 1e-8)

        half_extent = half_h + r
        if half_extent > 0:
            t = (cap.positions[:, 1] + half_extent) / (2 * half_extent)
        else:
            t = np.ones(len(cap.positions))
        w_parent = np.clip(1.0 - t, 0, 1)
        w_child = np.clip(t, 0, 1)

        v = len(cap.positions)
        positions.append(world_pos.astype(np.float32))
        normals.append(world_nrm.astype(np.float32))
        uvs_l.append(cap.uvs)
        joints.append(np.stack([np.full(v, parent), np.full(v, bone),
                                np.zeros(v), np.zeros(v)], axis=-1).astype(np.int32))
        weights.append(np.stack([w_parent, w_child, np.zeros(v), np.zeros(v)],
                                axis=-1).astype(np.float32))
        indices.append(cap.indices.astype(np.int64) + total)
        total += v

    return SkinnedMeshDescriptor(
        positions=np.concatenate(positions),
        normals=np.concatenate(normals),
        uvs=np.concatenate(uvs_l),
        joints=np.concatenate(joints),
        weights=np.concatenate(weights),
        indices=np.concatenate(indices).astype(np.int32),
        name="skeletonCapsules")
