"""Port of swift_game_engine_tpu/math3d.py.

Column-vector 4x4 matrices and (x, y, z, w) quaternions, as in the
reference (Game/Math.swift). Tensor functions broadcast over leading dims
and keep their inputs' device; the builders from numbers (``mat4_identity``,
``mat4_perspective_rh``, ...) take ``device`` (torch's default if None:
host-side matrix math, as the camera's); the ``*_np`` helpers are
host-side numpy for the scene builder.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def normalize(v, eps: float = 1e-12):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def radians_from_degrees(deg):
    """Game/Math.swift:48-50 (math3d.py:27)."""
    return deg / 180.0 * math.pi


def mat3_from_quat(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


def trs_matrices(t, r, s):
    """TransformComponent.modelMatrix = T * R * S (scene/step.py _trs_matrices).

    t (..., 3), r (..., 4) quaternion, s (..., 3) -> (..., 4, 4)."""
    m = torch.zeros((*t.shape[:-1], 4, 4), dtype=t.dtype, device=t.device)
    m[..., :3, :3] = mat3_from_quat(r) * s[..., None, :]
    m[..., :3, 3] = t
    m[..., 3, 3].fill_(1.0)    # a fill: setting a number copies it from the host
    return m


def quat_from_axis_angle_np(angle: float, axis) -> np.ndarray:
    axis = np.asarray(axis, np.float32)
    axis = axis / max(float(np.linalg.norm(axis)), 1e-12)
    h = np.float32(angle) * np.float32(0.5)
    return np.concatenate([axis * np.sin(h), [np.cos(h)]]).astype(np.float32)


def quat_mul_np(a, b) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], np.float32)


# ---------------------------------------------------------------------------
# What the fixed-step simulation needs (physics/systems.py, scene/step.py).


def dot(a, b):
    return (a * b).sum(-1)


def norm(v):
    """|v| over the last axis, as ``jnp.linalg.norm(v, axis=-1)``."""
    return torch.sqrt((v * v).sum(-1))


def xz(v):
    """``v`` with its Y component zeroed (``v * (1, 0, 1)``)."""
    out = v.clone()
    out[..., 1] = 0.0
    return out


def where_rows(cond, a, b):
    """torch.where with a per-row ``cond`` (N,) broadcast over the
    trailing dims of ``a``/``b`` (tensors or numbers)."""
    nd = max(x.dim() if isinstance(x, torch.Tensor) else 0 for x in (a, b))
    return torch.where(cond.reshape(cond.shape + (1,) * (nd - cond.dim())),
                       a, b)


def quat_normalize(q, eps: float = 1e-12):
    return normalize(q, eps)


def quat_from_axis_angle(angle, axis):
    """simd_quatf(angle:axis:): ``angle`` (...,), ``axis`` (..., 3)."""
    axis = normalize(axis)
    half = angle * 0.5
    return torch.cat([axis * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], -1)


def quat_from_yaw(yaw):
    """The rotation by ``yaw`` (...,) about +Y: quat_from_axis_angle(yaw,
    (0, 1, 0)) without building the axis."""
    half = yaw * 0.5
    z = torch.zeros_like(half)
    return torch.stack([z, torch.sin(half), z, torch.cos(half)], -1)


def quat_mul(a, b):
    """Hamilton product ``a * b`` (apply b first, then a)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], -1)


def quat_act(q, v):
    """Rotate ``v`` by the unit quaternion ``q`` (simd_act)."""
    qv = q[..., :3]
    t = 2.0 * cross(qv, v)
    return v + q[..., 3:4] * t + cross(qv, t)


def quat_forward(q):
    """quat_act(q, (0, 0, -1)): the facing direction of a rotation."""
    qv = q[..., :3]
    v = torch.zeros_like(qv)
    v[..., 2] = -1.0
    return quat_act(q, v)


def quat_slerp(q0, q1, t):
    """Shortest-arc slerp with an nlerp fallback for nearly parallel
    inputs; ``t`` a float or a tensor broadcastable to (...,)."""
    if isinstance(t, torch.Tensor):
        t = t[..., None]
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0.0, -q1, q1)
    d = torch.clamp(d.abs(), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    safe_sin = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe_sin)
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# What the pose stack needs (anim/pose.py, anim/fk.py; math3d.py:255-388).


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def mat4_from_quat(q):
    """(..., 4) -> (..., 4, 4): the rotation with a zero translation."""
    m = torch.zeros((*q.shape[:-1], 4, 4), dtype=q.dtype, device=q.device)
    m[..., :3, :3] = mat3_from_quat(q)
    m[..., 3, 3].fill_(1.0)
    return m


def quat_from_mat3(r):
    """Rotation matrix (..., 3, 3) -> unit quaternion, branch-free
    (Shepperd's method: the candidate built from the largest of the four
    4 q_i^2 - 1 terms), as math3d.py:275; q and -q are one rotation."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    qw2 = m00 + m11 + m22
    qx2 = m00 - m11 - m22
    qy2 = m11 - m00 - m22
    qz2 = m22 - m00 - m11

    def build(dom2, a, b, c):
        s = torch.sqrt(torch.clamp(dom2 + 1.0, min=0.0)) * 0.5
        inv = 0.25 / torch.clamp(s, min=1e-12)
        return s, a * inv, b * inv, c * inv

    s, a, b, c = build(qw2, m21 - m12, m02 - m20, m10 - m01)
    qw = torch.stack([a, b, c, s], -1)
    s, a, b, c = build(qx2, m21 - m12, m01 + m10, m02 + m20)
    qx = torch.stack([s, b, c, a], -1)
    s, a, b, c = build(qy2, m02 - m20, m01 + m10, m12 + m21)
    qy = torch.stack([b, s, c, a], -1)
    s, a, b, c = build(qz2, m10 - m01, m02 + m20, m12 + m21)
    qz = torch.stack([b, c, s, a], -1)
    cands = torch.stack([qw, qx, qy, qz], -2)
    best = torch.stack([qw2, qx2, qy2, qz2], -1).argmax(-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    return quat_normalize(q)


def quat_from_euler_xyz_degrees(deg):
    """The Euler XYZ rotation Rz @ Ry @ Rx of ``deg`` (..., 3) as the
    quaternion qz * qy * qx, expanded as math3d.py:341 expands it."""
    half = radians_from_degrees(deg) * 0.5
    cx, cy, cz = (torch.cos(half[..., i]) for i in range(3))
    sx, sy, sz = (torch.sin(half[..., i]) for i in range(3))
    return torch.stack([
        cz * cy * sx - sz * sy * cx,
        cz * sy * cx + sz * cy * sx,
        sz * cy * cx - cz * sy * sx,
        cz * cy * cx + sz * sy * sx,
    ], -1)


def smootherstep01(t):
    """Quintic smootherstep of an already clamped t: t^3 (t (6t - 15) + 10)
    (Game/ProceduralPoseSystem.swift:108)."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


# ---------------------------------------------------------------------------
# 4x4 matrix builders and the rest of the reference's helpers
# (math3d.py:45-230, 227-317).


def _t(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def mat4_identity(batch_shape=(), device=None):
    return torch.eye(4, device=device).expand(*batch_shape, 4, 4)


def mat4_rotation(radians, axis):
    """Axis-angle rotation (Game/Math.swift:11-24): ``radians`` (...,),
    ``axis`` (..., 3)."""
    radians = _t(radians, getattr(axis, "device", None))
    axis = normalize(_t(axis, radians.device))
    ct, st = torch.cos(radians), torch.sin(radians)
    ci = 1.0 - ct
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros, ones = torch.zeros_like(ct), torch.ones_like(ct)
    zeros, ones, ct, st, ci = torch.broadcast_tensors(zeros, ones, ct, st,
                                                      ci)
    return torch.stack([
        torch.stack([ct + x * x * ci, x * y * ci - z * st,
                     x * z * ci + y * st, zeros], -1),
        torch.stack([y * x * ci + z * st, ct + y * y * ci,
                     y * z * ci - x * st, zeros], -1),
        torch.stack([z * x * ci - y * st, z * y * ci + x * st,
                     ct + z * z * ci, zeros], -1),
        torch.stack([zeros, zeros, zeros, ones], -1)], -2)


def mat4_translation(t):
    """Game/Math.swift:26-33: ``t`` (..., 3)."""
    t = _t(t, getattr(t, "device", None))
    m = mat4_identity(t.shape[:-1], t.device).clone()
    m[..., :3, 3] = t
    return m


def mat4_from_rt(rot3, t):
    """A 4x4 from a 3x3 rotation block and a translation."""
    batch = torch.broadcast_shapes(rot3.shape[:-2], t.shape[:-1])
    m = mat4_identity(batch, rot3.device).clone()
    m[..., :3, :3] = rot3.expand(*batch, 3, 3)
    m[..., :3, 3] = t.expand(*batch, 3)
    return m


def _perspective(fovy_radians, aspect, near, far):
    ys = 1.0 / np.tan(np.float32(fovy_radians) * np.float32(0.5))
    xs = ys / np.float32(aspect)
    zs = np.float32(far) / (np.float32(near) - np.float32(far))
    return np.float32(xs), np.float32(ys), np.float32(zs)


def mat4_perspective_rh(fovy_radians, aspect, near, far, device=None):
    """Right-handed perspective, [0, 1] depth (Game/Math.swift:35-46)."""
    xs, ys, zs = _perspective(fovy_radians, aspect, near, far)
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1], m[2, 2] = xs, ys, zs
    m[2, 3], m[3, 2] = zs * np.float32(near), -1.0
    return _t(m, device)


def mat4_perspective_rh_inverse(fovy_radians, aspect, near, far,
                                device=None):
    """The closed-form inverse of ``mat4_perspective_rh`` (exact where a
    numeric inverse cancels at the far plane)."""
    xs, ys, zs = _perspective(fovy_radians, aspect, near, far)
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1], m[2, 3] = 1.0 / xs, 1.0 / ys, -1.0
    m[3, 2] = 1.0 / (zs * np.float32(near))
    m[3, 3] = 1.0 / np.float32(near)
    return _t(m, device)


def mat4_look_at_rh(eye, center, up):
    """Game/Math.swift:52-66: (..., 3) each."""
    eye = _t(eye, getattr(eye, "device", None))
    f = normalize(_t(center, eye.device) - eye)
    r = normalize(cross(f, _t(up, eye.device)))
    u = cross(r, f)
    last = _t([0.0, 0.0, 0.0, 1.0], eye.device).expand(*eye.shape[:-1], 4)
    return torch.stack([
        torch.cat([r, -dot(r, eye)[..., None]], -1),
        torch.cat([u, -dot(u, eye)[..., None]], -1),
        torch.cat([-f, dot(f, eye)[..., None]], -1), last], -2)


def mat4_ortho_rh(left, right, bottom, top, near, far, device=None):
    """Game/Math.swift:68-82."""
    left, right, bottom, top, near, far = (np.float32(v) for v in (
        left, right, bottom, top, near, far))
    rl, tb, fn = right - left, top - bottom, far - near
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1], m[2, 2] = 2.0 / rl, 2.0 / tb, -1.0 / fn
    m[0, 3], m[1, 3] = -(right + left) / rl, -(top + bottom) / tb
    m[2, 3], m[3, 3] = -near / fn, 1.0
    return _t(m, device)


def rotation_xyz_degrees(deg):
    """Euler XYZ, Rz @ Ry @ Rx (Game/Skeleton.swift:212-217): ``deg``
    (..., 3) -> (..., 4, 4)."""
    rad = radians_from_degrees(_t(deg, getattr(deg, "device", None)))
    cx, cy, cz = (torch.cos(rad[..., i]) for i in range(3))
    sx, sy, sz = (torch.sin(rad[..., i]) for i in range(3))
    zeros, ones = torch.zeros_like(cx), torch.ones_like(cx)
    return torch.stack([
        torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                     zeros], -1),
        torch.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                     zeros], -1),
        torch.stack([-sy, cy * sx, cy * cx, zeros], -1),
        torch.stack([zeros, zeros, zeros, ones], -1)], -2)


def mat4_translation_part(m):
    """Game/Skeleton.swift:219-221."""
    return m[..., :3, 3]


def transform_point(m, p):
    """(M @ [p, 1]).xyz for ``m`` (..., 4, 4), ``p`` (..., 3)."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def transform_dir(m, d):
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], d)


def mat4_inverse_rigid(m):
    """The inverse of a rotation + translation (no scale)."""
    rt = m[..., :3, :3].transpose(-1, -2)
    return mat4_from_rt(rt, -torch.einsum("...ij,...j->...i", rt,
                                           m[..., :3, 3]))


def quat_identity(batch_shape=(), device=None):
    return _t([0.0, 0.0, 0.0, 1.0], device).expand(*batch_shape, 4)


def quat_inverse(q):
    return quat_conj(q) / torch.clamp((q * q).sum(-1, keepdim=True),
                                      min=1e-20)


def quat_from_mat4(m):
    return quat_from_mat3(m[..., :3, :3])
