"""Closest-hit visibility by testing every triangle: the reference's
stand-in for the port's BVH walk (kernel K4 and its twin).

Each ray is tested against all of the frame's triangles with the
Moller-Trumbore arithmetic of the port's leaf test (``_mt_leaf``: the same
edges ``v1 - v0``, ``v2 - v0``, the same operation order, ``|det| >= EPS``,
``t > 1e-4``), and keeps the nearest hit below its ``t_max``. No tree is
built or read, so nothing the port derives for its walks enters the
reference.
"""

from __future__ import annotations

import torch


class BruteForce:
    """``trace_batch(bvh, o, d, active, count=None)`` of the frozen
    ``render/rt.py`` by brute force. ``rk``: the frozen ``ops.rt_kernel``
    (for ``BIG``, ``EPS``, ``_cross``, ``_dot``, ``barycentrics``).
    ``round_to``: a dtype the triangles and rays are rounded to before the
    test (the control), or None."""

    def __init__(self, rk, round_to=None, ray_chunk: int = 512,
                 tri_chunk: int = 16384):
        self.rk = rk
        self.round_to = round_to
        self.ray_chunk, self.tri_chunk = ray_chunk, tri_chunk
        self.calls = 0

    def _round(self, x):
        if self.round_to is None:
            return x
        return x.to(self.round_to).to(x.dtype)

    def closest(self, v0, v1, v2, o, d, t_max):
        """Nearest hit below ``t_max`` of each ray -> (t, tri), t = t_max
        and tri = -1 where none."""
        rk = self.rk
        v0, v1, v2 = (self._round(v) for v in (v0, v1, v2))
        o, d = self._round(o), self._round(d)
        e1, e2 = v1 - v0, v2 - v0
        t_best = t_max.clone()
        tri_best = torch.full_like(t_max, -1, dtype=torch.int64)
        inf = float("inf")
        for r0 in range(0, o.shape[0], self.ray_chunk):
            r1 = min(r0 + self.ray_chunk, o.shape[0])
            oo, dd = o[r0:r1, None, :], d[r0:r1, None, :]
            tb, ib = t_best[r0:r1], tri_best[r0:r1]
            for c0 in range(0, v0.shape[0], self.tri_chunk):
                c1 = min(c0 + self.tri_chunk, v0.shape[0])
                a, f1, f2 = v0[None, c0:c1], e1[None, c0:c1], e2[None, c0:c1]
                p = rk._cross(dd, f2)
                det = rk._dot(f1, p)
                ok = det.abs() >= rk.EPS
                inv_det = 1.0 / torch.where(ok, det, 1.0)
                tv = oo - a
                u = rk._dot(tv, p) * inv_det
                q = rk._cross(tv, f1)
                v = rk._dot(dd, q) * inv_det
                t = rk._dot(f2, q) * inv_det
                hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) \
                    & (t > 1e-4)
                t_near, j = torch.where(hit, t, inf).min(1)
                better = t_near < tb
                tb = torch.where(better, t_near, tb)
                ib = torch.where(better, j + c0, ib)
            t_best[r0:r1], tri_best[r0:r1] = tb, ib
        return t_best, tri_best

    def trace_batch(self, bvh, o, d, active, count=None):
        """The frozen ``rt_kernel.trace_batch`` contract: nearest-hit
        records (t, tri int64, u, v, found); inactive lanes miss."""
        rk = self.rk
        self.calls += 1
        n, dev = o.shape[0], o.device
        o = torch.where(active[:, None], o, 1.0e9)
        t = torch.full((n,), rk.BIG, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel():
            ti, ii = self.closest(bvh.v0, bvh.v1, bvh.v2, o[idx], d[idx],
                                  t[idx])
            t[idx], tri[idx] = ti, ii
        u, v, found = rk.barycentrics(bvh, o, d, t, tri)
        found = found & active & (t < rk.BIG)
        return (torch.where(found, t, rk.BIG), torch.where(found, tri, -1),
                u, v, found)
