"""Frozen metric arithmetic: the device's busy time from a trace, the
published peak the roofline shares are taken against, and the bytes each
port kernel's call must move at the least.

``union_ms`` is ``profile_port.py``'s ``_union_ms``. The peak and the
bytes-floor rule (each input read once, each output written once, over
the memory rate) are ``chip_smoke.py``'s ``HBM_BYTES_PER_S`` and
``_bound``; the counted-operations half of that bound is left out, since
it counts the walk work of the port's own tree.
"""

from __future__ import annotations

# Published device memory rate of one H100 SXM at its 700 W limit (NVIDIA
# data sheet).
HBM_BYTES_PER_S = 3.35e12
TRI_BYTES = 36          # a triangle: three f32 vertices
RAY_BYTES = 24          # origin and direction, f32
F32, I32 = 4, 4


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def union_ms(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in ms."""
    return union_us(intervals) / 1e3


def floor_ms(nbytes: float) -> float:
    """The least time the card can take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def k1_bytes(tris: int, pixels: int, layers: int, prior: bool) -> int:
    """A cluster raster: its triangles read once, each pixel's records
    (triangle id, two barycentrics, depth) written for each layer, and the
    prior depth read where the call has one."""
    return (tris * TRI_BYTES + pixels * layers * 4 * F32
            + (pixels * F32 if prior else 0))


def k4_bytes(lanes: int, live: int, tris: int) -> int:
    """A closest-hit trace: each live ray's origin, direction and t_max
    read and its (t, triangle) written; a lane past the live count reads
    its t_max only; the scene's triangles read once."""
    return (live * (RAY_BYTES + F32 + F32 + I32) + (lanes - live) * F32
            + tris * TRI_BYTES)


def k2_bytes(lanes: int, live: int, tris: int, threshold: bool) -> int:
    """An occlusion sweep: each live lane's origin and limit (and settle
    threshold) read and its opaque t written; a dead lane reads its limit;
    the swept triangles read once."""
    return (live * (12 + F32 + (F32 if threshold else 0) + F32)
            + (lanes - live) * F32 + tris * TRI_BYTES)


def k3_bytes(lanes: int, live: int, tris: int, slots: int) -> int:
    """A slotted sweep: each live lane's origin and limit read and its
    opaque t and ``slots`` (t, id) records written; a dead lane reads its
    limit; the swept triangles read once."""
    return (live * (12 + F32 + F32 + slots * 2 * F32)
            + (lanes - live) * F32 + tris * TRI_BYTES)
