"""ctypes binding for the shared native binned-SAH BVH builder.

The source is the reference's ``native/bvh_builder.cpp``, compiled with the
flags of ``native/build.sh`` (so both packages get the same tree from the
same input) into this package's gitignored ``build/`` directory — nothing
is written into ``native/``. ``-march=native`` ties the library to the CPU
it was built on, so its file name carries a hash of the source, the flags
and the instruction-set macros ``-march=native`` enables on this host: a
library built on another machine is never loaded. There is no fallback
builder: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")   # native/build.sh
_LIB = None


def _library_path() -> str:
    """build/libsge_bvh_<hash>.so, the hash over the source, the flags and
    the host's -march=native target (its predefined macros)."""
    target = subprocess.run(
        ["g++", "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, check=True).stdout
    h = hashlib.sha256(" ".join(FLAGS).encode() + target)
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsge_bvh_{h.hexdigest()[:16]}.so")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE], check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.build_bvh_sah.restype = ctypes.c_int32
    lib.build_bvh_sah.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32, p32, p32, p32, p32, p32, p32, p32,
        ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return lib


def build_bvh_sah(tri_min: np.ndarray, tri_max: np.ndarray,
                  leaf_size: int = 12):
    """Host SAH build -> the reference's BVHTopology fields as numpy:
    dict(skip, first_tri, tri_count, left, right, tri_order, levels,
    leaf_slots)."""
    lib = _load()
    t = len(tri_min)
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    cap = 2 * t + 64   # the builder's contract: <= 2T+1 nodes
    skip, first, count, left, right, parent, depth = (
        np.zeros(cap, np.int32) for _ in range(7))
    order = np.zeros(t, np.int64)

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    m = lib.build_bvh_sah(
        tri_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tri_max.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t, leaf_size, p32(skip), p32(first), p32(count), p32(left),
        p32(right), p32(parent), p32(depth),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if not 0 < m <= cap:
        raise RuntimeError(f"native BVH builder returned {m} nodes (cap {cap})")
    skip, first, count = skip[:m], first[:m], count[:m]
    left, right, depth = left[:m], right[:m], depth[:m]

    internal = np.nonzero(count == 0)[0]
    levels = []
    if len(internal):
        for d in range(int(depth[internal].max()), -1, -1):
            lv = internal[depth[internal] == d]
            if len(lv):
                levels.append(lv.astype(np.int32))
    leaf_slots = np.full((m, leaf_size), -1, np.int32)
    leaves = np.nonzero(count > 0)[0]
    span = np.arange(leaf_size)
    fill = span[None, :] < count[leaves, None]
    leaf_slots[leaves] = np.where(fill, first[leaves, None] + span[None, :], -1)
    return dict(skip=skip, first_tri=first, tri_count=count, left=left,
                right=right, tri_order=order.astype(np.int32),
                levels=tuple(levels), leaf_slots=leaf_slots)
