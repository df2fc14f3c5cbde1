"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` for ``sm_90a`` — one ``nvcc`` per
source, all started together — and linked into one shared library with a
plain C interface, loaded with ctypes. The library goes into this
package's gitignored ``build/`` directory, named by a hash of the sources
and flags, so a stale build is never loaded. Nothing is imported or built
when the module is imported: the CPU paths never touch it.

``--fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch twins and the reference compute them, so a kernel and its
twin disagree only where a triangle edge passes exactly through a sample.
Where a kernel fuses on purpose (K6's dot products, ``fmaf`` as XLA fuses
the reference's), its twin computes the same fused operations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("cluster_raster.cu", "cluster_shadow.cu", "bvh_trace.cu",
           "raster_lists.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-Xcompiler", "-fPIC")

_LIB = None
build_seconds = None   # wall time of the last compile in this process
build_log = ""         # compiler output of that compile

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "sge_cluster_raster": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I,
                           _I, _P, _P, _P, _P, _P, _P],
    "sge_shadow_occl": [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _P, _P,
                        _P],
    "sge_shadow_slots": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P],
    "sge_trace_closest": [_P, _P, _P, _P, _P, _P, _I64, _I, _P, _P, _P,
                          _P],
    "sge_so_layers": [_P, _P, _P, _P, _P, _I64, _I, _I, _P, _P, _P, _P, _P,
                      _P],
    "sge_shadow_walk": [_P, _P, _P, _P, _P, _I64, _I, _I, _P, _P, _P, _P,
                        _P],
    "sge_trace_so": [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _P, _P, _P, _P],
    "sge_trace_any": [_P, _P, _P, _P, _P, _I64, _I, _P, _P, _P],
    "sge_walk_threads": [_I, _I64],
    "sge_list_raster": [_P, _P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P,
                        _P],
    "sge_list_peeled": [_P, _P, _I, _I, _F, _F, _I, _I, _P, _P, _P, _P, _P,
                        _P],
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _compile(cmds):
    """Run the nvcc commands all at once; raise with the log of a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{log}")
    return "".join(logs)


def library(verbose: bool = False):
    """The loaded kernel library, compiled on first call. ``verbose`` adds
    ``-Xptxas -v`` (registers, spills) to a fresh compile."""
    global _LIB, build_seconds, build_log
    if _LIB is not None:
        return _LIB
    with open(os.path.join(CSRC, "common.cuh"), "rb") as f:
        common = f.read()
    h = hashlib.sha256(" ".join(FLAGS).encode() + common)
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libsge_kernels_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        pid = os.getpid()
        objs = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}_{tag}."
                             f"{pid}.o") for s in SOURCES]
        extra = ["-Xptxas", "-v"] if verbose else []
        t0 = time.perf_counter()
        build_log = _compile([[nvcc, *FLAGS, *extra, "-c", "-o", obj, src]
                              for src, obj in zip(srcs, objs)])
        tmp = f"{so}.{pid}.tmp"
        build_log += _compile([[nvcc, "-shared", "-o", tmp, *objs]])
        build_seconds = time.perf_counter() - t0
        for obj in objs:
            os.remove(obj)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.sge_error_string.argtypes = [ctypes.c_int]
    lib.sge_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(err: int, name: str):
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        msg = _LIB.sge_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, shape=None, dtype=torch.float32,
            device=None):
    """Wrapper checks: dtype, contiguity, device and (optionally) shape."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t
