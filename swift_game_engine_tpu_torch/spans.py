"""Stage ranges and the stage marks that a CUDA graph capture records.

``span(name)``: while torch.profiler records, a range named ``name`` on the
host, on the profiler's clock, nested in the range open around it;
otherwise nothing (checking costs ~0.2 us, an open range ~10 us). The range
is a host op (``_RecordFunctionFast``), not a ``record_function`` user
annotation: from a user annotation the device trace makes a range of its
own over the kernels launched inside it, and the device's operations would
no longer be the program's alone.

``stage(name)``: a span that, while ``scene/cuda_graph.capture`` records
marks, also marks the node count of the graph being captured where it
opens and where it closes. The capture turns the marks into the graph's
stage table (``cuda_graph.stage_table``). Warm-ups and eager runs open the
spans and record no marks; on the CPU nothing is captured.

The stages: ``sge.substep.*`` (begin, move, separate, end) and
``sge.render.*`` (flatten, primary, layer1, continuations, mirror,
refraction, shadows, composite, other; deferred and raster on those
paths).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

_NULL = contextlib.nullcontext()
# (stage, opens, node count) of the capture that records marks, else None
_marks = None
_cuda = None


def span(name: str):
    """A host range named ``name`` while the profiler records, else a null
    context."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


def stage(name: str):
    """``span(name)``; inside a capture that records marks, also the node
    count of the graph at its entry and exit."""
    if _marks is None:
        return span(name)
    return _marked(name, _marks)


@contextlib.contextmanager
def _marked(name: str, marks: list):
    marks.append((name, True, node_count()))
    try:
        with span(name):
            yield
    finally:
        marks.append((name, False, node_count()))


@contextlib.contextmanager
def recording_marks():
    """Inside a capture: the list ``stage`` appends its marks to until the
    block ends."""
    global _marks
    _marks = marks = []
    try:
        yield marks
    finally:
        _marks = None


def _driver():
    """The CUDA driver library, loaded at first use, with the signatures of
    the calls used here (each returns a CUresult)."""
    global _cuda
    if _cuda is None:
        cu = ctypes.CDLL("libcuda.so.1")
        ptr, size = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        for fn, args in (
                (cu.cuStreamGetCaptureInfo_v2,
                 [ptr, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ptr),
                  ctypes.POINTER(ptr), size]),
                (cu.cuGraphGetNodes, [ptr, ptr, size]),
                (cu.cuGraphGetEdges, [ptr, ptr, ptr, size])):
            fn.argtypes, fn.restype = args, ctypes.c_int
        _cuda = cu
    return _cuda


def _check(rc: int, call: str):
    if rc != 0:
        raise RuntimeError(f"{call} failed: CUresult {rc}")


def _capturing_graph() -> ctypes.c_void_p:
    """The graph that the current stream captures into."""
    status, ident = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, n_deps = ctypes.c_void_p(), ctypes.c_void_p(), \
        ctypes.c_size_t()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    _check(_driver().cuStreamGetCaptureInfo_v2(
        stream, ctypes.byref(status), ctypes.byref(ident),
        ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(n_deps)),
        "cuStreamGetCaptureInfo")
    if status.value != 1:       # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("the current stream is not capturing")
    return graph


def node_count() -> int:
    """The nodes of the graph that the current stream captures into (in
    stream capture from one stream, node k runs k-th)."""
    n = ctypes.c_size_t(0)
    _check(_driver().cuGraphGetNodes(_capturing_graph(), None,
                                     ctypes.byref(n)), "cuGraphGetNodes")
    return n.value


def edge_count() -> int:
    """The dependencies between the nodes of the graph that the current
    stream captures into: n - 1 for n nodes captured from one stream with
    no fork (a chain); more where work on another stream joined it (a
    collective on its own stream)."""
    n = ctypes.c_size_t(0)
    _check(_driver().cuGraphGetEdges(_capturing_graph(), None, None,
                                     ctypes.byref(n)), "cuGraphGetEdges")
    return n.value
