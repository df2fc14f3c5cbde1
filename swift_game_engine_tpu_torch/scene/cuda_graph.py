"""Capture of a unit of device work as one CUDA graph.

``SubstepGraph`` (scene/step.py) captures the fixed substep and the
Engine's frame program (scene/engine.py) the frame after its substeps;
both go through ``capture``: eager warm-up runs on a side stream (they
build what a first call builds: cached constants, the kernel library,
library workspaces), then the allocator's cache is emptied and the work is
recorded once. A capture that fails raises.

Work that holds a collective (parallel/sharding.py's programs over a
process group) is captured with ``mode="thread_local"``: the process
group's watchdog thread polls its events while another thread captures,
which the default ``"global"`` mode forbids. Its first warm-up creates the
communicator, so the capture records only the collective itself; every
rank runs the same warm-ups and captures in the same order.

The kernel wrappers of the port count their launches in module counters
(``LAUNCH_COUNTERS``). A replay launches the captured kernels without
calling the wrappers, so ``capture`` keeps what the recorded work added
to the counters, takes it back (recording launches nothing), and each
``Captured.replay`` adds it again.
"""

from __future__ import annotations

import importlib
import time
from typing import NamedTuple

import torch

# (module, counter) of every kernel wrapper's launch count; tile_raster's
# "launches" is a list (K1's launches by layer count)
LAUNCH_COUNTERS = (
    ("swift_game_engine_tpu_torch.render.tile_raster", "launches"),
    ("swift_game_engine_tpu_torch.render.tile_raster", "list_launches"),
    ("swift_game_engine_tpu_torch.render.tile_raster", "peel_launches"),
    ("swift_game_engine_tpu_torch.ops.cluster_shadow", "occl_launches"),
    ("swift_game_engine_tpu_torch.ops.cluster_shadow", "slots_launches"),
    ("swift_game_engine_tpu_torch.ops.rt_kernel", "launches"),
    ("swift_game_engine_tpu_torch.ops.rt_kernel", "so_launches"),
    ("swift_game_engine_tpu_torch.ops.rt_kernel", "so_closest_launches"),
    ("swift_game_engine_tpu_torch.ops.rt_kernel", "shadow_launches"),
    ("swift_game_engine_tpu_torch.ops.rt_kernel", "any_launches"),
)


def launch_counts() -> list:
    """The current value of every launch counter (lists copied)."""
    out = []
    for mod, name in LAUNCH_COUNTERS:
        v = getattr(importlib.import_module(mod), name)
        out.append(list(v) if isinstance(v, list) else v)
    return out


def _set_launch_counts(values: list):
    for (mod, name), v in zip(LAUNCH_COUNTERS, values):
        setattr(importlib.import_module(mod), name, v)


def _add(a, b, sign=1):
    if isinstance(a, list):
        return [x + sign * y for x, y in zip(a, b)]
    return a + sign * b


def add_launch_counts(delta: list):
    """Add ``delta`` (as ``launch_counts`` gives) to the counters."""
    _set_launch_counts([_add(c, d) for c, d in zip(launch_counts(), delta)])


class Captured(NamedTuple):
    """A captured graph, what its capture cost, and the kernel launches of
    the port that one replay makes (``launch_counts`` form)."""

    graph: torch.cuda.CUDAGraph
    seconds: float     # wall time of the warm-ups and the capture
    pool_bytes: int    # the memory the graph's private pool reserved
    launches: list

    def replay(self):
        self.graph.replay()
        add_launch_counts(self.launches)


def capture(warm, record, warmup: int, mode: str = "global"):
    """``warmup`` eager calls of ``warm()`` on a side stream, then ``record()``
    captured into a graph -> (Captured, what ``record`` returned: tensors
    that each replay writes again). ``mode``: the capture's error mode
    (``torch.cuda.graph``'s ``capture_error_mode``)."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            warm()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    # the capture empties the allocator's cache first: empty it here so
    # that the reserved memory's growth is the graph's pool alone
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode=mode):
        out = record()
    torch.cuda.synchronize()
    delta = [_add(a, b, -1) for a, b in zip(launch_counts(), before)]
    _set_launch_counts(before)        # recording launched nothing
    return Captured(graph=graph, seconds=time.perf_counter() - t0,
                    pool_bytes=torch.cuda.memory_reserved() - reserved,
                    launches=delta), out
