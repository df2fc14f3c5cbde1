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

A capture also keeps where its work's stages lie in the graph. The work
opens ``spans.stage`` ranges; while it is recorded, each range marks the
node count of the graph being built where it opens and where it closes.
Work recorded from one stream with no fork makes a chain, in which node k
runs k-th: ``stage_table`` turns the marks into ``[(stage, first node,
end node)]``, each node in the innermost stage open when it was added, a
node outside every stage in ``ROOT``. ``Captured.stages`` and
``Captured.node_count`` hold the table. A graph that is no chain (one with
a collective, which runs on the process group's own stream) keeps none:
its node order is not the order its nodes run in. ``register`` keeps a
program's table, as plain data, under the name its readers look it up by
(``STAGE_TABLES``) while the program lives, so a replaced program's table
goes with it: a reader of a device trace splits a replay's operations, in
the order they start, by the table. The marks add no node: a graph is the
same with or without them.
"""

from __future__ import annotations

import importlib
import time
import weakref
from typing import NamedTuple

import torch

from ..spans import edge_count, node_count, recording_marks

# a node of a captured graph outside every stage
ROOT = "sge.root"
# the name a program's stage table is looked up by (its ``SPAN``) -> {the
# program: its StageTable}, for the live programs alone
STAGE_TABLES = {}
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


def stage_table(marks, nodes: int) -> tuple:
    """``spans.stage``'s marks ``(stage, opens, node count)`` of a graph of
    ``nodes`` nodes -> ``((stage, first, end), ...)``: consecutive
    ranges covering ``[0, nodes)``, each node in the innermost stage
    open when it was added, ``ROOT`` outside every stage."""
    out, open_, at = [], [], 0
    for name, opens, count in list(marks) + [(None, True, nodes)]:
        if count > at:
            here = open_[-1] if open_ else ROOT
            if out and out[-1][0] == here:
                out[-1] = (here, out[-1][1], count)
            else:
                out.append((here, at, count))
            at = count
        if opens:
            open_.append(name)
        else:
            open_.pop()
    return tuple(out)


class StageTable(NamedTuple):
    """A captured graph's node count and stage table (``stage_table``)."""

    node_count: int
    stages: tuple


def register(owner):
    """Keep the stage table of ``owner.captured`` under ``owner.SPAN`` while
    ``owner`` (a ``FrameProgram`` or a ``SubstepGraph``) lives; a graph
    without a table (not captured, or no chain) keeps nothing."""
    cap = owner.captured
    if cap is not None and cap.stages is not None:
        STAGE_TABLES.setdefault(owner.SPAN, weakref.WeakKeyDictionary())[
            owner] = StageTable(cap.node_count, cap.stages)


class Captured(NamedTuple):
    """A captured graph, what its capture cost, the kernel launches of the
    port that one replay makes (``launch_counts`` form), and its nodes by
    stage (``stage_table``; None where the graph is no chain)."""

    graph: torch.cuda.CUDAGraph
    seconds: float     # wall time of the warm-ups and the capture
    pool_bytes: int    # the memory the graph's private pool reserved
    launches: list
    node_count: int
    stages: tuple | None

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
        with recording_marks() as marks:
            out = record()
            nodes, edges = node_count(), edge_count()
    torch.cuda.synchronize()
    delta = [_add(a, b, -1) for a, b in zip(launch_counts(), before)]
    _set_launch_counts(before)        # recording launched nothing
    return Captured(graph=graph, seconds=time.perf_counter() - t0,
                    pool_bytes=torch.cuda.memory_reserved() - reserved,
                    launches=delta, node_count=nodes,
                    stages=stage_table(marks, nodes)
                    if edges == nodes - 1 else None), out
