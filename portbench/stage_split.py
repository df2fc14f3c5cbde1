"""Device time of a captured graph's stages, for the stage readers
(``metrics/render_*_ms.py``, ``metrics/substep_*_ms.py``).

The program keeps, for each graph it captures as a chain, its node count
and its stage table ``((stage, first node, end node), ...)`` under the
name of its kind (``STAGE_TABLES`` in its ``scene/cuda_graph.py``:
{name: {program: table}}, for the live programs). In a chain the k-th
device operation of a replay to start is its k-th node. Here: the graph
launches inside the benchmark's ``portbench.<span>`` spans; each launch's
device operations (kernels, copies and sets, by correlation id), sorted by
start, split by the table whose node count equals their count; the
operations' durations summed, not their extent, since the profiler widens
the gaps inside a replay. ``None`` where the program keeps no table (a
program without stage marks), where a launch's operation count is no
table's, where two tables of that count differ, or where the table has
none of the stages.
"""

from __future__ import annotations

import importlib

from .trace import PROGRAM


def split(ctx, span: str, program_span: str):
    """({stage: device us summed over the launches}, launches) of the graphs
    launched inside ``portbench.<span>`` spans and registered under
    ``program_span``, or None (see the module docstring)."""
    cuda_graph = importlib.import_module(PROGRAM + ".scene.cuda_graph")
    by_count = {}
    tables = getattr(cuda_graph, "STAGE_TABLES", {}).get(program_span, {})
    for t in tables.values():
        by_count.setdefault(t.node_count, set()).add(t.stages)
    launches = [r for r in ctx.runtime_in(ctx.spans_named(span))
                if "GraphLaunch" in r[0]]
    if not by_count or not launches:
        return None
    ids = {r[3] for r in launches}
    ops = {}
    for _, s, e, cid in ctx.device:
        if cid in ids:
            ops.setdefault(cid, []).append((s, e))
    total = {}
    for r in launches:
        mine = sorted(ops.get(r[3], ()))
        found = by_count.get(len(mine), ())
        if len(found) != 1:
            return None
        for stage, a, b in next(iter(found)):
            total[stage] = total.get(stage, 0.0) + sum(
                e - s for s, e in mine[a:b])
    return total, len(launches)


def stage_ms(ctx, span: str, program_span: str, *stages: str):
    """Device ms a launch of the nodes of ``stages``, or None."""
    got = split(ctx, span, program_span)
    if got is None or not any(s in got[0] for s in stages):
        return None
    return sum(got[0].get(s, 0.0) for s in stages) / 1e3 / got[1]
