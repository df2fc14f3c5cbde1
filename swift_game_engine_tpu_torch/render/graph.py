"""Declarative render graph: port of swift_game_engine_tpu/render/graph.py.

Host-side equivalent of the reference's RenderGraph
(reference: Game/RenderGraph.swift:183-368): passes declare reads/writes and
a target; per frame the graph (a) prunes passes whose writes can't reach the
view target or an external resource, (b) topologically sorts passes by
resource dependencies (raising on cycles / missing writers), (c) lazily
realizes temporaries, then executes each pass. A pass is any callable from a
resource dict of tensors to a dict of the resources it writes; the Engine's
two passes are the RT frame ("rt") and the composite ("composite").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


VIEW_TARGET = "view"


@dataclass
class RenderPass:
    name: str
    execute: Callable            # (resources: dict) -> dict it writes
    reads: tuple = ()
    writes: tuple = ()
    target: Optional[str] = None  # convenience: target is also a write
    external: bool = False        # writes persist outside the graph

    @property
    def all_writes(self):
        return tuple(self.writes) + ((self.target,) if self.target else ())


class RenderGraph:
    def __init__(self):
        self.passes: list[RenderPass] = []
        self._temporaries: dict[str, Callable] = {}

    def add_pass(self, p: RenderPass):
        self.passes.append(p)

    def add_temporary(self, name: str, factory: Callable):
        """Lazily-realized resource (RenderGraph.swift:114-165)."""
        self._temporaries[name] = factory

    # -- frame execution ---------------------------------------------------

    def _prune(self, passes):
        """Keep passes that (transitively) feed the view target or an
        external write (RenderGraph.swift:275-314)."""
        needed = {VIEW_TARGET}
        keep = [False] * len(passes)
        changed = True
        while changed:
            changed = False
            for i, p in enumerate(passes):
                if keep[i]:
                    continue
                if p.external or any(w in needed for w in p.all_writes):
                    keep[i] = True
                    needed.update(p.reads)
                    changed = True
        return [p for i, p in enumerate(passes) if keep[i]]

    def _sort(self, passes):
        """Topological order by resource deps; raises on cycles
        (RenderGraph.swift:316-368)."""
        writers: dict[str, int] = {}
        for i, p in enumerate(passes):
            for w in p.all_writes:
                writers[w] = i
        state = [0] * len(passes)  # 0 unvisited, 1 visiting, 2 done
        order: list[int] = []

        def visit(i):
            if state[i] == 1:
                raise RuntimeError(
                    f"render graph cycle at pass {passes[i].name}")
            if state[i] == 2:
                return
            state[i] = 1
            for r in passes[i].reads:
                j = writers.get(r)
                if j is not None and j != i:
                    visit(j)
            state[i] = 2
            order.append(i)

        for i in range(len(passes)):
            visit(i)
        return [passes[i] for i in order]

    def execute(self, resources: dict) -> dict:
        """Run one frame. ``resources`` holds externally-provided inputs;
        returns the final resource dict (including the view target)."""
        live = self._sort(self._prune(self.passes))
        res = dict(resources)
        for p in live:
            for r in p.reads:
                if r not in res:
                    if r in self._temporaries:
                        res[r] = self._temporaries[r]()
                    else:
                        raise RuntimeError(
                            f"pass {p.name} reads {r} with no writer or "
                            f"temporary")
            written = p.execute(res)
            if written:
                res.update(written)
        return res
