"""The traced run: torch.profiler over the traced window, reduced to what
the per-layer readers (``portbench/metrics/*.py``) take.

``TraceContext`` holds, in microseconds on the profiler's clock: the
device's operations (kernels, copies, sets), the host's CUDA runtime calls,
the benchmark's ``portbench.*`` spans, and the window (from the traced
frames' first device operation to their last); beside them the
frames or replays of the window, the frame program's replay times by CUDA
events, and the bytes floor of the port kernels' calls in one replay.

``CallRecorder`` records the port kernels' calls that a CUDA graph capture
makes (the calls every replay of that graph repeats), with the shapes and
the live-count tensors their bytes floor needs; the counts are read after
the window, from the graph's own buffers, so they are those of its last
replay.
"""

from __future__ import annotations

import importlib

import torch

from .reference import arith

PROGRAM = "swift_game_engine_tpu_torch"
# the port's hand-written kernels, by the names the device trace gives them
PORT_KERNELS = ("cluster_raster_kernel", "shadow_sweep_kernel",
                "wide_walk_kernel", "list_kernel")
SPAN = "portbench."


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


class CallRecorder:
    """Wraps the port's kernel launchers (K1, K2, K3, K4) while a graph is
    captured; ``bytes_per_replay()`` is the sum of the recorded calls'
    bytes floors (``reference/arith.py``)."""

    SITES = (("render.tile_raster", "_launch_raster", "k1"),
             ("ops.cluster_shadow", "_launch_occl", "k2"),
             ("ops.cluster_shadow", "_launch_slots", "k3"),
             ("ops.rt_kernel", "_launch_k4", "k4"))

    def __init__(self, scene_tris: int):
        self.scene_tris = scene_tris
        self.calls = []

    def install(self):
        for mod_name, fn_name, kind in self.SITES:
            mod = importlib.import_module(f"{PROGRAM}.{mod_name}")
            fn = getattr(mod, fn_name, None)
            if fn is not None:
                setattr(mod, fn_name, self._wrap(fn, kind))

    def _wrap(self, fn, kind):
        def launch(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                self.calls.append((kind, args, kwargs))
            return fn(*args, **kwargs)
        return launch

    def _bytes(self, kind, args, kwargs) -> int:
        if kind == "k1":
            rows, _, _, width, height, layers, prior = args[:7]
            return arith.k1_bytes(rows.shape[0], width * height, layers,
                                  prior is not None)
        if kind == "k4":
            o = args[2]
            count = kwargs.get("count", args[6] if len(args) > 6 else None)
            n = o.shape[0]
            live = n if count is None else min(int(count), n)
            return arith.k4_bytes(n, live, self.scene_tris)
        sc, o, t_limit = args[:3]
        n, live = o.shape[0], int((t_limit > 0).sum())
        if kind == "k2":
            return arith.k2_bytes(n, live, sc.rows.shape[0],
                                  args[3] is not None)
        return arith.k3_bytes(n, live, sc.rows.shape[0], int(args[3]))

    def bytes_per_replay(self):
        if not self.calls:
            return None
        return float(sum(self._bytes(*c) for c in self.calls))


class TraceContext:
    def __init__(self, prof, frames: int, replays: int, render_ms,
                 port_bytes):
        self.frames, self.replays = frames, replays
        self.render_ms = list(render_ms)
        self.port_bytes_per_replay = port_bytes
        self.device, self.runtime, self.spans = [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            s = e.start_ns() / 1e3
            rec = (name, s, s + e.duration_ns() / 1e3, e.correlation_id())
            if name.startswith(SPAN):
                if e.device_type() != cuda:
                    self.spans.append(rec[:3])
            elif e.device_type() == cuda:
                self.device.append(rec)
            elif name.startswith("cu"):
                self.runtime.append(rec)
        # The window runs from the first device operation of the traced
        # frames to the last: the profiler's start and the host's work
        # before the first launch are outside it.
        win = [s for s in self.spans if s[0] == SPAN + "window"]
        lo, hi = (win[0][1], win[0][2]) if win else (float("-inf"),
                                                     float("inf"))
        inside = [d for d in self.device if d[1] >= lo and d[2] <= hi]
        self.window = (min(d[1] for d in inside),
                       max(d[2] for d in inside)) if inside else (lo, hi)
        self.intervals = sorted(
            (max(d[1], self.window[0]), min(d[2], self.window[1]))
            for d in self.device
            if d[2] > self.window[0] and d[1] < self.window[1])

    def replay_intervals(self):
        """The device's operations in the window, each graph replay taken
        whole, from its first kernel to its last: the profiler's records
        widen the gaps inside a replay, not those between the host's
        launches."""
        graphs = {r[3] for r in self.runtime if "GraphLaunch" in r[0]}
        whole, out = {}, []
        for _, s, e, cid in self.device:
            if e <= self.window[0] or s >= self.window[1]:
                continue
            s, e = max(s, self.window[0]), min(e, self.window[1])
            if cid in graphs:
                a, b = whole.get(cid, (s, e))
                whole[cid] = (min(a, s), max(b, e))
            else:
                out.append((s, e))
        return sorted(out + list(whole.values()))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return arith.union_us(self.intervals) / 1e6

    def spans_named(self, name: str):
        return [s for s in self.spans if s[0] == SPAN + name]

    def runtime_in(self, spans):
        """Runtime calls that start inside one of ``spans``."""
        return [r for r in self.runtime
                if any(a <= r[1] <= b for _, a, b in spans)]

    def kernels_of(self, runtime_calls):
        """Device kernels launched by ``runtime_calls`` (by correlation)."""
        ids = {r[3] for r in runtime_calls}
        return [d for d in self.device if d[3] in ids and not
                d[0].lower().startswith(("memcpy", "memset"))]

    def kernels_per_graph_launch(self, span: str):
        launches = [r for r in self.runtime_in(self.spans_named(span))
                    if "GraphLaunch" in r[0]]
        if not launches:
            return None
        kernels = self.kernels_of(launches)
        if not kernels:
            return None
        return len(kernels) / len(launches)

    def breakdown(self) -> dict:
        by_name = {}
        for name, s, e, _ in self.device:
            if e > self.window[0] and s < self.window[1]:
                by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps, end = [], None
        for a, b in self.intervals:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[self._host_at(a), (b - a) / 1e6]
                              for a, b in gaps]}

    def _host_at(self, t: float) -> str:
        """The innermost benchmark span open on the host at ``t``."""
        best = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "outside the benchmark's spans"
