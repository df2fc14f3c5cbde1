"""The system under test: the port, driven as a cell's configuration and
traffic mix say.

``EngineCell`` (configuration kind ``engine``) builds the DemoScene with
the port's ``build_demo_scene`` and an ``Engine`` with the configuration's
keywords, and drives ``Engine.frame(dt, pad)`` in a closed loop.
``CrowdCell`` (kind ``crowd``) builds the crowd with the port's world and collision constructors
and drives ``SubstepGraph.step()``.

Set-up builds the system, runs ``warmup_frames`` (or
``warmup_substeps``) of the cell's own traffic, then, where the mix sets
``settle_s``, replays the substep graph for that many seconds and puts the
world state back as it was: a replay of the port's substep graph runs
~20% slower for the first 0-60 s of a process (PERF.md), so these replays
keep that phase in set-up, where ``setup_s`` counts it.

Each cell keeps, for the check, the answers at the indices the traffic
draws: the world state just before and just after the sampled frame's
substeps (or the sampled replay), and for a frame its input buffer and
image. The copies are made on the card, in stream order, and read back
only once the window has closed. Where the window ends before every drawn
index was reached, the loop goes on past its end until it has.

Spans: ``record_function`` ranges named ``portbench.*`` around the calls
into the program (a frame, its substeps, its frame program; a replay; the
answers' copies), which the traced run reads.
"""

from __future__ import annotations

import os
import time

import torch
from torch.profiler import record_function

from . import traffic as T
from .reference import crowd

PROGRAM = "swift_game_engine_tpu_torch"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _clone_leaves(world_mod, state):
    return [x.clone() for x in world_mod.state_leaves(state)]


def _settle(w, state, step, seconds: float, device) -> list:
    """Replays ``step()`` for ``seconds``, then copies the state it started
    from back into ``state``'s buffers -> the mean ms of a replay in each
    second (CUDA events; host clock on the CPU)."""
    if seconds <= 0:
        return []
    saved = _clone_leaves(w, state)
    buckets, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        b0, times = time.perf_counter(), []
        while time.perf_counter() - b0 < 1.0:
            if device.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                step()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            else:
                h = time.perf_counter()
                step()
                times.append((time.perf_counter() - h) * 1e3)
        buckets.append(sum(times) / len(times))
    for a, b in zip(w.state_leaves(state), saved):
        a.copy_(b)
    _sync(device)
    return buckets


def _to_cpu(sample: dict) -> dict:
    out = {}
    for k, v in sample.items():
        if isinstance(v, list):
            out[k] = [x.cpu() for x in v]
        elif isinstance(v, torch.Tensor):
            out[k] = v.cpu()
        else:
            out[k] = v
    return out


class _TimedProgram:
    """A frame program whose replays are timed by CUDA events and spanned."""

    def __init__(self, prog, events: list):
        self.prog, self.events = prog, events

    def run(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with record_function("portbench.frame_program"):
            out = self.prog.run()
        end.record()
        self.events.append((start, end))
        return out


class EngineCell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, root: str):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.root = device, root
        self.samples, self._want, self._pending = [], set(), None
        self.render_events = []
        self.frames = 0
        self.settle_ms = []

    def setup(self, traced: bool):
        import importlib
        ds = importlib.import_module(PROGRAM + ".scene.demo_scene")
        en = importlib.import_module(PROGRAM + ".scene.engine")
        self.w = importlib.import_module(PROGRAM + ".ecs.world")
        self.input_frame = importlib.import_module(
            PROGRAM + ".scene.input").InputFrame
        scene = dict(self.cfg["scene"])
        asset_dir = os.path.join(self.root, scene.pop("asset_dir"))
        self.world = ds.build_demo_scene(asset_dir, self.device, **scene)
        self.eng = en.Engine(self.world, device=self.device,
                             **self.cfg["engine"])
        self.initial = _clone_leaves(self.w, self.eng.state)
        self.scene_tris = int(self.world.geometry.tri.shape[0])
        self.traffic = T.FrameTraffic(self.mix)
        self.overlay = bool(self.cfg.get("overlay", True))
        step = self.eng._step

        def spanned_step(n):
            if self._pending is not None:
                with record_function("portbench.sample"):
                    self._pending["pre"] = _clone_leaves(self.w,
                                                         self.eng.state)
                self._pending["substeps"] = n
            with record_function("portbench.substeps"):
                step(n)

        self.eng._step = spanned_step
        if traced and self.device.type == "cuda":
            program = self.eng.program
            self.eng.program = lambda: _TimedProgram(program(),
                                                     self.render_events)
        for _ in range(int(self.mix["warmup_frames"])):
            self._frame(None)
        _sync(self.device)
        self.settle_ms = _settle(self.w, self.eng.state, self.eng._sim.step,
                                 float(self.mix.get("settle_s", 0)),
                                 self.device)
        self.render_events.clear()

    def _frame(self, index):
        dt, (lx, ly, rx, ry) = self.traffic.next()
        pad = self.input_frame(lx=lx, ly=ly, rx=rx, ry=ry)
        if index in self._want:
            self._pending = {"index": index}
        with record_function("portbench.frame"):
            self.eng.frame(dt, pad, with_overlay=self.overlay)
        if self._pending is not None:
            with record_function("portbench.sample"):
                s = self._pending
                s["post"] = _clone_leaves(self.w, self.eng.state)
                s["inputs"] = self.eng._inputs.clone()
                s["image"] = self.eng._pending[-1][0]
                self.samples.append(s)
            self._pending = None

    def window(self, seconds: float) -> dict:
        """The timed window: frames until ``seconds`` have passed, then a
        synchronize."""
        self._want = set(T.sample_indices(
            self.mix, self.seed, int(self.cfg["check"]["frames"])))
        returns = []
        t0 = time.perf_counter()
        k = 0
        while True:
            self._frame(k)
            k += 1
            t = time.perf_counter()
            returns.append(t)
            if t - t0 >= seconds:
                break
        _sync(self.device)
        t1 = time.perf_counter()
        self.frames = k
        while len(self.samples) < len(self._want):
            self._frame(k)
            k += 1
        _sync(self.device)
        gaps = [(b - a) * 1e3 for a, b in zip([t0] + returns[:-1], returns)]
        return {"frame_ms": (t1 - t0) * 1e3 / self.frames,
                "frame_ms_p90": _p90(gaps), "frames": self.frames}

    def traced(self) -> float:
        """The traced window's frames (``traced_frames``); returns its
        length in seconds on the host clock."""
        n = int(self.mix["traced_frames"])
        self._want = set()
        t0 = time.perf_counter()
        with record_function("portbench.window"):
            for _ in range(n):
                self._frame(None)
            _sync(self.device)
        self.frames = n
        return time.perf_counter() - t0

    def after_trace(self):
        """The check's answers of a traced run: the frames that follow the
        traced window, so that the copies stay out of the trace."""
        self._want = set(T.sample_indices(
            self.mix, self.seed, int(self.cfg["check"]["frames"])))
        for k in range(int(self.mix["check_window"])):
            self._frame(k)
        _sync(self.device)

    def answers(self):
        return [_to_cpu(s) for s in self.samples]

    def close(self):
        self.samples = []
        for name in ("eng", "world"):
            if hasattr(self, name):
                delattr(self, name)


class CrowdCell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, root: str):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = device
        self.samples = []
        self.replays = 0
        self.render_events = []
        self.frames = 0
        self.scene_tris = 0
        self.settle_ms = []

    def setup(self, traced: bool):
        import importlib
        pkg = importlib.import_module(PROGRAM)
        self.w = importlib.import_module(PROGRAM + ".ecs.world")
        step = importlib.import_module(PROGRAM + ".scene.step")
        dt = importlib.import_module(PROGRAM + ".scene.engine").FIXED_DT
        stepper, state = crowd.build(
            pkg, crowd.placement(int(self.cfg["agents"]), self.seed),
            self.device)
        self.graph = step.SubstepGraph(stepper, state, dt)
        self.initial = _clone_leaves(self.w, self.graph.state)
        for _ in range(int(self.mix["warmup_substeps"])):
            self.graph.step()
        _sync(self.device)
        self.settle_ms = _settle(self.w, self.graph.state, self.graph.step,
                                 float(self.mix.get("settle_s", 0)),
                                 self.device)

    def _run(self, want, stop, k: int = 0):
        flight = []
        while not stop(k):
            s = {"index": k, "substeps": 1} if k in want else None
            if s is not None:
                with record_function("portbench.sample"):
                    s["pre"] = _clone_leaves(self.w, self.graph.state)
            with record_function("portbench.substep"):
                self.graph.step()
            if s is not None:
                with record_function("portbench.sample"):
                    s["post"] = _clone_leaves(self.w, self.graph.state)
                self.samples.append(s)
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                flight.append(ev)
                if len(flight) > int(self.mix["in_flight"]):
                    flight.pop(0).synchronize()
            k += 1
        _sync(self.device)
        self.replays = k
        return k

    def window(self, seconds: float) -> dict:
        want = set(T.sample_indices(self.mix, self.seed,
                                    int(self.cfg["check"]["substeps"])))
        t0 = time.perf_counter()
        k = self._run(want, lambda k: k > 0 and
                      time.perf_counter() - t0 >= seconds)
        t1 = time.perf_counter()
        self._run(want, lambda j: len(self.samples) == len(want), k)
        self.replays = k
        return {"substeps_per_s": k / (t1 - t0), "substeps": k}

    def traced(self) -> float:
        n = int(self.mix["traced_substeps"])
        t0 = time.perf_counter()
        with record_function("portbench.window"):
            self._run(set(), lambda k: k >= n)
        return time.perf_counter() - t0

    def after_trace(self):
        """The check's answers of a traced run: the replays that follow the
        traced window, so that the copies stay out of the trace."""
        want = set(T.sample_indices(self.mix, self.seed,
                                    int(self.cfg["check"]["substeps"])))
        self._run(want, lambda k: k >= int(self.mix["check_window"]))

    def answers(self):
        return [_to_cpu(s) for s in self.samples]

    def close(self):
        self.samples = []
        if hasattr(self, "graph"):
            del self.graph


CELLS = {"engine": EngineCell, "crowd": CrowdCell}


def _p90(values):
    import statistics
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[-1]
