"""PyTorch port: the stage tables of the captured substep and frame
program (``scene/cuda_graph.py``), on the card.

The machine with the card has no JAX, and tests/conftest.py imports it, so
this file imports no jax and runs there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda_spans.py -q

Here (no CUDA device) every test skips. On the small DemoScene (without
the imported assets), hybrid RT at 160x90, for the substep graph and the
frame program: the stage table covers the graph's nodes once each, in
consecutive ranges; one traced replay runs exactly ``node_count`` device
operations (kernels, copies, sets), and the spans put no range of their
own on the device; the first operation of each stage in the replay is the
first the same stage's range issues in a traced eager run of the body, and
every operation of the replay is, in order, the one the eager run's range
of its stage issued (a copy node may run as a kernel); and a graph captured
with the marks left out has as many nodes. A capture whose work forks onto
another stream and joins back keeps no table; one from a single stream
does.
"""

import contextlib
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swift_game_engine_tpu_torch.scene import cuda_graph as CG
from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene
from swift_game_engine_tpu_torch.scene.engine import (FIXED_DT, Engine,
                                                      FrameProgram)
from swift_game_engine_tpu_torch.scene.input import InputFrame
from swift_game_engine_tpu_torch.scene.step import SubstepGraph

pytestmark = pytest.mark.cuda

ASSETS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                      "assets"))
STAGES = {
    "substep": {f"sge.substep.{s}" for s in ("begin", "move", "separate",
                                             "end")},
    "frame": {f"sge.render.{s}" for s in (
        "flatten", "primary", "layer1", "continuations", "mirror",
        "refraction", "shadows", "composite", "other")},
}


@pytest.fixture(scope="module")
def eng():
    """A small DemoScene Engine whose first frame captured both graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured on the "
                    "card")
    dev = torch.device("cuda")
    world = build_demo_scene(ASSETS, dev, include_imported_assets=False)
    e = Engine(world, 160, 90, device=dev)
    e.frame(1 / 60, InputFrame(ly=1.0))
    torch.cuda.synchronize()
    return e


def _owner(eng, which):
    """The SubstepGraph or the FrameProgram."""
    return eng._sim if which == "substep" else eng.program()


def _graph(eng, which):
    """(Captured, a replay, an eager run of the body)."""
    own = _owner(eng, which)
    return own.captured, (own.step if which == "substep" else own.run), \
        own.eager


def _trace(fn):
    """(device ops, host runtime calls, sge.* host spans) of ``fn()``, each
    (name, start us, end us, correlation id), device ops sorted by start."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev, rt, sp = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        rec = (e.name(), s, s + e.duration_ns() / 1e3, e.correlation_id())
        if e.device_type() == cuda:
            dev.append(rec)
        elif rec[0].startswith("sge."):
            sp.append(rec)
        elif rec[0].startswith("cu"):
            rt.append(rec)
    return sorted(dev, key=lambda d: d[1]), rt, sp


def _replay_ops(replay):
    dev, rt, _ = _trace(replay)
    assert not [d for d in dev if d[0].startswith("sge.")]
    launches = [r for r in rt if "GraphLaunch" in r[0]]
    assert len(launches) == 1
    return [d for d in dev if d[3] == launches[0][3]]


@pytest.mark.parametrize("which", ["substep", "frame"])
def test_stage_table_covers_the_graph(eng, which):
    cap, _, _ = _graph(eng, which)
    t = cap.stages
    assert cap.node_count > 0 and t[0][1] == 0 and t[-1][2] == cap.node_count
    assert all(a < b for _, a, b in t)
    assert all(x[2] == y[1] for x, y in zip(t, t[1:]))
    assert {s for s, _, _ in t} == STAGES[which]
    own = _owner(eng, which)
    assert CG.STAGE_TABLES[own.SPAN][own] == CG.StageTable(cap.node_count, t)


@pytest.mark.parametrize("which", ["substep", "frame"])
def test_replay_runs_node_count_ops(eng, which):
    cap, replay, _ = _graph(eng, which)
    assert len(_replay_ops(replay)) == cap.node_count


def _eager_stages(eager, which):
    """[(op name, the innermost stage range open at its launch)] of a traced
    eager run, in the order the ops start (ops launched outside every stage
    range left out)."""
    dev, rt, sp = _trace(eager)
    launched = {r[3]: r[1] for r in rt}
    stages = [x for x in sp if x[0] in STAGES[which]]
    out = []
    for name, _, _, cid in dev:
        t = launched.get(cid)
        inner = [x for x in stages if t is not None and x[1] <= t <= x[2]]
        if inner:
            out.append((name, max(inner, key=lambda x: x[1])[0]))
    return out


def _table_stages(cap, ops):
    assert len(ops) == cap.node_count, (len(ops), cap.node_count)
    return [(ops[k][0], s) for s, a, b in cap.stages for k in range(a, b)]


def _op(name):
    """An op's name, a copy or a set as such: a graph runs some of its
    copy nodes as kernels (``memcpy32_post``) that an eager run makes as
    copies."""
    low = name.lower()
    return "copy or set" if low.startswith(("memcpy", "memset")) else name


@pytest.mark.parametrize("which", ["substep", "frame"])
def test_first_op_of_each_stage_matches_eager(eng, which):
    cap, replay, eager = _graph(eng, which)
    first, eager_first = {}, {}
    for name, s in _table_stages(cap, _replay_ops(replay)):
        first.setdefault(s, name)
    for name, s in _eager_stages(eager, which):
        eager_first.setdefault(s, name)
    assert eager_first == first


@pytest.mark.parametrize("which", ["substep", "frame"])
def test_every_op_in_the_stage_that_issued_it_eagerly(eng, which):
    cap, replay, eager = _graph(eng, which)
    assert [(_op(n), s) for n, s in _eager_stages(eager, which)] == \
        [(_op(n), s) for n, s in _table_stages(cap, _replay_ops(replay))]


@pytest.mark.parametrize("which", ["substep", "frame"])
def test_marks_add_no_node(eng, which, monkeypatch):
    monkeypatch.setattr(CG, "STAGE_TABLES", {})
    monkeypatch.setattr(CG, "recording_marks",
                        lambda: contextlib.nullcontext([]))
    cap, _, _ = _graph(eng, which)
    if which == "substep":
        plain = SubstepGraph(eng.stepper, eng.state, FIXED_DT).captured
    else:
        plain = FrameProgram(eng._frame_body, eng.device).captured
    assert plain.node_count == cap.node_count
    assert plain.stages == ((CG.ROOT, 0, cap.node_count),)


@pytest.mark.parametrize("fork", [False, True])
def test_only_a_chain_keeps_a_table(eng, fork):
    x = torch.zeros(64, device="cuda")
    side = torch.cuda.Stream()

    def body():
        x.add_(1.0)
        if fork:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                x.mul_(2.0)
            torch.cuda.current_stream().wait_stream(side)
        else:
            x.mul_(2.0)
        x.add_(1.0)

    cap, _ = CG.capture(body, body, 1)
    assert cap.node_count == 3
    assert cap.stages == (None if fork else ((CG.ROOT, 0, 3),))
