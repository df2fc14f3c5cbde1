"""PyTorch port: the stage ranges and capture stage marks of
``swift_game_engine_tpu_torch/spans.py``, on the CPU.

One eager frame of a tiny CPU Engine (tests/torch_sim_worlds.py's world
with render meshes, built by the port alone) under torch.profiler opens
every stage of the hybrid frame program (``sge.render.*``) inside the
program's root stage, and the substep's four stages (``sge.substep.*``).
Without the profiler the spans are null contexts; on the CPU nothing is
captured and no mark is kept. The stage table of a capture puts each node
in the innermost stage open when it was added (``cuda_graph.stage_table``),
here from marks made with a stand-in node counter; ``cuda_graph.register``
keeps a program's table while the program lives, and none for a graph
that is no chain.
"""

import contextlib
import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swift_game_engine_tpu_torch import spans
from swift_game_engine_tpu_torch.scene import cuda_graph as CG
from swift_game_engine_tpu_torch.scene.engine import Engine
from swift_game_engine_tpu_torch.scene.input import InputFrame
import torch_sim_worlds as W

RENDER = {f"sge.render.{s}" for s in (
    "flatten", "primary", "layer1", "continuations", "mirror", "refraction",
    "shadows", "composite", "other")}
SUBSTEP = {f"sge.substep.{s}" for s in ("begin", "move", "separate", "end")}


def _ancestors(ev):
    out, p = [], ev.cpu_parent
    while p is not None:
        if p.name.startswith("sge."):
            out.append(p.name)
        p = p.cpu_parent
    return out


@pytest.fixture(scope="module")
def traced():
    """(Engine, STAGE_TABLES before it, [(span, its sge.* ancestors)]) of
    one profiled eager frame after a first frame."""
    tables = {k: dict(v) for k, v in CG.STAGE_TABLES.items()}
    eng = Engine(W.port_engine_world("cpu"), 32, 18, max_layers=3,
                 device="cpu")
    eng.frame(1 / 60, InputFrame(ly=1.0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.frame(1 / 60, InputFrame(ly=1.0))
    seen = [(ev.name, _ancestors(ev)) for ev in prof.events()
            if ev.name.startswith("sge.")]
    return eng, tables, seen


def test_eager_frame_opens_every_stage_nested(traced):
    _, _, seen = traced
    names = {n for n, _ in seen}
    assert RENDER <= names and SUBSTEP <= names
    for name, up in seen:
        if name in RENDER:
            assert up[-1:] == (["sge.render.other"] if
                               name != "sge.render.other" else []), (name, up)
        if name in ("sge.render.layer1", "sge.render.continuations"):
            assert up[0] == "sge.render.primary", (name, up)
        if name in ("sge.render.mirror", "sge.render.refraction"):
            assert up[0] in ("sge.render.layer1",
                             "sge.render.continuations"), (name, up)
        if name in SUBSTEP:
            assert up == [], (name, up)


def test_cpu_keeps_no_marks(traced):
    eng, tables, _ = traced
    assert eng._sim.captured is None and eng.program().captured is None
    assert spans._marks is None
    assert {k: dict(v) for k, v in CG.STAGE_TABLES.items()} == tables


def test_spans_are_null_without_the_profiler():
    assert not torch._C._autograd._profiler_enabled()
    for make in (spans.span, spans.stage):
        assert isinstance(make("sge.x"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("sge.a"), spans.stage("sge.b"):
            pass
    assert {"sge.a", "sge.b"} <= {ev.name for ev in prof.events()}


class _Program:
    """A stand-in for a FrameProgram or SubstepGraph with a capture."""

    SPAN = "sge.test"

    def __init__(self, stages, nodes: int = 4):
        self.captured = CG.Captured(graph=None, seconds=0.0, pool_bytes=0,
                                    launches=[], node_count=nodes,
                                    stages=stages)


def test_register_keeps_a_table_while_its_program_lives(monkeypatch):
    monkeypatch.setattr(CG, "STAGE_TABLES", {})
    stages = (("a", 0, 3), (CG.ROOT, 3, 4))
    old, new = _Program(stages), _Program(stages[:1], 3)
    CG.register(old)
    CG.register(new)
    assert dict(CG.STAGE_TABLES["sge.test"]) == {
        old: CG.StageTable(4, stages), new: CG.StageTable(3, stages[:1])}
    del old                     # a replaced program takes its table along
    gc.collect()
    assert list(CG.STAGE_TABLES["sge.test"].values()) == [
        CG.StageTable(3, stages[:1])]


def test_register_keeps_nothing_without_a_chain(monkeypatch):
    monkeypatch.setattr(CG, "STAGE_TABLES", {})
    forked, eager = _Program(None), _Program(None)
    eager.captured = None
    CG.register(forked)
    CG.register(eager)
    assert CG.STAGE_TABLES == {}


@pytest.mark.parametrize("marks, nodes, table", [
    ([], 5, ((CG.ROOT, 0, 5),)),
    ([("a", True, 0), ("a", False, 5)], 5, (("a", 0, 5),)),
    ([("a", True, 2), ("a", False, 4)], 6,
     ((CG.ROOT, 0, 2), ("a", 2, 4), (CG.ROOT, 4, 6))),
    ([("o", True, 0), ("p", True, 1), ("s", True, 3), ("s", False, 4),
      ("p", False, 6), ("o", False, 7)], 7,
     (("o", 0, 1), ("p", 1, 3), ("s", 3, 4), ("p", 4, 6), ("o", 6, 7))),
    # empty stages leave no range; a stage reopened at once merges
    ([("a", True, 0), ("b", True, 2), ("b", False, 2), ("a", False, 3),
      ("a", True, 3), ("a", False, 5)], 5, (("a", 0, 5),)),
    ([("a", True, 1), ("a", False, 1)], 1, ((CG.ROOT, 0, 1),)),
])
def test_stage_table_innermost(marks, nodes, table):
    got = CG.stage_table(marks, nodes)
    assert got == table
    assert got[0][1] == 0 and got[-1][2] == nodes
    assert all(a[2] == b[1] for a, b in zip(got, got[1:]))


def test_stage_marks_inside_a_recording(monkeypatch):
    counts = iter(range(100))
    monkeypatch.setattr(spans, "node_count", lambda: next(counts))
    with spans.recording_marks() as marks:
        with spans.stage("o"):
            with spans.stage("i"):
                pass
        with spans.span("not a stage"):
            pass
    assert spans._marks is None
    assert marks == [("o", True, 0), ("i", True, 1), ("i", False, 2),
                     ("o", False, 3)]
    assert CG.stage_table(marks, 5) == (("o", 0, 1), ("i", 1, 2),
                                        ("o", 2, 3), (CG.ROOT, 3, 5))


def test_profile_port_splits_by_the_program_stages(traced):
    """profile_port.py's render split reads the program's own
    ``sge.render.*`` ranges (device time 0 on the CPU)."""
    import profile_port
    eng = traced[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.render(0.5)
    split, staged = profile_port._stage_split(prof, 1)
    assert set(split) == {s[len("sge.render."):] for s in RENDER} - {"other"}
    assert staged == 0.0 and set(split.values()) == {0.0}
