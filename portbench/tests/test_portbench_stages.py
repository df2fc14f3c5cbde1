"""The stage readers (``metrics/render_*_ms.py``, ``metrics/substep_*_ms.py``,
``stage_split.py``) on a small synthetic trace: two frames, each with two
substep graph launches and one frame-program launch, and the program's
stage tables registered as a capture registers them. Each reader gives the
stage's device ms a launch; none where a launch's operation count is no
table's, where two tables of that count differ, or where the program keeps
no tables. The program's ``sge.*`` stage ranges on the host (an eager
frame opens them) change no reading of the readers the benchmark had, nor
the breakdown."""

import pytest
import torch

from portbench import spec as S
from portbench.trace import TraceContext
from swift_game_engine_tpu_torch.scene import cuda_graph as CG

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
# (stage, first node, end node)
SUBSTEP = (("sge.substep.begin", 0, 2), ("sge.substep.move", 2, 4),
           ("sge.substep.separate", 4, 5), ("sge.substep.end", 5, 6))
FRAME = (("sge.render.other", 0, 1), ("sge.render.flatten", 1, 2),
         ("sge.render.primary", 2, 3), ("sge.render.layer1", 3, 4),
         ("sge.render.shadows", 4, 5), ("sge.render.mirror", 5, 6),
         ("sge.render.refraction", 6, 7), ("sge.render.layer1", 7, 8),
         ("sge.render.continuations", 8, 9), ("sge.render.composite", 9, 10),
         ("sge.render.other", 10, 11))
# render_bounces_ms reads the two bounce stages together
BOUNCES = {"mirror": "bounces", "refraction": "bounces"}
OLD = ("host_calls_per_frame", "substep_kernels.frame", "render_ms",
       "port_kernels_ms", "kernels_roofline", "idle_share.frame")


class _Event:
    """One event of ``kineto_results.events()``."""

    def __init__(self, name, start_us, end_us, cid=0, device=CPU):
        self._n, self._s, self._e = name, start_us, end_us
        self._c, self._d = cid, device

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int((self._e - self._s) * 1000)

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._d


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _trace(with_sge: bool):
    """Events of two frames. Substep launch k runs 6 operations of
    (i + 1) * (k + 1) us each, the frame program's ops (i + 1) * 10 us, and
    the profiler's gaps lie between the ops; with ``with_sge`` the
    program's stage ranges on the host too."""
    ev, cid = [], 100
    host = [("portbench.window", 0.0, 10_000.0)]
    for f in range(2):
        f0 = 1000.0 + f * 4000.0
        host.append(("portbench.frame", f0, f0 + 3000.0))
        if with_sge:
            host += [("sge.render.other", f0 + 1, f0 + 2999.0),
                     ("sge.render.flatten", f0 + 2, f0 + 10.0),
                     ("sge.render.composite", f0 + 2900.0, f0 + 2990.0)]
        host.append(("portbench.substeps", f0 + 20.0, f0 + 200.0))
        dev = f0 + 300.0
        for k in range(2):
            cid += 1
            at = f0 + 30.0 + 50.0 * k
            ev.append(_Event("cudaGraphLaunch", at, at + 20.0, cid))
            if with_sge:
                host.append(("sge.substep.move", at - 1.0, at + 21.0))
            for i in range(6):
                d = (i + 1) * (k + 1)
                ev.append(_Event(f"kernel_s{i}", dev, dev + d, cid, CUDA))
                dev += d + 5.0          # a gap the profiler widens
        cid += 1
        at = f0 + 250.0
        host.append(("portbench.frame_program", at - 2.0, at + 30.0))
        if with_sge:
            host.append(("sge.render.primary", at - 1.0, at + 29.0))
        ev.append(_Event("cudaGraphLaunch", at, at + 20.0, cid))
        dev += 500.0                    # an idle gap
        for i in range(11):
            name = "memcpy HtoD" if i == 0 else (
                "wide_walk_kernel" if i == 5 else f"kernel_f{i}")
            ev.append(_Event(name, dev, dev + (i + 1) * 10.0, cid, CUDA))
            dev += (i + 1) * 10.0 + 3.0
        cid += 1
        ev.append(_Event("cudaEventSynchronize", f0 + 2900.0, f0 + 2990.0,
                         cid))
    ev += [_Event(n, a, b) for n, a, b in host]
    return TraceContext(_Prof(ev), 2, 0, [1.0, 2.0], None)


@pytest.fixture
def tables(monkeypatch):
    # {name: {program: table}}, as cuda_graph.register keeps them
    t = {"sge.substep": {object(): CG.StageTable(6, SUBSTEP)},
         "sge.frame_program": {object(): CG.StageTable(11, FRAME)}}
    monkeypatch.setattr(CG, "STAGE_TABLES", t)
    return t


def _expected():
    out = {}
    # substep launch k: op i lasts (i + 1) * (k + 1) us; mean over k of
    # (k + 1) = 1.5
    for stage, a, b in SUBSTEP:
        out["substep_" + stage.split(".")[-1] + "_ms"] = \
            sum(i + 1 for i in range(a, b)) * 1.5 / 1e3
    for stage, a, b in FRAME:
        name = stage.split(".")[-1]
        key = "render_" + BOUNCES.get(name, name) + "_ms"
        out[key] = out.get(key, 0.0) + sum((i + 1) * 10.0
                                           for i in range(a, b)) / 1e3
    return out


NEW = sorted(_expected())


@pytest.mark.parametrize("name", NEW)
def test_stage_reader_reads_its_stage(tables, name):
    assert S.metric_reader(name)(_trace(True)) == pytest.approx(
        _expected()[name], rel=1e-9)


def test_stages_sum_to_the_replays_op_time(tables):
    ctx = _trace(True)
    render = sum(S.metric_reader(n)(ctx) for n in NEW
                 if n.startswith("render_"))
    substep = sum(S.metric_reader(n)(ctx) for n in NEW
                  if n.startswith("substep_"))
    assert render == pytest.approx(sum((i + 1) * 10.0
                                       for i in range(11)) / 1e3)
    assert substep == pytest.approx(21 * 1.5 / 1e3)


@pytest.mark.parametrize("name", NEW)
def test_stage_reader_none_on_an_op_count_mismatch(tables, name):
    for key, by_program in list(tables.items()):
        (t,) = by_program.values()
        tables[key] = {object(): CG.StageTable(t.node_count + 1, t.stages)}
    assert S.metric_reader(name)(_trace(True)) is None


@pytest.mark.parametrize("name", NEW)
def test_stage_reader_none_on_two_tables_of_one_count(tables, name):
    key = "sge.substep" if name.startswith("substep_") else \
        "sge.frame_program"
    (t,) = tables[key].values()
    tables[key][object()] = CG.StageTable(t.node_count, t.stages[::-1])
    assert S.metric_reader(name)(_trace(True)) is None


@pytest.mark.parametrize("name", NEW)
def test_stage_reader_none_without_tables(monkeypatch, name):
    monkeypatch.setattr(CG, "STAGE_TABLES", {})
    assert S.metric_reader(name)(_trace(True)) is None
    monkeypatch.delattr(CG, "STAGE_TABLES")       # a program without marks
    assert S.metric_reader(name)(_trace(True)) is None


@pytest.mark.parametrize("name", OLD)
def test_program_spans_change_no_earlier_reading(tables, name):
    with_sge, without = _trace(True), _trace(False)
    value = S.metric_reader(name)(without)
    assert S.metric_reader(name)(with_sge) == value
    # the trace has no bytes floors for the roofline
    assert (value is None) == (name == "kernels_roofline")


def test_program_spans_change_no_breakdown(tables):
    with_sge, without = _trace(True), _trace(False)
    assert with_sge.breakdown() == without.breakdown()
    assert (with_sge.busy_s, with_sge.window_s) == \
        (without.busy_s, without.window_s)
    assert with_sge.breakdown()["idle_gaps"]
