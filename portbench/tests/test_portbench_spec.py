"""BENCHMARK.json against the benchmark's contract: every cell, configuration,
traffic mix and per-layer metric it names resolves to its file, and the
entries keep the shapes and limits the contract sets."""

import json
import os
import re

import pytest

from portbench import spec as S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = S.load_bench()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    assert cfg["file"].startswith("portbench/")
    with open(os.path.join(S.ROOT, cfg["file"])) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    assert S.asset_faults(body) == []


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    c = S.Cell(BENCH, cell["name"])
    assert c.traffic["loop"] in ("frames", "substeps")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(S.metric_reader(metric["name"]))


def test_route_is_the_same_for_every_seed():
    """A frame mix's pads follow its fixed route; the seed only draws the
    answers the check compares."""
    from portbench import traffic as T
    for cell in BENCH["workloads"]:
        mix = S.Cell(BENCH, cell["name"]).traffic
        if mix["loop"] != "frames":
            continue
        a, b = T.FrameTraffic(mix), T.FrameTraffic(mix)
        assert [a.next() for _ in range(500)] == [b.next() for _ in range(500)]
        assert len({a.sticks_at(k) for k in range(2000)}) > 1
        draws = {tuple(T.sample_indices(mix, s, 2)) for s in (1, 2**31 + 5)}
        assert len(draws) == 2
