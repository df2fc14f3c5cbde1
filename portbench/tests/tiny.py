"""Tiny CPU cells for the benchmark's tests: BENCHMARK.json with two test
cells added, whose configurations and traffic mixes are in ``data/``."""

from __future__ import annotations

import io
import json
import os

import torch

from portbench import run as R
from portbench import spec as S

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEMO, CROWD = "tiny_demo.tiny_walk", "tiny_crowd.tiny_run"


def bench() -> dict:
    b = S.load_bench()
    for name in ("tiny_demo", "tiny_crowd"):
        b["configs"].append({
            "name": name, "source": "the benchmark's tests",
            "file": f"portbench/tests/data/configs/{name}.json",
            "reduced": [], "why": "a CPU-sized cell"})
    for cell in (DEMO, CROWD):
        config, traffic = cell.split(".")
        b["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [DEMO]
    # the crowd's metrics, whose readers wait for a crowd cell (PERF.md §7)
    b["end_to_end"].append({"name": "substeps_per_s", "unit": "substeps/s",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock", "workloads": [CROWD]})
    for name, unit in (("substep_kernels.crowd", "kernels"),
                       ("idle_share.crowd", "%")):
        b["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "substeps_per_s",
                               "workloads": [CROWD]})
    return b


def run(cell: str, trace: int = 0, control: int = 0, seed: int = 2**31 + 7,
        seconds: float = 0.5, bench_: dict = None):
    """(exit code, the result line as a dict or None, stderr text)."""
    out, err = io.StringIO(), io.StringIO()
    args = R.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", str(trace), "--control",
                    str(control)])
    rc = R.run(args, bench=bench() if bench_ is None else bench_,
               workloads_dir=os.path.join(DATA, "workloads"),
               device=torch.device("cpu"), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
