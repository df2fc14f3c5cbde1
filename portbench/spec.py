"""Where the benchmark finds a cell's parts, by the names in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:
the configuration is the JSON file its ``configs`` entry names, the traffic
mix is ``portbench/workloads/<traffic>.json``, and each per-layer metric is
read by ``portbench/metrics/<metric name>.py``. Adding a cell, a
configuration, a mix or a metric adds files and entries; nothing here names
one.
"""

from __future__ import annotations

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
WORKLOADS = os.path.join(PKG, "workloads")
METRICS = os.path.join(PKG, "metrics")


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One cell: its entry, its configuration's entry and file, its traffic
    mix, and the metrics it reports (end-to-end without a trace, per-layer
    with one)."""

    def __init__(self, bench: dict, name: str, root: str = ROOT,
                 workloads_dir: str = WORKLOADS):
        self.root = root
        self.entry = _named(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config_entry = _named(bench["configs"], self.entry["config"],
                                   "configuration")
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(workloads_dir,
                               f"{self.entry['traffic']}.json")) as f:
            self.traffic = json.load(f)
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells


def asset_faults(config: dict, root: str = ROOT) -> list:
    """Where the checkout's assets differ from what the configuration
    states (``assets``: a ``dir``, the files ``present`` and the files of
    the source scene that are ``absent``) -> a line for each difference."""
    assets = config.get("assets")
    if not assets:
        return []
    d = os.path.join(root, assets["dir"])
    return ([f"{n}: stated present, not in {assets['dir']}/"
             for n in assets.get("present", ())
             if not os.path.exists(os.path.join(d, n))] +
            [f"{n}: stated absent, but in {assets['dir']}/"
             for n in assets.get("absent", ())
             if os.path.exists(os.path.join(d, n))])


def metric_reader(name: str, metrics_dir: str = METRICS):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(metrics_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
