"""Tiny CPU cells end to end: the result line has the contract's shape,
the reference agrees with the port, the bfloat16 control and the planted
faults are not correct."""

import pytest
import torch

from portbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(scope="module")
def demo():
    return tiny.run(tiny.DEMO, control=1)


def _check_shape(res, trace=False):
    assert KEYS <= set(res)
    assert list(res)[-1] == "compared"
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][key]) <= 10


def test_demo_cell_end_to_end(demo):
    rc, res, err = demo
    assert rc == 0, err
    _check_shape(res)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p90", "setup_s"}
    assert "compared pixel_miss" in err.strip().splitlines()[-1]


def test_demo_control_is_not_correct(demo):
    _, res, _ = demo
    limits = {k: v["limit"] for k, v in res["compared"].items()}
    assert any(res["control"][k] > limits[k] for k in limits)


def test_crowd_cell_and_control():
    rc, res, err = tiny.run(tiny.CROWD, control=1)
    assert rc == 0, err
    _check_shape(res)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"substeps_per_s", "setup_s"}
    assert res["control"]["state_gap"] > res["compared"]["state_gap"]["limit"]


def test_traced_crowd_cell():
    rc, res, err = tiny.run(tiny.CROWD, trace=1)
    assert rc == 0, err
    _check_shape(res, trace=True)
    assert res["correct"] is True


def _half_step(orig):
    """A substep that leaves the second half of the entities as they were."""
    def step(self, state, dt):
        from swift_game_engine_tpu_torch.ecs import world
        new = orig(self, state, dt)
        old = world.state_leaves(state)
        n = state.alive.shape[0]
        out = []
        for a, b in zip(world.state_leaves(new), old):
            if a.dim() and a.shape[0] == n:
                a = torch.cat([a[:n // 2], b[n // 2:]])
            out.append(a)
        return world.rebuild_state(new, iter(out))
    return step


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_crowd_faults_are_not_correct(fault, monkeypatch):
    from swift_game_engine_tpu_torch.scene import step
    if fault == "unchanged":
        monkeypatch.setattr(step.SubstepGraph, "step", lambda self: None)
    else:
        monkeypatch.setattr(step.Stepper, "_substep_impl",
                            _half_step(step.Stepper._substep_impl))
    rc, res, err = tiny.run(tiny.CROWD)
    assert rc == 0, err
    assert res["correct"] is False


def test_altered_frame_is_not_correct(monkeypatch):
    from swift_game_engine_tpu_torch.scene import engine

    def altered(u8, fps):
        return (u8.int() + 40).clamp(0, 255).to(torch.uint8)
    monkeypatch.setattr(engine, "overlay_blit_device", altered)
    rc, res, err = tiny.run(tiny.DEMO)
    assert rc == 0, err
    assert res["correct"] is False
    assert res["compared"]["pixel_miss"]["value"] > 0.5


def test_assets_that_differ_give_no_result(tmp_path):
    """A checkout whose assets differ from those the configuration states
    present or absent exits with code 5 and prints no result."""
    import json
    import os
    b = tiny.bench()
    entry = next(c for c in b["configs"] if c["name"] == "tiny_demo")
    with open(os.path.join(tiny.S.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    for assets in ({"dir": "assets", "present": ["no_such.static.json"]},
                   {"dir": "assets", "absent": ["Semla.static.json"]}):
        cfg["assets"] = assets
        path = tmp_path / "tiny_demo.json"
        path.write_text(json.dumps(cfg))
        entry["file"] = str(path)
        rc, res, err = tiny.run(tiny.DEMO, bench_=b)
        assert rc == 5 and res is None
        assert "assets differ" in err
