#!/usr/bin/env python3
"""Where the time of a port frame goes, on one NVIDIA GPU.

    python3 profile_port.py [--out profile.json] [--repo DIR] [--crowd]

Drives the paths that chip_smoke.py defines (``path_engines``: the
hybrid RT frame of the full DemoScene; the traced frame of the decimated
DemoScene; the same at RT scale 0.25; the raster path of the full scene;
the list-binned raster path and the non-layered traced frame with the
shadow prepass of the decimated scene; the hybrid frame of the full
DemoScene with its player posed; the decimated scene's "peels" and
"raster" primaries; the hybrid frame of the full DemoScene shaded
deferred; the raster path of the full scene with traced visibility), each
at 960x540, and for each:

  * 10 frames by host clock around ``Engine.frame(1/60,
    InputFrame(ly=1.0))`` (the bench headline's input) + ``synchronize()``;
  * the stages of one frame (``substeps``: the frame's one fixed substep
    of the DemoScene world, one replay of the Engine's CUDA graph of it,
    with ``substep_eager``, the same substep run eagerly by
    ``Stepper.substep``, beside it; ``flatten_frame``: the extraction,
    ``Engine.extract``, and flatten_frame; ``render``: the path's frame,
    ``Engine.render_target``; ``present``: upscale, the render graph's
    composite pass, u8) by host clock with a synchronize after each,
    median of 5;
  * a torch.profiler trace of 3 frames: device busy time per frame (the
    union of the kernel and memcpy intervals, so overlaps count once), the
    idle share against the unprofiled frame and the trace's longest idle
    gaps, the kernels the card runs, the launch calls the host makes
    (kernel and graph launches: a CUDA graph's replay is one) and the host
    time of the graph launches, memcpys, the frames' stream and event
    synchronisations (by kind; the device synchronisation that ends the
    trace is the script's own and not counted) per frame, and device time
    per frame of the port's own kernels and of the rest;
  * the render's device time split by stage, from a torch.profiler trace of
    3 eager renders (``Engine.render``; in a graph's replay no host range
    is open, and the benchmark's ``render_*_ms`` readers split the replays
    by the stage tables the captures keep): the stages are the program's
    own ``sge.render.*`` ranges (``swift_game_engine_tpu_torch/spans.py``),
    and a kernel counts for the innermost range it was issued in:
    "primary" (``render_frame``: rays, primary visibility (K1, K5 or a
    traced layer 1), the layer records, dither), "layer1" (the frame's
    first layer shade), "continuations" (layers 2.., compacted, with their
    traces), "mirror" and "refraction" (the two bounce passes, with their
    K4 traces), "shadows" (the light-0 shadow source and every shadow
    sweep), "deferred" (``render/deferred.py``'s shade but its one shadow
    sweep), "raster" (the raster path's frame), "flatten"
    (``flatten_frame``), "composite" (``composite_frame``) and "other"
    (extraction, upscale, outside every stage range).

``--crowd`` profiles chip_smoke.py's path 12 crowd instead of the paths:
the ``ENTITY_AGENTS`` crowd's substep replicated (a ``SubstepGraph``)
and on each of ``ENTITY_VIRTUAL`` virtual shards (an
``EntityShardedSubstep``), one graph replay a substep each: ms a replay
by CUDA events (mean of 10), and from a torch.profiler trace of one
replay its device busy time, the share of the replay the card is idle
(gaps between the graph's kernels), and the kernels it runs.

``--repo DIR`` profiles the port in another checkout (its package and its
``chip_smoke.path_engines``), so that a parent commit and a change are
measured in one run on one card; a checkout whose port opens no stage
ranges (one older than the stage ranges) gives no stage split, only
"other".

Prints one line per path and, with ``--out``, writes the numbers there as
JSON.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FRAMES, PROFILED, STAGE_REPS = 10, 3, 5
STAGE = "sge.render."     # the program's render stage ranges (spans.py)


def _union_ms(intervals):
    """Length of the union of (start, end) microsecond intervals, in ms."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def _device_us(ev):
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(ev, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _stage_split(prof, frames):
    """Device ms per frame of each of the program's render stages (its
    ``sge.render.*`` ranges), a kernel counted for the innermost stage
    range it was issued in."""
    out = {}

    def inner_total(ev):
        total = 0.0
        for ch in ev.cpu_children:
            total += _device_us(ch) if ch.name.startswith(STAGE) else \
                inner_total(ch)
        return total

    def stage_total(ev):
        # the range's kernels, less those of the stage ranges inside it
        return _device_us(ev) - inner_total(ev)

    top = 0.0
    for ev in prof.events():
        if ev.device_type.name != "CPU" or not ev.name.startswith(STAGE):
            continue
        key = ev.name[len(STAGE):]
        out[key] = out.get(key, 0.0) + stage_total(ev)
        parent, nested = ev.cpu_parent, False
        while parent is not None:
            nested |= parent.name.startswith(STAGE)
            parent = parent.cpu_parent
        if not nested:
            top += _device_us(ev)
    return {k: v / 1e3 / frames for k, v in out.items()}, top / 1e3 / frames


def _profile(eng, torch, np):
    from torch.profiler import ProfilerActivity, profile

    from swift_game_engine_tpu_torch.render.scene_geometry import flatten_frame
    from swift_game_engine_tpu_torch.scene.engine import FIXED_DT
    from swift_game_engine_tpu_torch.scene.input import InputFrame

    pad = InputFrame(ly=1.0)    # the bench headline's input
    for _ in range(2):
        eng.frame(1 / 60, pad)
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        eng.frame(1 / 60, pad)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    dev = eng.device
    cam = eng.camera
    rw, rh = eng.rt_size
    stages = {"substeps": [], "substep_eager": [], "flatten_frame": [],
              "render": [], "present": []}
    composite = next(p for p in eng.graph.passes if p.name == "composite")
    for _ in range(STAGE_REPS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        eng.stepper.substep(eng.state, FIXED_DT)
        torch.cuda.synchronize()
        tg = time.perf_counter()
        eng._sim.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf, palettes = eng.extract(eng.accumulator / FIXED_DT)
        fg = flatten_frame(eng.geometry, tf, palettes)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = eng.render_target(
            fg, torch.as_tensor(cam.inv_view_proj(rw, rh), device=dev),
            torch.as_tensor(cam.view_proj(rw, rh), device=dev), cam.position)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        view = composite.execute({"rt_output": eng._upscale(img),
                                  "exposure": eng.tone_mapping_exposure})
        (torch.clamp(view["view"], 0.0, 1.0) * 255.0).to(torch.uint8)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(("substep_eager", "substeps", "flatten_frame",
                         "render", "present"),
                        (tg - ts, t0 - tg, t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(v * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            eng.frame(1 / 60, pad)
        torch.cuda.synchronize()
    intervals, kernels, launches, memcpys, syncs = [], {}, 0, 0, {}
    host = graphs = 0
    graph_host_us = 0.0
    for ev in prof.events():
        name = ev.name
        if ev.device_type.name == "CUDA":
            span = (ev.time_range.start, ev.time_range.end)
            intervals.append(span)
            if "memcpy" in name.lower() or "memset" in name.lower():
                memcpys += 1
            else:
                launches += 1
                kernels[name] = kernels.get(name, 0.0) + span[1] - span[0]
        elif "Synchronize" in name:
            syncs[name] = syncs.get(name, 0) + 1
        elif name.lower().startswith("cu") and "launch" in name.lower():
            host += 1
            if "graph" in name.lower():
                graphs += 1
                graph_host_us += ev.time_range.end - ev.time_range.start
    busy = _union_ms(intervals) / PROFILED
    # the device's longest idle gaps (ms) in the profiled frames
    gaps, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            gaps.append((a - end) / 1e3)
        end = b if end is None else max(end, b)
    # the script's own synchronize() after the frames is a device sync; a
    # frame makes stream and event syncs
    frame_syncs = sum(v for k, v in syncs.items() if "Device" not in k)

    # the render's device time by stage, on eager renders
    alpha = eng.accumulator / FIXED_DT
    eng.render(alpha)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            eng.render(alpha)
        torch.cuda.synchronize()
    split, staged = _stage_split(prof, PROFILED)
    render_busy = _union_ms([
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type.name == "CUDA"]) / PROFILED
    render_kernels = sum(
        _device_us(ev) for ev in prof.events()
        if ev.device_type.name == "CPU" and ev.cpu_parent is None) / 1e3 / \
        PROFILED
    split["other"] = max(render_kernels - staged, 0.0)
    median = float(np.median(times))
    own = {k: v / 1e3 / PROFILED for k, v in kernels.items() if "sge::" in k}
    rest = sum(v for k, v in kernels.items() if "sge::" not in k) / 1e3 / \
        PROFILED
    return {
        "rt_size": list(eng.rt_size), "frame_ms_median": median,
        "frame_ms_p90": float(np.percentile(times, 90)),
        "stages_ms": {k: float(np.median(v)) for k, v in stages.items()},
        "device_busy_ms": busy, "idle_share": 1.0 - busy / median,
        "kernel_launches_per_frame": launches / PROFILED,
        "host_launches_per_frame": host / PROFILED,
        "graph_launches_per_frame": graphs / PROFILED,
        "memcpys_per_frame": memcpys / PROFILED,
        "syncs_per_frame": frame_syncs / PROFILED,
        "syncs_by_kind": syncs,
        "graph_launch_host_ms_per_frame": graph_host_us / 1e3 / PROFILED,
        "longest_idle_gaps_ms": sorted(gaps, reverse=True)[:2 * PROFILED],
        "render_stage_device_ms": split,
        "render_device_ms": render_kernels,
        "render_busy_ms": render_busy,
        "port_kernels_ms_per_frame": own,
        "other_kernels_ms_per_frame": rest,
    }


def _crowd(torch):
    """Path 12's crowd substep replicated and on virtual shards: ms a
    replay (CUDA events), device busy ms, idle share and kernels of one
    profiled replay."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import ENTITY_AGENTS, ENTITY_VIRTUAL
    from swift_game_engine_tpu_torch.examples import bench_crowd
    from swift_game_engine_tpu_torch.parallel import sharding as SH
    from swift_game_engine_tpu_torch.scene.engine import FIXED_DT
    from swift_game_engine_tpu_torch.scene.step import SubstepGraph
    stepper, state = bench_crowd.build(ENTITY_AGENTS,
                                       device=torch.device("cuda:0"))
    out = {}
    for k in (1,) + ENTITY_VIRTUAL:
        sim = SubstepGraph(stepper, state, FIXED_DT) if k == 1 else \
            SH.EntityShardedSubstep(stepper, SH.shard_world_state(k, state),
                                    FIXED_DT, k)
        sim.step()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(FRAMES):
            sim.step()
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / FRAMES
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sim.step()
            torch.cuda.synchronize()
        spans = [(ev.time_range.start, ev.time_range.end)
                 for ev in prof.events() if ev.device_type.name == "CUDA"]
        busy = _union_ms(spans)
        name = f"crowd_{ENTITY_AGENTS}_" + ("replicated" if k == 1 else
                                            f"{k}_virtual_shards")
        out[name] = dict(ms=ms, busy_ms=busy, idle=1 - busy / ms,
                         kernels=len(spans),
                         capture_s=sim.capture_seconds)
        del sim
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the numbers as JSON to this file")
    ap.add_argument("--repo", default=REPO,
                    help="the checkout whose port is profiled (default: "
                         "this one)")
    ap.add_argument("--crowd", action="store_true",
                    help="profile path 12's crowd substep in place of the "
                         "paths")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_port: no CUDA device")
    from chip_smoke import path_engines

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card (nvidia-smi name, power limit): {card}")
    print(f"profiling the port in {os.path.abspath(args.repo)}")
    result = {"card": card, "repo": os.path.abspath(args.repo)}
    if args.crowd:
        result.update(_crowd(torch))
    else:
        for name, _, eng in path_engines(torch.device("cuda:0")):
            result[name] = _profile(eng, torch, np)
    for name, r in result.items():
        if name not in ("card", "repo"):
            print(name, json.dumps(r))
    if not args.out:
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
