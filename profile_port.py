#!/usr/bin/env python3
"""Where the time of a port frame goes, on one NVIDIA GPU.

    python3 profile_port.py [--out profile.json]

Drives the six paths that chip_smoke.py defines (``path_engines``: the
hybrid RT frame of the full DemoScene; the traced frame of the decimated
DemoScene; the same at RT scale 0.25; the raster path of the full scene;
the list-binned raster path and the non-layered traced frame with the
shadow prepass of the decimated scene), each at 960x540, and for each:

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
    idle share against the unprofiled frame, kernel launches, memcpys and
    stream/device synchronisations per frame, and device time per frame of
    the port's own kernels and of the rest.

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
    intervals, kernels, launches, memcpys, syncs = [], {}, 0, 0, 0
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
            syncs += 1
    busy = _union_ms(intervals) / PROFILED
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
        "memcpys_per_frame": memcpys / PROFILED,
        "syncs_per_frame": syncs / PROFILED,
        "port_kernels_ms_per_frame": own,
        "other_kernels_ms_per_frame": rest,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the numbers as JSON to this file")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_port: no CUDA device")
    from chip_smoke import path_engines

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card (nvidia-smi name, power limit): {card}")
    result = {"card": card}
    for name, _, eng in path_engines(torch.device("cuda:0")):
        result[name] = _profile(eng, torch, np)
    for name, r in result.items():
        if name != "card":
            print(name, json.dumps(r))
    if not args.out:
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
