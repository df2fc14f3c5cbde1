"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout: builds the cell's system from its
configuration and the seed (set-up, timed as ``setup_s`` from the start of
this process to the first timed frame, the warm-up of the cell's own
shapes and the mix's ``settle_s`` of substep replays included), then with ``--trace 0`` measures the end-to-end metrics over
``--seconds`` of traffic, or with ``--trace 1`` profiles a short window
and reads the per-layer metrics (the check's answers then come from the
frames that follow it). Once the window has closed and the peak
memory is read, the program's state is freed and the reference
(``reference/check.py``) recomputes the sampled answers: each number
compared is printed beside its limit, last on standard error and last in
the result line. The last line of standard output is the JSON result.

Exits with another code than 0, and prints no result, where no CUDA card
(or fewer than the cell asks for) is visible, where the checkout's assets
differ from those the configuration states, or where jax, jaxlib, flax
or the JAX package were loaded. ``--control 1`` also computes the check's
control (the reference in bfloat16) and prints its numbers on standard
error; the benchmark's own runs leave it off.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "swift_game_engine_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __package__ in (None, ""):
    sys.path.insert(0, ROOT)

# Every cache the program or its libraries write lives at a fixed place in
# the checkout (the port's nvcc and BVH builds are in its own build/).
_CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(_CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_CACHE, "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from portbench import spec as S  # noqa: E402
from portbench.reference.check import reference  # noqa: E402
from portbench.systems import CELLS  # noqa: E402


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def finite(x: float) -> float:
    """A compared number as JSON can hold it: a value that is not finite
    (a state that diverged) reads 1e300, far above any limit."""
    x = float(x)
    return x if x == x and abs(x) < 1e300 else 1e300


def device_info(device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(args, bench=None, root=ROOT, workloads_dir=S.WORKLOADS,
        device=None, out=sys.stdout, err=sys.stderr) -> int:
    bench = S.load_bench(root) if bench is None else bench
    cell = S.Cell(bench, args.workload, root, workloads_dir)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return 3
        device = torch.device("cuda", 0)
    cfg = cell.config
    faults = S.asset_faults(cfg, root)
    if faults:
        print(f"portbench: the assets differ from configuration "
              f"{cell.config_entry['name']}: " + "; ".join(faults), file=err)
        return 5
    sys_ = CELLS[cfg["kind"]](cfg, cell.traffic, args.seed, device, root)
    recorder = None
    if args.trace:
        from portbench.trace import CallRecorder
        recorder = CallRecorder(0)
        if device.type == "cuda":
            recorder.install()
    sys_.setup(traced=bool(args.trace))
    setup_s = time.perf_counter() - T_START
    if sys_.settle_ms:
        print("portbench: settle, ms a substep replay in each second: " +
              " ".join(f"{x:.2f}" for x in sys_.settle_ms), file=err)
    metrics = {}
    extra = {}
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        from portbench.trace import TraceContext
        recorder.scene_tris = sys_.scene_tris
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            sys_.traced()
        render_ms = [a.elapsed_time(b) for a, b in sys_.render_events]
        ctx = TraceContext(prof, sys_.frames, getattr(sys_, "replays", 0),
                           render_ms, recorder.bytes_per_replay())
        del prof
        sys_.after_trace()
        for m in cell.per_layer:
            value = S.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        extra["busy_s"], extra["window_s"] = ctx.busy_s, ctx.window_s
        breakdown = ctx.breakdown()
        del ctx
    else:
        measured = sys_.window(args.seconds)
        measured["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in measured:
                metrics[m["name"]] = {"value": float(measured[m["name"]]),
                                      "unit": m["unit"]}
        extra["counted"] = {k: v for k, v in measured.items()
                            if k not in metrics}
    dev = device_info(device, cell.chips)
    dev.update({k: extra[k] for k in ("busy_s", "window_s") if k in extra})
    initial = [x.cpu() for x in sys_.initial]
    answers = sys_.answers()
    sys_.close()
    del sys_
    recorder = None
    _free(device)

    ref = reference(cfg, root, args.seed, device)
    numbers = ref.numbers(initial, answers, args.seed)
    control = ref.numbers(initial, answers, args.seed, torch.bfloat16) \
        if args.control else None
    del ref
    _free(device)

    limits = cfg["check"]["limits"]
    compared = {k: {"value": finite(numbers[k]), "limit": limits[k]}
                for k in limits}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}; the benchmark may load "
              "neither jax nor the JAX package", file=err)
        return 4
    result = {"correct": correct, "attempted": len(answers),
              "failed": 0 if correct else len(answers), "metrics": metrics,
              "device": dev}
    if args.trace:
        result["breakdown"] = breakdown
    if "counted" in extra:
        result["counted"] = extra["counted"]
    if control is not None:
        result["control"] = {k: finite(v) for k, v in control.items()}
        print("control " + " ".join(f"{k} {v!r}" for k, v in
                                    control.items()), file=err)
    result["compared"] = compared
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None) -> int:
    return run(parse(argv))


if __name__ == "__main__":
    sys.exit(main())
