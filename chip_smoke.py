#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. It builds the port's kernels from ``swift_game_engine_tpu_torch/
csrc`` (first use, one nvcc per source in parallel) and drives eleven
paths of the port through its entry points, each for 2 warm-up and 10
timed frames (paths 8a, 8b, 9 and 10: 3) at 960x540 (the RT paths with
``max_layers=3``), then path 11, the sharded frame, path 12, the
entity-sharded substep, and the knob paths' first frames (below). Every
frame of paths 1-10 is
the bench headline's ``eng.frame(1/60, InputFrame(ly=1.0))``: the
DemoScene world steps (one fixed substep a frame, one replay of the
Engine's CUDA graph of the substep: the player falls and walks, the NPCs
and platforms move), then one replay of the Engine's frame graph
(extraction, flatten, render, composite, u8, overlay, snapshot: captured
once per RT size), and each path checks that its Engine captured both
graphs, that every timed frame took its substep and that the player moved
and stayed above the ground; then three more frames, with the camera
turning and the exposure and the fps digits changing, each of whose
replays must equal the frame program run eagerly on the card at the same
inputs bit for bit (image and snapshot), and one whole frame under
``torch.cuda.set_sync_debug_mode("error")``: no host read from the
intent to the snapshot's copy:

  1. ``demo_rt_960x540``: the full DemoScene (``import_tri_budget=0``,
     181,340 triangles), ``Engine(path="rt")`` with the default hybrid
     visibility and 4 shadow layers: K1 cluster raster twice a frame,
     K2/K3 shadow sweeps per shade call, K4 bounces;
  2. ``demo_trace_960x540``: the default, decimated DemoScene (its tree
     must fit the walks' 22,000-row cap) with ``primary="trace"``: K5 (the
     layered shared-origin walk) once a frame, K2/K3, K4, and no K1;
  3. ``demo_trace_rtscale_0.25``: the same Engine after
     ``set_rt_resolution_scale(0.25)`` — a 240x135 RT target (40,960
     padded lanes, under the 100,000-lane cluster threshold) upscaled to
     960x540: K5 once a frame, K7 (the shadow walk) per shade call, no
     K2/K3;
  4. ``demo_raster_960x540``: the full scene, ``Engine(path="raster")``:
     K1 once a frame over all triangles with the raster's opaque flags, 2
     layers, and no BVH kernel;
  5. ``demo_raster_lists_960x540``: the decimated scene,
     ``Engine(path="raster", raster_mode="lists")``: the list binning and
     K9 twice a frame (one per peel);
  6. ``demo_trace_so_prepass_960x540``: the decimated scene,
     ``Engine(primary="trace", layered=False, shadow_layers=5,
     shadow_prepass=True)``: K6 once dense and once per continuation layer,
     K8 once per shade call in front of the per-layer K4 shadow loop, K4
     bounces, no K1/K2/K3/K5/K7;
  7. ``demo_rt_posed_960x540``: path 1's Engine on the full DemoScene built
     from the synthetic rig's directory (tests/torch_pose_rig.py, written
     into ``local/pose_rig``: the skeleton and five motion profiles the
     reference's posed player reads, beside links to the repository's
     assets), so the player is posed: the locomotion FSM, the action clock
     and the pose stack run in the substep graph, and its palettes skin the
     body; the timed frame ``DODGE_FRAME`` carries a dodge. It prints the
     substep graph's kernels beside path 1's, the locomotion states met,
     the action weight after the dodge and that the palettes are finite and
     rigid (|det - 1| < 1e-3), and one replay of the substep must equal an
     eager card substep from the same state bit for bit;
  8. ``demo_peels_960x540`` (8a) and ``demo_raster_primary_960x540`` (8b):
     the decimated scene with ``primary="peels"`` (K1 over every triangle,
     3 peeled layers, once a frame) and ``primary="raster"`` (K1 over every
     triangle, 1 layer, once a frame; K4 continuations), 2 + 3 frames each;
  9. ``demo_rt_deferred_960x540``: path 1's Engine with ``deferred=True``
     (render/deferred.py) on the full scene, 2 + 3 frames: K1 twice, one
     K4 call over the merged bounce stream (none if the static pruning
     drops every bounce segment; the surviving segments are printed) and
     one K2/K3 pair over every shadow origin of the frame, sorted live
     first, a frame. Its image is held against path 1's sequential frame
     from the same state (``save_state`` / ``load_state``) with
     tests/test_deferred.py's bounds (>= 99.5% of pixels within 1e-4, max
     < 0.1, means within 1e-3 relative), and the sweep's dead-tail warps
     must test no cluster;
 10. ``demo_raster_trace_960x540``: the full scene,
     ``Engine(path="raster", raster_vis="trace")``: K4 twice a frame (the
     raster path's 2 layers), nothing else, 2 + 3 frames;
 11. ``demo_rt_sharded_960x540``: the full scene through
     ``parallel/sharding.py`` ``sharded_fused_step`` (one substep, the
     extraction, the flatten and the image-plane-sharded traced frame,
     ``max_layers=3``, 4 shadow layers, mirror and refraction on, no
     dither) in an NCCL group of ``min(cards, 4)`` ranks, one spawned
     process a card, rendezvous through a ``file://`` store in a
     temporary directory. The step is captured at its first call: a step
     copies the state in and makes two graph replays, the substep's and
     the frame's (the extraction, flatten, the shard's render and the
     NCCL all-gather inside it). 2 + 3 frames from a fixed camera, the
     launch counts of rank 0 (K4 and K2/K3: shards of at least 100,000
     lanes on a tree past the walks' row cap), the frame median, the
     host's CUDA API calls of one step (torch.profiler), the captures'
     seconds and pool; on every rank the last timed frame run again
     eagerly from the state it started from must equal the replayed
     frame bit for bit (image and state), and one whole step under
     ``set_sync_debug_mode("error")`` must make no host sync. On this
     card the last timed frame is rendered again from its starting state,
     whole and as 4 and 8 virtual shards (``sharded_render`` with an int
     group, captured at its first call; the 4-shard replay bit for bit
     its eager body): each shard's shadow source must be the reference's
     rule for its lane count (4 shards of 139,264 lanes: the cluster
     sweeps; 8 of 69,632: the K4 loop), the 4-slice image must equal the
     ranks' and the whole batch's (1e-5) and the 8-slice image meet the
     whole batch's (>= 99% of pixels within 1e-4); the whole render's
     K4, K2 and K3 calls are held against their twins on subsets, as paths
     9 and 10's are;
 12. ``crowd_entity_sharded_1024``: the entity axis
     (``shard_world_state``, ``EntityShardedSubstep``; ``entity_phase``).
     The 1,024-agent crowd of ``examples/bench_crowd.build`` (separation's
     grid branch) takes 8 substeps from one state replicated (a
     ``SubstepGraph``), on path 11's NCCL ranks (``entity_worker``, in the
     same processes) and on 3, 4 and 8 virtual shards on this card, each
     one graph replay a substep with its all-gathers inside; each final
     state must be the replicated run's bit for bit or within 1e-5 (the
     count of leaves that differ printed), and ms a substep and each
     capture's seconds and pool are printed, and on the ranks the device
     busy ms of a replay and the NCCL kernels' share of it. Then path 11's
     DemoScene frame again from the state its last timed frame started
     from, on an entity-sharded state through the captured
     ``sharded_fused_step`` (``demo_rt_entity_sharded_960x540``: 4
     virtual shards here, padded by ``pad_entities_to`` to the rank count
     on the ranks where it does not divide), against the replicated
     state's frame: the states equal, the images within 1e-5, a second
     call bit for bit the first; its K2, K3 and K4 calls are held against
     their twins on subsets.

The knob paths' first frames (``knob_frames``, KNOB_FRAMES): one eager
frame at 960x540 of each of ``layer_slots=2`` (path 2), ``trans_subdiv=1``
(path 1, printing whether its gate held), ``unlit_split`` and
``unlit_dense`` (path 1) and ``packet_compact`` (paths 1 and 6), each
against its path's default eager frame: bit for bit (the reference
reports identical images), but for ``layer_slots`` (the share of pixels
that differ printed: fewer slots than layers change records by design)
and ``trans_subdiv`` (at most 1e-4 of the pixels may differ, by less than
0.1, each explained by its translucent K1 records: the children's
corners are f32 midpoints, so on the parent's outer edges their edge
tests, and their depths, round otherwise than the parent's; each such
pixel's records are printed), with one eager time beside the default's.
The kernel calls of the role each knob changes (K5 at 2 slots; K1 over
the subdivided translucent subset; K2, K3 and K4 in the batched
continuation shade; K4 on packet-compacted bounce retraces) are held
against their twins, tagged with the knob frame's name.

Every path but 11 asserts the DemoScene branch its scene took: the
stand-in player on paths 1-6 and 8-10, the posed one on path 7. Paths
7-10 also print the device busy time and the syncs a frame of 3
profiled frames (at most 1).
Paths 1 and 9 time each of a frame's sorted shadow sweeps (K2 + K3) on
its sorted origins and on the same origins unsorted, and print the lanes
each sort moved.

Each path's kernel launch counts are zeroed just before its timed frames
and read just after (a replay adds the launches its capture recorded:
``scene/cuda_graph.py``); the capture seconds and the pool of every
(path, RT size) graph are printed. Path 1 also runs at
``pipeline_depth=3`` (2 + 10 frames on a new Engine): its first two
frames are zero, the rest are not constant, its frame median is printed
beside depth 1's, and four more calls each return the frame of two calls
before, equal to the eager card frame of that call's inputs. Then the
simulation on its own (``simulation_phase``; it runs no kernel of the
port, only PyTorch's):

  * 60 substeps of the DemoScene world with ``InputFrame(ly=1.0)``
    intents, each started on the card from the CPU's state of the same
    substep and held against the CPU's substep: positions and velocities
    within 1e-4, integer and bool fields equal (a disagreement passes only
    as a tie that rounding decides, proven as the CPU tests prove the
    reference's: the CPU reaches the card's result with one agent moved by
    at most 5e-5; it is printed); each also loaded into a
    ``SubstepGraph`` and replayed, which must equal the eager card
    substep bit for bit;
  * one substep and one replay under
    ``torch.cuda.set_sync_debug_mode("error")``: neither reads anything
    back to the host;
  * ms per substep eager and graphed (CUDA events, median and p90 of
    ``SIM_TIMED`` = 10), the kernels the card runs and the launches the
    host makes for one eager substep and for one replay (torch.profiler),
    the capture's seconds and the graph pool's size, for the DemoScene
    world and for a 256-agent crowd on procedural meshes
    (``swift_game_engine_tpu_torch/examples/bench_crowd.build``: the
    separation grid).

The simulation phase then runs again on path 7's posed world (60 substeps
card against CPU, the pose clocks and palettes held too, a dodge at
substep ``SIM_DODGE``; the replays bit-equal; its substep timed). Then the
pose phase (``pose_phase``): bench.py's pose configuration #2, 64
characters x 120 steps of ``PoseEngine.step_character`` with the action
layer, each card step held against the CPU's (1e-4), and char-steps/s
eager and as one captured step. Then the examples phase
(``examples_phase``): the port's entry points as a user runs them,
``run_demo`` (3 frames at 320x180; each PNG, decoded with zlib and
struct, must be its frame), ``bench_crowd`` at 4 and 1,024 agents (its
table: K = 32 substep replays a count) and ``play --frames 10`` at
192x108.

And the kernels:

  * every kernel is held against its plain PyTorch version on the inputs
    the first frame of each path that runs it gave it (the walks K5-K8 on
    a fixed subset of the captured lanes: their twins walk lane by lane in
    lockstep and are slow; K2, K3 and K4 of paths 9 and 10, whose streams
    reach 5M lanes, on a subset too: a strided sample of the live lanes
    and a slice of the dead ones; K10, which no path runs, on path 5's
    candidate lists, and its first layer against K9's first peel; path
    7's kernels are path 1's and are held there, as are path 9's K1
    calls), and both are
    timed (CUDA events); each kernel's bound — the larger of its bytes over
    the card's memory rate and its operations over the FP32 rate — is
    computed from the same inputs: for K1-K10 from the work their counting
    instantiations count on that call (printed as "K<n> work" lines and
    checked equal to the kernel's records), with the bytes floor and a
    one-test-per-record bound beside; K9 and K10 (one patch-culled
    template), bounded like K1 by their pixels' edge tests, also print the
    bound of their whole counted work (the warps' row cull included), that
    of the one-thread-a-pixel walk they replaced, and any record that
    differs from the plain version; K5-K8
    (instances of K4's wide walk) also print their bound before the
    redesign, the tests the binary walk they replaced makes on the subset
    (K5, K7: on every 4th lane of it), scaled (``trace_layers_so_binary``,
    ``trace_rays_so_binary``, ``trace_shadow_factor_binary``,
    ``trace_shadow_any_binary``), and both walks' work per ray. K1 is
    reported per role (its layer count: the opaque and translucent rasters
    of path 1, path 4's raster, path 8's peels and 1-layer primary), with
    every record where it differs from
    its plain version. A kernel's entry in the JSON line carries the path
    name after an ``@`` for every path but the first that runs it;
  * four small renders, each through the kernels and through the plain
    versions, must agree (>= 99% of pixels within 1e-4, means within
    0.1%): a 320x180 hybrid render of the full scene (73,728 lanes, with
    the cluster threshold lowered to 0 so that its shadows take the
    cluster sweeps K2/K3, as paths 1 and 2 do), a 128x72 traced render of
    the decimated scene (K5, K7), a 480x270 list-binned raster frame (K9)
    and a 128x72 frame configured as path 6 (K6, K8, K4);
  * the layer schedules: 320x180 hybrid renders of the full scene with
    ``lbatch`` 0, 1 and 3 (cluster shadows, the threshold lowered to 0)
    through the kernels, each against ``lbatch=2`` (>= 99.9% of pixels
    within 1e-4, means within 1e-4 relative).

``path_engines`` is the one definition of the eleven paths;
``profile_port.py`` drives the same ones.

It prints the card (``nvidia-smi`` name and power limit), the build and
scene statistics, each path's frame times and launches, one JSON line of
per-kernel results and, last, ``{"ok": true, "device": {...}}``. Any
failure exits non-zero before that line; with no CUDA device it exits
non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(REPO, "assets")
W, H = 960, 540
WARMUP, TIMED = 2, 10
LAYERS, SHADOW_LAYERS = 3, 4
# The DemoScene's ground and the player's capsule (r 1.5, half height 1.0).
GROUND_Y, PLAYER_CORE_TO_FOOT = -3.0, 2.5
# Simulation phase: substeps held card against CPU; timed substeps.
SIM_STEPS, SIM_TIMED, CROWD_AGENTS = 60, 10, 256
PATHS = ("demo_rt_960x540", "demo_trace_960x540", "demo_trace_rtscale_0.25",
         "demo_raster_960x540", "demo_raster_lists_960x540",
         "demo_trace_so_prepass_960x540", "demo_rt_posed_960x540",
         "demo_peels_960x540", "demo_raster_primary_960x540",
         "demo_rt_deferred_960x540", "demo_raster_trace_960x540")
# Path 7: the timed frame whose input carries the dodge. Paths 8a-10:
# timed frames each.
DODGE_FRAME, PRIMARY_TIMED = 3, 3
# The pose phase: bench.py's pose configuration (#2), characters x steps.
POSE_CHARS, POSE_STEPS = 64, 120

# Tolerances of kernel vs plain version. Both compute the same records with
# the same f32 operation order (the kernels build with --fmad=false), so
# records agree exactly except where a triangle edge or an equal-depth tie
# falls on a sample: at most this fraction of records may differ ...
MAX_MISMATCH = 1e-3
# ... and where the records agree, t / depth / barycentrics agree to f32
# rounding of the same expression (relative).
MAX_REL_ERR = 1e-5
# The walks' twins run on at most this many of the captured lanes.
TWIN_LANES = 65_536
# On paths 9 and 10, K2/K3's twins run on at most this many live lanes
# and a quarter as many dead ones, K4's on at most a quarter of those.
STREAM_TWIN_LANES = 32_768

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory rate and FP32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of one test, counted from the kernels' sources.
SLAB_OPS = 25         # slab test: 6 sub, 6 mul, 10 min/max, 3 compares
SO_SLOT_OPS = 29      # K5 slot: 3 dots (15), sign fold (5), divide, compares
WALK_SLOT_OPS = 26    # K7 slot: 3 dots (15), 3 subtracts, compares
MT_OPS = 45           # K4 Moller-Trumbore slot test
EDGE_OPS = 20         # K1/K9/K10 edge functions and depth of a fragment
CULL_OPS = 80         # K9/K10 row cull: 3 forms x 25 (7 mul, 7 add, 4
                      # min/max, 3 abs, 3 compares, a negate), 5 to combine
SWEEP_OPS = 26        # K2/K3 slot: 3 dots (15), 3 subtracts, compares
META_OPS = 12         # K1/K2/K3 cluster entry against a footprint or a lane


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up call, by CUDA
    events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed(fn):
    """fn() once, cold -> (its result, ms by CUDA events). The plain
    versions are timed on the very call whose records are compared."""
    import torch
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _compare(name, key_k, key_p, vals_k, vals_p):
    """Mismatch fraction of record keys (per lane: a row of keys) and the
    max absolute / relative error of the values where the keys agree.
    Returns the max absolute error."""
    import torch
    same = key_k == key_p
    if same.dim() == 2:
        same = same.all(1)
    mism = float((~same).float().mean())
    err = rel = 0.0
    for a, b in zip(vals_k, vals_p):
        lanes = same if a.dim() == same.dim() else same[:, None]
        m = lanes & (a < 1e30) & (b < 1e30)
        if m.any():
            d = (a[m] - b[m]).abs()
            err = max(err, float(d.max()))
            rel = max(rel, float((d / torch.clamp(b[m].abs(), min=1.0))
                                 .max()))
    print(f"  {name}: {int((~same).sum())} of {same.numel()} records differ "
          f"({mism:.2e}), max abs err {err:.3e}, max rel err {rel:.3e}")
    if mism > MAX_MISMATCH or rel > MAX_REL_ERR:
        _fail(f"{name} disagrees with its plain version")
    return err


def _nbytes(tensors):
    """Bytes of the tensors; an int stands for the bytes of the part of an
    input that the function reads."""
    return sum(t if isinstance(t, int) else t.numel() * t.element_size()
               for t in tensors if t is not None)


def _bound(inputs, outputs, ops):
    """(bound_ms, bound_by): the larger of the bytes (each input read once,
    each output written once; ints: bytes) over the memory rate and the
    operations over the FP32 rate."""
    t_bytes = _nbytes(inputs + outputs) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _count_line(cnt, per_warp=32):
    """mean / p99 / max of each per-lane count and of the per-warp maxima
    of the per-lane counts (``per_warp`` lanes a warp); per-warp counts
    (``warp_*``) as they are."""
    import torch
    out = []
    for k, v in cnt.items():
        v = v.double()
        if not k.startswith("warp_"):
            pad = (-v.numel()) % per_warp
            w = torch.cat([v, v.new_zeros(pad)]).reshape(-1, per_warp)
            out.append(f"{k} {_stats(v)} (per-warp max {_stats(w.amax(1))})")
        else:
            out.append(f"{k} {_stats(v)}")
    return "; ".join(out)


def _stats(v):
    import torch
    return (f"mean {float(v.mean()):.1f} p99 "
            f"{float(torch.quantile(v, 0.99)):.0f} max {float(v.max()):.0f} "
            f"sum {float(v.sum()):.0f}")


def _ray_line(cnt):
    """mean / p99 / max of a walk twin's per-ray nodes and slot tests."""
    return "; ".join(f"{k} {_stats(cnt[k].double())}"
                     for k in ("nodes", "slots"))


def _subset(n, device, lanes=TWIN_LANES):
    """Every k-th lane, at most ``lanes`` of them."""
    import torch
    step = max(1, math.ceil(n / lanes))
    return torch.arange(0, n, step, device=device)


def _stream_subset(live, n_live):
    """A subset of a long, mostly dead stream: every k-th live lane, at
    most ``n_live`` of them, then every k-th dead lane, at most a quarter
    as many; the live lanes first."""
    import torch

    def strided(idx, n):
        return idx[::max(1, math.ceil(idx.numel() / n))][:n]
    return torch.cat([strided(torch.nonzero(live).squeeze(1), n_live),
                      strided(torch.nonzero(~live).squeeze(1),
                              n_live // 4)])


class Capture:
    """Records the first call's arguments of chosen kernel wrappers."""

    def __init__(self):
        self.args, self._orig = {}, []

    def on(self, mod, name, key_of):
        orig = getattr(mod, name)

        def wrapper(*a, **k):
            self.args.setdefault(key_of(*a, **k), (a, k))
            return orig(*a, **k)
        setattr(mod, name, wrapper)
        self._orig.append((mod, name, orig))

    def off(self):
        for mod, name, orig in self._orig:
            setattr(mod, name, orig)
        self._orig = []


def pose_rig_dir():
    """The synthetic rig (tests/torch_pose_rig.py: the skeleton and five
    motion profiles the posed player reads, with links to the repository's
    other assets), written into the checkout's ``local/pose_rig``."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_pose_rig
    return torch_pose_rig.write_rig(os.path.join(REPO, "local", "pose_rig"),
                                    ASSETS)


def path_engines(dev):
    """The eleven paths, in order: yields (name, scene, Engine). The three
    scenes (full, decimated, full posed) are built once each, when a path
    first needs them; paths 2 and 3 share one Engine (path 3 is path 2's
    Engine after ``set_rt_resolution_scale(0.25)``)."""
    from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene
    from swift_game_engine_tpu_torch.scene.engine import Engine
    kw = dict(max_layers=LAYERS, shadow_layers=SHADOW_LAYERS, device=dev)
    full = build_demo_scene(ASSETS, device=dev, import_tri_budget=0)
    yield PATHS[0], full, Engine(full, W, H, path="rt", **kw)
    world = build_demo_scene(ASSETS, device=dev)
    eng = Engine(world, W, H, primary="trace", **kw)
    yield PATHS[1], world, eng
    eng.set_rt_resolution_scale(0.25)
    yield PATHS[2], world, eng
    yield PATHS[3], full, Engine(full, W, H, path="raster", device=dev)
    yield PATHS[4], world, Engine(world, W, H, path="raster",
                                  raster_mode="lists", device=dev)
    yield PATHS[5], world, Engine(world, W, H, primary="trace",
                                  layered=False, shadow_layers=5,
                                  shadow_prepass=True, max_layers=LAYERS,
                                  device=dev)
    posed = build_demo_scene(pose_rig_dir(), device=dev, import_tri_budget=0)
    yield PATHS[6], posed, Engine(posed, W, H, path="rt", **kw)
    del posed
    yield PATHS[7], world, Engine(world, W, H, primary="peels", **kw)
    yield PATHS[8], world, Engine(world, W, H, primary="raster", **kw)
    yield PATHS[9], full, Engine(full, W, H, path="rt", deferred=True, **kw)
    yield PATHS[10], full, Engine(full, W, H, path="raster",
                                  raster_vis="trace", device=dev)


def zero_counts():
    """Every kernel wrapper's launch count set to 0 (after the card is
    idle)."""
    import torch
    from swift_game_engine_tpu_torch.ops import cluster_shadow as CS
    from swift_game_engine_tpu_torch.ops import rt_kernel as RK
    from swift_game_engine_tpu_torch.render import tile_raster as TR
    torch.cuda.synchronize()
    TR.launches = [0] * len(TR.launches)
    TR.list_launches = TR.peel_launches = 0
    CS.occl_launches = CS.slots_launches = 0
    RK.launches = RK.so_launches = RK.so_closest_launches = 0
    RK.shadow_launches = RK.any_launches = 0


def read_counts():
    """Launches by kernel; K1's by role (its layer count)."""
    from swift_game_engine_tpu_torch.ops import cluster_shadow as CS
    from swift_game_engine_tpu_torch.ops import rt_kernel as RK
    from swift_game_engine_tpu_torch.render import tile_raster as TR
    k1 = {f"K1/layers={n}": v for n, v in enumerate(TR.launches, 1)}
    return {**k1, "K2": CS.occl_launches,
            "K3": CS.slots_launches, "K4": RK.launches,
            "K5": RK.so_launches, "K6": RK.so_closest_launches,
            "K7": RK.shadow_launches, "K8": RK.any_launches,
            "K9": TR.list_launches, "K10": TR.peel_launches}


def _sim_leaves(state, prefix=""):
    out = []
    for f in state._fields:
        x = getattr(state, f)
        out += _sim_leaves(x, prefix + f + ".") if isinstance(x, tuple) \
            else [(prefix + f, x)]
    return out


# Float fields held card against CPU (positions, velocities and the pose
# systems' clocks and palettes).
SIM_FLOATS = ("trs_t", "wp_local", "body_pos", "body_vel", "body_prev_pos",
              "loco.times", "loco.blend_t", "loco.idle_inertia",
              "action.time", "action.weight", "palettes", "pose_phase")
# The substep of the simulation phase whose input carries a dodge (it
# restarts the posed player's action clip; other players have no dodge).
SIM_DODGE = 20


def _sim_disagree(ref, card, atol=1e-4):
    """The first disagreement of the card's state with the CPU's: a
    position or velocity beyond atol, or an integer/bool field that
    differs -> message, or None."""
    import torch
    for (name, a), (_, b) in zip(_sim_leaves(ref), _sim_leaves(card)):
        if a.dtype.is_floating_point:
            if name in SIM_FLOATS:
                d = (a - b).abs()
                if float(d.max()) > atol:
                    e = int(d.reshape(d.shape[0], -1).amax(1).argmax())
                    return f"{name} of entity {e} differs by " \
                        f"{float(d.max()):.3g}"
        elif not torch.equal(a, b):
            e = int((a != b).reshape(a.shape[0], -1).any(1).int().argmax())
            return f"{name} of entity {e}: CPU {a[e].tolist()}, card " \
                f"{b[e].tolist()}"
    return None


def _bits_differ(a, b):
    """The name of the first leaf where two world states differ in any
    bit, or None."""
    import torch
    for (name, x), (_, y) in zip(_sim_leaves(a), _sim_leaves(b)):
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(
                x.contiguous().reshape(-1).view(torch.uint8),
                y.contiguous().reshape(-1).view(torch.uint8)):
            return name
    return None


def _event_ms(fn):
    """ms of each of SIM_TIMED calls of fn (CUDA events)."""
    import torch
    ms = []
    for _ in range(SIM_TIMED):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return ms


def _launches(fn):
    """(kernels the card ran, launch calls the host made) in one call of
    fn (torch.profiler; memcpys and memsets not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = host = 0
    for ev in prof.events():
        name = ev.name.lower()
        if ev.device_type.name == "CUDA":
            kernels += "memcpy" not in name and "memset" not in name
        elif name.startswith("cu") and "launch" in name:
            host += 1
    return kernels, host


def _api_calls(fn):
    """The CUDA API calls the host makes in one call of fn, by name
    (torch.profiler; the closing ``cudaDeviceSynchronize`` not counted)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {}
    for ev in prof.events():
        if ev.device_type.name != "CUDA" and re.match(r"cu(da)?[A-Z]",
                                                      ev.name):
            calls[ev.name] = calls.get(ev.name, 0) + 1
    calls["cudaDeviceSynchronize"] = calls.get("cudaDeviceSynchronize", 1) - 1
    return {k: v for k, v in sorted(calls.items()) if v}


def _union_ms(spans):
    """The length of the union of (start, end) intervals, us -> ms."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e3


def _device_share(fn, reps):
    """(device busy ms a call: the union of the kernel and memcpy
    intervals; ms a call of the NCCL kernels; NCCL kernels a call) of
    ``reps`` calls of fn under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans, nccl = [], []
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            span = (ev.time_range.start, ev.time_range.end)
            spans.append(span)
            if "nccl" in ev.name.lower():
                nccl.append(span)
    return (_union_ms(spans) / reps, _union_ms(nccl) / reps,
            len(nccl) / reps)


def _busy_syncs(eng, frames=3):
    """(device busy ms a frame: the union of the kernel and memcpy
    intervals; the stream and event synchronisations a frame) of
    ``frames`` frames of ``eng`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from swift_game_engine_tpu_torch.scene.input import InputFrame
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            eng.frame(1 / 60, InputFrame(ly=1.0))
        torch.cuda.synchronize()
    spans, syncs = [], 0
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            spans.append((ev.time_range.start, ev.time_range.end))
        elif "Synchronize" in ev.name and "Device" not in ev.name:
            syncs += 1
    return _union_ms(spans) / frames, syncs / frames


def simulation_phase(dev, world, label="demo", crowd=True):
    """The fixed-step simulation on the card (see the module docstring) of
    ``world`` (and, with ``crowd``, the 256-agent crowd's timing). Returns
    {label: dict of ms and launches a substep, eager and graphed}."""
    import numpy as np
    import torch
    from swift_game_engine_tpu_torch.ecs.world import copy_state, to_device
    from swift_game_engine_tpu_torch.scene.engine import (FIXED_DT,
                                                          apply_intent)
    from swift_game_engine_tpu_torch.scene.input import (InputFrame,
                                                         InputSystem)
    from swift_game_engine_tpu_torch.scene.step import SubstepGraph

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cstep = world.stepper.to(cpu)
    gstep, e = world.stepper, world.player
    graph = SubstepGraph(gstep, world.state, FIXED_DT)
    state = to_device(world.state, cpu)
    inp, (walk, run, thresh) = InputSystem(), world.movement
    ties = 0
    for i in range(SIM_STEPS):
        apply_intent(state, e, inp.update(
            InputFrame(ly=1.0, dodge=i == SIM_DODGE), FIXED_DT, False, walk,
            run, thresh))
        start = to_device(state, dev)
        card = gstep.substep(start, FIXED_DT)
        # the graph's replay from the same state: the eager card substep's
        # kernels on the same inputs, so bit for bit its result
        copy_state(graph.state, start)
        graph.step()
        leaf = _bits_differ(graph.state, card)
        if leaf is not None:
            _fail(f"simulation substep {i}: the graph's replay differs from "
                  f"the eager card substep in {leaf}")
        card = to_device(card, cpu)
        nxt = cstep.substep(state, FIXED_DT)
        msg = _sim_disagree(nxt, card)
        if msg is not None:
            # a tie that rounding decides: the CPU's own substep reaches
            # the card's result from its state with one agent moved by at
            # most 5e-5 (tests/torch_sim_worlds.py reference_reaches)
            ag = int((nxt.body_pos - card.body_pos).abs().amax(1).argmax())
            how = None
            for nudge in (2e-6, 1e-5, 5e-5):
                for axis in range(3):
                    for sign in (1.0, -1.0):
                        moved = state
                        for f in ("body_pos", "wp_local", "trs_t"):
                            t = getattr(moved, f).clone()
                            t[ag, axis] += sign * nudge
                            moved = moved._replace(**{f: t})
                        if how is None and _sim_disagree(
                                cstep.substep(moved, FIXED_DT), card) is None:
                            how = f"agent {ag} moved {sign * nudge:+g} on " \
                                  f"axis {axis}"
            if how is None:
                _fail(f"simulation substep {i}: card and CPU disagree: {msg}")
            ties += 1
            print(f"  substep {i}: {msg}; the CPU reaches the card's result "
                  f"with {how} (a tie rounding decides)")
        state = nxt
    p = state.body_pos[e].tolist()
    print(f"simulation, {label} DemoScene world ({world.spec.n_entities} "
          f"entities, "
          f"{int(world.collision.valid.sum())} collision triangles): "
          f"{SIM_STEPS} substeps started on the card from the CPU's state "
          f"agree (positions, velocities, pose clocks and palettes within "
          f"1e-4, integer and bool fields equal; {ties} ties), and the "
          f"graph's replays equal the eager card substeps bit for bit; "
          f"player at {[round(v, 4) for v in p]}, locomotion state "
          f"{int(state.loco.state[e])}, action weight "
          f"{float(state.action.weight[e]):.4f} "
          f"({time.perf_counter() - t0:.1f} s)")

    # One substep under the sync checker: it reads nothing back.
    gstate = to_device(state, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gstep.substep(gstate, FIXED_DT)
        graph.step()
    except RuntimeError as err:
        import traceback
        _fail(f"a substep synchronised with the host: {err}\n"
              f"{traceback.format_exc()}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"simulation, {label}: one substep and one replay under "
          f"torch.cuda.set_sync_debug_mode('error'): no host sync")

    out = {}
    worlds = [(label, gstep, gstate)]
    if crowd:
        from swift_game_engine_tpu_torch.examples.bench_crowd import build
        worlds.append(("crowd_256", *build(CROWD_AGENTS, dev)))
    for name, stp, st in worlds:
        for _ in range(3):
            st = stp.substep(st, FIXED_DT)
        g = graph if name == label else SubstepGraph(stp, st, FIXED_DT)
        copy_state(g.state, st)
        eager, replay = (_event_ms(lambda: stp.substep(st, FIXED_DT)),
                         _event_ms(g.step))
        launches, host = _launches(lambda: stp.substep(st, FIXED_DT))
        g_launches, g_host = _launches(g.step)
        n = stp.spec.n_entities
        out[name] = dict(eager_ms=float(np.median(eager)),
                         graph_ms=float(np.median(replay)),
                         launches=launches, graph_launches=g_launches,
                         graph_host_launches=g_host)
        print(f"simulation {name} ({n} entities, "
              f"{int(stp.collision.valid.sum())} collision triangles): "
              f"substep median {np.median(eager):.3f} ms eager, "
              f"{np.median(replay):.3f} ms graphed (CUDA events, "
              f"{SIM_TIMED} substeps each; p90 {np.percentile(eager, 90):.3f}"
              f", {np.percentile(replay, 90):.3f}); {launches} kernels from "
              f"{host} host launches a substep eager, {g_launches} kernels "
              f"from {g_host} host launch(es) a replay; capture "
              f"{g.capture_seconds:.3f} s, graph pool "
              f"{g.pool_bytes / 2**20:.1f} MiB")
        if g_host > 1:
            _fail(f"simulation {name}: a replay took {g_host} host launches")
        if not bool(torch.isfinite(g.state.body_pos).all()):
            _fail(f"simulation {name}: positions are not finite")
    return out


def pose_inputs(n, device, seed=5):
    """``n`` characters' pose inputs, made from ``seed``: every locomotion
    state, half of them blending, clocks spread over the clips, the dodge
    clip playing at weights in (0, 1) on most, facings all round, ground
    normals tilted up to ~30 degrees, grounded or not -> (LocoState,
    LocoParams, ActionState, PoseInputs) on ``device``."""
    import numpy as np
    import torch
    from swift_game_engine_tpu_torch.anim import pose as P
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    state = np.arange(n) % 4
    yaw = rng.uniform(0, 2 * np.pi, n)
    normal = np.stack([rng.normal(0, 0.3, n), np.ones(n),
                       rng.normal(0, 0.3, n)], 1)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    loco = P.LocoState(
        state=t(state, torch.int32),
        from_state=t(rng.integers(0, 4, n), torch.int32),
        times=t(rng.uniform(0, 2, (n, 4))), blend_t=t(rng.uniform(0, 1, n)),
        idle_inertia=t(rng.uniform(0, 1, n)),
        is_blending=t(np.arange(n) % 2 == 1, torch.bool))
    action = P.ActionState(time=t(rng.uniform(0, 1, n)),
                           weight=t(rng.uniform(0, 1, n)),
                           active=t(rng.uniform(size=n) < 0.8, torch.bool))
    inputs = P.PoseInputs(
        forward=t(np.stack([-np.sin(yaw), np.zeros(n), -np.cos(yaw)], 1)),
        ground_normal=t(normal),
        grounded_near=t(rng.uniform(size=n) < 0.7, torch.bool))
    return loco, P.LocoParams.default((n,), device), action, inputs


def pose_phase(dev, rig_dir):
    """bench.py's pose configuration (#2): POSE_CHARS characters x
    POSE_STEPS steps of ``PoseEngine.step_character`` with the action
    layer, on the synthetic rig. Each card step starts from the CPU's
    locomotion state of that step and is held against the CPU's step:
    palettes and model matrices within 1e-4, the phase and clocks within
    1e-5, the states and flags equal. Then char-steps/s eager and as one
    captured step (CUDA graph, replayed) by CUDA events."""
    import numpy as np
    import torch
    from swift_game_engine_tpu_torch.anim.pose import LocoState
    from swift_game_engine_tpu_torch.ecs.world import copy_state, to_device
    from swift_game_engine_tpu_torch.scene.cuda_graph import capture
    from swift_game_engine_tpu_torch.scene.demo_scene import load_pose_rig
    from swift_game_engine_tpu_torch.scene.engine import FIXED_DT

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    card, host = load_pose_rig(rig_dir, dev), load_pose_rig(rig_dir, cpu)
    loco, params, action, inputs = pose_inputs(POSE_CHARS, cpu)
    g_params, g_action, g_inputs = (to_device(x, dev)
                                    for x in (params, action, inputs))
    err = 0.0
    for i in range(POSE_STEPS):
        ref = host.engine.step_character(host.bank, host.action, loco,
                                         params, action, inputs, FIXED_DT)
        got = card.engine.step_character(card.bank, card.action,
                                         to_device(loco, dev), g_params,
                                         g_action, g_inputs, FIXED_DT)
        for f in ("palette", "model"):
            d = float((getattr(got, f).cpu() - getattr(ref, f)).abs().max())
            err = max(err, d)
            if d > 1e-4:
                _fail(f"pose step {i}: the card's {f} differs from the "
                      f"CPU's by {d:.3g}")
        for a, b, f in zip(ref.loco, got.loco, LocoState._fields):
            b = b.cpu()
            if a.dtype.is_floating_point:
                if float((a - b).abs().max()) > 1e-5:
                    _fail(f"pose step {i}: loco.{f} differs")
            elif not torch.equal(a, b):
                _fail(f"pose step {i}: loco.{f} differs")
        if float((got.phase.cpu() - ref.phase).abs().max()) > 1e-5:
            _fail(f"pose step {i}: the phase differs")
        loco = ref.loco
        action = action._replace(time=action.time + FIXED_DT)
        g_action = to_device(action, dev)
    pal = got.palette[..., :3, :3]
    rigid = float((torch.det(pal) - 1).abs().max())
    if not bool(torch.isfinite(got.palette).all()) or rigid > 1e-3:
        _fail("pose phase: the card's palettes are not finite and rigid")
    print(f"pose phase ({POSE_CHARS} characters x {POSE_STEPS} steps, "
          f"{card.skeleton.bone_count} bones, the action layer on): each "
          f"card step agrees with the CPU's (palettes and model within "
          f"1e-4, max abs err {err:.3g}; clocks within 1e-5, states equal);"
          f" palettes finite, |det - 1| <= {rigid:.2e} "
          f"({time.perf_counter() - t0:.1f} s)")

    # timing: POSE_STEPS chained steps eager, and one captured step replayed
    g_loco = to_device(loco, dev)

    def step():
        res = card.engine.step_character(card.bank, card.action, g_loco,
                                         g_params, g_action, g_inputs,
                                         FIXED_DT)
        copy_state(g_loco, res.loco)
        return res

    def run(fn):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(POSE_STEPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)
    step()
    eager_ms = run(step)
    cap, _ = capture(step, step, 3)
    graph_ms = run(cap.graph.replay)
    kernels, host_launches = _launches(step)
    rate = POSE_CHARS * POSE_STEPS
    out = dict(eager_ms=eager_ms / POSE_STEPS, graph_ms=graph_ms / POSE_STEPS,
               eager_char_steps_per_s=rate / eager_ms * 1e3,
               graph_char_steps_per_s=rate / graph_ms * 1e3, kernels=kernels)
    print(f"pose phase timing: {out['eager_ms']:.3f} ms a step eager "
          f"({out['eager_char_steps_per_s']:.0f} char-steps/s), "
          f"{out['graph_ms']:.3f} ms a step as one captured step "
          f"({out['graph_char_steps_per_s']:.0f} char-steps/s); {kernels} "
          f"kernels from {host_launches} host launches a step eager; capture "
          f"{cap.seconds:.3f} s (CUDA events, {POSE_STEPS} steps each)")
    return out


# Path 11: the image-plane-sharded traced frame (parallel/sharding.py) on
# the full scene, one spawned rank per card (at most 4), WARMUP +
# SHARD_TIMED frames of ``sharded_fused_step``; on this card the frame is
# also rendered as SHARD_VIRTUAL virtual shards. A fixed camera over the
# scene (the extraction is relative to the world origin).
SHARD_PATH = "demo_rt_sharded_960x540"
SHARD_TIMED, SHARD_VIRTUAL = 3, (4, 8)
SHARD_CAMERA = ((0.0, 8.0, 24.0), (0.0, 0.0, 0.0))
# The ranks' deadline, seconds (the scene build and the NCCL set-up
# included).
SHARD_SECONDS = 600
# Path 12: the crowd whose entity axis is sharded, its substeps from one
# state, the virtual shard counts on this card (3 does not divide 1,024),
# and the DemoScene frame on an entity-sharded state (4 virtual shards).
ENTITY_PATH = "crowd_entity_sharded_1024"
ENTITY_DEMO = "demo_rt_entity_sharded_960x540"
ENTITY_AGENTS, ENTITY_STEPS, ENTITY_VIRTUAL = 1024, 8, (3, 4, 8)
ENTITY_DEMO_SHARDS = 4
# The knob paths' first frames: (name, the path it applies to, the
# render_frame keyword, the kernel roles whose inputs it changes, how far
# the frame may be from the path's default frame: 0, bit for bit; None,
# the share of pixels that differ printed only (fewer slots than layers
# change the records by design); (share, max), at most that share of
# pixels differing, by less than max: the subdivided translucent subset's
# children have f32 midpoints for corners, so on the parent's outer edges
# K1's edge tests, and everywhere the depths, round otherwise than the
# parent's). A trans_subdiv pixel that differs from the default frame
# must lie within SUBDIV_EDGE (barycentric) of its parent's outer edge, or
# differ only in depths, by at most SUBDIV_DEPTH relative (subdiv_pixels).
SUBDIV_EDGE, SUBDIV_DEPTH = 1e-3, 1e-4
KNOB_FRAMES = (
    ("knob_layer_slots_2", 1, dict(layer_slots=2), ("K5",), None),
    ("knob_trans_subdiv_1", 0, dict(trans_subdiv=1), ("K1/layers=3",),
     (1e-4, 0.1)),
    ("knob_unlit_split", 0, dict(unlit_split=True), ("K2", "K3", "K4"), 0),
    ("knob_unlit_dense", 0, dict(unlit_dense=True), ("K2", "K3", "K4"), 0),
    ("knob_packet_compact", 0, dict(packet_compact=True), ("K4",), 0),
    ("knob_packet_compact_p6", 5, dict(packet_compact=True), ("K4",), 0))
# The walks' twins of the knob frames run on at most this many lanes.
KNOB_TWIN_LANES = 8_192


def shard_inputs(dev):
    """(inverse view-projection, camera position, camera world position)
    of path 11's camera, on ``dev``."""
    import numpy as np
    import torch
    from swift_game_engine_tpu_torch.render.camera import Camera
    cam = Camera()
    cam.position = np.array(SHARD_CAMERA[0], np.float32)
    cam.target = np.array(SHARD_CAMERA[1], np.float32)
    return (torch.as_tensor(cam.inv_view_proj(W, H), device=dev),
            torch.as_tensor(cam.position, device=dev),
            torch.zeros(3, device=dev))


def _same_bits(a, b):
    """Two tensors of one shape and dtype, equal bit for bit."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def sharded_worker(rank, world, store, out):
    """Rank ``rank`` of path 11, a process of its own on card ``rank``: an
    NCCL group through the ``file://`` store, the full DemoScene,
    ``sharded_fused_step`` (one substep a frame, max_layers 3, 4 shadow
    layers; captured at its first call: the substep graph, and the graph
    of the extraction and the render with the NCCL all-gather inside) for
    WARMUP frames, then SHARD_TIMED timed frames (replays) with the launch
    counts zeroed just before and read just after; then the last timed
    frame again eagerly (``step.eager``) from the state it started from,
    which must equal the replayed frame bit for bit, the host's CUDA API
    calls of one step (torch.profiler), and one whole step under
    ``torch.cuda.set_sync_debug_mode("error")``; then path 12's part
    (``entity_worker``). Each rank saves what the phase checks to
    ``out`` + its rank + ``.pt``; rank 0 also the last timed frame's image,
    the state it started from, the counts, the times and path 12's
    results. A rank drops every captured program before it destroys the
    group: NCCL's communicator waits for the graphs that captured its
    collectives (a 2-rank run hung there otherwise)."""
    sys.path.insert(0, REPO)
    import gc
    import torch
    from swift_game_engine_tpu_torch.parallel import sharding as SH
    start = time.perf_counter()
    group = SH.make_group(rank, world, "file://" + store)
    _sharded_rank(rank, world, group, out, start)
    gc.collect()
    torch.cuda.synchronize()
    torch.distributed.destroy_process_group()


def _sharded_rank(rank, world, group, out, start):
    """``sharded_worker``'s work in its NCCL group ``group``."""
    import torch
    from swift_game_engine_tpu_torch.ecs.world import to_device
    from swift_game_engine_tpu_torch.parallel import sharding as SH
    from swift_game_engine_tpu_torch.render.ibl import IBL
    from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene
    clock = [start]
    dev = torch.device("cuda", rank)
    seconds = {}

    def lap(name):
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        seconds[name] = clock[-1] - clock[-2]
    full = build_demo_scene(ASSETS, device=dev, import_tri_budget=0)
    ibl = IBL.build(dev)
    lap("group and scene")
    step = SH.sharded_fused_step(group, full, ibl, W, H, 1,
                                 LAYERS, SHADOW_LAYERS, device=dev)
    args = shard_inputs(dev)
    state = full.state
    for _ in range(WARMUP):
        state, img = step(state, *args)
    lap("warm-up frames (captures)")
    zero_counts()
    times = []
    for _ in range(SHARD_TIMED):
        before = state
        t0 = time.perf_counter()
        state, img = step(state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    lap("timed frames")
    est, eimg = step.eager(before, *args)
    eager = dict(image=_same_bits(img, eimg),
                 state=_bits_differ(est, state),
                 gap=float((img - eimg).abs().max()))
    lap("eager frame")
    api = _api_calls(lambda: step(state, *args))
    lap("API calls' profile")
    syncs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, *args)
    except RuntimeError as err:
        # noted for the phase to fail on; every rank stops at the same
        # call, and the step runs again so that every rank makes the
        # same collectives
        syncs.append(str(err))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if syncs:
        step(state, *args)
    lap("step under sync debug")
    res = dict(eager=eager, syncs=syncs, api=api,
               capture_s=step.capture_seconds, pool=step.pool_bytes,
               seconds=seconds)
    entity = entity_worker(group, world, dev, full, ibl, before, state,
                           img)
    lap("path 12")
    if rank == 0:
        res.update(before=to_device(before, "cpu"), image=img.cpu(),
                   counts=counts, times=times,
                   backend=torch.distributed.get_backend(group),
                   entity=entity)
    torch.save(res, f"{out}{rank}.pt")


def _entity_rows(small, padded, n):
    """``padded``'s state with its first ``n`` entity rows from ``small``
    (a state of ``n`` entities): the dormant slots of a padded scene
    appended to a state."""
    from swift_game_engine_tpu_torch.ecs.world import (rebuild_state,
                                                       state_leaves)
    import torch
    return rebuild_state(padded, iter([
        x if x.shape == y.shape else torch.cat([x, y[n:]])
        for x, y in zip(state_leaves(small), state_leaves(padded))]))


def entity_worker(group, world, dev, full, ibl, before, state, img):
    """Path 12 on the ranks of path 11's group (see ``entity_phase``):
    ENTITY_STEPS substeps of the ENTITY_AGENTS crowd on its entity-sharded
    state (``EntityShardedSubstep``: one graph replay a substep, its two
    NCCL all-gathers inside), timed by CUDA events, and the NCCL kernels'
    share of the device time of one more replay (torch.profiler); then the
    DemoScene frame of path 11's last timed frame again, from the state it
    started from, sharded over the entities too (padded by
    ``pad_entities_to`` to the rank count where it does not divide)
    through the captured ``sharded_fused_step``, its state and image held
    to that frame's. Returns what rank 0 saves."""
    import torch
    from swift_game_engine_tpu_torch.ecs.world import state_leaves
    from swift_game_engine_tpu_torch.examples import bench_crowd
    from swift_game_engine_tpu_torch.parallel import sharding as SH
    from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene
    from swift_game_engine_tpu_torch.scene.engine import FIXED_DT
    stepper, cstate = bench_crowd.build(ENTITY_AGENTS, device=dev)
    sim = SH.EntityShardedSubstep(stepper, SH.shard_world_state(group,
                                                                cstate),
                                  FIXED_DT, group)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(ENTITY_STEPS):
        sim.step()
    b.record()
    torch.cuda.synchronize()
    leaves = [x.cpu() for x in state_leaves(sim.state)]
    busy, nccl, n_nccl = _device_share(sim.step, 1)
    crowd = dict(leaves=leaves, ms=a.elapsed_time(b) / ENTITY_STEPS,
                 busy_ms=busy, nccl_ms=nccl, nccl_kernels=n_nccl,
                 capture_s=sim.capture_seconds, pool=sim.pool_bytes,
                 ranges=sim.ranges)
    del sim
    n = full.spec.n_entities
    scene, start = full, before
    if n % world:
        scene = build_demo_scene(ASSETS, device=dev, import_tri_budget=0,
                                 pad_entities_to=world)
        start = _entity_rows(before, scene.state, n)
    step = SH.sharded_fused_step(group, scene, ibl, W, H, 1, LAYERS,
                                 SHADOW_LAYERS, device=dev)
    est, eimg = step(SH.shard_world_state(group, start),
                     *shard_inputs(dev))
    differ = [i for i, (x, y) in enumerate(zip(state_leaves(est.state),
                                               state_leaves(state)))
              if not torch.equal(x if x.shape == y.shape else x[:n], y)]
    return dict(crowd=crowd, demo_gap=float((eimg - img).abs().max()),
                demo_differ=differ, demo_entities=(n, scene.spec.n_entities),
                demo_ranges=est.ranges)


def sharded_phase(dev, full, ibl, cap):
    """Path 11 (see the module docstring): the ranks, then on this card
    the last timed frame again from the state it started from (one eager
    substep, the extraction) rendered whole and as SHARD_VIRTUAL virtual
    shards through the captured ``sharded_render`` (the 4-slice one also
    eagerly, bit for bit the replay's), the kernels' first calls of the
    whole render (its program's first warm-up) captured by ``cap``. Every
    rank's replayed frame must equal its eager frame bit for bit and make
    no host sync; the 4-slice image must equal the ranks' and the whole
    batch's (1e-5), the 8-slice image, whose shards take another shadow
    source, meet the whole batch's (>= 99% of pixels within 1e-4).
    Returns (the ranks' launch counts, rank 0's saved results)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    from swift_game_engine_tpu_torch.ecs.world import to_device
    from swift_game_engine_tpu_torch.ops import rt_kernel as RK
    from swift_game_engine_tpu_torch.parallel import sharding as SH
    from swift_game_engine_tpu_torch.render import rt as RT
    from swift_game_engine_tpu_torch.render.scene_geometry import \
        flatten_frame
    from swift_game_engine_tpu_torch.scene.engine import FIXED_DT, \
        FrameProgram
    world = min(torch.cuda.device_count(), 4)
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "rank")
    t0 = time.perf_counter()
    ctx = mp.start_processes(sharded_worker, args=(world, os.path.join(
        tmp, "store"), out), nprocs=world, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + SHARD_SECONDS
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                _fail(f"{SHARD_PATH}: the ranks did not end in "
                      f"{SHARD_SECONDS} s")
    except ProcessException as err:
        _fail(f"{SHARD_PATH}: a rank failed: {err}")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join()
    ranks = [torch.load(f"{out}{r}.pt", weights_only=False)
             for r in range(world)]
    shutil.rmtree(tmp)
    r = ranks[0]
    times, counts = r["times"], r["counts"]
    print(f"path {SHARD_PATH}: {world} rank(s), {r['backend']}, one process "
          f"a card; "
          f"frame median {np.median(times):.2f} ms over {SHARD_TIMED} frames "
          f"(min {min(times):.2f}, max {max(times):.2f}; a step: the state's "
          f"copy in, one substep graph replay, one replay of the extraction, "
          f"flatten, the shard's render and the all-gather, the copies out); "
          f"ranks' phase {time.perf_counter() - t0:.1f} s")
    print(f"  launches in {SHARD_TIMED} frames (rank 0): {counts}")
    print(f"  CUDA API calls of one step (rank 0, torch.profiler): "
          f"{r['api']}")
    print(f"  captures (rank 0): {r['capture_s']:.3f} s, pool "
          f"{r['pool'] / 2**20:.1f} MiB; rank 0's seconds: " + ", ".join(
              f"{k} {v:.1f}" for k, v in r["seconds"].items()))
    for k, x in enumerate(ranks):
        e = x["eager"]
        print(f"  rank {k}: the replayed frame against the eager frame from "
              f"the same state: image " + ("bit for bit" if e["image"] else
                                           f"max {e['gap']:.3e}") +
              ", state " + ("bit for bit" if e["state"] is None else
                            f"differs at {e['state']}") +
              "; the whole step under set_sync_debug_mode('error'): " +
              ("no host sync" if not x["syncs"] else x["syncs"][0]))
    if any(x["syncs"] for x in ranks):
        _fail(f"{SHARD_PATH}: a step synchronised with the host")
    if not all(x["eager"]["image"] and x["eager"]["state"] is None
               for x in ranks):
        _fail(f"{SHARD_PATH}: a replayed frame differs from its eager frame")

    t0 = time.perf_counter()
    state = full.stepper.substep(to_device(r["before"], dev), FIXED_DT)
    ivp, cam, cam_world = shard_inputs(dev)
    tf, pal = full.stepper._extract(state, 1.0, cam_world)
    walks = RK.walk_available(flatten_frame(full.geometry, tf,
                                            pal).bvh.rows)
    modes, shadow_mode = [], RT._shadow_mode

    def logged(geo, fg, lights, lanes, shadow_layers):
        mode, consts = shadow_mode(geo, fg, lights, lanes, shadow_layers)
        modes.append((lanes, mode))
        return mode, consts
    RT._shadow_mode = logged
    imgs = {}
    try:
        for k in (1,) + SHARD_VIRTUAL:
            modes.clear()
            render = SH.sharded_render(k, full.geometry, ibl, full.lights,
                                       W, H, LAYERS, SHADOW_LAYERS, dev)
            imgs[k] = render(tf, pal, ivp, cam)
            cap.off()    # the kernels' first calls: the whole batch's
            prog = render.program
            rule = "clusters" if modes[0][0] >= RT.SHADOW_CLUSTER_MIN_LANES \
                else "walk" if walks else "loop"
            print(f"  {k} shard(s) of {modes[0][0]} lanes: shadow source "
                  f"{modes[0][1]} (the reference's rule: {rule}); captured "
                  f"in {prog.capture_seconds:.3f} s, pool "
                  f"{prog.pool_bytes / 2**20:.1f} MiB")
            # each warm-up and the capture render every shard once
            if prog.captured is None or modes != [(modes[0][0], rule)] * (
                    k * (FrameProgram.WARMUP + 1)):
                _fail(f"{SHARD_PATH}: a shard's shadow source is not the "
                      f"reference's for its lane count, or the render was "
                      f"not captured: {modes}")
            if k == SHARD_VIRTUAL[0]:
                eager = render.eager(tf, pal, ivp, cam)
                print(f"  {k} shards: the replay against the eager body: " +
                      ("bit for bit" if _same_bits(imgs[k], eager) else
                       f"max {float((imgs[k] - eager).abs().max()):.3e}"))
                if not _same_bits(imgs[k], eager):
                    _fail(f"{SHARD_PATH}: the {k}-shard replay differs from "
                          f"its eager body")
            del render, prog
    finally:
        RT._shadow_mode = shadow_mode
        cap.off()
    whole, four, eight = imgs[1], imgs[SHARD_VIRTUAL[0]], \
        imgs[SHARD_VIRTUAL[1]]
    ranks_img = r["image"].to(dev)
    gap_ranks = float((four - ranks_img).abs().max())
    gap_whole = float((four - whole).abs().max())
    diff8 = (eight - whole).abs().amax(-1)
    frac8 = float((diff8 < 1e-4).float().mean())
    print(f"  virtual shards ({time.perf_counter() - t0:.1f} s): the "
          f"4-slice image against the ranks' max {gap_ranks:.3e}, against "
          f"the whole batch max {gap_whole:.3e}; the 8-slice image against "
          f"the whole batch: {frac8:.5f} of pixels within 1e-4, max "
          f"{float(diff8.max()):.3e}; means {float(whole.mean()):.6f}, "
          f"{float(four.mean()):.6f}, {float(eight.mean()):.6f}")
    if not all(bool(torch.isfinite(x).all()) and float(x.std()) > 1e-3
               for x in (whole, four, eight, ranks_img)) or \
            tuple(ranks_img.shape) != (H, W, 3):
        _fail(f"{SHARD_PATH}: an image is not finite, or constant, or of "
              f"the wrong shape")
    if gap_ranks > 1e-5 or gap_whole > 1e-5 or frac8 < 0.99:
        _fail(f"{SHARD_PATH}: the shards' images disagree")
    return counts, r


def _leaves_agree(label, got, want):
    """Two final states' leaves: bit for bit, or every float leaf within
    1e-5 (tests/test_multichip.py:172-174) and every other leaf equal;
    prints which, with the count of leaves that differ in bits."""
    import torch
    differ = [i for i, (x, y) in enumerate(zip(got, want))
              if not torch.equal(x, y)]
    worst = 0.0
    for i in differ:
        x, y = got[i], want[i]
        if not x.dtype.is_floating_point:
            _fail(f"{label}: leaf {i} ({x.dtype}) differs")
        worst = max(worst, float((x - y).abs().max()))
    print(f"  {label}: " + ("bit for bit the replicated run's" if not differ
                            else f"{len(differ)} of {len(want)} leaves "
                            f"differ in bits, max {worst:.3e}"))
    if worst > 1e-5:
        _fail(f"{label}: the state is more than 1e-5 from the replicated "
              f"run's")


def entity_phase(dev, full, ibl, ranks, before, capture):
    """Path 12, the entity axis of the multi-device path
    (``shard_world_state`` / ``EntityShardedSubstep``):

      * the ENTITY_AGENTS crowd (examples/bench_crowd.build: separation's
        grid branch) takes ENTITY_STEPS substeps from one state on the
        replicated state (``SubstepGraph``), on the ranks of path 11's
        NCCL group (``entity_worker``) and on ENTITY_VIRTUAL virtual shards
        here, each one graph replay a substep (the all-gathers inside: NCCL
        on the ranks, concatenations here); each final state must be the
        replicated run's bit for bit or within 1e-5; ms per substep (CUDA
        events) and the capture's seconds and pool are printed for each,
        and for the ranks the device busy ms of a replay and the NCCL
        kernels' share of it (torch.profiler; ``profile_port.py --crowd``
        profiles the replicated and virtual-shard replays);
      * the DemoScene frame of path 11 (``sharded_fused_step``: one
        substep, the extraction, the image-plane-sharded render; captured
        at its first call) from the state path 11's last timed frame
        started from, on an entity-sharded state of ENTITY_DEMO_SHARDS
        virtual shards, against the replicated state's step over the same
        shards run eagerly (``eager``): the states equal bit for bit, the
        images within 1e-5; a
        second call (replays only) equals the first bit for bit; the
        ranks' run of it (in ``entity_worker``) against path 11's frame
        the same way. The kernel calls of the first call's warm-ups are
        captured by ``capture()`` (a Capture hooked on just before it), and
        the launches of the second call counted.

    Returns (the DemoScene frame's launch counts, its Capture)."""
    import torch
    from swift_game_engine_tpu_torch.ecs.world import state_leaves
    from swift_game_engine_tpu_torch.examples import bench_crowd
    from swift_game_engine_tpu_torch.parallel import sharding as SH
    from swift_game_engine_tpu_torch.scene.engine import FIXED_DT
    from swift_game_engine_tpu_torch.scene.step import SubstepGraph
    t0 = time.perf_counter()
    stepper, state = bench_crowd.build(ENTITY_AGENTS, device=dev)

    def run(sim):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(ENTITY_STEPS):
            sim.step()
        b.record()
        torch.cuda.synchronize()
        return (a.elapsed_time(b) / ENTITY_STEPS,
                [x.clone() for x in state_leaves(sim.state)])

    ms, want = run(SubstepGraph(stepper, state, FIXED_DT))
    print(f"path {ENTITY_PATH}: {state.alive.shape[0]} entities, "
          f"{ENTITY_STEPS} substeps from one state; replicated "
          f"(SubstepGraph) {ms:.3f} ms a substep (CUDA events)")
    c = ranks["crowd"]
    print(f"  {len(c['ranges'])} rank(s) over NCCL, rows {c['ranges']}: "
          f"{c['ms']:.3f} ms a substep (one replay), device busy "
          f"{c['busy_ms']:.3f} ms a replay, the NCCL kernels "
          f"{c['nccl_ms']:.3f} ms of it (" + (
              f"{c['nccl_ms'] / c['busy_ms']:.1%}" if c["busy_ms"] else
              "the trace shows no device time") +
          f"; {c['nccl_kernels']:.0f} a replay); capture "
          f"{c['capture_s']:.1f} s, pool {c['pool'] / 2**20:.1f} MiB")
    _leaves_agree(f"{len(c['ranges'])} rank(s)",
                  [x.to(dev) for x in c["leaves"]], want)
    for k in ENTITY_VIRTUAL:
        sim = SH.EntityShardedSubstep(stepper, SH.shard_world_state(k, state),
                                      FIXED_DT, k)
        if sim.graph is None:
            _fail(f"{ENTITY_PATH}: {k} virtual shards were not captured")
        ms, got = run(sim)
        rows = sorted({hi - lo for lo, hi in sim.ranges})
        print(f"  {k} virtual shards, rows of {rows}: {ms:.3f} ms a substep "
              f"(one replay: the ranges' phases in turn, the "
              f"concatenations inside); capture "
              f"{sim.capture_seconds:.1f} s, pool "
              f"{sim.pool_bytes / 2**20:.1f} MiB")
        _leaves_agree(f"{k} virtual shards", got, want)
        del sim
    args = shard_inputs(dev)
    k = ENTITY_DEMO_SHARDS
    rst, rimg = SH.sharded_fused_step(k, full, ibl, W, H, 1, LAYERS,
                                      SHADOW_LAYERS, dev).eager(before, *args)
    step = SH.sharded_fused_step(k, full, ibl, W, H, 1, LAYERS,
                                 SHADOW_LAYERS, dev)
    sharded = SH.shard_world_state(k, before)
    cap = capture()
    try:
        t1 = time.perf_counter()
        est, eimg = step(sharded, *args)
        torch.cuda.synchronize()
        ms_first = (time.perf_counter() - t1) * 1e3
    finally:
        cap.off()
    zero_counts()
    t1 = time.perf_counter()
    est2, eimg2 = step(sharded, *args)
    torch.cuda.synchronize()
    ms_next = (time.perf_counter() - t1) * 1e3
    counts = read_counts()
    gap = float((eimg - rimg).abs().max())
    differ = _bits_differ(est.state, rst)
    again = _same_bits(eimg2, eimg) and _bits_differ(est2.state,
                                                     est.state) is None
    print(f"  {ENTITY_DEMO}: the full DemoScene's frame on an entity-sharded "
          f"state ({k} virtual shards, rows {est.ranges}) against the "
          f"replicated state's eager step over the same shards: image max "
          f"{gap:.3e}, "
          f"state " + ("bit for bit" if differ is None else
                       f"differs at {differ}") +
          f"; the second call " + ("bit for bit the first" if again else
                                   "differs from the first") +
          f"; {ms_first:.1f} ms with the captures, {ms_next:.1f} ms the "
          f"next (host clock: two graph replays, the substep's and the "
          f"frame's, and the copies in and out); captures "
          f"{step.capture_seconds:.1f} s, pool "
          f"{step.pool_bytes / 2**20:.1f} MiB")
    print(f"  launches in the frame: {counts}")
    n, n_pad = ranks["demo_entities"]
    print(f"  the ranks' run ({n} entities, {n_pad} with the padding, rows "
          f"{ranks['demo_ranges']}) against path 11's frame: image max "
          f"{ranks['demo_gap']:.3e}, leaves differing "
          f"{ranks['demo_differ'] or 'none'}")
    if gap > 1e-5 or differ is not None or ranks["demo_gap"] > 1e-5 or \
            ranks["demo_differ"] or tuple(eimg.shape) != (H, W, 3) or \
            not again:
        _fail(f"{ENTITY_DEMO}: the entity-sharded frame disagrees with the "
              f"replicated state's")
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    return counts, cap


def read_png(path):
    """An 8-bit RGB PNG with filter 0 on every row -> (H, W, 3) uint8, by
    zlib and struct; each chunk's CRC checked."""
    import struct
    import zlib
    import numpy as np
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        _fail(f"{path} is not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(tag + body) & 0xFFFFFFFF:
            _fail(f"{path}: chunk {tag} has a bad CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h,
                                                                  1 + 3 * w)
    if (depth, color, interlace) != (8, 2, 0) or rows[:, 0].any():
        _fail(f"{path} is not 8-bit RGB with filter 0 on every row")
    return rows[:, 1:].reshape(h, w, 3)


def examples_phase():
    """The port's entry points on the card, as a user runs them:
    ``run_demo`` (3 frames at 320x180 into a temporary directory; each PNG
    must decode to the frame), ``bench_crowd`` at 4 and 1,024 agents (its
    table) and ``play --frames 10`` at 192x108."""
    import tempfile
    import numpy as np
    from swift_game_engine_tpu_torch.examples import (bench_crowd, play,
                                                      run_demo)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        frames = run_demo.main(["--frames", "3", "--width", "320",
                                "--height", "180", "--out", d])
        for i, u8 in enumerate(frames):
            if not np.array_equal(read_png(os.path.join(
                    d, f"frame_{i:03d}.png")), u8):
                _fail(f"run_demo: frame_{i:03d}.png is not the frame")
    if len(frames) != 3 or frames[-1].shape != (180, 320, 3) or \
            float(frames[-1].std()) < 1.0:
        _fail("run_demo: its frames are missing, misshapen or constant")
    print(f"examples: run_demo wrote 3 frames, each PNG decodes to its "
          f"frame ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    rows = bench_crowd.main(["4", "1024"])
    if not all(np.isfinite(ms) and ms > 0 for _, ms in rows):
        _fail("bench_crowd: a time is not finite")
    print(f"examples: bench_crowd ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    u8 = play.main(["--frames", "10"])
    if u8.shape != (108, 192, 3) or float(u8.std()) < 1.0:
        _fail("play: its last frame is misshapen or constant")
    print(f"examples: play ({time.perf_counter() - t0:.1f} s)")


def main():
    if not os.path.isdir(os.path.join(REPO, "swift_game_engine_tpu_torch")):
        _fail("run chip_smoke.py from the root of a checkout")
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")
    print(f"card (nvidia-smi name, power limit): {smi[0]}")

    from swift_game_engine_tpu_torch.ops import _cuda
    from swift_game_engine_tpu_torch.ops import cluster_shadow as CS
    from swift_game_engine_tpu_torch.ops import rt_kernel as RK
    from swift_game_engine_tpu_torch.render import raster as RA
    from swift_game_engine_tpu_torch.render import rt as RT
    from swift_game_engine_tpu_torch.render import tile_raster as TR
    from swift_game_engine_tpu_torch.render.scene_geometry import flatten_frame

    t_start = time.perf_counter()

    # -- 1. kernels ----------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library(verbose=True)
    print(f"kernels: built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_seconds or 0:.1f} s)")
    for line in _cuda.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    from swift_game_engine_tpu_torch.scene.engine import Engine
    from swift_game_engine_tpu_torch.scene.input import InputFrame

    def shade_calls_of(eng):
        """The RT shade calls of one frame: the frame program run eagerly
        (a replay calls no Python)."""
        calls, shade_hit = [0], RT._shade_hit

        def counted(*a, **k):
            calls[0] += 1
            return shade_hit(*a, **k)
        RT._shade_hit = counted
        try:
            eng.program().eager()
        finally:
            RT._shade_hit = shade_hit
        return calls[0]

    def check_graph(name, eng, frames=3):
        """Frames through the graph against the frame program run eagerly
        on the card at the same inputs, bit for bit (image and snapshot),
        with the camera turning, the exposure and the fps digits changing
        between replays; then one whole frame under
        ``torch.cuda.set_sync_debug_mode("error")``."""
        for i in range(frames):
            pad = InputFrame(ly=1.0, rx=0.7 - 0.5 * i,
                             exposure_delta=(1.0, -1.0, 0.5)[i % 3])
            img = eng.frame((1 / 60, 1 / 24, 1 / 144)[i % 3], pad)
            u8_g, snap_g = eng.program().out
            u8_e, snap_e = eng.program().eager()
            if not (_same_bits(img, u8_g) and _same_bits(u8_g, u8_e) and
                    _same_bits(snap_g, snap_e)):
                u8_e2, _ = eng.program().eager()
                apart = int((u8_e2 != u8_e).any(-1).sum())
                _fail(f"{name}: the frame graph's replay differs from the "
                      f"eager card frame at the same inputs ("
                      f"{int((u8_g != u8_e).any(-1).sum())} pixels; two eager "
                      f"frames differ in {apart})")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.frame(1 / 60, InputFrame(ly=1.0, rx=0.3))
        except RuntimeError as err:
            import traceback
            _fail(f"{name}: a frame synchronised with the host: {err}\n"
                  f"{traceback.format_exc()}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        x = eng.frame_inputs()
        print(f"  frame graph: {frames} replays equal the eager card frames "
              f"bit for bit (exposure {float(x['exposure']):.4f}, fps "
              f"{int(x['fps'])} at the last), and a frame under "
              f"set_sync_debug_mode('error') reads nothing back")

    def run_path(name, eng, cap, timed=TIMED, pad_of=None, watch=None):
        """2 warm-up frames (inputs captured), then ``timed`` frames with
        the launch counts zeroed just before and read just after. Every
        frame is the bench headline's ``eng.frame(1/60,
        InputFrame(ly=1.0))`` (or ``pad_of(i)`` on timed frame i): one
        substep (a replay), the player walking, and one replay of the frame
        graph; its snapshot is kept per timed frame, and ``watch()`` reads
        the state after it, untimed. Then the frame graph against eager
        card frames (``check_graph``)."""
        pad = InputFrame(ly=1.0)
        for _ in range(WARMUP):
            img = eng.frame(1 / 60, pad)
            if watch is not None:
                watch()
        cap.off()
        zero_counts()
        times, snaps = [], []
        for i in range(timed):
            t0 = time.perf_counter()
            img = eng.frame(1 / 60, pad if pad_of is None else pad_of(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            snaps.append(eng._snap.copy())
            if watch is not None:
                watch()
        counts = read_counts()
        counts["shade_calls"] = timed * shade_calls_of(eng)
        medians[name] = float(np.median(times))
        prog = eng.program()
        print(f"path {name}: frame median {np.median(times):.2f} ms, p90 "
              f"{np.percentile(times, 90):.2f} ms over {timed} frames (min "
              f"{min(times):.2f}, max {max(times):.2f}); RT target "
              f"{eng.rt_size[0]}x{eng.rt_size[1]}; substep graph captured "
              f"in {eng._sim.capture_seconds:.3f} s "
              f"({eng._sim.pool_bytes / 2**20:.1f} MiB pool); frame graph "
              f"captured in {prog.capture_seconds:.3f} s "
              f"({prog.pool_bytes / 2**20:.1f} MiB pool)")
        print(f"  launches in {timed} frames: {counts}")
        captures.append((name, eng.rt_size, prog.capture_seconds,
                         prog.pool_bytes))
        if eng._sim.graph is None or prog.captured is None:
            _fail(f"{name}: the Engine's substep or frame is not a CUDA "
                  f"graph")
        if tuple(img.shape) != (H, W, 3) or img.dtype != torch.uint8:
            _fail(f"{name}: frame has shape {tuple(img.shape)} {img.dtype}")
        f = img.float()
        if not bool(torch.isfinite(f).all()) or float(f.std()) < 1.0:
            _fail(f"{name}: frame is not finite or is constant")
        print(f"  frame mean {float(f.mean()):.4f}, std {float(f.std()):.4f}")
        check_player(name, eng, np.array(snaps))
        check_graph(name, eng)
        return counts

    def run_pipelined(name, scene, depth):
        """Path 1's Engine at ``pipeline_depth=depth``: the first depth-1
        frames are zero, the rest are not constant; the frame median
        (timed as ``run_path`` times it) beside depth 1's."""
        eng = Engine(scene, W, H, path="rt", max_layers=LAYERS,
                     shadow_layers=SHADOW_LAYERS, pipeline_depth=depth,
                     device=dev)
        pad, times, stds, snaps = InputFrame(ly=1.0), [], [], []
        for i in range(WARMUP + TIMED):
            t0 = time.perf_counter()
            img = eng.frame(1 / 60, pad)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if tuple(img.shape) != (H, W, 3) or img.dtype != torch.uint8:
                _fail(f"{name} at depth {depth}: frame has shape "
                      f"{tuple(img.shape)} {img.dtype}")
            if i < depth - 1 and int(img.max()) != 0:
                _fail(f"{name} at depth {depth}: warm-up frame {i} is not "
                      f"zero")
            stds.append(float(img.float().std()))
            snaps.append(eng._snap.copy())
        ms = times[WARMUP:]
        # the ring returns the frames in order: each call returns the
        # frame submitted depth - 1 calls before, which equals the eager
        # card frame of that call's inputs
        eager = []
        for i in range(depth + 2):
            img = eng.frame(1 / 60, InputFrame(ly=1.0, rx=0.5))
            eager.append(eng.program().eager()[0])
            if i >= depth - 1 and not _same_bits(img, eager[i - depth + 1]):
                _fail(f"{name} at depth {depth}: call {i} did not return the "
                      f"frame of call {i - depth + 1}")
        print(f"  at depth {depth}: {depth + 2 - (depth - 1)} frames returned "
              f"in order, each equal to the eager card frame of its inputs")
        print(f"path {name} at pipeline_depth={depth}: frame median "
              f"{np.median(ms):.2f} ms, p90 {np.percentile(ms, 90):.2f} ms "
              f"over {TIMED} frames (depth 1: {medians[name]:.2f} ms); "
              f"warm-up frames 0..{depth - 2} zero, the rest std "
              f"{min(stds[depth - 1:]):.2f} at least")
        if min(stds[depth - 1:]) < 1.0:
            _fail(f"{name} at depth {depth}: a frame after the warm-up is "
                  f"constant")
        check_player(f"{name} at depth {depth}", eng,
                     np.array(snaps[WARMUP:]))

    def check_player(name, eng, snaps):
        """Each timed frame took one substep; the player moved and stayed
        above the ground (its capsule's bottom at or above y = -3)."""
        if eng.substeps != 1 or eng.time_scale != 1.0:
            _fail(f"{name}: {eng.substeps} substeps at time scale "
                  f"{eng.time_scale}, expected one at 1.0")
        cur = snaps[:, 3:6]
        moved = float(np.linalg.norm(cur[-1] - cur[0]))
        bottom = float(cur[:, 1].min()) - PLAYER_CORE_TO_FOOT
        print(f"  player: {cur[0].round(4).tolist()} -> "
              f"{cur[-1].round(4).tolist()} over the timed frames (moved "
              f"{moved:.4f}), lowest capsule bottom y {bottom:.4f}")
        if not np.isfinite(cur).all() or moved < 1e-3 or \
                bottom < GROUND_Y - 0.05:
            _fail(f"{name}: the player did not move or fell through the "
                  f"ground")

    def posed_checks(name, eng, scene, eng1, states):
        """Path 7 after its frames: the substep graph's kernels beside path
        1's (``eng1``), the locomotion states its frames met, the action
        weight after the dodge, the palettes finite and rigid, and one
        replay of the substep graph bit-equal to an eager card substep from
        the same state."""
        from swift_game_engine_tpu_torch.ecs.world import clone_state
        from swift_game_engine_tpu_torch.scene.engine import FIXED_DT
        p = scene.player
        weight = float(eng.state.action.weight[p])
        pal = eng.state.palettes
        rigid = float((torch.det(pal[..., :3, :3]) - 1).abs().max())
        k_posed, _ = _launches(eng._sim.step)
        k_stand, _ = _launches(eng1._sim.step)
        print(f"  {name}: the substep graph runs {k_posed} kernels a replay "
              f"({k_stand} on path 1's stand-in world); locomotion states "
              f"met {sorted(states)} (0 idle, 1 walk, 2 run, 3 falling); "
              f"action weight {weight:.4f} after the dodge (timed frame "
              f"{DODGE_FRAME}); {pal.shape[1]} palettes finite: "
              f"{bool(torch.isfinite(pal).all())}, max |det - 1| "
              f"{rigid:.2e}")
        if weight <= 0.0:
            _fail(f"{name}: the dodge did not start the action clip")
        if not bool(torch.isfinite(pal).all()) or rigid > 1e-3:
            _fail(f"{name}: the palettes are not finite and rigid")
        start = clone_state(eng._sim.state)
        eager = eng.stepper.substep(start, FIXED_DT)
        eng._sim.step()
        leaf = _bits_differ(eng._sim.state, eager)
        if leaf is not None:
            _fail(f"{name}: the substep graph's replay differs from the "
                  f"eager card substep in {leaf}")
        print(f"  {name}: a replay of the posed substep equals the eager "
              f"card substep from the same state bit for bit")

    def expect(name, counts, rule, ok):
        if not ok:
            _fail(f"{name}: expected {rule}, got {counts}")

    def scene_stats(label, scene, t0):
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        g = scene.geometry
        rows_n = (g.topo.node_count + 7) // 8 * 8
        print(f"scene ({label}): {g.tri.shape[0]} triangles, "
              f"{int(g.tri_translucent.sum())} translucent, "
              f"{g.topo.node_count} BVH nodes ({len(g.topo.levels)} interior "
              f"levels), {rows_n} rows, {g.topo.wide_index.shape[0]} wide "
              f"nodes (stack bound {g.topo.wide_stack}), built in "
              f"{seconds:.1f} s")
        return rows_n

    def sorted_sweeps(name, eng):
        """Each sorted shadow sweep (K2 + K3) of one eager frame of
        ``eng``, timed (CUDA events) on its sorted origins and on the same
        origins in the shade call's order; the lanes each sort moved."""
        calls, split, shadow_order = [], RT.trace_shadow_split, \
            RT._shadow_order

        def order(*a, **k):
            order = shadow_order(*a, **k)
            calls.append([order])
            return order

        def sweep(sp, o, t_lim, **k):
            if calls and len(calls[-1]) == 1:
                calls[-1] += [sp, o, t_lim, k]
            return split(sp, o, t_lim, **k)
        RT._shadow_order, RT.trace_shadow_split = order, sweep
        try:
            eng.program().eager()
        finally:
            RT._shadow_order, RT.trace_shadow_split = shadow_order, split
        total_s = total_u = 0.0
        for i, (order, sp, o, t_lim, k) in enumerate(calls):
            o_u, t_u = (torch.empty_like(x).index_copy_(0, order, x)
                        for x in (o, t_lim))
            ms_s = _time_ms(lambda: split(sp, o, t_lim, **k), 5)
            ms_u = _time_ms(lambda: split(sp, o_u, t_u, **k), 5)
            moved = int((order != torch.arange(order.shape[0],
                                               device=dev)).sum())
            total_s, total_u = total_s + ms_s, total_u + ms_u
            print(f"  {name}: sorted sweep {i + 1} ({o.shape[0]} origins, "
                  f"{int((t_lim > 0).sum())} live, {moved} moved by the "
                  f"sort): K2 + K3 {ms_s:.3f} ms sorted, {ms_u:.3f} ms "
                  f"unsorted")
        print(f"  {name}: the frame's {len(calls)} sorted sweeps: K2 + K3 "
              f"{total_s:.3f} ms sorted, {total_u:.3f} ms on the same "
              f"origins unsorted (CUDA events, 5 calls each)")

    def deferred_vs_sequential(name, eng, eng1):
        """Path 9's frame against path 1's sequential frame from the same
        state: path 9's state saved and loaded into path 1's Engine, the
        same camera; the RT-size float frames of both from their own
        extraction, with tests/test_deferred.py's bounds."""
        state = os.path.join(REPO, "local", "deferred_state.npz")
        os.makedirs(os.path.dirname(state), exist_ok=True)
        eng.save_state(state)
        eng1.load_state(state)
        eng1.camera = eng.camera
        cam, (rw, rh) = eng.camera, eng.rt_size
        ivp = torch.as_tensor(cam.inv_view_proj(rw, rh), device=dev)
        vp = torch.as_tensor(cam.view_proj(rw, rh), device=dev)
        pos = torch.as_tensor(cam.position, device=dev)
        imgs = []
        for e in (eng, eng1):
            tf, pal = e.extract(0.5)
            imgs.append(e.render_target(
                flatten_frame(e.geometry, tf, pal), ivp, vp, pos))
        img_d, img_s = imgs
        diff = (img_d - img_s).abs()
        frac = float((diff.amax(-1) < 1e-4).float().mean())
        mean_d, mean_s = float(img_d.mean()), float(img_s.mean())
        print(f"  {name}: the deferred frame against path 1's sequential "
              f"frame from the same state: {frac:.5f} of pixels within "
              f"1e-4, max {float(diff.max()):.3e}, means {mean_d:.6f} vs "
              f"{mean_s:.6f}")
        if not bool(torch.isfinite(img_d).all()) or frac <= 0.995 or \
                float(diff.max()) >= 0.1 or \
                abs(mean_d - mean_s) >= 1e-3 * max(mean_s, 1e-3):
            _fail(f"{name}: the deferred frame is not within the bounds of "
                  f"the sequential one")

    def subdiv_pixels(whole, halves, diff):
        """Where the ``trans_subdiv`` frame differs from the default frame
        (``diff`` > 0): the translucent K1 records at each such pixel of
        the default frame's call (whole triangles: id, depth w, the
        parent's barycentrics b0 b1 b2) and of the subdivided call (the
        children, which carry the parent's id: id, w), and what differs:
        "coverage" (a parent id in one call's layers and not the other's;
        where the whole call holds it, the smallest |b|, 0 on the parent's
        outer edges, and |b - 1/2|, 0 on the children's inner edges),
        "depth" (the same ids, other depths) or "none" (the same records).
        A pixel is explained when a whole-call record there lies within
        SUBDIV_EDGE of its parent's outer edge (the children's outer
        edges run to f32 midpoints, so their edge tests there round
        otherwise than the parent's) or only the depths differ, by at most
        SUBDIV_DEPTH relative (the children's planes through those
        midpoints) -> the pixels not explained."""
        outs = []
        for (rows, meta, boxes, w, h, lay, *rest), k in (whole, halves):
            prior = rest[0] if rest else k.get("prior_w")
            outs.append(TR.cluster_raster(rows, meta, boxes, w, h, lay,
                                          prior))
        tiles_x = -(-W // 128)
        kinds, unexplained = {}, []
        for n, (y, x) in enumerate(torch.nonzero(diff > 0).tolist()):
            at = (y // 32 * tiles_x + x // 128, slice(None), y % 32,
                  x % 128)
            (ia, b0, b1, wa), (ib, _, _, wb) = (
                [t[at].tolist() for t in o] for o in outs)
            b2 = [1.0 - u - v for u, v in zip(b0, b1)]
            bs = [(b0[li], b1[li], b2[li]) for li in range(len(ia))]
            only = (set(ia) ^ set(ib)) - {-1}
            if only:
                kind, ok = "coverage", False
                for li, i in enumerate(ia):
                    if i >= 0:
                        edge = min(abs(v) for v in bs[li])
                        ok |= edge <= SUBDIV_EDGE
                        if i in only:
                            kind += (f" (id {i} only in the whole call: "
                                     f"min |b| {edge:.3g}, min |b - 1/2| "
                                     f"{min(abs(v - 0.5) for v in bs[li]):.3g})")
                if set(ib) - set(ia) - {-1}:
                    kind += (f" (ids {sorted(set(ib) - set(ia) - {-1})} "
                             f"only in the subdivided call)")
            elif ia != ib or wa != wb:
                apart = max(abs(u - v) / max(abs(u), 1.0)
                            for u, v in zip(wa, wb) if u < 1e30)
                kind = f"depth (max relative w apart {apart:.3g})"
                ok = ia == ib and apart <= SUBDIV_DEPTH
            else:
                kind, ok = "none", False
            kinds[kind.split(" ")[0]] = kinds.get(kind.split(" ")[0], 0) + 1
            if not ok:
                unexplained.append((x, y))
            if n < 16 or not ok:
                print(f"    ({x}, {y}; max channel diff "
                      f"{float(diff[y, x]):.3e}): whole " + "; ".join(
                          f"{int(i)} w {u:.9g} b {p:.6g} {q:.6g} {r:.6g}"
                          for i, u, (p, q, r) in zip(ia, wa, bs)) +
                      " | subdivided " + "; ".join(
                          f"{int(i)} w {u:.9g}" for i, u in zip(ib, wb)) +
                      f" -> {kind}{'' if ok else ', NOT EXPLAINED'}")
        print(f"  trans_subdiv: the differing pixels' translucent records: "
              f"{kinds}; not explained: {len(unexplained)}")
        return unexplained

    def knob_frames():
        """One first frame for each knob keyword on the path it applies to
        (KNOB_FRAMES), eager through the kernels at the path's size from
        its Engine's camera and first-frame transforms, against the
        path's default frame made the same way, within its KNOB_FRAMES
        bound (bit for bit where the reference reports identical images),
        the share of pixels that differ printed. Each frame's kernel calls
        of the roles the knob changes are captured (K4 in the bounce
        passes for ``packet_compact``; K2, K3 and K4 in the batched
        continuation shade for the unlit knobs) for the checks against the
        twins in section 3, its launches counted, and one eager time
        printed beside the default's. Where ``trans_subdiv`` differs
        from the default, ``subdiv_pixels`` prints why."""
        flags = {"bounce": False, "cont": False}

        def flagged(fn, key):
            def run(*a, **k):
                flags[key] = True
                try:
                    return fn(*a, **k)
                finally:
                    flags[key] = False
            return run
        for name, pi, kw, keys, bound in KNOB_FRAMES:
            path = PATHS[pi]
            eng, scene = engines[path], scenes[path]
            scope = "bounce" if "packet_compact" in kw else \
                "cont" if ("unlit_split" in kw or "unlit_dense" in kw) \
                else None
            cam = eng.camera
            tf = scene.transforms.clone()
            tf[:, :3, 3] -= torch.as_tensor(
                cam.world_position.astype(np.float32), device=dev)
            fg = flatten_frame(scene.geometry, tf, scene.palettes)
            ivp = torch.as_tensor(cam.inv_view_proj(W, H), device=dev)
            vp = torch.as_tensor(cam.view_proj(W, H), device=dev)

            def render(**k):
                return RT.render_frame(
                    scene.geometry, fg, eng.ibl, scene.lights, ivp,
                    cam.position, W, H, max_layers=eng.max_layers,
                    shadow_layers=eng.shadow_layers, view_proj=vp,
                    primary=eng.primary, layered=eng.layered,
                    shadow_prepass=eng.shadow_prepass, **k)
            whole = Capture()      # the default frame's translucent K1
            if "trans_subdiv" in kw:
                whole.on(*wrappers["K1"], roles["K1"])
            try:
                base, base_ms = _timed(render)
            finally:
                whole.off()
            cap = caps[name] = Capture()
            runs[name] = keys
            for fam in dict.fromkeys(k.split("/")[0] for k in keys + ("K4",)):
                if fam == "K1":
                    def key_of(*a, **k):
                        return f"K1/layers={a[5]}" if a[5] == LAYERS else "-"
                elif fam == "K6":
                    key_of = roles["K6"]
                else:
                    def key_of(*a, fam=fam, **k):
                        return fam if scope is None or flags[scope] else "-"
                cap.on(*wrappers[fam], key_of)
            hooks = [(RT, f, getattr(RT, f)) for f in (
                "_mirror_pass", "_refraction_pass", "_shade_continuations")]
            for mod, f, fn in hooks:
                setattr(mod, f, flagged(fn, "cont" if f ==
                                        "_shade_continuations" else "bounce"))
            zero_counts()
            try:
                out, ms = _timed(lambda: render(**kw))
            finally:
                cap.off()
                for mod, f, fn in hooks:
                    setattr(mod, f, fn)
            counts[name] = read_counts()
            for key in keys:
                if key not in cap.args:
                    _fail(f"{name}: {key} was not called in its frame")
            diff = (out - base).abs().amax(-1)
            share = float((diff > 0).float().mean())
            gate = ""
            if "trans_subdiv" in kw:
                held = scene.geometry.trans_untextured
                gate = (f"; the gate (no texture in the translucent set) "
                        f"{'held' if held else 'did not hold'}")
            print(f"knob {name} on {path}: {kw}: {share:.5f} of pixels "
                  f"differ from the default frame (max "
                  f"{float(diff.max()):.3e}){gate}; eager frame "
                  f"{ms:.2f} ms, default {base_ms:.2f} ms (CUDA events, one "
                  f"cold frame each)")
            print(f"  launches in the frame: {counts[name]}")
            if 0 < share < 1e-3:
                ys, xs = torch.nonzero(diff > 0, as_tuple=True)
                print(f"  the pixels that differ (x, y; max channel "
                      f"difference): " + ", ".join(
                          f"({int(x)}, {int(y)}; {float(diff[y, x]):.3e})"
                          for x, y in list(zip(xs, ys))[:12]))
            if "trans_subdiv" in kw and share > 0 and subdiv_pixels(
                    whole.args[f"K1/layers={LAYERS}"],
                    cap.args[f"K1/layers={LAYERS}"], diff):
                _fail(f"{name}: pixels differ from the default frame where "
                      f"the translucent records do not explain it")
            if not bool(torch.isfinite(out).all()) or float(out.std()) < 1e-3:
                _fail(f"{name}: the frame is not finite or is constant")
            if bound == 0 and not _same_bits(out, base) or bound and (
                    share > bound[0] or float(diff.max()) >= bound[1]):
                _fail(f"{name}: the frame is not within {bound} of the "
                      f"default frame")

    # -- 2. the eleven paths --------------------------------------------------
    # Each path captures the first call of every kernel it runs, keyed by
    # kernel and, where a frame calls it in two roles, by role: K1 by its
    # layer count, K6 dense or past a t floor, K9 first or behind a peel.
    wrappers = {"K1": (TR, "cluster_raster"), "K2": (CS, "trace_shadow_occl"),
                "K3": (CS, "trace_shadow_clusters"), "K4": (RK, "trace_rays"),
                "K5": (RK, "trace_layers_so"), "K6": (RK, "trace_rays_so"),
                "K7": (RK, "trace_shadow_factor"),
                "K8": (RK, "trace_shadow_any"), "K9": (TR, "list_raster")}
    roles = {
        "K1": lambda *a, **k: f"K1/layers={a[5]}",
        "K6": lambda *a, **k: "K6" if k["t_floor"] is None else "K6/floor",
        "K9": lambda *a, **k: "K9" if a[4] is None else "K9/peel"}
    runs = {PATHS[0]: ("K1/layers=1", f"K1/layers={LAYERS}", "K2", "K3",
                       "K4"),
            PATHS[1]: ("K2", "K3", "K4", "K5"),
            PATHS[2]: ("K4", "K5", "K7"),
            PATHS[3]: ("K1/layers=2",),
            PATHS[4]: ("K9", "K9/peel"),
            PATHS[5]: ("K4", "K6", "K6/floor", "K8"),
            # path 7 runs path 1's kernels, held against their twins there
            PATHS[6]: (),
            PATHS[7]: (f"K1/layers={LAYERS}",),
            PATHS[8]: ("K1/layers=1",),
            # path 9's K1 calls are path 1's, held there; its K4 call is
            # added where a bounce segment survives the pruning
            PATHS[9]: ("K2", "K3"),
            PATHS[10]: ("K4",)}
    caps, counts, scenes, engines, overflow = {}, {}, {}, {}, []
    medians, captures, states = {}, [], set()
    t0 = time.perf_counter()
    for name, scene, eng in path_engines(dev):
        # the DemoScene's branch: only path 7's asset directory holds the
        # skeleton and profiles
        if scene.posed != (name == PATHS[6]):
            _fail(f"{name}: the DemoScene took the "
                  f"{'posed' if scene.posed else 'stand-in'} branch")
        print(f"path {name}: {'posed' if scene.posed else 'stand-in'} "
              f"player")
        if all(scene is not s for s in scenes.values()):
            label = "full, posed" if scene.posed else \
                "decimated" if scenes else "full"
            rows_n = scene_stats(label, scene, t0)
            if label == "decimated" and rows_n > RK.WALK_MAX_ROWS:
                _fail(f"the decimated tree has {rows_n} rows, over the "
                      f"walks' cap")
        scenes[name], engines[name] = scene, eng
        if name == PATHS[9]:
            bounces = scene.geometry.bounces
            print(f"  {name}: bounce segments that survive the static "
                  f"pruning: mirror {bounces.mirror}, refraction "
                  f"{bounces.refraction}")
            if any(bounces):
                runs[name] += ("K4",)
        cap = caps[name] = Capture()
        for fam in dict.fromkeys(k.split("/")[0] for k in runs[name]):
            cap.on(*wrappers[fam], roles.get(fam, lambda *a, fam=fam, **k:
                                               fam))
        if name == PATHS[4]:   # the overflowed tile count of each peel
            orig = RA.rasterize

            def peel(*a, **k):
                hits = orig(*a, **k)
                # read in the eager warm-up runs; the capture reads nothing
                if not torch.cuda.is_current_stream_capturing():
                    overflow.append(int(hits.overflow))
                return hits
            cap._orig.append((RA, "rasterize", orig))
            RA.rasterize = peel
        if name == PATHS[6]:
            p = scene.player

            def watch():
                states.add(int(eng.state.loco.state[p]))
            counts[name] = run_path(
                name, eng, cap, watch=watch,
                pad_of=lambda i: InputFrame(ly=1.0, dodge=i == DODGE_FRAME))
            posed_checks(name, eng, scene, engines[PATHS[0]], states)
        elif name in PATHS[7:]:
            counts[name] = run_path(name, eng, cap, timed=PRIMARY_TIMED)
        else:
            counts[name] = run_path(name, eng, cap)
        if name in (PATHS[0], PATHS[9]):
            sorted_sweeps(name, eng)
        if name == PATHS[9]:
            deferred_vs_sequential(name, eng, engines[PATHS[0]])
        if name in PATHS[6:]:
            busy, syncs = _busy_syncs(eng)
            print(f"  device busy {busy:.3f} ms a frame, {syncs:.2f} syncs "
                  f"a frame (torch.profiler, 3 frames)")
            if syncs > 1:
                _fail(f"{name}: {syncs} syncs a frame")
        for key in runs[name]:
            if key not in cap.args:
                _fail(f"{key} was not called in the first frame of {name}")
        if name == PATHS[0]:
            run_pipelined(name, scene, 3)
        t0 = time.perf_counter()
    print(f"  path 5: overflowed tiles per peel (the capture's eager warm-up "
          f"frames): "
          f"{overflow}")
    for name, size, secs, pool in captures:
        print(f"frame graph capture, {name} at {size[0]}x{size[1]}: "
              f"{secs:.3f} s, pool {pool / 2**20:.1f} MiB")
    c1, c2, c3, c4, c5, c6, c7, c8, c9, c10, c11 = (counts[p] for p in PATHS)

    def only(c, *keys):
        """No other kernel of the port was launched."""
        return all(v == 0 for k, v in c.items()
                   if k not in keys + ("shade_calls",))

    opq, trans = "K1/layers=1", f"K1/layers={LAYERS}"
    expect("path 1", c1, "K1 once a frame in each role, K2 = K3 > 0, K4 > 0, "
           "nothing else", c1[opq] == c1[trans] == TIMED and
           c1["K2"] == c1["K3"] > 0 and c1["K4"] > 0 and
           only(c1, opq, trans, "K2", "K3", "K4"))
    expect("path 2", c2, "K5 once a frame, K2 = K3 > 0, K4 > 0, nothing "
           "else", c2["K5"] == TIMED and c2["K2"] == c2["K3"] > 0 and
           c2["K4"] > 0 and only(c2, "K2", "K3", "K4", "K5"))
    expect("path 3", c3, "K5 once a frame, K7 > 0, K4 > 0, nothing else",
           c3["K5"] == TIMED and c3["K7"] > 0 and c3["K4"] > 0 and
           only(c3, "K4", "K5", "K7"))
    expect("path 4", c4, "K1 with 2 layers once a frame, nothing else",
           c4["K1/layers=2"] == TIMED and only(c4, "K1/layers=2"))
    expect("path 5", c5, "K9 twice a frame, nothing else",
           c5["K9"] == 2 * TIMED and only(c5, "K9"))
    expect("path 6", c6, "K6 max_layers times a frame, K8 once per shade "
           "call, K4 > 0, nothing else",
           c6["K6"] == LAYERS * TIMED and c6["K8"] == c6["shade_calls"] > 0
           and c6["K4"] > 0 and only(c6, "K4", "K6", "K8"))

    expect("path 7", c7, "K1 once a frame in each role, K2 = K3 > 0, K4 > 0, "
           "nothing else", c7[opq] == c7[trans] == TIMED and
           c7["K2"] == c7["K3"] > 0 and c7["K4"] > 0 and
           only(c7, opq, trans, "K2", "K3", "K4"))
    expect("path 8a (peels)", c8, f"K1 with {LAYERS} layers once a frame, "
           "K2 = K3 > 0, K4 > 0 (the bounces), nothing else",
           c8[trans] == PRIMARY_TIMED and c8["K2"] == c8["K3"] > 0 and
           c8["K4"] > 0 and only(c8, trans, "K2", "K3", "K4"))
    expect("path 8b (raster)", c9, "K1 with 1 layer once a frame, K2 = K3 > "
           "0, K4 > 0 (continuations and bounces), nothing else",
           c9[opq] == PRIMARY_TIMED and c9["K2"] == c9["K3"] > 0 and
           c9["K4"] > 0 and only(c9, opq, "K2", "K3", "K4"))
    k4_9 = PRIMARY_TIMED if "K4" in runs[PATHS[9]] else 0
    expect("path 9 (deferred)", c10, "K1 once a frame in each role, one K2 "
           "and one K3 a frame, one K4 a frame where a bounce segment "
           "survives the pruning, nothing else",
           c10[opq] == c10[trans] == PRIMARY_TIMED and
           c10["K2"] == c10["K3"] == PRIMARY_TIMED and c10["K4"] == k4_9
           and only(c10, opq, trans, "K2", "K3", "K4"))
    expect("path 10 (raster, traced visibility)", c11, "K4 twice a frame "
           "(the raster path's 2 layers), nothing else",
           c11["K4"] == 2 * PRIMARY_TIMED and only(c11, "K4"))

    # -- 2a. path 11: the image plane sharded over the cards -----------------
    cap = caps[SHARD_PATH] = Capture()
    runs[SHARD_PATH] = ("K2", "K3", "K4")
    for fam in runs[SHARD_PATH]:
        cap.on(*wrappers[fam], lambda *a, fam=fam, **k: fam)
    c12, shard_r = sharded_phase(dev, scenes[PATHS[0]],
                                 engines[PATHS[0]].ibl, cap)
    counts[SHARD_PATH] = c12
    expect("path 11 (sharded)", c12, "K4 > 0, K2 = K3 > 0 (shards of at "
           "least 100,000 lanes, a tree past the walks' row cap), nothing "
           "else", c12["K4"] > 0 and c12["K2"] == c12["K3"] > 0 and
           only(c12, "K2", "K3", "K4"))
    for key in runs[SHARD_PATH]:
        if key not in cap.args:
            _fail(f"{key} was not called in the whole render of "
                  f"{SHARD_PATH}")

    # -- 2b. path 12: the entity axis ---------------------------------------
    def entity_capture():
        cap = Capture()
        for fam in ("K2", "K3", "K4"):
            cap.on(*wrappers[fam], lambda *a, fam=fam, **k: fam)
        return cap
    runs[ENTITY_DEMO] = ("K2", "K3", "K4")
    from swift_game_engine_tpu_torch.ecs.world import to_device
    counts[ENTITY_DEMO], caps[ENTITY_DEMO] = entity_phase(
        dev, scenes[PATHS[0]], engines[PATHS[0]].ibl, shard_r["entity"],
        to_device(shard_r["before"], dev), entity_capture)
    ce = counts[ENTITY_DEMO]
    expect(f"path 12 ({ENTITY_DEMO})", ce, "K4 > 0, K2 = K3 > 0 (path 11's "
           "render over 4 shards of 139,264 lanes), nothing else",
           ce["K4"] > 0 and ce["K2"] == ce["K3"] > 0 and
           only(ce, "K2", "K3", "K4"))
    for key in runs[ENTITY_DEMO]:
        if key not in caps[ENTITY_DEMO].args:
            _fail(f"{key} was not called in {ENTITY_DEMO}")

    # -- 2c. the knob paths' first frames ----------------------------------
    knob_frames()

    # -- 2d. the fixed-step simulation and the pose stack on the card --------
    simulation_phase(dev, scenes[PATHS[1]])
    simulation_phase(dev, scenes[PATHS[6]], "posed", crowd=False)
    pose_phase(dev, pose_rig_dir())

    # -- 2e. the entry points a user runs ------------------------------------
    examples_phase()

    # -- 3. each kernel vs its plain version, on each path's inputs ----------
    results = []

    def report(name, source, replaces, launches, err, ms, plain_ms, bound,
               extra="", floor=None, records=None):
        bound_ms, bound_by = bound
        if floor is not None:   # the bytes floor beside the counted bound
            extra += f", bytes floor {floor[0]:.4f} ms"
        if records is not None:  # and the bound of one test per record
            extra += f", records bound {records[0]:.4f} ms"
        results.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None))
        print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{extra},"
              f" bound {bound_ms:.4f} ms by {bound_by}, {launches} launches")

    def behind_opaque(rows, tid):
        """(tiles, L, 32, 128) bool: the record lies behind an opaque
        fragment of a nearer layer. The kernel ends a pixel's cluster walk
        at its nearest opaque fragment, so it may keep or drop such a
        record; the frame never reads one (the alpha chain saturates at an
        opaque layer), and the dense plain version always keeps it."""
        ids = rows[:, 12].long()
        flag = torch.zeros(int(ids.max()) + 1, dtype=torch.bool, device=dev)
        flag[ids[ids >= 0]] = rows[ids >= 0, 13] > 0.5
        opq = flag[tid.long().clamp(min=0)] & (tid >= 0)
        nearer = torch.cumsum(opq.int(), 1) - opq.int()
        return nearer > 0

    def k1_differing(rows, meta, boxes, w, lay, key_k, key_p, out_k, out_p):
        """Each record where K1 and its plain version differ: the pixel,
        the layer, both sides' triangle id and depth w, the pixel's records
        in every layer, and of each triangle involved its row (16 f32), its
        screen box and its cluster's."""
        per = rows.shape[0] // meta.shape[0]
        tiles_x = -(-w // 128)
        for tile, li, y, x in torch.nonzero(key_k != key_p).tolist()[:8]:
            def rec(o, l):
                at = (tile, l, y, x)
                return f"{int(o[0][at])} w {float(o[3][at]):.9g}"

            def pixel(o):
                return "; ".join(rec(o, l) for l in range(lay))
            print(f"    K1 differs at pixel ({(tile % tiles_x) * 128 + x}, "
                  f"{(tile // tiles_x) * 32 + y}) layer {li + 1}: kernel id "
                  f"{rec(out_k, li)}, plain id {rec(out_p, li)}; the pixel's "
                  f"layers, kernel: {pixel(out_k)} | plain: {pixel(out_p)}")
            for tid in {int(out_k[0][tile, li, y, x]),
                        int(out_p[0][tile, li, y, x])} - {-1}:
                i = int(torch.nonzero(rows[:, 12] == tid)[0])
                cl = meta[meta[:, 5] == (i // per) * (per // 8)][0]
                print(f"      row of id {tid}: " +
                      " ".join(f"{v:.9g}" for v in rows[i].tolist()) +
                      "; screen box " + " ".join(
                          f"{v:.9g}" for v in boxes[i].tolist()) +
                      "; its cluster's " + " ".join(
                          f"{v:.9g}" for v in cl[:4].tolist()))

    def check_k1(args, c, tag):
        """Each role (layer count) on its own: records, work, time, bound;
        ``c``: the path's launch counts."""
        for key in sorted(k for k in args if k.startswith("K1/")):
            (rows, meta, boxes, w, h, lay, *rest), kw = args[key]
            prior = rest[0] if rest else kw.get("prior_w")
            out_k = TR.cluster_raster(rows, meta, boxes, w, h, lay, prior)
            out_p, plain_ms = _timed(lambda: TR.cluster_raster_plain(
                rows, w, h, lay, prior, meta))
            behind = behind_opaque(rows, out_p[0])
            if bool(behind.any()):
                print(f"  K1 layers={lay}: {int(behind.sum())} records lie "
                      f"behind an opaque fragment; compared up to it")
            (key_k, *vals_k), (key_p, *vals_p) = (
                [torch.where(behind, -2, o[0])] +
                [torch.where(behind, 0.0, v) for v in o[1:]]
                for o in (out_k, out_p))
            err = _compare(f"K1 layers={lay} ({rows.shape[0]} rows)", key_k,
                           key_p, vals_k, vals_p)
            k1_differing(rows, meta, boxes, w, lay, key_k, key_p, out_k,
                         out_p)
            # the work of the frame's call, from the counting instantiation
            out_c, cnt = TR.cluster_raster_counts(rows, meta, boxes, w, h,
                                                  lay, prior)
            if not all(torch.equal(a, b) for a, b in zip(out_c, out_k)):
                _fail("K1's counting instantiation differs from the kernel")
            print(f"  K1 work layers={lay} ({meta.shape[0]} clusters of "
                  f"{rows.shape[0] // meta.shape[0]}): " + _count_line(cnt))
            # counted: each pixel's own test of each cluster the cull
            # admits, and the triangle rows it edge-tests; records: one
            # edge test per record written
            ops = (int(cnt["lane_meta"].sum()) * META_OPS +
                   int(cnt["lane_tri"].sum()) * EDGE_OPS)
            # bytes: what the function reads and writes (the row boxes are
            # this design's own table, not part of the work)
            ins, outs = [rows, meta, prior], list(out_k)
            report(f"cluster_raster/layers={lay}" + tag, "swift_game_engine_"
                   "tpu_torch/csrc/cluster_raster.cu", "swift_game_engine_tpu"
                   "/render/tile_raster.py:620", c[key], err,
                   _time_ms(lambda: TR.cluster_raster(rows, meta, boxes, w, h,
                                                      lay, prior), 5),
                   plain_ms, _bound(ins, outs, ops),
                   floor=_bound(ins, outs, 0),
                   records=_bound(ins, outs, int((out_k[0] >= 0).sum()) *
                                  EDGE_OPS))

    def shadow_subset(t_lim, subset):
        """(the lanes the twin runs on, a label): all of them, or a
        subset of a long stream (``_stream_subset``)."""
        if not subset:
            return slice(None), f"{t_lim.shape[0]} lanes"
        sub = _stream_subset(t_lim > 0, STREAM_TWIN_LANES)
        return sub, (f"{sub.numel()} of {t_lim.shape[0]} lanes: "
                     f"{int((t_lim[sub] > 0).sum())} of the "
                     f"{int((t_lim > 0).sum())} live, the rest dead")

    def dead_warps(t_lim, cnt):
        """The warps of 32 lanes all dead (t_lim <= 0) must test no
        cluster: they retire at once."""
        n = t_lim.shape[0]
        dead = torch.cat([t_lim <= 0, t_lim.new_ones((-n) % 32, dtype=bool)])
        dead = dead.reshape(-1, 32).all(1)
        tested = int(cnt["warp_meta"][dead].sum())
        print(f"  {int(dead.sum())} of {dead.numel()} warps all dead: "
              f"{tested} cluster entries tested by them")
        if tested:
            _fail("a warp of dead lanes tested clusters")

    def check_k2(args, c, tag, subset=False):
        (sc, o, t_lim), kw = args["K2"][0][:3], args["K2"][1]
        tt = kw.get("tt")
        sub, label = shadow_subset(t_lim, subset)
        exact_k = CS.trace_shadow_occl(sc, o, t_lim)[sub]
        exact_p, plain_ms = _timed(lambda: CS.trace_shadow_occl_plain(
            sc, o[sub].contiguous(), t_lim[sub].contiguous()))
        err = _compare(f"K2 exact ({label})", exact_k < 1e30,
                       exact_p < 1e30, [exact_k], [exact_p])
        if tt is not None:   # any-hit: settled lanes return SOME t < tt
            any_k = CS.trace_shadow_occl(sc, o, t_lim, tt=tt)
            any_s, tt_s = any_k[sub], tt[sub]
            bad = (any_s != exact_p) & ~((any_s < tt_s) & (exact_p < tt_s))
            print(f"  K2 any-hit: {int(bad.sum())} lanes not "
                  f"factor-equivalent")
            if float(bad.float().mean()) > MAX_MISMATCH:
                _fail("K2 any-hit records are not factor-equivalent")
        else:
            any_k = CS.trace_shadow_occl(sc, o, t_lim)
        # the work of the frame's call, from the counting instantiation
        any_c, cnt = CS.trace_shadow_occl_counts(sc, o, t_lim, tt)
        if not torch.equal(any_c, any_k):
            _fail("K2's counting instantiation differs from the kernel")
        print(f"  K2 work ({sc.meta.shape[0]} clusters of {sc.cluster}): "
              + _count_line(cnt))
        if subset:
            dead_warps(t_lim, cnt)
        # counted: each lane's own test of each cluster the warp's cull
        # admits, and the opaque rows it tests; records: one row test per
        # lane with a hit
        ops = (int(cnt["lane_tri"].sum()) * SWEEP_OPS +
               int(cnt["lane_meta"].sum()) * META_OPS)
        ins, outs = [sc.rows, sc.meta, sc.basis, o, t_lim, tt], [any_k]
        report("shadow_occl" + tag, "swift_game_engine_tpu_torch/csrc/"
               "cluster_shadow.cu", "swift_game_engine_tpu/ops/"
               "cluster_shadow.py:541", c["K2"], err,
               _time_ms(lambda: CS.trace_shadow_occl(sc, o, t_lim, tt=tt), 5),
               plain_ms, _bound(ins, outs, ops), floor=_bound(ins, outs, 0),
               records=_bound(ins, outs, int((any_k < 1e30).sum()) *
                              SWEEP_OPS),
               extra=f" (plain on {label})" if subset else "")

    def check_k3(args, c, tag, subset=False):
        (sc, o, t_lim, *rest), kw = args["K3"]
        n_slots = rest[0] if rest else kw.get("n_slots", 4)
        alpha = rest[1] if len(rest) > 1 else kw.get("alpha_payload", False)
        sub, label = shadow_subset(t_lim, subset)
        k3 = CS.trace_shadow_clusters(sc, o, t_lim, n_slots, alpha)
        p3, plain_ms = _timed(lambda: CS.trace_shadow_clusters_plain(
            sc, o[sub].contiguous(), t_lim[sub].contiguous(), n_slots,
            alpha))
        k3s = [x[sub] for x in k3]
        err = max(_compare(f"K3 t_opq ({label})", k3s[0] < 1e30,
                           p3[0] < 1e30, [k3s[0]], [p3[0]]),
                  _compare(f"K3 slots ({n_slots} per lane)", k3s[2], p3[2],
                           [k3s[1]], [p3[1]]))
        # the work of the frame's call, from the counting instantiation
        k3c, cnt = CS.trace_shadow_clusters_counts(sc, o, t_lim, n_slots,
                                                   alpha)
        if not all(torch.equal(a, b) for a, b in zip(k3c, k3)):
            _fail("K3's counting instantiation differs from the kernel")
        print(f"  K3 work ({sc.meta.shape[0]} clusters of {sc.cluster}): "
              + _count_line(cnt))
        # counted: each lane's own test of each cluster the cull admits, and
        # the rows it tests; records: one row test per record written
        ops = (int(cnt["lane_tri"].sum()) * SWEEP_OPS +
               int(cnt["lane_meta"].sum()) * META_OPS)
        ins, outs = [sc.rows, sc.meta, sc.basis, o, t_lim], list(k3)
        report("shadow_slots" + tag, "swift_game_engine_tpu_torch/csrc/"
               "cluster_shadow.cu", "swift_game_engine_tpu/ops/"
               "cluster_shadow.py:254", c["K3"], err,
               _time_ms(lambda: CS.trace_shadow_clusters(sc, o, t_lim,
                                                         n_slots, alpha), 5),
               plain_ms, _bound(ins, outs, ops), floor=_bound(ins, outs, 0),
               records=_bound(ins, outs, (int((k3[2] >= 0).sum()) +
                                          int((k3[0] < 1e30).sum()))
                              * SWEEP_OPS),
               extra=f" (plain on {label})" if subset else "")

    def check_k4(args, c, tag, subset=False):
        """The frame's first call: a compacted batch, its live lanes'
        count on the device (K4 walks the lanes below it); with
        ``subset``, the twin runs on a strided sample of the live lanes
        and a slice of the rest."""
        (tree, rows, o, d, t_max, *rest), _ = args["K4"]
        count = rest[0] if rest else None
        live = o.shape[0] if count is None else int(count)
        t_k, tri_k = RK.trace_rays(tree, rows, o, d, t_max, count)
        sub, count_s, label = slice(None), count, ""
        if subset:
            walked = t_max > 0
            if count is not None:
                walked &= torch.arange(o.shape[0], device=dev) < count
            sub = _stream_subset(walked, STREAM_TWIN_LANES // 4)
            n_walked = int(walked[sub].sum())
            if count is not None:
                count_s = torch.tensor(n_walked, dtype=torch.int32,
                                       device=dev)
            label = f"; plain on {sub.numel()} of them, {n_walked} walked"
        (t_p, tri_p), plain_ms = _timed(lambda: RK.trace_rays_plain(
            tree, rows, o[sub].contiguous(), d[sub].contiguous(),
            t_max[sub].contiguous(), count_s))
        err = _compare(f"K4 ({live} live of {o.shape[0]} rays, "
                       f"{rows.shape[0]} rows, {tree.nodes.shape[0]} wide "
                       f"nodes{label})", tri_k[sub], tri_p, [t_k[sub]],
                       [t_p])
        # the work of the frame's call, from the counting instantiation
        t_c, tri_c, cnt = RK.trace_rays_counts(tree, rows, o, d, t_max,
                                               count)
        if not (torch.equal(tri_c, tri_k) and torch.equal(t_c, t_k)):
            _fail("K4's counting instantiation differs from the kernel")
        threads = RK.walk_threads("K4")
        print(f"  K4 work (threads a ray {threads}, stack {tree.stack}): "
              + _count_line(cnt, 32 // threads))
        # counted: the non-empty child boxes and the triangles the walk
        # tests; records: one triangle test per ray with a hit
        ops = int(cnt["boxes"].sum()) * SLAB_OPS + \
            int(cnt["slots"].sum()) * MT_OPS
        # the lanes past the count read only their t_max
        ins = [tree.nodes, rows, o[:live], d[:live], t_max]
        outs = [t_k, tri_k]
        report("trace_closest" + tag, "swift_game_engine_tpu_torch/csrc/"
               "bvh_trace.cu", "swift_game_engine_tpu/ops/rt_kernel.py:794",
               c["K4"], err,
               _time_ms(lambda: RK.trace_rays(tree, rows, o, d, t_max, count),
                        5),
               plain_ms, _bound(ins, outs, ops), floor=_bound(ins, outs, 0),
               records=_bound(ins, outs, int((tri_k >= 0).sum()) * MT_OPS),
               extra=f" (plain on {sub.numel()} rays)" if subset else "")

    def walk_bounds(ins, outs, own, binary, n_sub, n, records):
        """The bounds of a wide walk's call, each the larger of the bytes
        and the operations: (the kernel's own counted tests, which the JSON
        line reports; the bytes floor; one test per record; the binary
        walk's tests on the subset, scaled to the call: the bound before
        the redesign)."""
        return (_bound(ins, outs, own), _bound(ins, outs, 0),
                _bound(ins, outs, records),
                _bound(ins, outs, binary * n / n_sub))

    def slot_walk(key, launch, twin, counting, binary, args, rows,
                  lanes=TWIN_LANES):
        """K5 or K7, a slot walk of the wide tree: the records of the
        frame's call (the build its lane count chooses) at a subset of the
        lanes against the wide twin on that subset (keyed by the opaque id,
        or whether there is an opaque hit, and the slot ids; t_opq and the
        slots' t compared where the keys agree); the call's work by the
        counting instantiation, the binary walk's (the design before the
        redesign) on every 4th lane of the subset (``binary`` None: not
        run; the walk's counts are then empty); the twin on at most
        ``lanes`` lanes."""
        (tree, srows, shared, *lane), _ = args[key]
        n = lane[0].shape[0]
        sub = _subset(n, dev, lanes)
        lane_s = [x[sub].contiguous() for x in lane]

        def keyed(r):
            opq = r[1].float() if key == "K5" else (r[0] < 1e30).float()
            return torch.cat([opq[:, None], r[-1]], 1), [r[0], r[-2]]
        threads = RK.walk_threads(key, n)
        out = launch(tree, srows, shared, *lane)
        k = [x[sub] for x in out]
        p, plain_ms = _timed(lambda: twin(tree, srows, shared, *lane_s))
        err = _compare(f"{key} ({sub.numel()} of {n} lanes, "
                       f"{k[-1].shape[1]} slots, threads a ray {threads})",
                       keyed(k)[0], keyed(p)[0], keyed(k)[1], keyed(p)[1])
        *out_c, cnt = counting(tree, srows, shared, *lane)
        if not all(torch.equal(x, y) for x, y in zip(out_c, out)):
            _fail(f"{key}'s counting instantiation differs from the kernel")
        print(f"  {key} work (threads a ray {threads}, stack {tree.stack}): "
              + _count_line(cnt, 32 // threads))
        print(f"  {key} work, per ray of the subset: " +
              _ray_line({x: v[sub] for x, v in cnt.items()}))
        walk, n_bin = dict(box=0, slot=0), 0
        if binary is not None:             # a quarter of the subset
            lane_b = [x[::4].contiguous() for x in lane_s]
            binary(rows, shared, *lane_b, walk)
            n_bin = lane_b[0].shape[0]
            print(f"  {key} binary walk, per ray of {n_bin} of the subset: "
                  + _ray_line(walk))
        return err, out, cnt, walk, sub.numel(), n_bin, n, plain_ms

    def check_k5(args, c, tag, binary=True, lanes=TWIN_LANES):
        """``binary=False``: the binary walk (the bound before the
        redesign) is not run; the twin on at most ``lanes`` lanes."""
        rows = args["K4"][0][1]            # the packed rows of the frame
        n_slots = args["K5"][1].get("n_slots", 3)

        def launch(*a):
            return RK.trace_layers_so(*a, n_slots)

        def binary_walk(rows, origin, d_s, tm_s, walk):
            if not torch.equal(RK.build_origin_rows(rows, origin),
                               args["K5"][0][1]):
                _fail("K5's origin rows are not those of the frame's rows")
            RK.trace_layers_so_binary(
                (RK.binary_header(rows), args["K5"][0][1]), origin, d_s,
                tm_s, n_slots, counts=walk)
        err, out, cnt, walk, n_sub, n_bin, n, plain_ms = slot_walk(
            "K5", launch,
            lambda *a: RK.trace_layers_so_plain(*a, n_slots),
            lambda *a: RK.trace_layers_so_counts(*a, n_slots),
            binary_walk if binary else None, args, rows, lanes)
        tree, srows, origin, d, t_max = args["K5"][0]
        own, floor, records, bin_bound = walk_bounds(
            [tree.nodes, srows, d, t_max], list(out),
            int(cnt["boxes"].sum()) * SLAB_OPS +
            int(cnt["slots"].sum()) * SO_SLOT_OPS,
            walk["box"] * SLAB_OPS + walk["slot"] * SO_SLOT_OPS,
            max(n_bin, 1), n,
            (int((out[1] >= 0).sum()) + int((out[3] >= 0).sum()))
            * SO_SLOT_OPS)
        report("so_layers" + tag,
               "swift_game_engine_tpu_torch/csrc/bvh_trace.cu",
               "swift_game_engine_tpu/ops/rt_kernel.py:1503", c["K5"], err,
               _time_ms(lambda: RK.trace_layers_so(tree, srows, origin, d,
                                                   t_max, n_slots), 5),
               plain_ms, own,
               f" (plain on {n_sub} of {n} rays; " + (
                   f"binary walk's bound {bin_bound[0]:.4f} ms by "
                   f"{bin_bound[1]})" if binary else "binary walk not run)"),
               floor=floor, records=records)

    def check_k7(args, c, tag):
        rows = args["K4"][0][1]            # the packed rows of the frame
        n_slots = args["K7"][1].get("n_slots", 4)

        def launch(*a):
            return RK.trace_shadow_factor(*a, n_slots)

        def binary(rows, l, o_s, tl_s, walk):
            if not torch.equal(RK.build_shadow_rows(rows, torch.as_tensor(
                    l, dtype=torch.float32, device=dev)), args["K7"][0][1]):
                _fail("K7's shadow rows are not those of the frame's rows")
            RK.trace_shadow_factor_binary(
                (RK.binary_header(rows), args["K7"][0][1]), l, o_s, tl_s,
                n_slots, counts=walk)
        err, out, cnt, walk, n_sub, n_bin, n, plain_ms = slot_walk(
            "K7", launch,
            lambda *a: RK.trace_shadow_factor_plain(*a, n_slots),
            lambda *a: RK.trace_shadow_factor_counts(*a, n_slots), binary,
            args, rows)
        tree, srows, l, o, t_lim = args["K7"][0]
        own, floor, records, bin_bound = walk_bounds(
            [tree.nodes, srows, o, t_lim], list(out),
            int(cnt["boxes"].sum()) * SLAB_OPS +
            int(cnt["slots"].sum()) * WALK_SLOT_OPS,
            walk["box"] * SLAB_OPS + walk["slot"] * WALK_SLOT_OPS, n_bin, n,
            (int(((out[0] > 0) & (out[0] < 1e30)).sum()) +
             int((out[2] >= 0).sum())) * WALK_SLOT_OPS)
        report("shadow_walk" + tag,
               "swift_game_engine_tpu_torch/csrc/bvh_trace.cu",
               "swift_game_engine_tpu/ops/rt_kernel.py:1113", c["K7"], err,
               _time_ms(lambda: RK.trace_shadow_factor(tree, srows, l, o,
                                                       t_lim, n_slots), 5),
               plain_ms, own,
               f" (plain on {n_sub} of {n} origins; binary walk's bound "
               f"{bin_bound[0]:.4f} ms by {bin_bound[1]})",
               floor=floor, records=records)

    def check_k6(args, c, tag):
        """The dense layer-1 call and the first continuation (t floor):
        records against the wide twin on a subset of the rays; the dense
        call's work by the counting instantiation, and the binary walk's
        (the design before the wide walk) on the subset."""
        err = 0.0
        rows = args["K4"][0][1]            # the packed rows of the frame
        threads = RK.walk_threads("K6")
        for key in ("K6", "K6/floor"):
            (tree, srows, origin, d, t_max, *rest), kw = args[key]
            t_floor = rest[0] if rest else kw.get("t_floor")
            # a continuation's lanes past its count are parked (t_max 0),
            # so the subset's records need no count; the full call takes it
            count = kw.get("count")
            n = d.shape[0]
            sub = _subset(n, dev)
            d_s, tm_s = d[sub].contiguous(), t_max[sub].contiguous()
            tf_s = None if t_floor is None else t_floor[sub].contiguous()
            k6 = RK.trace_rays_so(tree, srows, origin, d_s, tm_s, tf_s)
            p6, ms = _timed(lambda: RK.trace_rays_so_plain(
                tree, srows, origin, d_s, tm_s, tf_s))
            role = "past a t floor" if key != "K6" else "dense"
            err = max(err, _compare(f"K6 {role} ({sub.numel()} of {n} rays)",
                                    k6[1], p6[1], [k6[0]], [p6[0]]))
            # the work of the frame's call, from the counting instantiation
            t_c, tri_c, cnt = RK.trace_rays_so_counts(tree, srows, origin, d,
                                                      t_max, t_floor, count)
            out6 = RK.trace_rays_so(tree, srows, origin, d, t_max, t_floor,
                                    count)
            if not (torch.equal(tri_c, out6[1]) and torch.equal(t_c,
                                                                out6[0])):
                _fail("K6's counting instantiation differs from the kernel")
            print(f"  K6 work {role} (threads a ray {threads}, stack "
                  f"{tree.stack}): " + _count_line(cnt, 32 // threads))
            print(f"  K6 work {role}, per ray of the subset: " +
                  _ray_line({k: v[sub] for k, v in cnt.items()}))
            # the binary walk's work on the same rays
            if not torch.equal(RK.build_origin_rows(rows, origin), srows):
                _fail("K6's origin rows are not those of the frame's rows")
            walk = {}
            RK.trace_rays_so_binary((RK.binary_header(rows), srows), origin,
                                    d_s, tm_s, tf_s, counts=walk)
            print(f"  K6 binary walk {role}, per ray of the subset: "
                  + _ray_line(walk))
            if key == "K6":      # the dense call is timed and bounded
                plain_ms = ms
                ins, outs = [tree.nodes, srows, d, t_max], list(out6)
                own, floor, records, binary = walk_bounds(
                    ins, outs,
                    int(cnt["boxes"].sum()) * SLAB_OPS +
                    int(cnt["slots"].sum()) * SO_SLOT_OPS,
                    walk["box"] * SLAB_OPS + walk["slot"] * SO_SLOT_OPS,
                    sub.numel(), n, int((out6[1] >= 0).sum()) * SO_SLOT_OPS)
                dense = (tree, srows, origin, d, t_max, n, sub.numel())
        tree, srows, origin, d, t_max, n, n_sub = dense
        report("so_closest" + tag,
               "swift_game_engine_tpu_torch/csrc/bvh_trace.cu",
               "swift_game_engine_tpu/ops/rt_kernel.py:1327", c["K6"], err,
               _time_ms(lambda: RK.trace_rays_so(tree, srows, origin, d,
                                                 t_max), 5),
               plain_ms, own,
               f" (the dense call; plain on {n_sub} of {n} rays; binary "
               f"walk's bound {binary[0]:.4f} ms by {binary[1]})",
               floor=floor, records=records)

    def check_k8(args, c, tag):
        (tree, rows, o, d, t_lim), _ = args["K8"]
        n = o.shape[0]
        sub = _subset(n, dev)
        o_s, d_s, tl_s = (x[sub].contiguous() for x in (o, d, t_lim))
        k8 = RK.trace_shadow_any(tree, rows, o_s, d_s, tl_s)
        p8, plain_ms = _timed(lambda: RK.trace_shadow_any_plain(
            tree, rows, o_s, d_s, tl_s))
        err = _compare(f"K8 ({sub.numel()} of {n} rays, "
                       f"{int(p8.sum())} blocked)", k8, p8, [], [])
        # the work of the frame's call, from the counting instantiation
        out8 = RK.trace_shadow_any(tree, rows, o, d, t_lim)
        out_c, cnt = RK.trace_shadow_any_counts(tree, rows, o, d, t_lim)
        if not torch.equal(out_c, out8):
            _fail("K8's counting instantiation differs from the kernel")
        threads = RK.walk_threads("K8")
        print(f"  K8 work (threads a ray {threads}, stack {tree.stack}): "
              + _count_line(cnt, 32 // threads))
        print("  K8 work, per ray of the subset: " +
              _ray_line({k: v[sub] for k, v in cnt.items()}))
        # the binary walk's work on the same rays
        walk = {}
        RK.trace_shadow_any_binary(rows, o_s, d_s, tl_s, counts=walk)
        print(f"  K8 binary walk on the subset: {walk['box']} box tests, "
              f"{walk['slot']} slot tests")
        print("  K8 binary walk, per ray of the subset: " + _ray_line(walk))
        ins, outs = [tree.nodes, rows, o, d, t_lim], [out8]
        own, floor, records, binary = walk_bounds(
            ins, outs,
            int(cnt["boxes"].sum()) * SLAB_OPS +
            int(cnt["slots"].sum()) * MT_OPS,
            walk["box"] * SLAB_OPS + walk["slot"] * MT_OPS, sub.numel(), n,
            int((out8 & (t_lim > 0)).sum()) * MT_OPS)
        report("shadow_any" + tag,
               "swift_game_engine_tpu_torch/csrc/bvh_trace.cu",
               "swift_game_engine_tpu/ops/rt_kernel.py:902", c["K8"], err,
               _time_ms(lambda: RK.trace_shadow_any(tree, rows, o, d, t_lim),
                        5),
               plain_ms, own,
               f" (plain on {sub.numel()} of {n} rays; binary walk's bound "
               f"{binary[0]:.4f} ms by {binary[1]})",
               floor=floor, records=records)

    def list_work(cnt, cand, prev, outs, work, label):
        """The bounds of a K9/K10 call, each the larger of the bytes and the
        operations, as K1 is bounded: the bytes of the candidate rows the
        tiles' counts name, read once (the rest of the K-padded lists is
        never read), the counts, ``prev`` and the outputs; the operations
        of the pixel edge tests the counting instantiation counts (each
        pixel's test of each row its patch admits, as K1 counts its own:
        the JSON line's bound), of one edge test per record written, of
        the design's whole counted work (those tests and each warp's cull
        test of each of its tile's rows, this design's own overhead: a
        diagnostic), and of the one-thread-a-pixel walk the redesign
        replaced (every pixel against every candidate of its tile)."""
        print(f"  {label} work ({cand.shape[0]} tiles, K {cand.shape[1]}): "
              + _count_line(work) + "; candidates per tile "
              + _stats(cnt.double()))
        rows_read = int(cnt.sum()) * cand.shape[2] * cand.element_size()
        ins, outs = [cnt, rows_read, prev], list(outs)
        tests = int(work["lane_test"].sum()) * EDGE_OPS
        return (_bound(ins, outs, tests), _bound(ins, outs, 0),
                _bound(ins, outs, int((outs[0] >= 0).sum()) * EDGE_OPS),
                _bound(ins, outs, int(work["warp_cull"].sum()) * CULL_OPS +
                       tests),
                _bound(ins, outs, int(cnt.sum()) * TR.TILE_H * TR.TILE_W *
                       EDGE_OPS))

    def list_extra(culled, old):
        return (f"with the warps' cull counted {culled[0]:.4f} ms by "
                f"{culled[1]}; one-thread-a-pixel walk's bound {old[0]:.4f} "
                f"ms by {old[1]}")

    def list_differing(label, cand, out_k, out_p, w):
        """Each record (at most 8) where a list kernel and its plain
        version differ: the pixel, the layer, both sides' id and depth w,
        and each triangle's candidate row."""
        tid_k, tid_p = (o[0].reshape(o[0].shape[0], -1, 32, 128)
                        for o in (out_k, out_p))
        w_k, w_p = (o[3].reshape(tid_k.shape) for o in (out_k, out_p))
        tiles_x = -(-w // 128)
        for tile, li, y, x in torch.nonzero(tid_k != tid_p).tolist()[:8]:
            at = (tile, li, y, x)
            print(f"    {label} differs at pixel ({(tile % tiles_x) * 128 + x}"
                  f", {(tile // tiles_x) * 32 + y}) layer {li + 1}: kernel id "
                  f"{int(tid_k[at])} w {float(w_k[at]):.9g}, plain id "
                  f"{int(tid_p[at])} w {float(w_p[at]):.9g}")
            for tid in {int(tid_k[at]), int(tid_p[at])} - {-1}:
                row = cand[tile][cand[tile][:, 12] == tid][0]
                print(f"      row of id {tid}: " +
                      " ".join(f"{v:.9g}" for v in row.tolist()))

    def check_k9(args, c, tag):
        err = ms = plain_ms = 0.0
        bounds = []
        for key in ("K9", "K9/peel"):
            (cnt, cand, w, h, *rest), kw = args[key]
            prev = rest[0] if rest else kw.get("prev_w")
            role = "peel" if prev is not None else "first"
            k9 = TR.list_raster(cnt, cand, w, h, prev)
            p9, p_ms = _timed(lambda: TR.list_raster_plain(cnt, cand, w, h,
                                                           prev))
            plain_ms += p_ms
            err = max(err, _compare(
                f"K9 {role} ({cand.shape[0]} tiles, K {cand.shape[1]}, "
                f"{int(cnt.sum())} candidates)", k9[0], p9[0], k9[1:],
                p9[1:]))
            list_differing(f"K9 {role}", cand, k9, p9, w)
            # the work of the frame's call, from the counting instantiation
            out_c, work = TR.list_raster_counts(cnt, cand, w, h, prev)
            if not all(torch.equal(a, b) for a, b in zip(out_c, k9)):
                _fail("K9's counting instantiation differs from the kernel")
            bounds.append(list_work(cnt, cand, prev, k9, work, f"K9 {role}"))
            ms += _time_ms(lambda: TR.list_raster(cnt, cand, w, h, prev), 5)
        # both peels: the bounds add
        own, floor, records, culled, old = (
            (sum(b[i][0] for b in bounds), bounds[0][i][1])
            for i in range(5))
        report("list_raster" + tag,
               "swift_game_engine_tpu_torch/csrc/raster_lists.cu",
               "swift_game_engine_tpu/render/tile_raster.py:154", c["K9"],
               err, ms, plain_ms, own,
               f" (both peels; {list_extra(culled, old)})", floor=floor,
               records=records)
        check_k10(args, c["K10"])

    def check_k10(args, launches):
        """On the first peel's candidate lists, 2 layers; its first layer
        against K9's first peel too."""
        (cnt, cand, w, h, *_), _ = args["K9"]
        k10 = TR.list_raster_peeled(cnt, cand, w, h, 2)
        p10, plain_ms = _timed(lambda: TR.list_raster_peeled_plain(
            cnt, cand, w, h, 2))
        err = _compare("K10 (2 layers)", k10[0], p10[0], k10[1:], p10[1:])
        list_differing("K10", cand, k10, p10, w)
        k9 = TR.list_raster(cnt, cand, w, h)
        _compare("K10 layer 1 vs K9's first peel", k10[0][:, 0], k9[0],
                 [a[:, 0] for a in k10[1:]], k9[1:])
        out_c, work = TR.list_raster_peeled_counts(cnt, cand, w, h, 2)
        if not all(torch.equal(a, b) for a, b in zip(out_c, k10)):
            _fail("K10's counting instantiation differs from the kernel")
        own, floor, records, culled, old = list_work(
            cnt, cand, None, k10, work, "K10 (2 layers)")
        report("list_raster_peeled",
               "swift_game_engine_tpu_torch/csrc/raster_lists.cu",
               "swift_game_engine_tpu/render/tile_raster.py:227", launches,
               err, _time_ms(lambda: TR.list_raster_peeled(cnt, cand, w, h, 2),
                             5),
               plain_ms, own,
               f" (no path runs it: path 5's candidate lists; "
               f"{list_extra(culled, old)})", floor=floor, records=records)

    checks = {"K1": check_k1, "K2": check_k2, "K3": check_k3, "K4": check_k4,
              "K5": check_k5, "K6": check_k6, "K7": check_k7, "K8": check_k8,
              "K9": check_k9}
    seen = set()
    knob_names = tuple(k[0] for k in KNOB_FRAMES)
    for name, cap in caps.items():
        print(f"kernel vs plain version on the first frame's inputs of "
              f"{name}:")
        t0 = time.perf_counter()
        for fam in dict.fromkeys(k.split("/")[0] for k in runs[name]):
            tag = f"@{name}" if fam in seen else ""
            seen.add(fam)
            # paths 9-12 and the knob frames: the merged streams, the dense
            # traces and the frames' first calls: K2-K4 on subsets
            kw = dict(subset=True) if name in PATHS[9:] + (
                SHARD_PATH, ENTITY_DEMO) + knob_names and \
                fam in ("K2", "K3", "K4") else {}
            if name == "knob_layer_slots_2":
                # K5's bound before the redesign is path 2's, printed
                # there; the knob frame's walk twin on fewer lanes
                kw = dict(binary=False, lanes=KNOB_TWIN_LANES)
            checks[fam](cap.args, counts[name], tag, **kw)
        print(f"  ({time.perf_counter() - t0:.1f} s)")

    # -- 4. kernel path vs plain path, end to end ----------------------------
    plain = {
        (TR, "cluster_raster"):
            lambda rows, meta, boxes, w, h, lay, prior_w=None:
            TR.cluster_raster_plain(rows, w, h, lay, prior_w, meta),
        (TR, "list_raster"): TR.list_raster_plain,
        (CS, "trace_shadow_occl"): lambda sc, o, t, tt=None:
            CS.trace_shadow_occl_plain(sc, o, t),
        (CS, "trace_shadow_clusters"): CS.trace_shadow_clusters_plain,
        (RK, "trace_rays"): RK.trace_rays_plain,
        (RK, "trace_layers_so"): RK.trace_layers_so_plain,
        (RK, "trace_rays_so"): RK.trace_rays_so_plain,
        (RK, "trace_shadow_factor"): RK.trace_shadow_factor_plain,
        (RK, "trace_shadow_any"): RK.trace_shadow_any_plain,
    }

    def end_to_end(name, eng, scene, sw, sh, cluster_min_lanes=None, **kw):
        """A sw x sh frame from ``eng``'s camera through the kernels and
        through the plain versions: the RT frame with ``kw``, or the raster
        frame when ``kw`` names a raster_mode."""
        cam = eng.camera
        tf = scene.transforms.clone()
        tf[:, :3, 3] -= torch.as_tensor(cam.world_position.astype(np.float32),
                                        device=dev)
        fg = flatten_frame(scene.geometry, tf, scene.palettes)
        ivp = torch.as_tensor(cam.inv_view_proj(sw, sh), device=dev)
        vp = torch.as_tensor(cam.view_proj(sw, sh), device=dev)

        def render():
            if "raster_mode" in kw:
                return RA.render_frame_raster(scene.geometry, fg, ivp,
                                              cam.position, sw, sh,
                                              view_proj=vp, **kw)
            return RT.render_frame(scene.geometry, fg, eng.ibl, scene.lights,
                                   ivp, cam.position, sw, sh,
                                   max_layers=LAYERS, view_proj=vp, **kw)

        t0 = time.perf_counter()
        threshold = RT.SHADOW_CLUSTER_MIN_LANES
        if cluster_min_lanes is not None:
            RT.SHADOW_CLUSTER_MIN_LANES = cluster_min_lanes
        orig = {k: getattr(*k) for k in plain}
        try:
            img_k = render()
            for (mod, attr), fn in plain.items():
                setattr(mod, attr, fn)
            img_p = render()
        finally:
            RT.SHADOW_CLUSTER_MIN_LANES = threshold
            for (mod, attr), fn in orig.items():
                setattr(mod, attr, fn)
        diff = (img_k - img_p).abs().amax(-1)
        frac = float((diff < 1e-4).float().mean())
        mean_k, mean_p = float(img_k.mean()), float(img_p.mean())
        print(f"end to end {name} {sw}x{sh}: {frac:.5f} of pixels within "
              f"1e-4 of the plain path; means {mean_k:.6f} vs {mean_p:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not bool(torch.isfinite(img_k).all()) or frac < 0.99 or \
                abs(mean_k - mean_p) > 1e-3 * max(mean_p, 1e-3):
            _fail(f"{name}: kernel path and plain path renders disagree")

    # the cluster sweeps at 73,728 lanes: the shadow branch of paths 1 and 2
    end_to_end("hybrid, full scene, cluster shadows", engines[PATHS[0]],
               scenes[PATHS[0]], 320, 180, 0, shadow_layers=SHADOW_LAYERS,
               primary="hybrid")
    # the shadow walk under the cluster threshold, as path 3 takes it
    end_to_end("trace, decimated scene, shadow walk", engines[PATHS[1]],
               scenes[PATHS[1]], 128, 72, shadow_layers=SHADOW_LAYERS,
               primary="trace")
    # path 5's list raster (K9, two peels)
    end_to_end("raster, decimated scene, lists", engines[PATHS[4]],
               scenes[PATHS[4]], 480, 270, raster_mode="lists")
    # path 6's configuration: K6, K8 in front of the K4 shadow loop
    end_to_end("trace, decimated scene, non-layered, 5 shadow layers, "
               "prepass", engines[PATHS[5]], scenes[PATHS[5]], 128, 72,
               primary="trace", layered=False, shadow_layers=5,
               shadow_prepass=True)

    # the layer schedules against the default, through the kernels
    t0 = time.perf_counter()
    eng1, full = engines[PATHS[0]], scenes[PATHS[0]]
    cam = eng1.camera
    tf = full.transforms.clone()
    tf[:, :3, 3] -= torch.as_tensor(cam.world_position.astype(np.float32),
                                    device=dev)
    fg = flatten_frame(full.geometry, tf, full.palettes)
    sw, sh = 320, 180
    threshold = RT.SHADOW_CLUSTER_MIN_LANES
    RT.SHADOW_CLUSTER_MIN_LANES = 0
    try:
        imgs = {lb: RT.render_frame(
            full.geometry, fg, eng1.ibl, full.lights,
            torch.as_tensor(cam.inv_view_proj(sw, sh), device=dev),
            cam.position, sw, sh, max_layers=LAYERS,
            shadow_layers=SHADOW_LAYERS,
            view_proj=torch.as_tensor(cam.view_proj(sw, sh), device=dev),
            lbatch=lb) for lb in (2, 0, 1, 3)}
    finally:
        RT.SHADOW_CLUSTER_MIN_LANES = threshold
    for lb in (0, 1, 3):
        frac = float(((imgs[lb] - imgs[2]).abs().amax(-1) < 1e-4).float()
                     .mean())
        mean, mean2 = float(imgs[lb].mean()), float(imgs[2].mean())
        print(f"end to end lbatch={lb}, full scene {sw}x{sh}, cluster "
              f"shadows: {frac:.5f} of pixels within 1e-4 of lbatch=2; "
              f"means {mean:.6f} vs {mean2:.6f}")
        if not bool(torch.isfinite(imgs[lb]).all()) or frac < 0.999 or \
                abs(mean - mean2) > 1e-4 * mean2:
            _fail(f"lbatch={lb} disagrees with lbatch=2")
    print(f"  ({time.perf_counter() - t0:.1f} s)")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": results}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
