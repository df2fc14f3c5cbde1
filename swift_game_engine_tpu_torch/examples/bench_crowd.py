"""Crowd scaling: fixed-substep throughput against agent count
(examples/bench_crowd.py).

    python -m swift_game_engine_tpu_torch.examples.bench_crowd [counts ...]
        [--device cpu]                               (default 4 16 64 1024)

Spawns N controller agents on a 400x400 ground plane with 8 box obstacles
(``build``) and times K = 32 substeps per count: on the card K replays of
the count's ``SubstepGraph`` between CUDA events after one warm replay (the
counterpart of the reference's one jitted scan of 32 substeps), on the CPU
K eager substeps by the host clock. All counts run in one process. From
``physics/separation.py``'s ``GRID_MIN_N`` (64) agents on, separation takes
its grid branch.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

K = 32
HEADER = (f"{'agents':>7} {'ms/substep':>11} {'substeps/s':>11} "
          f"{'agent-steps/s':>14}")


def build(n_agents: int, device="cuda", seed: int = 11):
    """The reference's crowd with the port's builders: a 400x400 ground at
    y = -3, 8 box obstacles, the player and ``n_agents - 1`` oscillating
    agents over 140x140, placed from ``seed`` -> (Stepper, state) on
    ``device``."""
    from .. import resolve_device
    from ..assets import procedural_meshes as pm
    from ..ecs.world import BODY_DYNAMIC, BODY_STATIC, WorldBuilder
    from ..physics.collision_world import CollisionWorldBuilder
    from ..scene.step import Stepper
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    wb, cb = WorldBuilder(), CollisionWorldBuilder()

    def body(name, pos, body_type):
        e = wb.create_entity(name)
        wb.add(e, "transform", translation=pos)
        wb.add(e, "world_position")
        wb.add(e, "body", body_type=body_type, position=pos)
        return e

    g = body("ground", [0, -3, 0], BODY_STATIC)
    cb.add_mesh(pm.plane(400.0).positions, pm.plane(400.0).indices, entity=g,
                mu_s=0.9, mu_k=0.8)
    for i in range(8):
        e = body(f"obstacle_{i}", [float(rng.uniform(-60, 60)), -1.0,
                                   float(rng.uniform(-60, 60))], BODY_STATIC)
        cb.add_mesh(pm.box(4.0).positions, pm.box(4.0).indices, entity=e)
    p = body("player", [0, 0, 0], BODY_DYNAMIC)
    for comp, kw in (("player", {}), ("intent", {}), ("movement", {}),
                     ("controller", dict(radius=1.5, half_height=1.0)),
                     ("agent", dict(mass_weight=3.0))):
        wb.add(p, comp, **kw)
    for i in range(n_agents - 1):
        pos = [float(rng.uniform(-70, 70)), float(rng.uniform(0, 4)),
               float(rng.uniform(-70, 70))]
        e = body(f"agent_{i}", pos, BODY_DYNAMIC)
        for comp, kw in (("intent", {}), ("movement", {}),
                         ("controller", dict(radius=1.5, half_height=1.0)),
                         ("agent", dict(mass_weight=1.0)),
                         ("oscillate", dict(
                             origin=pos, axis=[float(rng.uniform(-1, 1)), 0,
                                               float(rng.uniform(-1, 1))],
                             amplitude=6.0,
                             speed=float(rng.uniform(0.4, 1.2))))):
            wb.add(e, comp, **kw)
    spec, state = wb.build(device)
    return Stepper(spec, cb.build(device=device)), state


def substep_ms(n_agents: int, device="cuda") -> float:
    """ms per substep of the ``n_agents`` crowd, K substeps timed after one
    warm substep (see the module docstring)."""
    import torch
    from ..scene.engine import FIXED_DT
    from ..scene.step import SubstepGraph
    stepper, state = build(n_agents, device)
    graph = SubstepGraph(stepper, state, FIXED_DT)
    graph.step()
    if graph.graph is None:         # CPU tensors: eager substeps
        t0 = time.perf_counter()
        for _ in range(K):
            graph.step()
        return (time.perf_counter() - t0) * 1e3 / K
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(K):
        graph.step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / K


def main(argv=None):
    """Prints the table; returns its rows (agents, ms/substep)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("counts", type=int, nargs="*", default=[4, 16, 64, 1024])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(HEADER, flush=True)
    rows = []
    for n in args.counts:
        ms = substep_ms(n, args.device)
        rows.append((n, ms))
        print(f"{n:7d} {ms:11.2f} {1e3 / ms:11.1f} {n * 1e3 / ms:14.0f}",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
