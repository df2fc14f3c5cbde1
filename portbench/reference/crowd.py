"""The crowd world: a frozen copy of the port's
``examples/bench_crowd.build`` recipe, split into the placement (numbers
drawn from the seed) and the build (the entities and the collision world,
through the world and collision constructors of whichever package is passed: the port for the
program, ``frozen_port`` for the reference).
"""

from __future__ import annotations

import importlib

from ..traffic import rng_of


def placement(n_agents: int, seed: int) -> dict:
    """A 400x400 ground at y = -3, 8 box obstacles over 120x120, the player
    at the origin and ``n_agents - 1`` oscillating agents over 140x140."""
    rng = rng_of(seed, 3)
    obstacles = [[float(rng.uniform(-60, 60)), -1.0,
                  float(rng.uniform(-60, 60))] for _ in range(8)]
    agents = []
    for _ in range(n_agents - 1):
        pos = [float(rng.uniform(-70, 70)), float(rng.uniform(0, 4)),
               float(rng.uniform(-70, 70))]
        axis = [float(rng.uniform(-1, 1)), 0.0, float(rng.uniform(-1, 1))]
        agents.append((pos, axis, float(rng.uniform(0.4, 1.2))))
    return {"obstacles": obstacles, "agents": agents}


def build(pkg, place: dict, device):
    """(Stepper, state) of the placed crowd, built by ``pkg`` (a package
    with the port's layout) on ``device``."""
    def sub(name):
        return importlib.import_module(f"{pkg.__name__}.{name}")

    pm = sub("assets.procedural_meshes")
    world = sub("ecs.world")
    wb = world.WorldBuilder()
    cb = sub("physics.collision_world").CollisionWorldBuilder()

    def body(name, pos, body_type):
        e = wb.create_entity(name)
        wb.add(e, "transform", translation=pos)
        wb.add(e, "world_position")
        wb.add(e, "body", body_type=body_type, position=pos)
        return e

    g = body("ground", [0, -3, 0], world.BODY_STATIC)
    plane = pm.plane(400.0)
    cb.add_mesh(plane.positions, plane.indices, entity=g, mu_s=0.9, mu_k=0.8)
    box = pm.box(4.0)
    for i, pos in enumerate(place["obstacles"]):
        e = body(f"obstacle_{i}", pos, world.BODY_STATIC)
        cb.add_mesh(box.positions, box.indices, entity=e)
    p = body("player", [0, 0, 0], world.BODY_DYNAMIC)
    for comp, kw in (("player", {}), ("intent", {}), ("movement", {}),
                     ("controller", dict(radius=1.5, half_height=1.0)),
                     ("agent", dict(mass_weight=3.0))):
        wb.add(p, comp, **kw)
    for i, (pos, axis, speed) in enumerate(place["agents"]):
        e = body(f"agent_{i}", pos, world.BODY_DYNAMIC)
        for comp, kw in (("intent", {}), ("movement", {}),
                         ("controller", dict(radius=1.5, half_height=1.0)),
                         ("agent", dict(mass_weight=1.0)),
                         ("oscillate", dict(origin=pos, axis=axis,
                                            amplitude=6.0, speed=speed))):
            wb.add(e, comp, **kw)
    spec, state = wb.build(device)
    return sub("scene.step").Stepper(spec, cb.build(device=device)), state
