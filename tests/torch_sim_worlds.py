"""Stepping worlds for the simulation tests of the PyTorch port.

Each recipe stages one world into a WorldBuilder and a
CollisionWorldBuilder; the JAX package's builders and the port's share the
staging API, so one recipe drives either. ``jax_world`` builds the
reference's (spec, state, Stepper); ``port_world`` carries that spec,
state and collision across with ``interop`` into the port's Stepper, so
both packages start from one state. Imported by the test modules (not a
test module itself).
"""

import numpy as np

DT = 1.0 / 60.0
STATIC, KINEMATIC, DYNAMIC = 0, 1, 2


def _pm(cb):
    """The procedural meshes of the package whose builder ``cb`` is (the
    port's copy has the same geometry), so that a port world imports
    nothing of the JAX package."""
    if type(cb).__module__.startswith("swift_game_engine_tpu_torch"):
        from swift_game_engine_tpu_torch.assets import procedural_meshes
    else:
        from swift_game_engine_tpu.assets import procedural_meshes
    return procedural_meshes


def _static(wb, cb, name, pos, mesh, mu=(0.8, 0.6), **kw):
    e = wb.create_entity(name)
    wb.add(e, "transform", translation=pos)
    wb.add(e, "world_position")
    wb.add(e, "body", body_type=STATIC, position=pos)
    cb.add_mesh(mesh.positions, mesh.indices, entity=e, mu_s=mu[0],
                mu_k=mu[1], **kw)
    return e


def _agent(wb, name, pos, mass=1.0, intent=False, player=False, **ctrl):
    e = wb.create_entity(name)
    wb.add(e, "transform", translation=pos)
    wb.add(e, "world_position")
    if player:
        wb.add(e, "player")
    wb.add(e, "body", body_type=DYNAMIC, position=pos)
    if intent:
        wb.add(e, "intent")
        wb.add(e, "movement")
    wb.add(e, "controller", radius=ctrl.get("radius", 1.5),
           half_height=ctrl.get("half_height", 1.0))
    wb.add(e, "agent", mass_weight=mass)
    return e


def _platform(wb, cb, name, pos, axis, amp, speed, phase=0.0):
    box = _pm(cb).box(4.0)
    scale = np.array([1.5, 0.2, 1.5], np.float32)
    e = wb.create_entity(name)
    wb.add(e, "transform", translation=pos, scale=scale)
    wb.add(e, "world_position")
    wb.add(e, "body", body_type=KINEMATIC, position=pos)
    aabb = box.positions * scale
    wb.add(e, "platform", origin=pos, axis=axis, amplitude=amp, speed=speed,
           phase=phase, aabb_min=aabb.min(0), aabb_max=aabb.max(0))
    cb.add_mesh(box.positions, box.indices, entity=e, mu_s=0.9, mu_k=0.7)
    return e


def tiny(wb, cb):
    """tests/test_world_step.py's ``tiny`` world: ground, a falling player,
    an elevator platform. -> {"player", "platform"}"""
    _static(wb, cb, "ground", [0, -3, 0], _pm(cb).plane(80.0), mu=(0.9, 0.8))
    player = _agent(wb, "player", [0.0, 2.0, 0.0], mass=3.0, intent=True,
                    player=True)
    plat = _platform(wb, cb, "platform", [16, -1, 0], [0, 1, 0], 2.0, 1.1)
    return dict(player=player, platform=plat)


def multi(wb, cb):
    """Several agents: the player walks into a wall, an NPC rides the
    elevator, an oscillating NPC (mass 500) sweeps through two NPCs that
    overlap at the start, a horizontal mover, a flattenGround ramp and a
    dormant slot. The agents start in the air, off round coordinates: an
    agent resting exactly on the ground or exactly at contact distance
    from another makes the agent sweep and the ground sweep tie at TOI 0,
    and which one wins is then decided by f32 rounding (the reference's
    fused multiply-adds tilt its ground normal by ~6e-7). -> entity
    indices by role"""
    _static(wb, cb, "ground", [0, -3, 0], _pm(cb).plane(80.0), mu=(0.9, 0.8))
    _static(wb, cb, "wall", [6, 0, 0], _pm(cb).box(6.0))
    _static(wb, cb, "ramp", [-8, -1, 6], _pm(cb).ramp(8.0, 10.0, 4.0),
            mu=(0.35, 0.25), flatten=True)
    player = _agent(wb, "player", [-2.0, 0.3, 0.1], mass=3.0, intent=True,
                    player=True)
    elev = _platform(wb, cb, "elevator", [16, -1, 0], [0, 1, 0], 2.0, 1.1)
    rider = _agent(wb, "rider", [16.2, 2.2, 0.3])
    mover = _platform(wb, cb, "mover", [-16, -2, 12], [1, 0, 0], 4.0, 0.9,
                      0.7)
    osc = _agent(wb, "osc", [0.2, 0.6, 14.0], mass=500.0, intent=True)
    wb.add(osc, "oscillate", origin=[0.2, 0.6, 14.0], axis=[1, 0, 0],
           amplitude=6.0, speed=0.6)
    a = _agent(wb, "npc_a", [3.4, 0.8, 14.1])
    b = _agent(wb, "npc_b", [4.7, 1.1, 14.7])
    slope = _agent(wb, "npc_ramp", [-8.3, 3.4, 6.2])
    dormant = wb.create_entity("dormant", alive=False)
    wb.add(dormant, "transform", translation=[10.0, 0.0, -10.0])
    wb.add(dormant, "world_position")
    wb.add(dormant, "body", body_type=DYNAMIC, position=[10.0, 0.0, -10.0])
    wb.add(dormant, "controller", radius=1.5, half_height=1.0)
    wb.add(dormant, "agent", mass_weight=1.0)
    return dict(player=player, elevator=elev, rider=rider, mover=mover,
                osc=osc, npc_a=a, npc_b=b, npc_ramp=slope, dormant=dormant)


def crowd(wb, cb, n_agents=72, seed=11):
    """``n_agents`` agents (more than 64: the separation grid) packed into
    a 30x30 patch on a ground plane with box obstacles, some oscillating
    (examples/bench_crowd.py, denser so that neighbours meet). Agents
    spawn standing on the ground (within 0.03 of their rest height) and
    clear of the obstacles, as a game spawns them. A crowd dropped from
    the air lands all at once, and a landing agent that a neighbour
    touches sits on ties of the reference: the separation pass re-snaps
    an agent to the ground (up to 0.1) only if its correction exceeds
    1e-6, and a capsule spawned inside a box corner touches three faces
    at one depth; the reference's own jitted and op-by-op runs of one
    such substep part by 0.03."""
    rng = np.random.default_rng(seed)
    _static(wb, cb, "ground", [0, -3, 0], _pm(cb).plane(400.0), mu=(0.9, 0.8))
    boxes = []
    for i in range(4):
        c = [float(rng.uniform(-15, 15)), -1.0, float(rng.uniform(-15, 15))]
        boxes.append(c)
        _static(wb, cb, f"obstacle_{i}", c, _pm(cb).box(4.0))
    player = _agent(wb, "player", [0.0, 0.0, 0.0], mass=3.0, intent=True,
                    player=True)
    i = 0
    while i < n_agents - 1:
        pos = [float(rng.uniform(-15, 15)), float(rng.uniform(-0.44, -0.41)),
               float(rng.uniform(-15, 15))]
        if any(abs(pos[0] - b[0]) < 4.0 and abs(pos[2] - b[2]) < 4.0
               for b in boxes):
            continue
        e = _agent(wb, f"agent_{i}", pos, intent=i % 3 == 0)
        if i % 3 == 0:
            wb.add(e, "oscillate", origin=pos,
                   axis=[float(rng.uniform(-1, 1)), 0,
                         float(rng.uniform(-1, 1))],
                   amplitude=6.0, speed=float(rng.uniform(0.4, 1.2)))
        i += 1
    return dict(player=player)


def chunk_edge(wb, cb):
    """The player 1.5 units short of the chunk border x = 256 walking +x
    over a ground that spans it; a static box four chunks away (outside
    the active radius). -> {"player", "far"}"""
    _static(wb, cb, "ground", [256, -3, 0], _pm(cb).plane(60.0), mu=(0.9, 0.8))
    far = _static(wb, cb, "far_box", [256 + 4 * 512, 0, 0], _pm(cb).box(4.0))
    player = _agent(wb, "player", [254.5, 0.2, 0.1], mass=3.0, intent=True,
                    player=True)
    return dict(player=player, far=far)


def jax_world(recipe, **kw):
    """-> (spec, state, Stepper, handles) of the JAX package."""
    from swift_game_engine_tpu.ecs.world import WorldBuilder
    from swift_game_engine_tpu.physics.collision_world import \
        CollisionWorldBuilder
    from swift_game_engine_tpu.scene.step import Stepper
    wb, cb = WorldBuilder(), CollisionWorldBuilder()
    handles = recipe(wb, cb, **kw)
    spec, state = wb.build()
    local = cb.build()
    return spec, state, Stepper(spec, local), handles, local


def port_stepper(jspec, jlocal):
    """The port's Stepper of the same spec and collision (CPU)."""
    from swift_game_engine_tpu_torch import interop
    from swift_game_engine_tpu_torch.scene.step import Stepper
    return Stepper(interop.scene_spec(jspec, device="cpu"),
                   interop.local_triangles(jlocal, device="cpu"))


def port_world(recipe, device="cpu", **kw):
    """-> (spec, state, Stepper, handles) built by the port's own builders
    (no module of the JAX package)."""
    from swift_game_engine_tpu_torch.ecs.world import WorldBuilder
    from swift_game_engine_tpu_torch.physics.collision_world import \
        CollisionWorldBuilder
    from swift_game_engine_tpu_torch.scene.step import Stepper
    wb, cb = WorldBuilder(), CollisionWorldBuilder()
    handles = recipe(wb, cb, **kw)
    spec, state = wb.build(device)
    return spec, state, Stepper(spec, cb.build(device=device)), handles


def posed_port_world(rig_dir, device="cpu"):
    """The tiny world with its player posed as the posed DemoScene's player
    is (the skeleton and profiles of ``rig_dir``, the synthetic rig of
    tests/torch_pose_rig.py), built by the port alone -> (spec, state,
    Stepper, handles)."""
    from swift_game_engine_tpu_torch.ecs.world import WorldBuilder
    from swift_game_engine_tpu_torch.physics.collision_world import \
        CollisionWorldBuilder
    from swift_game_engine_tpu_torch.scene.demo_scene import (
        add_pose_components, load_pose_rig)
    from swift_game_engine_tpu_torch.scene.step import Stepper
    wb, cb = WorldBuilder(), CollisionWorldBuilder()
    handles = tiny(wb, cb)
    rig = load_pose_rig(rig_dir, device)
    add_pose_components(wb, handles["player"], rig)
    spec, state = wb.build(device)
    return spec, state, Stepper(spec, cb.build(device=device), rig.engine,
                                rig.bank, rig.action), handles


# The tiny world's render meshes (instance by role), materials and lights.
RENDER_MESHES = (("ground", "plane", (80.0,), (0.5, 0.5, 0.5)),
                 ("player", "capsule", (1.5, 1.0), (0.2, 0.4, 0.9)),
                 ("platform", "box", (4.0,), (0.8, 0.6, 0.2)))
LIGHTS = dict(direction=[[0.6, -0.7, -0.1], [-0.3, -0.6, 0.6]],
              intensity=[2.0, 0.4],
              color=[[1.0, 0.86, 0.68], [0.95, 0.85, 0.75]],
              enabled=[True, True], max_distance=[450.0, 300.0])


def _render_geometry(builder, pm, material, handles):
    b = builder(texture_size=8)
    for role, mesh, args, rgb in RENDER_MESHES:
        b.add_static_mesh(getattr(pm, mesh)(*args),
                          material(name=role, base_color_factor=rgb),
                          instance=handles.get(role, 0))
    return b


def _demo_world(geometry, lights, spec, state, stepper, player):
    from swift_game_engine_tpu_torch.scene.demo_scene import DemoWorld
    tf, pal = stepper.extract(state, 1.0, np.zeros(3, np.float32))
    mv = spec.movement
    return DemoWorld(
        geometry=geometry, transforms=tf, palettes=pal, lights=lights,
        player_position=state.body_pos[player].cpu().numpy().astype(
            np.float64),
        movement=(float(mv["walk_speed"][player]),
                  float(mv["run_speed"][player]),
                  float(mv["run_threshold"][player])),
        spec=spec, state=state, stepper=stepper, player=player)


def engine_scenes():
    """The tiny world with render meshes (a ground plane, the player's
    capsule, the platform's box) for the Engine tests: the JAX Engine's
    scene dict, built by the reference, and the port's DemoWorld carried
    across with ``interop`` (CPU)."""
    import jax.numpy as jnp
    from swift_game_engine_tpu.assets import procedural_meshes as pm
    from swift_game_engine_tpu.assets.materials import Material
    from swift_game_engine_tpu.render import rt as j_rt
    from swift_game_engine_tpu.render import scene_geometry as j_sg
    from swift_game_engine_tpu_torch import interop
    jspec, jstate, jstep, h, local = jax_world(tiny)
    h = dict(h, ground=0)
    geo = _render_geometry(j_sg.RenderGeometryBuilder, pm, Material,
                           h).build()
    lights = j_rt.DirectionalLights(**{k: jnp.array(v)
                                       for k, v in LIGHTS.items()})
    jscene = dict(spec=jspec, state=jstate, stepper=jstep, geometry=geo,
                  lights=lights, player=h["player"])
    pstep = port_stepper(jspec, local)
    world = _demo_world(interop.scene_geometry(geo, device="cpu"),
                        interop.lights(lights, device="cpu"), pstep.spec,
                        interop.world_state(jstate, device="cpu"), pstep,
                        h["player"])
    return jscene, world


def port_engine_world(device):
    """The tiny world with the render meshes of ``engine_scenes``, built by
    the port alone on ``device`` -> DemoWorld."""
    import torch
    from swift_game_engine_tpu_torch.assets import procedural_meshes as pm
    from swift_game_engine_tpu_torch.assets.materials import Material
    from swift_game_engine_tpu_torch.render.rt import DirectionalLights
    from swift_game_engine_tpu_torch.render.scene_geometry import \
        RenderGeometryBuilder
    spec, state, stepper, h = port_world(tiny, device)
    h = dict(h, ground=0)
    geo = _render_geometry(RenderGeometryBuilder, pm, Material, h).build(
        device)
    lights = DirectionalLights(**{k: torch.tensor(v, device=device)
                                  for k, v in LIGHTS.items()})
    return _demo_world(geo, lights, spec, state, stepper, h["player"])


def set_player_intent(state, e, vel, yaw=None, jump=False):
    """A JAX WorldState with entity ``e``'s MoveIntent set."""
    import jax.numpy as jnp
    state = state._replace(
        intent_vel=state.intent_vel.at[e].set(jnp.asarray(vel, jnp.float32)),
        intent_jump=state.intent_jump.at[e].set(jump))
    if yaw is not None:
        state = state._replace(
            intent_has_yaw=state.intent_has_yaw.at[e].set(True),
            intent_yaw=state.intent_yaw.at[e].set(jnp.float32(yaw)))
    return state


def leaves(state, prefix=""):
    """(name, numpy array) of every leaf of a world state (JAX or port)."""
    out = []
    for f in state._fields:
        x = getattr(state, f)
        if hasattr(x, "_fields"):
            out += leaves(x, prefix + f + ".")
        else:
            out.append((prefix + f, x.numpy() if hasattr(x, "numpy") and
                        not isinstance(x, np.ndarray) and
                        type(x).__module__.startswith("torch")
                        else np.asarray(x)))
    return out


def _share_edge(a, b):
    """Two triangles with two vertices in common."""
    return sum(np.abs(a[i] - b[j]).max() < 1e-5 for i in range(3)
               for j in range(3)) >= 2


def _tri_xz_distance(p, a, b, c):
    """XZ distance from point p to triangle abc projected on XZ."""
    p, a, b, c = (np.asarray(v, np.float64)[[0, 2]] for v in (p, a, b, c))

    def seg(p, u, v):
        d = v - u
        t = np.clip(np.dot(p - u, d) / max(np.dot(d, d), 1e-30), 0, 1)
        return np.linalg.norm(p - (u + t * d))

    def side(u, v):
        return (v[0] - u[0]) * (p[1] - u[1]) - (v[1] - u[1]) * (p[0] - u[0])
    s = [side(a, b), side(b, c), side(c, a)]
    if all(x >= 0 for x in s) or all(x <= 0 for x in s):
        return 0.0
    return min(seg(p, a, b), seg(p, b, c), seg(p, c, a))


POSITIONS = ("body_pos", "trs_t", "wp_local", "body_prev_pos",
             "wp_prev_local")


def compare_states(jstate, pstate, jsoup_tris=None, atol=1e-4, rtol=1e-5,
                   float_fields=None):
    """Float leaves within atol + rtol |ref|; integer and bool leaves
    equal, with two ties that f32 rounding decides:

    * a ground triangle may differ where the agent stands on the shared
      edge of the two triangles (within 0.01 in XZ of both: the two ground
      probe TOIs agree to rounding); ``jsoup_tris``, the (T,3,3)
      world-space triangles or a function giving them, checks that;
    * a contact-cache triangle (manifold_tri) may differ where the two
      triangles share an edge (two vertices) and the cached contact
      normals agree (1e-2: blends of contact normals on that edge over
      the cache's frames): a contact on that edge is one TOI for both;
    * the per-substep work counters (query_casts, query_candidates) may
      differ for a grounded agent moving parallel to the ground (|v_y| <
      1e-4): its horizontal move makes the blocking test of the ground hit
      a zero dot product, which the reference's ground normal, tilted by
      ~6e-7 by its fused multiply-adds, decides one way and the port's
      exact (0, 1, 0) the other: one slide iteration more or less, the
      same position.

    ``float_fields`` limits the float comparison to those fields (None:
    every float field). Returns the ties as (entity, field, reference,
    port); raises AssertionError naming field, entity and values
    otherwise."""
    ties = []
    jl, pl = dict(leaves(jstate)), dict(leaves(pstate))
    pos = np.asarray(jstate.body_pos)
    vel_y = np.asarray(jstate.body_vel)[:, 1]
    grounded = np.asarray(jstate.ctrl.grounded)
    for name, x in jl.items():
        y = pl[name]
        assert x.shape == y.shape, (name, x.shape, y.shape)
        if x.dtype == np.bool_ or np.issubdtype(x.dtype, np.integer):
            bad = np.argwhere(x.astype(np.int64) != y.astype(np.int64))
            for idx in bad:
                e = int(idx[0]) if x.ndim else -1
                if name == "ctrl.ground_tri" and jsoup_tris is not None:
                    if callable(jsoup_tris):
                        jsoup_tris = jsoup_tris()
                    ta, tb = int(x[e]), int(y[e])
                    da = _tri_xz_distance(pos[e], *jsoup_tris[ta])
                    db = _tri_xz_distance(pos[e], *jsoup_tris[tb])
                    if ta >= 0 and tb >= 0 and max(da, db) < 0.01:
                        ties.append((e, name, ta, tb))
                        continue
                if name == "ctrl.manifold_tri" and jsoup_tris is not None:
                    if callable(jsoup_tris):
                        jsoup_tris = jsoup_tris()
                    e, slot = int(idx[0]), int(idx[1])
                    ta, tb = int(x[e, slot]), int(y[e, slot])
                    nj = np.asarray(jstate.ctrl.manifold_normal)[e, slot]
                    npn = pstate.ctrl.manifold_normal[e, slot].numpy()
                    if ta >= 0 and tb >= 0 and _share_edge(jsoup_tris[ta],
                                                           jsoup_tris[tb]) \
                            and np.abs(nj - npn).max() < 1e-2:
                        ties.append((e, name, ta, tb))
                        continue
                if name in ("ctrl.query_casts", "ctrl.query_candidates") \
                        and grounded[e] and abs(vel_y[e]) < 1e-4:
                    ties.append((e, name, int(x[e]), int(y[e])))
                    continue
                raise AssertionError(
                    f"{name} of entity {e}: reference {x[tuple(idx)]}, "
                    f"port {y[tuple(idx)]}")
        elif float_fields is None or name in float_fields:
            big = np.abs(x) >= 1e30
            assert np.array_equal(big, np.abs(y) >= 1e30), name
            d = np.abs(np.where(big, 0, x) - np.where(big, 0, y))
            lim = atol + rtol * np.abs(np.where(big, 0, x))
            if (d > lim).any():
                idx = np.unravel_index(np.argmax(d - lim), d.shape)
                raise AssertionError(
                    f"{name} at {idx}: reference {x[idx]}, port {y[idx]} "
                    f"(|diff| {d[idx]:.3g})")
    return ties


def soup_tris(jstate, jstepper):
    """(T,3,3) world-space collision triangles of a JAX state."""
    from swift_game_engine_tpu.physics.collision_world import transform_soup
    from swift_game_engine_tpu.scene.step import _trs_matrices
    import jax.numpy as jnp
    hb = jnp.asarray(jstepper.spec.has_body)[:, None]
    t = jnp.where(hb, jstate.body_pos, jstate.trs_t)
    r = jnp.where(hb, jstate.body_rot, jstate.trs_r)
    soup = transform_soup(jstepper.collision, _trs_matrices(t, r,
                                                            jstate.trs_s))
    return np.stack([np.asarray(soup.v0), np.asarray(soup.v1),
                     np.asarray(soup.v2)], 1)


def to_jax(pstate, like):
    """A JAX WorldState (structure and dtypes of ``like``) holding the port
    state's values."""
    import jax.numpy as jnp
    if hasattr(like, "_fields"):
        return type(like)(*(to_jax(getattr(pstate, f), getattr(like, f))
                            for f in like._fields))
    return jnp.asarray(pstate.numpy().astype(np.asarray(like).dtype))


def position_gap(jstate, pstate):
    """The largest difference of body, transform and chunk-local
    positions -> (gap, entity)."""
    d = np.stack([np.abs(np.asarray(getattr(jstate, f)) -
                         getattr(pstate, f).numpy()).max(-1)
                  for f in ("body_pos", "trs_t", "wp_local")]).max(0)
    return float(d.max()), int(d.argmax())


NUDGES = (2e-6, 1e-5, 5e-5)


def reference_reaches(jstep, j_before, p_before, p_after, atol=1e-4,
                      rtol=1e-5):
    """Whether the reference's own substep gives the port's result (every
    field as ``compare_states`` holds them) from an input within the
    one-substep tolerance of its state: the port's state before the
    substep, or the reference's with the diverging agent moved by one of
    NUDGES (<= 5e-5) along one axis. Such a place is a tie of the
    reference that f32 rounding decides: a contact on the edge two
    triangles share (one TOI for both), a threshold its state sits on, or
    the sign of a residual velocity that a ground normal tilted by ~6e-7
    of rounding leaves after a slide (the snap gate v_y <= 0). Returns a
    description of the input that did, or None."""
    e = position_gap(jstep.substep(j_before, DT), p_after)[1]
    cands = [("the port's state", to_jax(p_before, j_before))]
    for nudge in NUDGES:
        for axis in range(3):
            for sign in (1, -1):
                d = np.zeros(3, np.float32)
                d[axis] = sign * nudge
                cands.append((
                    f"its own with agent {e} moved {sign * nudge:+g} on "
                    f"axis {axis}", j_before._replace(
                        body_pos=j_before.body_pos.at[e].add(d),
                        wp_local=j_before.wp_local.at[e].add(d),
                        trs_t=j_before.trs_t.at[e].add(d))))
    for what, start in cands:
        try:
            compare_states(jstep.substep(start, DT), p_after,
                           lambda: soup_tris(start, jstep), atol, rtol)
        except AssertionError:
            continue
        return what
    return None


def compare_specs(jspec, pspec):
    """The port's SceneSpec equals the reference's: names, counts, masks,
    component tables and parameter tuples exactly."""
    import torch
    from swift_game_engine_tpu_torch import interop
    ref = interop.scene_spec(jspec, device="cpu")
    for f in ("n_entities", "names", "gravity"):
        assert getattr(pspec, f) == getattr(ref, f), f
    for f in ("has_body", "body_type", "has_controller", "has_intent",
              "has_movement", "has_loco", "has_action", "has_dodge",
              "has_osc", "has_spin", "has_platform", "has_wp", "is_player",
              "character_slot", "follow_target"):
        np.testing.assert_array_equal(getattr(pspec, f), getattr(ref, f), f)
    for f in ("movement", "osc", "spin", "platform", "dodge_cfg",
              "action_cfg"):
        for k, v in getattr(ref, f).items():
            np.testing.assert_array_equal(getattr(pspec, f)[k], v, f"{f}.{k}")
    for a, b in ((pspec.controller_params, ref.controller_params),
                 (pspec.loco_params, ref.loco_params),
                 (pspec.loco_tuning, ref.loco_tuning)):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), f
