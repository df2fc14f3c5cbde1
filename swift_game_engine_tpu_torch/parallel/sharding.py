"""Multi-device path: port of swift_game_engine_tpu/parallel/sharding.py on
``torch.distributed``.

The pixels axis: the traced frame is embarrassingly parallel over its
camera rays. Every rank holds the whole scene and flattens the frame itself
(geometry, the BVH and the per-frame constants are replicated), traces and
shades one contiguous slice of the frame's padded tile-major lanes with
``render/rt._render_rays`` (whole 32x128 pixel tiles when the world size
divides the tile count), and one all-gather assembles the image. Nothing
crosses ranks before that gather. Each shard takes the light-0 shadow
source its own lane count selects (rt.py:1420-1423), as the reference's
shards do: a frame split into shards of fewer than
``rt.SHADOW_CLUSTER_MIN_LANES`` lanes takes the shadow walk or loop where
the whole frame takes the cluster sweeps, and its any-hit shadows may differ
from the whole frame's.

The entities axis: ``shard_world_state`` gives each rank a contiguous
range of the entity rows (balanced: the first ``n % world`` ranges hold one
row more, so any count of at least ``world`` rows splits, as GSPMD splits
one, sharding.py:52-53). The reference leaves the partition of the substep
to GSPMD; here it is written out (``EntityShardedSubstep``, over
``Stepper._begin`` / ``_move`` / ``_separate`` / ``_end``):

  1. every rank runs the stages before the mover over every entity (they
     are elementwise, and the collision soup and the platform set are
     built from every collider's and platform's pose), then the mover over
     its own rows;
  2. an all-gather of the moved positions and velocities: separation reads
     every agent;
  3. separation's pair passes over every agent, its casts over the rank's
     rows;
  4. an all-gather of positions, velocities and controller state;
  5. the stages after separation (integrate, the pose systems, writeback)
     over every entity, so every rank holds the whole state, as the
     reference's global arrays are whole.

Each rank's rows get the unsharded substep's values (the row math is the
same; only the partition of the rows differs). An all-gather packs its
tensors into one byte buffer a row and pads each rank's rows to the
longest range.

A group is made by ``make_group`` (one process per card, NCCL; gloo for
``device="cpu"``), or stands as an int k: k virtual shards rendered one
after another in this process and concatenated in rank order, the
all-gather's result with no collective (a one-card check of the sharded
frame).
"""

from __future__ import annotations

from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import constant, resolve_device
from ..ecs.world import WorldState, clone_state, copy_state
from ..scene.cuda_graph import capture
from ..render import rt as RT
from ..render.camera import generate_rays_tiled, untile_image
from ..render.scene_geometry import flatten_frame
from ..scene.engine import FIXED_DT
from ..scene.step import SubstepGraph


def make_group(rank: int, world: int, init_method: str, device="cuda",
               timeout: float = 300.0):
    """The process group of ``world`` ranks, this process being ``rank``
    (the counterpart of ``make_mesh``, sharding.py:26): NCCL on the card,
    gloo for ``device="cpu"``, rendezvous at ``init_method`` (a
    ``file://`` path needs no network; ``tcp://localhost:<port>`` works
    too). On the card each rank uses ``cuda:<rank>`` unless ``device``
    names its index. ``timeout``: seconds a collective may wait. A failure
    raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else rank)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world,
                            rank=rank, timeout=timedelta(seconds=timeout))
    return dist.group.WORLD


def _slice(x, rank: int, world: int):
    """Rank ``rank``'s contiguous rows of ``x`` (a multiple of ``world``
    rows)."""
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def shard_rays(o, d, rank: int, world: int):
    """This rank's contiguous slice of the ray arrays, padded to a multiple
    of ``world`` with origin 0 and direction +y (sharding.py:31-40) ->
    (o, d, n) with n the unpadded ray count."""
    n = o.shape[0]
    pad = (-n) % world
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, constant((0.0, 1.0, 0.0), d.device).expand(pad,
                                                                      3)])
    return _slice(o, rank, world), _slice(d, rank, world), n


def _ranks(group):
    """(world size, the ranks this process renders)."""
    if isinstance(group, int):
        return group, range(group)
    return dist.get_world_size(group), (dist.get_rank(group),)


def entity_ranges(n: int, world: int) -> tuple:
    """The contiguous (lo, hi) entity rows of each of ``world`` ranks:
    balanced, the first ``n % world`` ranges one row longer."""
    if n < world:
        raise ValueError(f"{n} entities cannot be split over {world} ranks")
    base, extra = divmod(n, world)
    bounds = [0]
    for r in range(world):
        bounds.append(bounds[-1] + base + (r < extra))
    return tuple(zip(bounds[:-1], bounds[1:]))


class ShardedWorldState(NamedTuple):
    """A WorldState with its entity axis split over a group's ranks
    (``shard_world_state``). ``state`` is whole on every rank; ``ranges``
    holds each rank's (lo, hi) rows, which it steps."""

    state: WorldState
    ranges: tuple


def shard_world_state(group, state: WorldState) -> ShardedWorldState:
    """``state`` with its entity axis split over ``group`` (a process
    group from ``make_group``, or an int k: k virtual shards stepped in
    turn in this process) -> a ShardedWorldState, which
    ``EntityShardedSubstep`` and ``sharded_fused_step`` partition
    (sharding.py:43-65). Every leaf whose first axis is the entity count
    is partitioned by rows; the palettes, indexed by character, are not."""
    world, _ = _ranks(group)
    return ShardedWorldState(state, entity_ranges(int(state.alive.shape[0]),
                                                  world))


def _pack_rows(xs):
    """Tensors of equal row count -> one (rows, bytes) uint8 tensor."""
    return torch.cat([x.reshape(x.shape[0], -1).contiguous().view(
        torch.uint8) for x in xs], 1)


def _unpack_rows(buf, like):
    """``_pack_rows``'s inverse for ``buf`` of any row count: tensors of
    ``like``'s dtypes and trailing shapes."""
    out, at = [], 0
    for x in like:
        width = x[:1].reshape(1, -1).contiguous().view(torch.uint8).shape[1]
        out.append(buf[:, at:at + width].contiguous().view(x.dtype).reshape(
            (buf.shape[0],) + tuple(x.shape[1:])))
        at += width
    return out


def gather_rows(group, ranges, parts):
    """The all-gather of an entity-sharded step -> every tensor over all
    rows. ``parts``: for an int group, one list of tensors per range (the
    virtual shards'); for a process group, this rank's list alone. The
    tensors of one rank are packed into one byte buffer, padded to the
    longest range and gathered in one collective."""
    if isinstance(group, int):
        return [torch.cat(xs) for xs in zip(*parts)]
    world = len(ranges)
    per = max(hi - lo for lo, hi in ranges)
    own = _pack_rows(parts)
    buf = own.new_zeros((per, own.shape[1]))
    buf[:own.shape[0]] = own
    out = own.new_empty((world * per, own.shape[1]))
    dist.all_gather_into_tensor(out, buf, group=group)
    rows = torch.cat([out[r * per:r * per + hi - lo]
                      for r, (lo, hi) in enumerate(ranges)])
    return _unpack_rows(rows, parts)


class EntityShardedSubstep:
    """Fixed substeps of ``stepper`` on an entity-sharded state over
    ``group`` (see the module docstring): ``state`` holds the whole
    WorldState's buffers, cloned from ``sharded.state``, and ``step()``
    advances them in place by one substep of ``dt``.

    On the card each phase is a CUDA graph replay (``scene/cuda_graph
    .capture``, as ``SubstepGraph``): ``Stepper._begin`` once, then for
    each of this process's ranges ``_move`` and ``_separate``, then
    ``_end`` once; the all-gathers between them run eagerly (NCCL for a
    process group, concatenation for virtual shards). For CPU tensors
    every phase runs eagerly (``Stepper._substep_impl`` with the rank's
    rows and the all-gather, or for virtual shards each phase over every
    range in turn). ``gather_events``: set to a list to have
    ``step()`` append a (start, end) CUDA event pair around each
    all-gather."""

    # each phase's kernels and caches are first used in its one warm-up
    WARMUP = 1

    def __init__(self, stepper, sharded: ShardedWorldState, dt: float,
                 group):
        world, ranks = _ranks(group)
        if len(sharded.ranges) != world:
            raise ValueError(f"a state sharded over {len(sharded.ranges)} "
                             f"ranks stepped over {world}")
        self.stepper, self.dt, self.group = stepper, float(dt), group
        self.ranges, self.ranks = sharded.ranges, tuple(ranks)
        self.state = clone_state(sharded.state)
        self.gather_events = None
        self.capture_seconds, self.pool_bytes = 0.0, 0
        self.graphs = None
        if self.state.alive.is_cuda:
            self._capture()

    def _gather(self, parts):
        """``parts``: one list of tensors per range of this process."""
        ev = None
        if self.gather_events is not None and self.state.alive.is_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = gather_rows(self.group, self.ranges,
                          parts if isinstance(self.group, int) else parts[0])
        if ev is not None:
            ev[1].record()
            self.gather_events.append(ev)
        return out

    def _begin(self):
        return self.stepper._begin(self.state, self.dt)

    def _move(self, b, r):
        return list(self.stepper._move(b, self.dt, self.ranges[r]))

    def _separate(self, b, moved, ctrl, r):
        pos, vel, ctrl = self.stepper._separate(b, *moved, ctrl,
                                                self.ranges[r])
        return [pos, vel, *ctrl]

    def _end(self, b, sep):
        return self.stepper._end(self.state, b, sep[0], sep[1],
                                 type(b.ctrl)(*sep[2:]), self.dt)

    def _advance(self):
        if not isinstance(self.group, int):
            r = self.ranks[0]
            copy_state(self.state, self.stepper._substep_impl(
                self.state, self.dt, self.ranges[r],
                lambda xs: self._gather([xs])))
            return
        # virtual shards: each phase over every range before the gather
        b = self._begin()
        moves = [self._move(b, r) for r in self.ranks]
        moved = self._gather([m[:2] for m in moves])
        seps = [self._separate(b, moved, m[2], r)
                for r, m in zip(self.ranks, moves)]
        copy_state(self.state, self._end(b, self._gather(seps)))

    def _capture(self):
        """Capture each phase after the phases before it have run once,
        so that its warm-up reads their values; the gathers' results live
        in buffers the later graphs read."""
        total, pool = 0.0, 0

        def rec(fn, record=None, run=True):
            nonlocal total, pool
            cap, out = capture(fn, record or fn, self.WARMUP)
            total, pool = total + cap.seconds, pool + cap.pool_bytes
            if run:     # fills the outputs the next phase reads
                cap.graph.replay()
            return cap.graph, out

        begin, b = rec(self._begin)
        moves = [rec(lambda r=r: self._move(b, r)) for r in self.ranks]
        self.moved = [x.clone() for x in self._gather(
            [out[:2] for _, out in moves])]
        seps = [rec(lambda r=r, m=out: self._separate(b, self.moved, m[2],
                                                        r))
                for r, (_, out) in zip(self.ranks, moves)]
        self.seps = [x.clone() for x in self._gather(
            [out for _, out in seps])]
        end, _ = rec(lambda: self._end(b, self.seps),
                     lambda: copy_state(self.state, self._end(b, self.seps)),
                     run=False)
        self.graphs = (begin, [g for g, _ in moves], [g for g, _ in seps],
                       end)
        self.outputs = ([out for _, out in moves], [out for _, out in seps])
        self.capture_seconds, self.pool_bytes = total, pool

    def step(self):
        """Advance ``state`` in place by one substep."""
        if self.graphs is None:
            self._advance()
            return
        begin, moves, seps, end = self.graphs
        begin.replay()
        for g in moves:
            g.replay()
        for dst, src in zip(self.moved, self._gather(
                [out[:2] for out in self.outputs[0]])):
            dst.copy_(src)
        for g in seps:
            g.replay()
        for dst, src in zip(self.seps, self._gather(self.outputs[1])):
            dst.copy_(src)
        end.replay()


def render_shard(geo, fg, ibl, lights, cam, o, d, rank: int, world: int,
                 max_layers: int, shadow_layers: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the padded rays ``o``, ``d`` traced and
    shaded, mirror and refraction on (sharding.py:92-95) -> (P / world, 3)."""
    return RT._render_rays(geo, fg, ibl, lights, cam, _slice(o, rank, world),
                           _slice(d, rank, world), max_layers, shadow_layers,
                           True, True)


def sharded_render(group, geo, ibl, lights, width: int, height: int,
                   max_layers: int = 2, shadow_layers: int = 1,
                   device="cuda"):
    """The image-plane-sharded traced frame (sharding.py:68-118) ->
    ``render(transforms, palettes, inv_view_proj, cam_pos)`` giving the
    (height, width, 3) linear image, no dither, on every rank.

    ``group``: a process group from ``make_group`` or an int (virtual
    shards; see the module docstring). ``device``: where the frame runs,
    the card unless the caller asks otherwise; the geometry, lights and
    IBL are on it. Each call flattens the frame, makes the tiled camera
    rays, pads them to a multiple of the world size with rays parked far
    outside the scene (sharding.py:105-109), renders this rank's slice,
    gathers the slices and crops and untiles. ``inv_view_proj`` and
    ``cam_pos`` may be host values or tensors; with tensors on the device
    the shard's render reads nothing back to the host."""
    dev = resolve_device(device)
    RT._check_layers(max_layers, shadow_layers)
    world, ranks = _ranks(group)

    def render(transforms, palettes, inv_view_proj, cam_pos):
        fg = flatten_frame(geo, transforms, palettes)
        ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32, device=dev)
        cam = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
        o, d, _, _ = generate_rays_tiled(ivp, cam, width, height)
        n = o.shape[0]
        pad = (-n) % world
        if pad:
            o = torch.cat([o, torch.full((pad, 3), 1.0e9, device=dev)])
            d = torch.cat([d, constant((0.0, 1.0, 0.0), dev).expand(pad, 3)])
        parts = [render_shard(geo, fg, ibl, lights, cam, o, d, r, world,
                              max_layers, shadow_layers) for r in ranks]
        if isinstance(group, int):
            img = torch.cat(parts)
        else:
            img = torch.empty((o.shape[0], 3), device=dev)
            dist.all_gather_into_tensor(img, parts[0].contiguous(),
                                        group=group)
        return untile_image(img[:n], width, height)

    return render


def sharded_fused_step(group, world, ibl, width: int, height: int,
                       n_substeps: int = 1, max_layers: int = 1,
                       shadow_layers: int = 1, device="cuda"):
    """The shipped frame's structure over the group (sharding.py:121-166)
    -> ``step(state, inv_view_proj, cam_pos, cam_world)`` giving (the
    state after the substeps, the (height, width, 3) image).

    ``world``: a DemoWorld (geometry, lights, stepper) on ``device``. Each
    call runs ``n_substeps`` fixed substeps of the world's Stepper, the
    render extraction at alpha 1 relative to ``cam_world`` (a (3,) tensor
    on the device), and ``sharded_render``. A WorldState is stepped whole
    on every rank through a ``SubstepGraph``; a ShardedWorldState
    (``shard_world_state``) through an ``EntityShardedSubstep``, each rank
    stepping its own entity rows, and the step then returns a
    ShardedWorldState with the same ranges. Either is captured at the
    first call (CUDA graph replays on the card) and the state is copied
    into its buffers; the returned state is a copy of the buffers."""
    dev = resolve_device(device)
    render = sharded_render(group, world.geometry, ibl, world.lights, width,
                            height, max_layers, shadow_layers, dev)
    stepper, sim = world.stepper, None

    def step(state, inv_view_proj, cam_pos, cam_world):
        nonlocal sim
        sharded = isinstance(state, ShardedWorldState)
        if sim is None:
            sim = EntityShardedSubstep(stepper, state, FIXED_DT, group) \
                if sharded else SubstepGraph(stepper, state, FIXED_DT)
        elif sharded != isinstance(sim, EntityShardedSubstep) or (
                sharded and state.ranges != sim.ranges):
            raise ValueError("a step keeps the entity partition of its "
                             "first state")
        else:
            copy_state(sim.state, state.state if sharded else state)
        for _ in range(n_substeps):
            sim.step()
        transforms, palettes = stepper._extract(sim.state, 1.0, cam_world)
        out = clone_state(sim.state)
        if sharded:
            out = ShardedWorldState(out, sim.ranges)
        return out, render(transforms, palettes, inv_view_proj, cam_pos)

    return step
