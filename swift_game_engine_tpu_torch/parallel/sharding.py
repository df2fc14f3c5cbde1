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

The programs: as the reference jits each entry point into one program
over its mesh, the port captures each on the card as CUDA graphs
(``scene/cuda_graph.capture``) with the NCCL all-gathers inside: a
``ShardedRender`` (``sharded_render``) is one replay a call, an
``EntityShardedSubstep`` one replay a substep, a ``ShardedFusedStep``
(``sharded_fused_step``) ``n_substeps`` substep replays and one replay of
the extraction and the render. Every rank captures the same programs in
the same order. For CPU tensors the same bodies run eagerly.
"""

from __future__ import annotations

from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import constant, resolve_device
from ..ecs.world import WorldState, clone_state, copy_state
from ..render import rt as RT
from ..render.camera import (TILE_H, TILE_W, generate_rays_tiled,
                             untile_image)
from ..render.scene_geometry import flatten_frame
from ..scene.engine import FIXED_DT, FrameProgram
from ..scene.step import SubstepGraph
from ..spans import stage


def make_group(rank: int, world: int, init_method: str, device="cuda",
               timeout: float = 300.0):
    """The process group of ``world`` ranks, this process being ``rank``
    (the counterpart of ``make_mesh``, sharding.py:26): NCCL on the card,
    gloo for ``device="cpu"``, rendezvous at ``init_method`` (a
    ``file://`` path needs no network; ``tcp://localhost:<port>`` works
    too). On the card each rank uses ``cuda:<rank>`` unless ``device``
    names its index. ``timeout``: seconds a collective may wait. A failure
    raises. Before ``torch.distributed.destroy_process_group()``, drop
    every program captured over the group and ``gc.collect()``: NCCL's
    communicator waits for the CUDA graphs that captured its collectives
    (with two ranks, the destroy otherwise blocks)."""
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
    rows. ``parts``: one list of tensors per range of this process (every
    range for an int group, the virtual shards'; this rank's alone for a
    process group). The tensors of one rank are packed into one byte
    buffer, padded to the longest range and gathered in one collective."""
    if isinstance(group, int):
        return [torch.cat(xs) for xs in zip(*parts)]
    (parts,) = parts
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


def _mode(group) -> str:
    """The capture error mode of a program over ``group``: a process
    group's collective is captured beside its watchdog thread."""
    return "global" if isinstance(group, int) else "thread_local"


class EntityShardedSubstep(SubstepGraph):
    """Fixed substeps of ``stepper`` on an entity-sharded state over
    ``group`` (see the module docstring): ``state`` holds the whole
    WorldState's buffers, cloned from ``sharded.state``, and ``step()``
    advances them in place by one substep of ``dt``.

    The substep is ``Stepper._substep_impl`` over this process's ranges
    (a rank's own, or every virtual shard's in turn) with ``gather_rows``
    for its two all-gathers (NCCL for a process group, concatenations for
    virtual shards): one composition, run eagerly for CPU tensors and
    captured on the card as one CUDA graph with the all-gathers inside
    (``SubstepGraph``), so ``step()`` is one replay."""

    # the substep's kernels and caches are first used in its one warm-up
    WARMUP = 1

    def __init__(self, stepper, sharded: ShardedWorldState, dt: float,
                 group):
        world, ranks = _ranks(group)
        if len(sharded.ranges) != world:
            raise ValueError(f"a state sharded over {len(sharded.ranges)} "
                             f"ranks stepped over {world}")
        self.group, self.mode = group, _mode(group)
        self.ranges, self.ranks = sharded.ranges, tuple(ranks)
        super().__init__(stepper, sharded.state, dt)

    def _next(self):
        return self.stepper._substep_impl(
            self.state, self.dt, [self.ranges[r] for r in self.ranks],
            lambda parts: gather_rows(self.group, self.ranges, parts))


def render_shard(geo, fg, ibl, lights, cam, o, d, rank: int, world: int,
                 max_layers: int, shadow_layers: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the padded rays ``o``, ``d`` traced and
    shaded, mirror and refraction on (sharding.py:92-95) -> (P / world, 3)."""
    return RT._render_rays(geo, fg, ibl, lights, cam, _slice(o, rank, world),
                           _slice(d, rank, world), max_layers, shadow_layers,
                           True, True)


def _render_body(group, geo, ibl, lights, width: int, height: int,
                 max_layers: int, shadow_layers: int, dev):
    """-> ``body(transforms, palettes, inv_view_proj, cam_pos)``, the
    sharded frame from device tensors to the (height, width, 3) image:
    flatten, the tiled camera rays written into padded ray buffers (the
    padding rays parked far outside the scene, sharding.py:105-109), this
    process's shard render(s), the all-gather (a concatenation for virtual
    shards) into a (P, 3) buffer, crop and untile. The buffers are made
    here, so a CUDA graph of the body writes at fixed addresses."""
    world, ranks = _ranks(group)
    n = -(-width // TILE_W) * -(-height // TILE_H) * TILE_W * TILE_H
    p = n + (-n) % world
    o = torch.full((p, 3), 1.0e9, device=dev)
    d = constant((0.0, 1.0, 0.0), dev).expand(p, 3).clone()
    img = torch.empty((p, 3), device=dev)

    def body(transforms, palettes, inv_view_proj, cam_pos):
        with stage("sge.render.flatten"):
            fg = flatten_frame(geo, transforms, palettes)
        ro, rd, _, _ = generate_rays_tiled(inv_view_proj, cam_pos, width,
                                           height)
        o[:n].copy_(ro)
        d[:n].copy_(rd)
        parts = [render_shard(geo, fg, ibl, lights, cam_pos, o, d, r, world,
                              max_layers, shadow_layers) for r in ranks]
        if isinstance(group, int):
            torch.cat(parts, out=img)
        else:
            dist.all_gather_into_tensor(img, parts[0].contiguous(),
                                        group=group)
        return untile_image(img[:n], width, height)

    return body


def _put(dst, value):
    """``value`` (a tensor, or a host value) into the buffer ``dst``: a
    device copy, or one non-blocking copy from pinned host memory."""
    if isinstance(value, torch.Tensor) and value.device == dst.device:
        dst.copy_(value.reshape(dst.shape))
        return
    host = torch.as_tensor(np.asarray(value, np.float32)).reshape(dst.shape)
    if dst.is_cuda:
        dst.copy_(host.pin_memory(), non_blocking=True)
    else:
        dst.copy_(host)


def _camera_buffer(dev, count: int):
    """A flat f32 buffer and its views: the inverse view-projection (4, 4)
    and ``count - 1`` (3,) vectors (the camera position, and the world
    position the extraction is relative to)."""
    buf = torch.empty(16 + 3 * (count - 1), device=dev)
    return buf, [buf[:16].view(4, 4)] + [buf[16 + 3 * i:19 + 3 * i]
                                         for i in range(count - 1)]


def _stage_camera(buf, views, values):
    """The camera's values into ``buf``: with every value on the host, one
    copy of them all (as ``Engine._stage_inputs``), else each by ``_put``."""
    if any(isinstance(v, torch.Tensor) and v.device == buf.device
           for v in values):
        for dst, v in zip(views, values):
            _put(dst, v)
        return
    _put(buf, np.concatenate([np.ravel(np.asarray(v, np.float32))
                              for v in values]))


class ShardedRender:
    """The image-plane-sharded traced frame of one size, ``sharded_render``'s
    result: ``render(transforms, palettes, inv_view_proj, cam_pos)``.

    Each call copies its inputs into buffers it owns (device tensors by
    device copies, host values by one copy from pinned memory) and runs
    the frame's body (``_render_body``) on them: on the card one replay of
    a ``FrameProgram`` captured at the first call (``WARMUP`` eager runs
    first; a capture that fails raises; a process group's all-gather is
    in the graph), eagerly for CPU tensors. The image is a copy of the
    body's output (on the card, the graph's). ``eager(...)`` runs the body
    eagerly at the same inputs whatever the device: on the card, the image
    a replay must equal bit for bit."""

    def __init__(self, group, geo, ibl, lights, width, height, max_layers,
                 shadow_layers, dev):
        self.body = _render_body(group, geo, ibl, lights, width, height,
                                 max_layers, shadow_layers, dev)
        self.device, self.mode = dev, _mode(group)
        self.inputs, (self.ivp, self.cam) = _camera_buffer(dev, 2)
        self.frame, self.program = None, None

    def _stage(self, transforms, palettes, inv_view_proj, cam_pos):
        if self.frame is None:
            self.frame = tuple(torch.empty(tuple(x.shape), device=self.device)
                               for x in (transforms, palettes))
        for dst, x in zip(self.frame, (transforms, palettes)):
            _put(dst, x)
        _stage_camera(self.inputs, (self.ivp, self.cam),
                      (inv_view_proj, cam_pos))

    def _run(self):
        return self.body(*self.frame, self.ivp, self.cam)

    def __call__(self, transforms, palettes, inv_view_proj, cam_pos):
        self._stage(transforms, palettes, inv_view_proj, cam_pos)
        if self.program is None:
            self.program = FrameProgram(self._run, self.device, self.mode)
        return self.program.run().clone()

    def eager(self, transforms, palettes, inv_view_proj, cam_pos):
        self._stage(transforms, palettes, inv_view_proj, cam_pos)
        return self._run().clone()


def sharded_render(group, geo, ibl, lights, width: int, height: int,
                   max_layers: int = 2, shadow_layers: int = 1,
                   device="cuda") -> ShardedRender:
    """The image-plane-sharded traced frame (sharding.py:68-118) ->
    ``render(transforms, palettes, inv_view_proj, cam_pos)`` giving the
    (height, width, 3) linear image, no dither, on every rank (a
    ``ShardedRender``: on the card one CUDA graph replay a call).

    ``group``: a process group from ``make_group`` or an int (virtual
    shards; see the module docstring). ``device``: where the frame runs,
    the card unless the caller asks otherwise; the geometry, lights and
    IBL are on it. Each call flattens the frame, makes the tiled camera
    rays, pads them to a multiple of the world size with rays parked far
    outside the scene, renders this rank's slice, gathers the slices and
    crops and untiles. ``inv_view_proj`` and ``cam_pos`` may be host values
    or tensors; nothing is read back to the host."""
    dev = resolve_device(device)
    RT._check_layers(max_layers, shadow_layers)
    return ShardedRender(group, geo, ibl, lights, width, height, max_layers,
                         shadow_layers, dev)


class ShardedFusedStep:
    """``sharded_fused_step``'s result: ``step(state, inv_view_proj,
    cam_pos, cam_world)`` -> (the state after the substeps, the image).

    A call copies ``state`` into the substep's buffers (``copy_state``)
    and the camera into its input buffer, then makes ``n_substeps``
    replays of the substep graph (a ``SubstepGraph`` for a WorldState, an
    ``EntityShardedSubstep`` for a ShardedWorldState) and one replay of a
    ``FrameProgram`` of the extraction (``Stepper._extract`` at alpha 1
    relative to ``cam_world``) and the sharded render: at most
    ``n_substeps + 1`` graph launches and no host read. Both graphs are
    captured at the first call; for CPU tensors both run eagerly. The
    returned state (a ShardedWorldState with the same ranges for a
    sharded one) and image are device copies. ``eager(...)`` runs the
    same step with every substep and the frame eager (on the card, what
    the replays must equal bit for bit)."""

    def __init__(self, group, world, ibl, width, height, n_substeps,
                 max_layers, shadow_layers, dev):
        self.body = _render_body(group, world.geometry, ibl, world.lights,
                                 width, height, max_layers, shadow_layers,
                                 dev)
        self.group, self.stepper, self.n_substeps = group, world.stepper, \
            int(n_substeps)
        self.device = dev
        self.inputs, (self.ivp, self.cam, self.cam_world) = \
            _camera_buffer(dev, 3)
        self.sim, self.program = None, None

    @property
    def capture_seconds(self) -> float:
        return sum(0.0 if x is None else x.capture_seconds
                   for x in (self.sim, self.program))

    @property
    def pool_bytes(self) -> int:
        return sum(0 if x is None else x.pool_bytes
                   for x in (self.sim, self.program))

    def _start(self, state, inv_view_proj, cam_pos, cam_world):
        sharded = isinstance(state, ShardedWorldState)
        if self.sim is None:
            self.sim = EntityShardedSubstep(self.stepper, state, FIXED_DT,
                                            self.group) if sharded else \
                SubstepGraph(self.stepper, state, FIXED_DT)
        elif sharded != isinstance(self.sim, EntityShardedSubstep) or (
                sharded and state.ranges != self.sim.ranges):
            raise ValueError("a step keeps the entity partition of its "
                             "first state")
        else:
            copy_state(self.sim.state, state.state if sharded else state)
        _stage_camera(self.inputs, (self.ivp, self.cam, self.cam_world),
                      (inv_view_proj, cam_pos, cam_world))

    def _frame(self):
        transforms, palettes = self.stepper._extract(self.sim.state, 1.0,
                                                     self.cam_world)
        return self.body(transforms, palettes, self.ivp, self.cam)

    def _result(self, img):
        out = clone_state(self.sim.state)
        if isinstance(self.sim, EntityShardedSubstep):
            out = ShardedWorldState(out, self.sim.ranges)
        return out, img

    def __call__(self, state, inv_view_proj, cam_pos, cam_world):
        self._start(state, inv_view_proj, cam_pos, cam_world)
        for _ in range(self.n_substeps):
            self.sim.step()
        if self.program is None:
            self.program = FrameProgram(self._frame, self.device,
                                        _mode(self.group))
        return self._result(self.program.run().clone())

    def eager(self, state, inv_view_proj, cam_pos, cam_world):
        self._start(state, inv_view_proj, cam_pos, cam_world)
        for _ in range(self.n_substeps):
            self.sim.eager()
        return self._result(self._frame().clone())


def sharded_fused_step(group, world, ibl, width: int, height: int,
                       n_substeps: int = 1, max_layers: int = 1,
                       shadow_layers: int = 1,
                       device="cuda") -> ShardedFusedStep:
    """The shipped frame's structure over the group (sharding.py:121-166)
    -> ``step(state, inv_view_proj, cam_pos, cam_world)`` giving (the
    state after the substeps, the (height, width, 3) image): a
    ``ShardedFusedStep``.

    ``world``: a DemoWorld (geometry, lights, stepper) on ``device``. Each
    call runs ``n_substeps`` fixed substeps of the world's Stepper, the
    render extraction at alpha 1 relative to ``cam_world`` (a (3,) tensor
    on the device), and the sharded render. A WorldState is stepped whole
    on every rank; a ShardedWorldState (``shard_world_state``) by each
    rank over its own entity rows, and the step then returns a
    ShardedWorldState with the same ranges. The reference's one program
    is here two CUDA graphs a step, the substep's and the frame's."""
    dev = resolve_device(device)
    RT._check_layers(max_layers, shadow_layers)
    return ShardedFusedStep(group, world, ibl, width, height, n_substeps,
                            max_layers, shadow_layers, dev)
