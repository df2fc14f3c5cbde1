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

The entities axis stays replicated: every rank holds the whole WorldState
and runs the whole substep (the demo's ~10 agents, sharding.py:12-13). The
reference's ``shard_world_state`` leaves the partition of the substep to
GSPMD, which has no counterpart here; it is not ported.

A group is made by ``make_group`` (one process per card, NCCL; gloo for
``device="cpu"``), or stands as an int k: k virtual shards rendered one
after another in this process and concatenated in rank order, the
all-gather's result with no collective (a one-card check of the sharded
frame).
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from .. import constant, resolve_device
from ..ecs.world import clone_state, copy_state
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
    call runs ``n_substeps`` fixed substeps of the world's Stepper on the
    whole, replicated WorldState through a ``SubstepGraph`` (a CUDA graph
    replay on the card, captured at the first call; the state is copied
    into its buffers), the render extraction at alpha 1 relative to
    ``cam_world`` (a (3,) tensor on the device), and ``sharded_render``.
    The returned state is a copy of the graph's buffers."""
    dev = resolve_device(device)
    render = sharded_render(group, world.geometry, ibl, world.lights, width,
                            height, max_layers, shadow_layers, dev)
    stepper, sim = world.stepper, None

    def step(state, inv_view_proj, cam_pos, cam_world):
        nonlocal sim
        if sim is None:
            sim = SubstepGraph(stepper, state, FIXED_DT)
        else:
            copy_state(sim.state, state)
        for _ in range(n_substeps):
            sim.step()
        transforms, palettes = stepper._extract(sim.state, 1.0, cam_world)
        return clone_state(sim.state), render(transforms, palettes,
                                              inv_view_proj, cam_pos)

    return step
