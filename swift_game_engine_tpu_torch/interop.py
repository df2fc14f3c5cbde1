"""Carry the reference's state across: numpy arrays -> the port's tensors.

Render side: ``scene_geometry``, ``frame_geometry``, ``lights``, ``ibl``;
simulation side: ``world_state``, ``scene_spec``, ``controller_params``,
``local_triangles``; pose: ``skeleton``, ``profile_bank``,
``action_profile``, ``loco_state``, ``loco_params``.

Each function takes the JAX package's NamedTuple (or a dict with the same
fields) whose leaves are numpy arrays — or anything ``np.asarray`` accepts,
so the caller converts on the JAX side — and returns the port's
counterpart on ``device``: the card unless the caller names another
(``resolve_device``; without CUDA, a call that names no device raises).
This module imports no jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .anim.locomotion import LocomotionTuning
from .anim.pose import ActionProfile, LocoParams, LocoState, ProfileBank
from .assets.skeleton import Skeleton
from .ecs.world import SceneSpec, WorldState
from .physics.character import ControllerParams, ControllerState
from .physics.collision_world import LocalTriangles
from .physics.systems import ActionClock, DodgeState
from .ops.rt_kernel import wide_tree
from .render.bvh import BVHArrays
from .render.ibl import IBL
from .render.rt import DirectionalLights
from .render.scene_geometry import (FrameGeometry, MaterialTable, SceneGeometry,
                                    pack_scene)


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _t(x, device, dtype=None):
    a = np.array(x)
    if dtype is None:
        dtype = torch.bool if a.dtype == np.bool_ else \
            torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(a, dtype=dtype, device=device)


def scene_geometry(geo, topo=None, device="cuda") -> SceneGeometry:
    """The reference's SceneGeometry (fields incl. ``materials`` with the
    MaterialTable fields, ``textures`` (its bank or the bank's data array)
    and ``skinned_blocks``) plus its BVHTopology (default: ``geo.topo``)."""
    device = resolve_device(device)
    mats = _get(geo, "materials")
    tex = _get(geo, "textures")
    tex = tex if isinstance(tex, np.ndarray) else _get(tex, "data")
    fields = ("static_pos", "static_nrm", "static_tan", "vert_instance", "uv",
              "tri", "tri_material", "n_static_verts", "tri_translucent",
              "tri_shade")
    arrays = {k: np.asarray(_get(geo, k)) for k in fields}
    arrays["materials"] = {k: np.asarray(_get(mats, k))
                           for k in MaterialTable._fields}
    arrays["textures"] = np.asarray(tex)
    arrays["skinned_blocks"] = [
        {k: np.asarray(b[k]) for k in ("base_vertex", "positions", "normals",
                                        "tangents", "dense_weights",
                                        "character")}
        for b in _get(geo, "skinned_blocks")]
    topo = _get(geo, "topo") if topo is None else topo
    topo = {k: (tuple(np.asarray(lv) for lv in _get(topo, k)) if k == "levels"
                else np.asarray(_get(topo, k)))
            for k in ("skip", "first_tri", "tri_count", "left", "right",
                      "tri_order", "levels", "leaf_slots")}
    return pack_scene(arrays, topo, device)


def frame_geometry(fg, device="cuda") -> FrameGeometry:
    """The reference's FrameGeometry (with its BVHArrays) on ``device``."""
    device = resolve_device(device)
    b = _get(fg, "bvh")
    rows = _t(_get(b, "rows"), device)
    bvh = BVHArrays(
        bmin=_t(_get(b, "bmin"), device), bmax=_t(_get(b, "bmax"), device),
        skip=_t(_get(b, "skip"), device, torch.int32),
        is_leaf=_t(_get(b, "is_leaf"), device, torch.bool),
        slot_tri=_t(_get(b, "slot_tri"), device, torch.int64),
        v0=_t(_get(b, "v0"), device), v1=_t(_get(b, "v1"), device),
        v2=_t(_get(b, "v2"), device), rows=rows, wide=wide_tree(rows))
    return FrameGeometry(pos=_t(_get(fg, "pos"), device),
                         nrm=_t(_get(fg, "nrm"), device),
                         tan=_t(_get(fg, "tan"), device), bvh=bvh,
                         tri_nrm=_t(_get(fg, "tri_nrm"), device))


def lights(l, device="cuda") -> DirectionalLights:
    device = resolve_device(device)
    return DirectionalLights(**{k: _t(_get(l, k), device)
                                for k in DirectionalLights._fields})


def ibl(tables, device="cuda") -> IBL:
    device = resolve_device(device)
    return IBL(sh0=_t(_get(tables, "sh0"), device),
               sh1=_t(_get(tables, "sh1"), device),
               brdf_lut=_t(_get(tables, "brdf_lut"), device),
               env_mip_count=int(_get(tables, "env_mip_count")))


# ---------------------------------------------------------------------------
# The simulation: world state, scene spec, controller params, collision.


def _keep(x, device):
    """A leaf with its dtype kept (int32 stays int32: chunk arithmetic and
    triangle ids depend on it); uint32 layer masks become int64."""
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def _tuple(cls, obj, device, nested=None):
    nested = nested or {}
    return cls(**{k: nested[k](_get(obj, k)) if k in nested
                  else _keep(_get(obj, k), device) for k in cls._fields})


def controller_params(cp, device="cuda") -> ControllerParams:
    """The reference's ControllerParams (collision_mask uint32 -> int64)."""
    return _tuple(ControllerParams, cp, resolve_device(device))


def world_state(ws, device="cuda") -> WorldState:
    """The reference's WorldState with its nested ControllerState,
    LocoState, ActionClock and DodgeState."""
    device = resolve_device(device)
    sub = {"ctrl": ControllerState, "loco": LocoState,
           "action": ActionClock, "dodge": DodgeState}
    return _tuple(WorldState, ws, device, {
        k: (lambda o, c=c: _tuple(c, o, device)) for k, c in sub.items()})


def scene_spec(spec, device="cuda") -> SceneSpec:
    """The reference's SceneSpec: masks and driver tables as numpy, the
    controller and pose parameters as tensors on ``device``."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(SceneSpec):
        v = getattr(spec, f.name, None)
        if f.name == "controller_params":
            v = controller_params(v, device)
        elif f.name == "loco_params":
            v = _tuple(LocoParams, v, device)
        elif f.name == "loco_tuning":
            v = None if v is None else LocomotionTuning(
                *(np.array(x) for x in v))
        elif isinstance(v, dict):
            v = {k: np.array(x) for k, x in v.items()}
        elif f.name not in ("n_entities", "names", "gravity"):
            v = np.array(v)
        kw[f.name] = v
    kw["gravity"] = tuple(float(g) for g in spec.gravity)
    return SceneSpec(**kw)


def local_triangles(lt, device="cuda") -> LocalTriangles:
    """The reference's LocalTriangles (entity and layer as int64)."""
    device = resolve_device(device)
    return LocalTriangles(**{
        k: torch.as_tensor(np.array(_get(lt, k)).astype(
            np.int64) if k in ("entity", "layer") else np.array(_get(lt, k)),
            device=device) for k in LocalTriangles._fields})


# ---------------------------------------------------------------------------
# Pose: the skeleton, the profile bank, the action profile, loco state.


def skeleton(sk) -> Skeleton:
    """The reference's Skeleton (a dataclass of numpy arrays) as the
    port's, field for field."""
    return Skeleton(**{f.name: getattr(sk, f.name)
                       for f in dataclasses.fields(Skeleton)})


def profile_bank(bank, device="cuda") -> ProfileBank:
    return _tuple(ProfileBank, bank, resolve_device(device))


def action_profile(action, device="cuda") -> ActionProfile:
    return _tuple(ActionProfile, action, resolve_device(device))


def loco_state(loco, device="cuda") -> LocoState:
    return _tuple(LocoState, loco, resolve_device(device))


def loco_params(params, device="cuda") -> LocoParams:
    return _tuple(LocoParams, params, resolve_device(device))
