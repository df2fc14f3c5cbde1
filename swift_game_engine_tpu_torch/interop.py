"""Carry the reference's state across: numpy arrays -> the port's tensors.

Each function takes the JAX package's NamedTuple (or a dict with the same
fields) whose leaves are numpy arrays — or anything ``np.asarray`` accepts,
so the caller converts on the JAX side — and returns the port's
counterpart on ``device``: the card unless the caller names another
(``resolve_device``; without CUDA, a call that names no device raises).
This module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
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
