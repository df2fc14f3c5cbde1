"""Render geometry: pack scene items into flat tensors; per-frame flatten.

Port of swift_game_engine_tpu/render/scene_geometry.py (reference:
Game/RTGeometryCache.swift:54-577). Geometry is packed once on the host
(vertex pool [static | skinned], index pool, per-triangle materials, a flat
material table, a texture bank, one native-SAH BVH over the build pose);
``flatten_frame`` produces the frame's world-space arrays and refits the
BVH.

Three things the reference recomputes per trace are computed once here and
stored on the geometry: the static ``TextureUsage`` (the reference memoizes
it in a global cache), the static opaque/translucent triangle partition
the hybrid visibility rasterizes separately (``opaque_idx`` /
``translucent_idx``) and which bounces some material can start
(``BounceUsage``: the deferred shade's static pruning).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device

from ..assets.mesh_api import MeshDescriptor, compute_tangents
from ..assets.materials import Material
from ..anim.skinning import skin_vertices
from . import bvh as B
from .textures import TextureBank, TextureBankBuilder

LEAF = 12          # triangles inlined per BVH leaf row (SGE_RT_LEAF)
TEXTURE_SIZE = 512  # SGE_TEX_SIZE


class MaterialTable(NamedTuple):
    """Flat PBR material arrays (K materials)."""

    base_color: torch.Tensor        # (K,3)
    metallic: torch.Tensor          # (K,)
    roughness: torch.Tensor         # (K,)
    emissive: torch.Tensor          # (K,3)
    occlusion_strength: torch.Tensor
    alpha: torch.Tensor
    transmission: torch.Tensor
    ior: torch.Tensor
    unlit: torch.Tensor             # (K,) bool
    normal_scale: torch.Tensor
    exposure: torch.Tensor
    tone_mapped: torch.Tensor       # (K,) bool
    base_tex: torch.Tensor          # (K,) int32 (-1 none)
    normal_tex: torch.Tensor
    mr_tex: torch.Tensor
    emissive_tex: torch.Tensor
    occlusion_tex: torch.Tensor
    # (K,16) hot shading fields: [0:3] base, [3] alpha, [4] metallic,
    # [5] roughness, [6:9] emissive, [9] occlusion, [10] transmission,
    # [11] ior, [12] normal_scale, [13] base_tex, [14] normal_tex, [15] mr_tex
    packed: torch.Tensor


class TextureUsage(NamedTuple):
    """Which texture slots any material binds; ``alpha_tex`` is True only if
    a bound base texture carries alpha < 1."""

    base: bool
    mr: bool
    emissive: bool
    occlusion: bool
    normal: bool
    alpha_tex: bool


def texture_usage_np(mats: dict, tex_data: np.ndarray) -> TextureUsage:
    """TextureUsage from numpy material-table fields and the texture bank."""
    base_ids = np.asarray(mats["base_tex"])
    alpha_tex = False
    if np.any(base_ids >= 0):
        amin = np.asarray(tex_data)[..., 3].min(axis=(1, 2))
        alpha_tex = bool(amin[base_ids[base_ids >= 0]].min() < 0.999)

    def used(k):
        return bool(np.any(np.asarray(mats[k]) >= 0))

    return TextureUsage(base=used("base_tex"), mr=used("mr_tex"),
                        emissive=used("emissive_tex"),
                        occlusion=used("occlusion_tex"),
                        normal=used("normal_tex"), alpha_tex=alpha_tex)


class BounceUsage(NamedTuple):
    """Which bounces some material can start (render/deferred.py:84-95):
    a mirror (metallic >= 0.8 and roughness <= 0.08), a refraction
    (transmission > 0.001)."""

    mirror: bool
    refraction: bool


def bounce_usage_np(mats: dict) -> BounceUsage:
    """BounceUsage from numpy material-table fields."""
    return BounceUsage(
        mirror=bool(((np.asarray(mats["metallic"]) >= 0.8) &
                     (np.asarray(mats["roughness"]) <= 0.08)).any()),
        refraction=bool((np.asarray(mats["transmission"]) > 0.001).any()))


class SceneGeometry(NamedTuple):
    """Static packing; world-space arrays come from flatten_frame."""

    static_pos: torch.Tensor      # (S,3) local
    static_nrm: torch.Tensor      # (S,3)
    static_tan: torch.Tensor      # (S,4)
    vert_instance: torch.Tensor   # (V,) int64 into instance transforms
    uv: torch.Tensor              # (V,2)
    tri: torch.Tensor             # (T,3) int64 into the vertex pool
    tri_material: torch.Tensor    # (T,) int64
    materials: MaterialTable
    textures: TextureBank
    skinned_blocks: tuple         # dicts of tensors (see RenderGeometryBuilder)
    n_static_verts: int
    topo: B.BVHTopology
    tri_translucent: torch.Tensor  # (T,) bool: material can pass light
    # (T,8): [uv0.xy, uv1.xy, uv2.xy, material id, unlit flag]
    tri_shade: torch.Tensor
    usage: TextureUsage           # static texture-slot usage
    opaque_idx: torch.Tensor      # (To,) int64: ~tri_translucent
    translucent_idx: torch.Tensor  # (Tt,) int64: tri_translucent
    bounces: BounceUsage          # static: the bounces materials can start
    # static: some triangle is translucent and no material of the
    # translucent set binds a texture (rt.py:1120 _trans_subdiv_ok)
    trans_untextured: bool = False


def trans_untextured_np(mats: dict, tri_material, tri_translucent) -> bool:
    """The gate of the translucent subset's subdivision (rt.py:1120-1136
    _trans_subdiv_ok): some triangle is translucent and no material of the
    translucent set binds a texture slot, so sub-triangle barycentrics,
    which feed only texture taps, change no shade."""
    tr = np.asarray(tri_translucent, bool)
    if not tr.any():
        return False
    mids = np.unique(np.maximum(np.asarray(tri_material), 0)[tr])
    return not any((np.asarray(mats[f])[mids] >= 0).any() for f in (
        "base_tex", "normal_tex", "mr_tex", "emissive_tex", "occlusion_tex"))


def pack_scene(arrays: dict, topo, device=None) -> SceneGeometry:
    """Numpy arrays (the reference's SceneGeometry fields) -> SceneGeometry
    on ``device``. Shared by RenderGeometryBuilder and the interop path."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    m = arrays["materials"]
    ints = ("base_tex", "normal_tex", "mr_tex", "emissive_tex",
            "occlusion_tex")
    bools = ("unlit", "tone_mapped")
    table = MaterialTable(**{
        k: t(m[k], torch.int32 if k in ints else
             torch.bool if k in bools else torch.float32)
        for k in MaterialTable._fields})
    tex = np.asarray(arrays["textures"], np.float32)
    tr = np.asarray(arrays["tri_translucent"], bool)
    blocks = tuple(dict(
        base_vertex=int(b["base_vertex"]),
        positions=t(b["positions"]), normals=t(b["normals"]),
        tangents=t(b["tangents"]), dense_weights=t(b["dense_weights"]),
        character=int(b["character"])) for b in arrays["skinned_blocks"])
    return SceneGeometry(
        static_pos=t(arrays["static_pos"]), static_nrm=t(arrays["static_nrm"]),
        static_tan=t(arrays["static_tan"]),
        vert_instance=t(arrays["vert_instance"], torch.int64),
        uv=t(arrays["uv"]), tri=t(arrays["tri"], torch.int64),
        tri_material=t(arrays["tri_material"], torch.int64),
        materials=table,
        textures=TextureBank(data=t(tex), size=int(tex.shape[1])),
        skinned_blocks=blocks,
        n_static_verts=int(arrays["n_static_verts"]),
        topo=B.BVHTopology.from_numpy(topo, device),
        tri_translucent=t(tr, torch.bool),
        tri_shade=t(arrays["tri_shade"]),
        usage=texture_usage_np(m, tex),
        opaque_idx=t(np.nonzero(~tr)[0], torch.int64),
        translucent_idx=t(np.nonzero(tr)[0], torch.int64),
        bounces=bounce_usage_np(m),
        trans_untextured=trans_untextured_np(m, arrays["tri_material"], tr))


@dataclass
class RenderGeometryBuilder:
    """Host-side accumulation of render items (numpy)."""

    texture_size: int = TEXTURE_SIZE

    def __post_init__(self):
        self._pos, self._nrm, self._tan, self._uv, self._inst = [], [], [], [], []
        self._sk_uv, self._sk_inst = [], []
        self._tri, self._tri_mat = [], []
        self._sk_tri, self._sk_tri_mat = [], []
        self._materials: list[Material] = []
        self._mat_ids: dict[int, int] = {}
        self._mat_tex = []
        self._skinned = []
        self._tex_builder = TextureBankBuilder(self.texture_size)
        self._tex_ids: dict[int, int] = {}
        self._n_verts = 0
        self._n_sk_verts = 0

    def _material_id(self, mat: Material) -> int:
        key = id(mat)
        if key in self._mat_ids:
            return self._mat_ids[key]

        def tex(t):
            if t is None:
                return -1
            k = id(t)
            if k not in self._tex_ids:
                self._tex_ids[k] = self._tex_builder.add(t)
            return self._tex_ids[k]

        idx = len(self._materials)
        self._materials.append(mat)
        self._mat_ids[key] = idx
        self._mat_tex.append((tex(mat.base_color_texture),
                              tex(mat.normal_texture),
                              tex(mat.metallic_roughness_texture),
                              tex(mat.emissive_texture),
                              tex(mat.occlusion_texture)))
        return idx

    def add_static_mesh(self, mesh: MeshDescriptor, material: Material,
                        instance: int, tri_range=None):
        """Static mesh bound to instance-transform slot ``instance``;
        ``tri_range``: optional (start, count) in index units."""
        if mesh.uvs is not None and mesh.normals is not None:
            mesh = mesh.with_tangents()
        base = self._n_verts
        v = mesh.vertex_count
        self._pos.append(mesh.positions)
        self._nrm.append(mesh.normals if mesh.normals is not None else
                         np.tile(np.array([[0, 1, 0]], np.float32), (v, 1)))
        self._tan.append(mesh.tangents if mesh.tangents is not None else
                         np.tile(np.array([[1, 0, 0, 1]], np.float32), (v, 1)))
        self._uv.append(mesh.uvs if mesh.uvs is not None else
                        np.zeros((v, 2), np.float32))
        self._inst.append(np.full(v, instance, np.int32))
        self._n_verts += v
        idx = mesh.indices
        if tri_range is not None:
            s, c = tri_range
            idx = idx[s:s + c]
        tris = idx.reshape(-1, 3) + base
        self._tri.append(tris.astype(np.int32))
        self._tri_mat.append(np.full(len(tris), self._material_id(material),
                                     np.int32))

    def add_skinned_mesh(self, positions, normals, uvs, indices, dense_weights,
                         materials_per_submesh, submesh_ranges, instance: int,
                         character: int, tangents=None):
        """Skinned mesh whose vertices come from the per-frame LBS of
        character slot ``character``."""
        if tangents is None:
            tangents = compute_tangents(positions, normals, uvs, indices)
        base = self._n_sk_verts
        v = len(positions)
        self._sk_uv.append(np.asarray(uvs, np.float32))
        self._sk_inst.append(np.full(v, instance, np.int32))
        self._n_sk_verts += v
        self._skinned.append(dict(
            base_vertex=base, positions=np.asarray(positions, np.float32),
            normals=np.asarray(normals, np.float32),
            tangents=np.asarray(tangents, np.float32),
            dense_weights=np.asarray(dense_weights, np.float32),
            character=character))
        for (s, c), mat in zip(submesh_ranges, materials_per_submesh):
            tris = np.asarray(indices[s:s + c]).reshape(-1, 3) + base
            self._sk_tri.append(tris.astype(np.int32))
            self._sk_tri_mat.append(np.full(len(tris), self._material_id(mat),
                                            np.int32))

    def build_arrays(self):
        """(numpy arrays with the reference's SceneGeometry fields, topology
        dict) — the host half of ``build``."""
        def cat(lists, empty_shape, dtype=np.float32):
            return np.concatenate(lists) if lists else np.zeros(empty_shape,
                                                                dtype)

        static_pos = cat(self._pos, (0, 3))
        n_static = len(static_pos)
        uv = np.concatenate([cat(self._uv, (0, 2)), cat(self._sk_uv, (0, 2))])
        inst = np.concatenate([cat(self._inst, (0,), np.int32),
                               cat(self._sk_inst, (0,), np.int32)])
        sk_tri = cat(self._sk_tri, (0, 3), np.int32)
        tri = np.concatenate([cat(self._tri, (0, 3), np.int32),
                              sk_tri + n_static]).astype(np.int32)
        tri_mat = np.concatenate([cat(self._tri_mat, (0,), np.int32),
                                  cat(self._sk_tri_mat, (0,), np.int32)])

        mats = self._materials
        k = max(len(mats), 1)

        def arr(fn, default, dtype=np.float32, dims=()):
            out = np.full((k, *dims), default, dtype)
            for i, mt in enumerate(mats):
                out[i] = fn(mt)
            return out

        def tex_col(j):
            return np.array([t[j] for t in self._mat_tex] or [-1], np.int32)

        table = dict(
            base_color=arr(lambda m: m.base_color_factor, 1.0, dims=(3,)),
            metallic=arr(lambda m: m.metallic_factor, 0.0),
            roughness=arr(lambda m: m.roughness_factor, 0.5),
            emissive=arr(lambda m: m.emissive_factor, 0.0, dims=(3,)),
            occlusion_strength=arr(lambda m: m.occlusion_strength, 1.0),
            alpha=arr(lambda m: m.alpha, 1.0),
            transmission=arr(lambda m: m.transmission_factor, 0.0),
            ior=arr(lambda m: m.ior, 1.5),
            unlit=arr(lambda m: m.unlit, False, bool),
            normal_scale=arr(lambda m: m.normal_scale, 1.0),
            exposure=arr(lambda m: m.exposure, 1.0),
            tone_mapped=arr(lambda m: m.tone_mapped, False, bool),
            base_tex=tex_col(0), normal_tex=tex_col(1), mr_tex=tex_col(2),
            emissive_tex=tex_col(3), occlusion_tex=tex_col(4))
        packed = np.zeros((k, 16), np.float32)
        packed[:, 0:3] = table["base_color"]
        packed[:, 3] = table["alpha"]
        packed[:, 4] = table["metallic"]
        packed[:, 5] = table["roughness"]
        packed[:, 6:9] = table["emissive"]
        packed[:, 9] = table["occlusion_strength"]
        packed[:, 10] = table["transmission"]
        packed[:, 11] = table["ior"]
        packed[:, 12] = table["normal_scale"]
        packed[:, 13] = table["base_tex"]
        packed[:, 14] = table["normal_tex"]
        packed[:, 15] = table["mr_tex"]
        table["packed"] = packed

        # Host BVH over the build pose (skinned verts at their stored pose).
        pos0 = np.concatenate([static_pos] +
                              [b["positions"] for b in self._skinned])
        t0, t1, t2 = pos0[tri[:, 0]], pos0[tri[:, 1]], pos0[tri[:, 2]]
        # The reference never walks this tree (visibility.py tests every
        # triangle); a Morton build replaces the port's native SAH build.
        topo = B.build_bvh_morton(np.minimum(np.minimum(t0, t1), t2),
                                  np.maximum(np.maximum(t0, t1), t2),
                                  leaf_size=LEAF)

        # Static translucency: alpha factor < 1, or a bound base texture
        # whose min alpha < 1.
        tex_data = self._tex_builder.build_np()
        trans_mat = table["alpha"] < 0.999
        if np.any(table["base_tex"] >= 0):
            amin = tex_data[..., 3].min(axis=(1, 2))
            has_tex = table["base_tex"] >= 0
            trans_mat = trans_mat | (
                has_tex & (amin[np.maximum(table["base_tex"], 0)] < 0.999))
        safe_mat = np.maximum(tri_mat, 0)
        tri_shade = np.concatenate([
            uv[tri[:, 0]], uv[tri[:, 1]], uv[tri[:, 2]],
            safe_mat[:, None].astype(np.float32),
            table["unlit"][safe_mat].astype(np.float32)[:, None],
        ], axis=1).astype(np.float32)
        arrays = dict(
            static_pos=static_pos, static_nrm=cat(self._nrm, (0, 3)),
            static_tan=cat(self._tan, (0, 4)), vert_instance=inst, uv=uv,
            tri=tri, tri_material=tri_mat, materials=table,
            textures=tex_data, skinned_blocks=self._skinned,
            n_static_verts=n_static, tri_translucent=trans_mat[safe_mat],
            tri_shade=tri_shade)
        return arrays, topo

    def build(self, device="cuda") -> SceneGeometry:
        """The packed geometry on ``device`` (the card unless asked
        otherwise)."""
        device = resolve_device(device)
        arrays, topo = self.build_arrays()
        return pack_scene(arrays, topo, device)


class FrameGeometry(NamedTuple):
    """Per-frame world-space arrays + refit BVH."""

    pos: torch.Tensor      # (V,3) world
    nrm: torch.Tensor      # (V,3)
    tan: torch.Tensor      # (V,4) world xyz + sign
    bvh: B.BVHArrays
    tri_nrm: torch.Tensor  # (T,3) unit geometric face normal


def flatten_frame(geo: SceneGeometry, instance_transforms,
                  palettes) -> FrameGeometry:
    """World-space geometry for one frame.

    instance_transforms (E,4,4) model matrices; palettes (C,B,4,4) final
    skinning palettes per character slot, used as given."""
    pos, nrm, tan = [geo.static_pos], [geo.static_nrm], [geo.static_tan]
    for blk in geo.skinned_blocks:
        out = skin_vertices(blk["dense_weights"], palettes[blk["character"]],
                            blk["positions"], blk["normals"], blk["tangents"])
        pos.append(out["positions"])
        nrm.append(out["normals"])
        tan.append(out["tangents"])
    pos, nrm, tan = torch.cat(pos), torch.cat(nrm), torch.cat(tan)

    m = instance_transforms[geo.vert_instance]        # (V,4,4)
    rot = m[:, :3, :3]
    pos_w = (rot * pos[:, None, :]).sum(-1) + m[:, :3, 3]
    nrm_w = (rot * nrm[:, None, :]).sum(-1)
    tan_w = torch.cat([(rot * tan[:, None, :3]).sum(-1), tan[:, 3:]], -1)

    v0, v1, v2 = pos_w[geo.tri[:, 0]], pos_w[geo.tri[:, 1]], pos_w[geo.tri[:, 2]]
    bvh = B.refit(geo.topo, v0, v1, v2, translucent=geo.tri_translucent)
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    fn = fn / torch.clamp(torch.linalg.vector_norm(fn, dim=-1, keepdim=True),
                          min=1e-20)
    return FrameGeometry(pos=pos_w, nrm=nrm_w, tan=tan_w, bvh=bvh, tri_nrm=fn)
