"""PyTorch port, scene packing and per-frame geometry vs the JAX reference.

The same items — procedural meshes (one textured, one translucent), a
skinned procedural body and a triangle range of assets/17-Cheese.static.json
— go through the reference's RenderGeometryBuilder and the port's. Both
run the same numpy code and the same native SAH builder, so every packed
array, the BVH topology included, must be identical. flatten_frame (LBS
skinning, instancing, refit, kernel rows) is compared at 1e-5 relative:
the per-vertex 3x3 products sum in another order in XLA and PyTorch.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swift_game_engine_tpu.assets import procedural_meshes as pm
from swift_game_engine_tpu.assets import procedural_textures as pt
from swift_game_engine_tpu.assets.materials import Material
from swift_game_engine_tpu.assets.skinned_mesh import dense_weight_matrix
from swift_game_engine_tpu.assets.static_mesh import load_static_mesh
from swift_game_engine_tpu.render import scene_geometry as j_sg
from swift_game_engine_tpu_torch import interop
from swift_game_engine_tpu_torch.render import scene_geometry as p_sg
from torch_threads import one_thread  # noqa: E402,F401

CHEESE = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "17-Cheese.static.json")


def _fill(b):
    part = load_static_mesh(CHEESE).parts[0]
    b.add_static_mesh(pm.plane(40.0), Material(
        name="ground", base_color_factor=(0.5, 0.5, 0.5),
        base_color_texture=pt.checkerboard(16, 16, 4)), instance=0)
    b.add_static_mesh(part.mesh, Material(name="cheese", roughness_factor=0.3),
                      instance=1, tri_range=(0, 3 * 1500))
    b.add_static_mesh(pm.capsule(1.5, 1.0), Material(
        name="hull", alpha=0.25, unlit=True), instance=2)
    body = pm.humanoid_skinned()
    nb = int(body.joints.max()) + 1
    b.add_skinned_mesh(body.positions, body.normals, body.uvs, body.indices,
                       dense_weight_matrix(body.joints, body.weights, nb),
                       [Material(name="body")], [(0, len(body.indices))],
                       instance=3, character=0)
    return nb


@pytest.fixture(scope="module")
def scenes():
    jb = j_sg.RenderGeometryBuilder(texture_size=16)
    nb = _fill(jb)
    pb = p_sg.RenderGeometryBuilder(texture_size=16)
    _fill(pb)
    rng = np.random.default_rng(11)
    tf = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for i in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        # The cheese (instance 1) has triangles 1e-3 wide at coordinates ~5:
        # a rotation's ulp-level differences would move their normals by
        # 1e-4. Unrotated, its world positions are bit-equal in both.
        tf[i, :3, :3] = np.eye(3) if i == 1 else q
        tf[i, :3, 3] = rng.uniform(-5, 5, 3)
    pal = np.tile(np.eye(4, dtype=np.float32), (1, nb, 1, 1))
    pal[0, :, :3, 3] = rng.uniform(-0.3, 0.3, (nb, 3))
    return jb.build(), pb.build(device="cpu"), tf, pal


def _arrays(geo):
    m = geo.materials
    topo = geo.topo
    return {
        "vertices": [geo.static_pos, geo.static_nrm, geo.static_tan, geo.uv,
                     geo.vert_instance],
        "triangles": [geo.tri, geo.tri_material, geo.tri_shade],
        "materials": [getattr(m, k) for k in type(m)._fields],
        "textures": [geo.textures.data],
        "translucency": [geo.tri_translucent],
        "topology": [topo.skip, topo.first_tri, topo.tri_count, topo.left,
                     topo.right, topo.tri_order, topo.leaf_slots,
                     *topo.levels],
        "skinned": [b[k] for b in geo.skinned_blocks
                    for k in ("positions", "normals", "tangents",
                              "dense_weights")],
    }


@pytest.mark.parametrize("group", ["vertices", "triangles", "materials",
                                   "textures", "translucency", "topology",
                                   "skinned"])
def test_builder_arrays_identical(scenes, group):
    jgeo, pgeo, _, _ = scenes
    ja, pa = _arrays(jgeo)[group], _arrays(pgeo)[group]
    assert len(ja) == len(pa)
    for a, b in zip(ja, pa):
        np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())
    if group == "topology":
        assert len(jgeo.topo.levels) == len(pgeo.topo.levels)


def test_usage_and_partition(scenes):
    jgeo, pgeo, _, _ = scenes
    assert tuple(j_sg.texture_usage(jgeo)) == tuple(pgeo.usage)
    tr = np.asarray(jgeo.tri_translucent)
    np.testing.assert_array_equal(np.nonzero(tr)[0],
                                  pgeo.translucent_idx.numpy())
    np.testing.assert_array_equal(np.nonzero(~tr)[0], pgeo.opaque_idx.numpy())


def test_interop_scene_matches_port_build(scenes):
    jgeo, pgeo, _, _ = scenes
    via = interop.scene_geometry(jgeo, device="cpu")
    for group, arrs in _arrays(via).items():
        for a, b in zip(arrs, _arrays(pgeo)[group]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert via.usage == pgeo.usage


def test_interop_needs_a_device_without_cuda(scenes, monkeypatch):
    """interop defaults to the card like every entry point: where CUDA is
    absent, a call that names no device raises instead of running on the
    CPU."""
    from swift_game_engine_tpu_torch.render.rt import DirectionalLights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jgeo, _, tf, pal = scenes
    jfg = j_sg.flatten_frame(jgeo, jnp.asarray(tf), jnp.asarray(pal))
    lights = {k: np.zeros((1, 3), np.float32)
              for k in DirectionalLights._fields}
    tables = {"sh0": np.zeros(3, np.float32),
              "sh1": np.zeros((3, 3), np.float32),
              "brdf_lut": np.zeros((8, 8, 2), np.float32), "env_mip_count": 1}
    for call in (lambda: interop.scene_geometry(jgeo),
                 lambda: interop.frame_geometry(jfg),
                 lambda: interop.lights(lights),
                 lambda: interop.ibl(tables)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert interop.lights(lights, device="cpu").direction.device.type == \
        "cpu"


@pytest.fixture(scope="module")
def frames(scenes):
    jgeo, pgeo, tf, pal = scenes
    jfg = j_sg.flatten_frame(jgeo, jnp.asarray(tf), jnp.asarray(pal))
    pfg = p_sg.flatten_frame(pgeo, torch.as_tensor(tf), torch.as_tensor(pal))
    return interop.frame_geometry(jfg, device="cpu"), pfg


@pytest.mark.parametrize("field", ["pos", "nrm", "tan", "tri_nrm"])
def test_flatten_frame(frames, field):
    jfg, pfg = frames
    a, b = getattr(pfg, field).numpy(), getattr(jfg, field).numpy()
    if field == "tri_nrm":
        # A unit face normal carries the cross product's rounding divided by
        # sin(angle between the edges): XLA contracts the cross product's
        # multiply-adds and PyTorch does not, so only triangles with
        # sin > 1e-2 (all but a few slivers) have normals defined to 1e-5.
        v0, v1, v2 = (getattr(jfg.bvh, k).numpy() for k in ("v0", "v1", "v2"))
        e1, e2 = v1 - v0, v2 - v0
        sin = np.linalg.norm(np.cross(e1, e2), axis=-1) / np.maximum(
            np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1), 1e-30)
        well = sin > 1e-2
        assert well.mean() > 0.95
        a, b = a[well], b[well]
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("field", ["bmin", "bmax", "rows"])
def test_refit_and_pack_bvh(frames, field):
    jfg, pfg = frames
    np.testing.assert_allclose(getattr(pfg.bvh, field).numpy(),
                               getattr(jfg.bvh, field).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pfg.bvh.slot_tri.numpy(),
                                  jfg.bvh.slot_tri.numpy())
