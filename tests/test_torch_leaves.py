"""PyTorch port, render leaves vs the JAX reference on seeded inputs (CPU).

Each case feeds the same numpy inputs to a JAX function and to its port and
compares. Tolerance: both evaluate the same float32 formulas, so results
agree to float32 rounding; only the order of the few-term sums inside dot
products and matrix-vector products differs between XLA and PyTorch, which
moves values by a few ulp. 1e-5 relative (plus 1e-6 absolute for values
near 0) covers that and nothing more; integer and uint8 outputs must be
equal.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from swift_game_engine_tpu.anim import skinning as j_skin
from swift_game_engine_tpu.render import camera as j_cam
from swift_game_engine_tpu.render import composite as j_comp
from swift_game_engine_tpu.render import ibl as j_ibl
from swift_game_engine_tpu.render import shading as j_sh
from swift_game_engine_tpu.render import textures as j_tex
from swift_game_engine_tpu_torch.anim import skinning as p_skin
from swift_game_engine_tpu_torch.render import camera as p_cam
from swift_game_engine_tpu_torch.render import composite as p_comp
from swift_game_engine_tpu_torch.render import ibl as p_ibl
from swift_game_engine_tpu_torch.render import shading as p_sh
from swift_game_engine_tpu_torch.render import textures as p_tex
from torch_threads import one_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6


def close(jax_out, port_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port_out), np.asarray(jax_out),
                               rtol=rtol, atol=atol)


def unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("width,height", [(96, 54), (130, 40)])
def test_rays_tiled_and_untile(width, height):
    cam = j_cam.Camera()
    cam.position = np.array([1.0, 4.0, 10.0], np.float32)
    cam.target = np.array([0.0, 1.0, -2.0], np.float32)
    ivp = cam.inv_view_proj(width, height)
    jo, jd, jpx, jpy = j_cam.generate_rays_tiled(ivp, cam.position, width,
                                                 height)
    po, pd, ppx, ppy = p_cam.generate_rays_tiled(torch.as_tensor(ivp),
                                                 cam.position, width, height)
    close(jo, po)
    # unit directions from a 4x4 matmul whose summation order differs
    # between XLA and PyTorch: 1e-5 relative to the vector's norm
    close(jd, pd, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jpx), ppx.numpy())
    np.testing.assert_array_equal(np.asarray(jpy), ppy.numpy())
    flat = np.random.default_rng(0).normal(
        size=(jd.shape[0], 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(j_cam.untile_image(jnp.asarray(flat), width, height)),
        p_cam.untile_image(torch.as_tensor(flat), width, height).numpy())


def test_camera_matrices_match():
    jc, pc = j_cam.Camera(), p_cam.Camera()
    for c in (jc, pc):
        c.position = np.array([3.0, 2.0, 9.0], np.float32)
        c.target = np.array([-1.0, 0.5, 0.0], np.float32)
    np.testing.assert_array_equal(jc.inv_view_proj(96, 54),
                                  pc.inv_view_proj(96, 54))
    np.testing.assert_array_equal(jc.view_proj(96, 54), pc.view_proj(96, 54))


def _shading_case(name, rng, n=512):
    n_ = unit(rng, n)
    v = unit(rng, n)
    l = unit(rng, n)
    base = rng.random((n, 3)).astype(np.float32)
    met = rng.random(n).astype(np.float32)
    rough = rng.uniform(0.05, 1.0, n).astype(np.float32)
    cos = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    if name == "eval_brdf":
        return (n_, v, l, base, met, rough)
    if name == "fresnel_schlick":
        return (cos, rng.random(n).astype(np.float32))
    if name == "fresnel_schlick3":
        return (cos, base)
    if name == "shadow_bias":
        return (rng.uniform(0.0, 50.0, n).astype(np.float32),)
    if name == "tone_map_aces":
        return (rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32),)
    if name == "hash12":
        return (rng.integers(0, 2000, (n, 2)).astype(np.float32),)
    if name == "apply_normal_map":
        tan = unit(rng, n)
        return (n_, v, tan, np.sign(rng.normal(size=n)).astype(np.float32),
                rng.random((n, 3)).astype(np.float32),
                rng.uniform(0.5, 6.0, n).astype(np.float32), l)
    if name == "reflect":
        return (v, n_)
    return (v, n_, rng.uniform(0.5, 1.6, n).astype(np.float32))  # refract


@pytest.mark.parametrize("name", [
    "eval_brdf", "fresnel_schlick", "fresnel_schlick3", "shadow_bias",
    "tone_map_aces", "hash12", "apply_normal_map", "reflect", "refract"])
def test_shading_functions(name):
    args = _shading_case(name, np.random.default_rng(1))
    ja = [jnp.asarray(a) for a in args]
    pa = [torch.as_tensor(a) for a in args]
    # hash12's fract of sums near 33.33 keeps ~5 decimal digits
    atol = 1e-5 if name == "hash12" else ATOL
    close(getattr(j_sh, name)(*ja), getattr(p_sh, name)(*pa), atol=atol)


def test_ibl_lut_and_sh():
    np.testing.assert_array_equal(j_ibl.integrate_brdf_lut(),
                                  p_ibl.integrate_brdf_lut())
    jsh0, jsh1 = j_ibl.hemisphere_sh()
    psh0, psh1 = p_ibl.hemisphere_sh()
    close(jsh0, psh0)
    close(jsh1, psh1)
    n = unit(np.random.default_rng(2), 256)
    close(j_ibl.eval_env_sh(jnp.asarray(n), jsh0, jsh1),
          p_ibl.eval_env_sh(torch.as_tensor(n), psh0, psh1))


def test_ibl_env_and_specular():
    rng = np.random.default_rng(3)
    n, v = unit(rng, 512), unit(rng, 512)
    rough = rng.uniform(0.05, 1.0, 512).astype(np.float32)
    met = rng.random(512).astype(np.float32)
    base = rng.random((512, 3)).astype(np.float32)
    lut = j_ibl.integrate_brdf_lut()
    close(j_ibl.sample_env(jnp.asarray(v), jnp.asarray(rough)),
          p_ibl.sample_env(torch.as_tensor(v), torch.as_tensor(rough)))
    close(j_ibl.sample_brdf_lut(jnp.asarray(lut), jnp.asarray(rough),
                                jnp.asarray(met)),
          p_ibl.sample_brdf_lut(torch.as_tensor(lut), torch.as_tensor(rough),
                                torch.as_tensor(met)))
    close(j_ibl.eval_spec_ibl(jnp.asarray(n), jnp.asarray(v), jnp.asarray(rough),
                              jnp.asarray(met), jnp.asarray(base),
                              jnp.asarray(lut)),
          p_ibl.eval_spec_ibl(torch.as_tensor(n), torch.as_tensor(v),
                              torch.as_tensor(rough), torch.as_tensor(met),
                              torch.as_tensor(base), torch.as_tensor(lut)))


def test_composite_frame():
    """Against the reference formula evaluated op by op: under jit, XLA
    fuses the hash dither's multiply-adds, which moves fract() across 1 at
    a few pixels (one 1/255 dither step); op by op the two agree."""
    img = np.random.default_rng(4).uniform(0, 3, (54, 96, 3)).astype(
        np.float32)
    with jax.disable_jit():
        ref = j_comp.composite_frame(jnp.asarray(img), 0.8, True)
    close(ref, p_comp.composite_frame(torch.as_tensor(img), 0.8, True))


@pytest.mark.parametrize("fps", [-1, 0, 7, 42, 123, 999, 4000])
def test_overlay_blit(fps):
    u8 = np.random.default_rng(5).integers(0, 256, (54, 96, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        np.asarray(j_comp.overlay_blit_device(jnp.asarray(u8), fps)),
        p_comp.overlay_blit_device(torch.as_tensor(u8), fps).numpy())


def test_skin_vertices():
    rng = np.random.default_rng(6)
    v, b = 300, 7
    w = rng.random((v, b)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    pal = rng.normal(size=(b, 4, 4)).astype(np.float32)
    pal[:, 3] = [0, 0, 0, 1]
    pos = rng.normal(size=(v, 3)).astype(np.float32)
    nrm = unit(rng, v)
    tan = np.concatenate([unit(rng, v), np.sign(rng.normal(size=(v, 1)))],
                         1).astype(np.float32)
    jo = j_skin.skin_vertices(*(jnp.asarray(x) for x in (w, pal, pos, nrm,
                                                         tan)))
    po = p_skin.skin_vertices(*(torch.as_tensor(x) for x in (w, pal, pos, nrm,
                                                             tan)))
    for k in ("positions", "normals", "tangents"):
        close(jo[k], po[k], atol=1e-5)


def test_sample_bilinear():
    rng = np.random.default_rng(7)
    data = rng.random((3, 16, 16, 4)).astype(np.float32)
    ids = rng.integers(-1, 3, 400).astype(np.int32)
    uv = rng.uniform(-0.2, 1.2, (400, 2)).astype(np.float32)
    default = np.array([0.5, 0.5, 1.0, 1.0], np.float32)
    close(j_tex.sample_bilinear(j_tex.TextureBank(jnp.asarray(data), 16),
                                jnp.asarray(ids), jnp.asarray(uv),
                                jnp.asarray(default)),
          p_tex.sample_bilinear(p_tex.TextureBank(torch.as_tensor(data), 16),
                                torch.as_tensor(ids).long(),
                                torch.as_tensor(uv), torch.as_tensor(default)))
