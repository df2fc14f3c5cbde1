"""PyTorch port, the traced-path kernels' plain twins vs the JAX reference
(CPU). Each CUDA kernel is held against its twin on the card by
tests/test_torch_cuda_kernels.py.

The JAX traversal kernels read their packet size and variant knobs when
ops/rt_kernel.py is imported, so every JAX run happens in a subprocess of
its own with SGE_RT_BLOCK=1024, in Pallas interpret mode (as
tests/test_layered_kernel.py and tests/test_shadow_kernel.py run them), and
hands its tree rows and records back as an .npz. The port's twin then runs
on the same rows here.

  * K5's twins vs trace_layers_so on the 250-triangle soup of
    test_layered_kernel.py, 512 rays from one origin, n_slots 1..3: the
    wide twin (trace_layers_so_plain, over the wide tree rebuilt from the
    reference's packed rows) and the binary twin (trace_layers_so_binary).
    The TPU kernel orders a packet's children by the packet's nearest entry
    and the twins by the ray's own, so a ray may meet its hits in another
    order. What the layer chain reads agrees: the nearest opaque hit (once
    a ray's n_slots translucent slots are full in front of it, the walk may
    or may not have met the opaque hit behind them, and the chain never
    reads it: such a lane counts as "no opaque hit"), t to 1e-5, and the
    translucent slots in front of it as sets.
  * K7's twins vs trace_shadow_factor on the 400-triangle soup of
    test_shadow_kernel.py, 256 origins, an eighth of them inactive,
    n_slots 1..4. The binary twin (trace_shadow_factor_binary) follows the
    same skip links per lane, so the records are equal (ids exactly), t to
    1e-5. The wide twin (trace_shadow_factor_plain) walks near-first, so it
    fills the slots behind the opaque hit otherwise; what
    _apply_shadow_records reads agrees (``_shadow_view``: the slots in
    front of the opaque hit as sets, the opaque t while slots remain), and
    so does the shadow factor it computes from them, to 1e-6.
  * The wide twins' records at a lane do not depend on the call's other
    lanes, and inactive lanes hold t_opq 0 and empty slots.
  * build_origin_rows / build_shadow_rows (and binary_header, the binary
    tree's header beside them) vs the reference's, ids exactly.
    The reference's XLA CPU build contracts each cross product's
    a*b - c*d into one fused multiply-add where the port rounds both
    products, so constants differ in their last bits: the origin rows agree
    to 1e-6 of their largest entry; the shadow rows divide by the
    triangle's determinant along the light, which magnifies those bits for
    nearly edge-on triangles, so they agree to 1e-6 of the largest entry on
    99.9% of entries and to 1e-4 relative on all.
  * K4 twin (trace_rays_plain, the 4-wide walk over the wide nodes rebuilt
    from the reference's packed rows) vs trace_rays_pallas under each
    sibling kernel's knobs: the default ordered walk (_kernel_smem_ordered),
    SGE_RT_ORDERED=0 (_kernel_smem), SGE_RT_INTERVAL=1
    (_kernel_smem_interval), SGE_RT_DUAL=1 (_kernel_smem_ordered2) and
    SGE_RT_SMEM=0 (_kernel): triangle ids on >= 99.9% of rays (equal-t
    ties), t to 1e-5 where they agree.
"""

import os
import subprocess
import sys

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from swift_game_engine_tpu_torch.ops import rt_kernel as RK
from swift_game_engine_tpu_torch.render import rt as p_rt
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(__file__), "..")
BIG = 3.0e38

SOUP = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["SGE_RT_BLOCK"] = "1024"
import numpy as np
import jax.numpy as jnp
from swift_game_engine_tpu.render import bvh as B
from swift_game_engine_tpu.ops import rt_kernel as K


def soup(seed, t, spread, frac):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    v1 = base + rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    v2 = base + rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    translucent = rng.random(t) < frac
    topo = B.build_bvh(np.minimum(np.minimum(base, v1), v2),
                       np.maximum(np.maximum(base, v1), v2))
    bvh = B.refit(topo, jnp.asarray(base), jnp.asarray(v1), jnp.asarray(v2),
                  translucent=jnp.asarray(translucent))
    return rng, K.pack_bvh(bvh, translucent=jnp.asarray(translucent))
"""

K5_CODE = SOUP + r"""
rng, kb = soup(7, 250, 8.0, 0.4)
o = np.array([0.0, 1.0, 20.0], np.float32)
targets = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
d = targets - o
d /= np.linalg.norm(d, axis=1, keepdims=True)
so = K.build_origin_rows(kb.rows, o)
out = dict(rows=np.asarray(kb.rows), o=o, d=d, header=np.asarray(so[0]),
           srows=np.asarray(so[1]))
for s in (1, 2, 3):
    r = K.trace_layers_so(so, o, jnp.asarray(d),
                          jnp.full((512,), K.BIG, jnp.float32), n_slots=s,
                          interpret=True)
    for name, x in zip(("t_opq", "tri", "ts", "ids"), r):
        out[f"{name}{s}"] = np.asarray(x)
np.savez(sys.argv[1], **out)
"""

K7_CODE = SOUP + r"""
rng, kb = soup(7, 400, 10.0, 0.5)
l = np.array([0.3, 0.8, -0.2], np.float32)
l /= np.linalg.norm(l)
sr = K.build_shadow_rows(kb.rows, jnp.asarray(l))
o = rng.uniform(-12, 12, (256, 3)).astype(np.float32)
t_lim = np.full(256, 60.0, np.float32)
t_lim[: 256 // 8] = 0.0
out = dict(rows=np.asarray(kb.rows), l=l, o=o, t_lim=t_lim,
           header=np.asarray(sr[0]), srows=np.asarray(sr[1]))
for s in (1, 2, 3, 4):
    r = K.trace_shadow_factor(sr, jnp.asarray(l), jnp.asarray(o),
                              jnp.asarray(t_lim), n_slots=s, interpret=True)
    for name, x in zip(("t_opq", "ts", "ids"), r):
        out[f"{name}{s}"] = np.asarray(x)
np.savez(sys.argv[1], **out)
"""

K4_CODE = SOUP + r"""
rng, kb = soup(5, 300, 8.0, 0.3)
o = rng.uniform(-10, 10, (512, 3)).astype(np.float32)
d = rng.normal(size=(512, 3)).astype(np.float32)
d /= np.linalg.norm(d, axis=-1, keepdims=True)
t_max = np.full(512, 1e6, np.float32)
t_max[::17] = 0.0
t, tri = K.trace_rays_pallas(kb, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t_max), interpret=True)
np.savez(sys.argv[1], rows=np.asarray(kb.rows), o=o, d=d, t_max=t_max,
         t=np.asarray(t), tri=np.asarray(tri))
"""


def _reference(tmp_path_factory, code, name, env=None):
    out = str(tmp_path_factory.mktemp("ref") / f"{name}.npz")
    full_env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    full_env.update(env or {})
    proc = subprocess.run([sys.executable, "-c", code, out], cwd=REPO,
                          env=full_env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rows_match(got, ref, share=1.0):
    """Id columns exactly; constants equal to 1e-6 of their scale on
    ``share`` of the entries and to 1e-4 relative on all."""
    got = got.numpy()
    n_ids = RK.SLOT_N
    np.testing.assert_array_equal(got[:, -n_ids:], ref[:, -n_ids:])
    g, r = got[:, :-n_ids], ref[:, :-n_ids]
    close = np.abs(g - r) <= 1e-6 * np.abs(r) + 1e-6 * np.abs(r).max()
    assert close.mean() >= share, close.mean()
    np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6 * np.abs(r).max())


# --------------------------------------------------------------------- K5


@pytest.fixture(scope="module")
def k5(tmp_path_factory):
    return _reference(tmp_path_factory, K5_CODE, "k5")


def _layer_view(t_opq, tri, ts, ids):
    """What the layer chain reads of a K5 record: the opaque hit unless the
    slots are full in front of it, and the translucent slots in front of
    the opaque hit, sorted."""
    full = (ids >= 0).all(1) & (ts[:, -1] < t_opq)
    t_eff = np.where(full, BIG, t_opq)
    tri_eff = np.where(full, -1, tri)
    front = np.where((ids >= 0) & (ts < t_eff[:, None]), ts, BIG)
    order = np.argsort(front, 1, kind="stable")
    return (t_eff, tri_eff, np.take_along_axis(front, order, 1),
            np.take_along_axis(np.where(front < BIG, ids, -1.0), order, 1))


def test_build_origin_rows_matches_reference(k5):
    srows = RK.build_origin_rows(_t(k5["rows"]), _t(k5["o"]))
    np.testing.assert_array_equal(RK.binary_header(_t(k5["rows"])).numpy(),
                                  k5["header"])
    _rows_match(srows, k5["srows"])


def _layers_agree(got, ref):
    gt, gtri, gts, gids = _layer_view(*[x.numpy() for x in got])
    rt, rtri, rts, rids = _layer_view(*ref)
    np.testing.assert_array_equal(gtri, rtri)
    np.testing.assert_allclose(gt, rt, rtol=1e-5)
    np.testing.assert_array_equal(gids, rids)
    np.testing.assert_allclose(gts, rts, rtol=1e-5)
    assert (rtri >= 0).sum() > 50 and (rids[:, 0] >= 0).sum() > 50


@pytest.mark.parametrize("n_slots", [1, 2, 3])
def test_k5_twin_matches_reference(k5, n_slots):
    rows = _t(k5["rows"])
    srows = RK.build_origin_rows(rows, _t(k5["o"]))
    got = RK.trace_layers_so(RK.wide_tree(rows), srows, _t(k5["o"]),
                             _t(k5["d"]), torch.full((512,), BIG),
                             n_slots=n_slots)
    _layers_agree(got, [k5[f"{k}{n_slots}"]
                        for k in ("t_opq", "tri", "ts", "ids")])


@pytest.mark.parametrize("n_slots", [1, 2, 3])
def test_k5_binary_twin_matches_reference(k5, n_slots):
    rows = _t(k5["rows"])
    so = (RK.binary_header(rows), RK.build_origin_rows(rows, _t(k5["o"])))
    got = RK.trace_layers_so_binary(so, _t(k5["o"]), _t(k5["d"]),
                                    torch.full((512,), BIG), n_slots=n_slots)
    _layers_agree(got, [k5[f"{k}{n_slots}"]
                        for k in ("t_opq", "tri", "ts", "ids")])


# --------------------------------------------------------------------- K7


@pytest.fixture(scope="module")
def k7(tmp_path_factory):
    return _reference(tmp_path_factory, K7_CODE, "k7")


def test_build_shadow_rows_matches_reference(k7):
    srows = RK.build_shadow_rows(_t(k7["rows"]), _t(k7["l"]))
    np.testing.assert_array_equal(RK.binary_header(_t(k7["rows"])).numpy(),
                                  k7["header"])
    _rows_match(srows, k7["srows"], share=0.999)


@pytest.mark.parametrize("n_slots", [1, 2, 3, 4])
def test_k7_twin_matches_reference(k7, n_slots):
    rows = _t(k7["rows"])
    sr = (RK.binary_header(rows), RK.build_shadow_rows(rows, _t(k7["l"])))
    t_opq, ts, ids = RK.trace_shadow_factor_binary(
        sr, _t(k7["l"]), _t(k7["o"]), _t(k7["t_lim"]), n_slots=n_slots)
    np.testing.assert_array_equal(ids.numpy(), k7[f"ids{n_slots}"])
    np.testing.assert_allclose(t_opq.numpy(), k7[f"t_opq{n_slots}"],
                               rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), k7[f"ts{n_slots}"], rtol=1e-5)
    inactive = k7["t_lim"] <= 0
    assert (t_opq.numpy()[inactive] == 0).all()
    assert ((ids.numpy() >= 0).any(1).sum() > 20 and
            (t_opq.numpy() < 1e30).sum() > 20)


def _shadow_view(t_opq, ts, ids):
    """What _apply_shadow_records reads of a K7 record: the translucent
    slots in front of the opaque hit, sorted by (t, id) (ties at equal t
    as sets), and the opaque t unless every slot lies in front of it."""
    front = (ids >= 0) & (ts < t_opq[:, None])
    t_eff = np.where(front.all(1), BIG, t_opq)
    f_ts, f_ids = np.where(front, ts, BIG), np.where(front, ids, -1.0)
    order = np.lexsort((f_ids, f_ts))
    return (t_eff, np.take_along_axis(f_ts, order, 1),
            np.take_along_axis(f_ids, order, 1))


def _shadow_factor(t_opq, ts, ids, t_lim, alpha):
    """The shadow factor that render/rt.py's _apply_shadow_records computes
    from K7 records, with ``alpha`` per triangle id carried in the ids (its
    alpha-payload form, id -> 2 + alpha) and the t limit as the light's
    range."""
    tri = np.floor(np.maximum(ids, 0)).astype(np.int64)
    payload = np.where(ids >= 0, 2.0 + alpha[tri], -1.0).astype(np.float32)
    fr = SimpleNamespace(shadow_layers=ids.shape[1])
    return p_rt._apply_shadow_records(
        fr, torch.zeros((len(t_opq), 3)), None, _t(t_opq), _t(ts),
        _t(payload), _t(t_lim > 0), _t(t_lim), True).numpy()


@pytest.mark.parametrize("n_slots", [1, 2, 3, 4])
def test_k7_wide_twin_matches_reference(k7, n_slots):
    rows = _t(k7["rows"])
    srows = RK.build_shadow_rows(rows, _t(k7["l"]))
    got = [x.numpy() for x in RK.trace_shadow_factor(
        RK.wide_tree(rows), srows, _t(k7["l"]), _t(k7["o"]),
        _t(k7["t_lim"]), n_slots=n_slots)]
    ref = [k7[f"{k}{n_slots}"] for k in ("t_opq", "ts", "ids")]
    g_opq, g_ts, g_ids = _shadow_view(*got)
    r_opq, r_ts, r_ids = _shadow_view(*ref)
    np.testing.assert_array_equal(g_ids, r_ids)
    np.testing.assert_allclose(g_opq, r_opq, rtol=1e-5)
    np.testing.assert_allclose(g_ts, r_ts, rtol=1e-5)
    assert (got[0][k7["t_lim"] <= 0] == 0).all()
    alpha = np.random.default_rng(3).uniform(0.1, 0.9, 400)
    f_got = _shadow_factor(*got, k7["t_lim"], alpha)
    f_ref = _shadow_factor(*ref, k7["t_lim"], alpha)
    np.testing.assert_allclose(f_got, f_ref, rtol=0, atol=1e-6)
    assert ((f_ref > 0) & (f_ref < 1)).sum() > 20 and (f_ref == 0).sum() > 20


# ------------------------------------------------ K5, K7: lanes stand alone


@pytest.mark.parametrize("kernel", ["K5", "K7"])
def test_wide_twins_lanes_are_independent(request, kernel):
    """A lane's records do not depend on the call's other lanes, so a
    call's records at a subset of its lanes equal the twin's on that subset
    alone (as chip_smoke.py compares the kernels); inactive lanes hold
    t_opq 0 and empty slots."""
    ref = request.getfixturevalue(kernel.lower())
    rows = _t(ref["rows"])
    tree = RK.wide_tree(rows)
    if kernel == "K5":
        srows = RK.build_origin_rows(rows, _t(ref["o"]))
        lim = torch.full((512,), BIG)
        lim[::5] = 0.0                                    # inactive rays

        def run(lanes):
            return RK.trace_layers_so_plain(tree, srows, _t(ref["o"]),
                                            _t(ref["d"])[lanes], lim[lanes],
                                            3)
    else:
        srows = RK.build_shadow_rows(rows, _t(ref["l"]))
        lim = _t(ref["t_lim"])

        def run(lanes):
            return RK.trace_shadow_factor_plain(tree, srows, _t(ref["l"]),
                                                _t(ref["o"])[lanes],
                                                lim[lanes], 4)
    n = lim.shape[0]
    every = run(torch.arange(n))
    sub = torch.arange(1, n, 3)
    for a, b in zip(every, run(sub)):
        assert torch.equal(a[sub], b)
    dead = lim <= 0
    assert int(dead.sum()) > 20
    assert bool((every[0][dead] == 0).all())
    assert bool((every[-2][dead] == BIG).all() and
                (every[-1][dead] == -1).all())
    if kernel == "K5":
        assert bool((every[1][dead] == -1).all())
    assert int((every[-1][~dead] >= 0).any(1).sum()) > 20


# --------------------------------------------------------------------- K4


@pytest.mark.parametrize("knobs", [
    {},                                  # _kernel_smem_ordered
    {"SGE_RT_ORDERED": "0"},             # _kernel_smem
    {"SGE_RT_INTERVAL": "1"},            # _kernel_smem_interval
    {"SGE_RT_DUAL": "1"},                # _kernel_smem_ordered2
    {"SGE_RT_SMEM": "0"},                # _kernel
], ids=["ordered", "skip_link", "interval", "dual", "vmem"])
def test_k4_twin_matches_sibling_kernels(tmp_path_factory, knobs):
    ref = _reference(tmp_path_factory, K4_CODE, "k4", knobs)
    rows = _t(ref["rows"])
    t, tri = RK.trace_rays(RK.wide_tree(rows), rows, _t(ref["o"]),
                           _t(ref["d"]), _t(ref["t_max"]))
    same = tri.numpy() == ref["tri"]
    assert same.mean() >= 0.999, same.mean()
    assert (ref["tri"] >= 0).sum() > 50
    hit = same & (ref["tri"] >= 0)
    np.testing.assert_allclose(t.numpy()[hit], ref["t"][hit], rtol=1e-5)
