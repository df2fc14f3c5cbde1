"""A synthetic YBot rig in the reference's own file schemas (numpy only).

The repository holds the YBot skin (``assets/YBot.skinned.json``) but not
the skeleton and the five motion profiles the reference's posed player
reads. ``write_rig(dir)`` writes them, so that the loaders
(``load_skeleton``, ``load_motion_profile``) of both packages read them and
``build_demo_scene(dir)`` builds the posed DemoScene:

  * ``YBot.skeleton.json``: the skin's 52 bone names (mixamo, Hips first),
    unitScale 0.026, rig profile "mixamo" (so pelvis and spine1..3 resolve),
    root rule "keep". Each bone's parent is the nearest earlier bone by
    bind-model origin; its raw translation and ``preRotationDegrees`` come
    from the skin's own ``inverseBindMatrix`` entries (the bone's bind-local
    transform, decomposed as T(t) Rz Ry Rx), so the rest pose is the skin's
    bind pose and the palette at rest is the identity within f32;
  * five ``*.motionProfile.json`` files (Idle, Walking, Running,
    FallingIdle, StandingDodgeBackward): order 4, sample_fps 60, seeded
    rotation coefficients of a few degrees on every bone, translation
    channels on the root around its rest translation, distinct cycles (one
    rotation axis with a dangling a_k coefficient, which packing drops);
  * links (or copies) of the repository's other asset files.

It imports neither jax nor torch: the JAX package's tests, the port's
tests and ``chip_smoke.py`` use the same files. This is test data, not a
feature of either package.
"""

import json
import os
import shutil

import numpy as np

UNIT_SCALE = 0.026
ORDER, SAMPLE_FPS = 4, 60
# cycle seconds of each profile; the dodge's end (34 frames) lies inside
PROFILES = (("Idle", 2.4), ("Walking", 64 / 60), ("Running", 43 / 60),
            ("FallingIdle", 1.3), ("StandingDodgeBackward", 68 / 60))
ASSETS = ("17-Cheese.static.json", "Semla.static.json", "YBot.skinned.json")


def _euler_xyz_degrees(r):
    """Degrees (x, y, z) with Rz(z) @ Ry(y) @ Rx(x) == r (3x3)."""
    y = np.arcsin(np.clip(-r[2, 0], -1.0, 1.0))
    x = np.arctan2(r[2, 1], r[2, 2])
    z = np.arctan2(r[1, 0], r[0, 0])
    return np.degrees([x, y, z])


def skeleton_json(skin_path):
    """The skeleton schema's dict for the skin at ``skin_path``."""
    with open(skin_path) as f:
        bones = json.load(f)["skin"]["bones"]
    names = [b["name"] for b in bones]
    model = np.stack([np.linalg.inv(np.asarray(b["inverseBindMatrix"],
                                               np.float64).reshape(4, 4))
                      for b in bones])
    origin = model[:, :3, 3]
    parent = [-1] + [int(np.argmin(np.linalg.norm(origin[:i] - origin[i],
                                                  axis=1)))
                     for i in range(1, len(names))]
    trans, pre = [], []
    for i, p in enumerate(parent):
        local = model[i] if p < 0 else np.linalg.inv(model[p]) @ model[i]
        trans.append(local[:3, 3].tolist())
        pre.append(_euler_xyz_degrees(local[:3, :3]).tolist())
    return {"version": 1, "name": "YBot", "unitScale": UNIT_SCALE,
            "rigProfile": {"name": "mixamo"},
            "root": {"rule": "keep", "rotationFixDegrees": [0, 0, 0]},
            "names": names, "parent": parent, "translations": trans,
            "preRotationDegrees": pre}


def _series(rng, a0, scale):
    """Fourier coefficients [a0, a1, b1, ..., a_order, b_order]."""
    k = np.repeat(np.arange(1, ORDER + 1), 2)
    return [float(a0)] + (rng.normal(0.0, 1.0, 2 * ORDER) * scale / k).tolist()


def profile_json(name, cycle, skeleton, seed):
    """One motion profile's dict for the skeleton dict ``skeleton``."""
    rng = np.random.default_rng(seed)
    bones = {}
    for i, bone in enumerate(skeleton["names"]):
        rot = {ax: _series(rng, rng.normal(0.0, 2.0), 3.0) for ax in "xyz"}
        entry = {"translation": None, "rotation": rot}
        if i == 0:
            entry["translation"] = {
                ax: _series(rng, skeleton["translations"][0][j], 2.0)
                for j, ax in enumerate("xyz")}
        bones[bone] = entry
    # a dangling a_k with no b_k: the evaluator stops before it
    bones[skeleton["names"][1]]["rotation"]["z"].append(0.5)
    return {"version": 1, "name": name, "duration": cycle, "order": ORDER,
            "sample_fps": SAMPLE_FPS,
            "phase": {"mode": "normalized_time", "cycle_duration": cycle},
            "units": {"rotation": "degrees", "translation": "fbx_local"},
            "bones": bones}


def write_rig(out_dir, asset_dir, seed=0):
    """Write the skeleton, the five profiles and links to ``asset_dir``'s
    other files into ``out_dir`` -> ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    skel = skeleton_json(os.path.join(asset_dir, "YBot.skinned.json"))
    files = {"YBot.skeleton.json": skel}
    for k, (name, cycle) in enumerate(PROFILES):
        files[f"{name}.motionProfile.json"] = profile_json(name, cycle, skel,
                                                           seed * 7 + k)
    for fname, data in files.items():
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(data, f)
    for fname in ASSETS:
        src = os.path.abspath(os.path.join(asset_dir, fname))
        dst = os.path.join(out_dir, fname)
        if os.path.lexists(dst) or not os.path.exists(src):
            continue
        try:
            os.symlink(src, dst)
        except OSError:
            shutil.copyfile(src, dst)
    return out_dir
