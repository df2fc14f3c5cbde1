"""What the benchmark loads: no module whose top-level name (the part
before the first dot, compared whole) is jax, jaxlib, flax or the JAX
package; and no result without a card."""

import os
import subprocess
import sys

import pytest

from portbench import spec as S

LOAD_ALL = r"""
import importlib, os, sys
import portbench.run as R, portbench.systems, portbench.trace
import portbench.reference.check as C
from portbench import spec as S
for name in os.listdir(S.METRICS):
    if name.endswith(".py"):
        S.metric_reader(name[:-3])
for mod in ("scene.demo_scene", "scene.engine", "scene.step", "scene.input",
            "ecs.world", "render.rt", "ops.rt_kernel", "ops.cluster_shadow",
            "render.tile_raster"):
    importlib.import_module("swift_game_engine_tpu_torch." + mod)
for mod in ("scene.demo_scene", "scene.step", "render.rt",
            "render.camera", "render.composite", "render.scene_geometry",
            "render.shading", "render.ibl", "ops.rt_kernel", "ecs.world",
            "assets.procedural_textures"):
    C.frozen(mod)
print("forbidden:" + ",".join(R.forbidden_modules()))
print("port:", "swift_game_engine_tpu_torch" in sys.modules)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = S.ROOT
    return env


def test_no_forbidden_module_loaded():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL], cwd=S.ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    bad, port = out.stdout.strip().splitlines()[-2:]
    assert bad == "forbidden:"
    assert port == "port: True"


def test_forbidden_names_are_whole_top_level_names():
    from portbench.run import FORBIDDEN
    for name in ("swift_game_engine_tpu_torch", "jaxtyping", "flaxen"):
        assert name.split(".")[0] not in FORBIDDEN
    for name in ("jax.numpy", "swift_game_engine_tpu.render", "flax"):
        assert name.split(".")[0] in FORBIDDEN


def test_no_result_without_a_card():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "demo_partial_rt_1080p.walk60", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=S.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_card_cell_short_run():
    """A short run of each cell on the card (``correct`` true)."""
    import json
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    for cell in S.load_bench()["workloads"]:
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             cell["name"], "--seed", "5", "--seconds", "2", "--trace", "0"],
            cwd=S.ROOT, env=_env(), capture_output=True, text=True,
            timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
