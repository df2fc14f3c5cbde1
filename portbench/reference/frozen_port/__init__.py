"""A frozen copy of swift_game_engine_tpu_torch at commit 74208b3: the
modules the benchmark's check calls (portbench/reference/README.md). The
frame program (scene/engine.py, scene/cuda_graph.py, render/graph.py),
the raster and deferred paths, the native BVH builder, csrc/, build/,
examples/, parallel/ and interop.py are left out; ops/_cuda.py builds
nothing, the scene's tree is a Morton build, and the visibility the check
needs is the brute-force search of portbench/reference/visibility.py. What follows is the original docstring.

swift_game_engine_tpu_torch — the PyTorch/CUDA port of swift_game_engine_tpu.

The JAX package beside it stays the reference: every module here keeps the
name, contract and array layouts of its counterpart, and the tests hold the
two against each other. This package imports ``torch`` and never ``jax``.

Subpackages mirror the reference:
  assets  — host-side asset loaders, decimation, procedural meshes (numpy)
  anim    — linear-blend skinning
  render  — BVH refit, camera rays, shading, IBL, composite, tile raster, RT
  ops     — the hand-written Hopper kernels (csrc/) and their plain twins
  scene   — input, the DemoScene render world, the Engine frame loop
  parallel — the image plane sharded over cards (torch.distributed)
  examples — the user entry points: run_demo, bench_crowd, play

Entry points (``build_demo_scene``, ``Engine``, ``RenderGeometryBuilder.
build``, ``IBL.build``, ``DirectionalLights.from_list``, ``parallel.
sharding``'s ``make_group``, ``sharded_render`` and ``sharded_fused_step``,
the ``examples``' ``--device``) put their tensors
on ``device="cuda"`` unless the caller passes another device; the CPU is
used only when asked for (``device="cpu"``), and a call without a device
raises where CUDA is absent.

Numerics follow the reference, which forces true float32 matmuls
(swift_game_engine_tpu/__init__.py): TF32 stays off everywhere.
"""

__version__ = "0.1.0"

import numpy as _np
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


_CONSTANTS = {}


def constant(values, device, dtype=_torch.float32) -> _torch.Tensor:
    """``values`` as a tensor on ``device``, built once per value, device and
    dtype. A host value made a device tensor inside a frame is a copy from
    pageable host memory every frame: the host waits for it, and a CUDA
    graph cannot capture it. Callers must not write to the result."""
    a = _np.asarray(values)
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, str(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = _torch.as_tensor(a, dtype=dtype, device=device)
    return _CONSTANTS[key]


def resolve_device(device="cuda") -> _torch.device:
    """The device an entry point puts its tensors on: the card unless the
    caller names another. Raises where CUDA is asked for and absent."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev
