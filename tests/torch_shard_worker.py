"""One rank of a gloo group running the sharded path on the CPU.

    python tests/torch_shard_worker.py RANK WORLD STORE INPUTS OUT

Joins the group at ``file://STORE`` (``make_group(..., device="cpu")``) and
loads ``INPUTS`` (``torch.save`` of a dict). A frame's inputs (geo, ibl,
lights, transforms, palettes, ivp, cam, width, height, max_layers,
shadow_layers) are rendered with ``sharded_render`` over the group, and
the gathered image is saved to ``OUT``. Inputs holding ``substeps``
(with ``asset_dir`` and ``pad_entities_to``) build the DemoScene without
its imported assets, shard its state's entity axis over the group and take
that many substeps through ``EntityShardedSubstep``; ``OUT`` gets the
final state's leaves. Imports torch and the port only.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def substeps(SH, group, a):
    from swift_game_engine_tpu_torch.ecs.world import state_leaves
    from swift_game_engine_tpu_torch.scene.demo_scene import build_demo_scene
    from swift_game_engine_tpu_torch.scene.engine import FIXED_DT
    w = build_demo_scene(a["asset_dir"], device="cpu",
                         include_imported_assets=False,
                         pad_entities_to=a["pad_entities_to"])
    sharded = SH.shard_world_state(group, w.state)
    sim = SH.EntityShardedSubstep(w.stepper, sharded, FIXED_DT, group)
    for _ in range(a["substeps"]):
        sim.step()
    return dict(sim=state_leaves(sim.state), ranges=sharded.ranges)


def main(rank, world, store, inputs, out):
    from swift_game_engine_tpu_torch.parallel import sharding as SH
    torch.set_num_threads(1)
    a = torch.load(inputs, weights_only=False)
    group = SH.make_group(rank, world, "file://" + store, device="cpu",
                          timeout=120)
    try:
        if "substeps" in a:
            torch.save(substeps(SH, group, a), out)
            return
        render = SH.sharded_render(group, a["geo"], a["ibl"], a["lights"],
                                   a["width"], a["height"], a["max_layers"],
                                   a["shadow_layers"], device="cpu")
        img = render(a["transforms"], a["palettes"], a["ivp"], a["cam"])
        torch.save(img, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
