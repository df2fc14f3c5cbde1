"""One rank of a gloo group rendering a sharded frame on the CPU.

    python tests/torch_shard_worker.py RANK WORLD STORE INPUTS OUT

Joins the group at ``file://STORE`` (``make_group(..., device="cpu")``),
loads the frame's inputs that ``INPUTS`` holds (``torch.save`` of a dict:
geo, ibl, lights, transforms, palettes, ivp, cam, width, height,
max_layers, shadow_layers), renders them with ``sharded_render`` over the
group and saves the gathered image to ``OUT``. Imports torch and the port
only.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(rank, world, store, inputs, out):
    from swift_game_engine_tpu_torch.parallel import sharding as SH
    torch.set_num_threads(1)
    a = torch.load(inputs, weights_only=False)
    group = SH.make_group(rank, world, "file://" + store, device="cpu",
                          timeout=120)
    try:
        render = SH.sharded_render(group, a["geo"], a["ibl"], a["lights"],
                                   a["width"], a["height"], a["max_layers"],
                                   a["shadow_layers"], device="cpu")
        img = render(a["transforms"], a["palettes"], a["ivp"], a["cam"])
        torch.save(img, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
