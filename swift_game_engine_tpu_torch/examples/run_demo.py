"""Run the DemoScene headless: simulate and render frames to PNG
(examples/run_demo.py).

    python -m swift_game_engine_tpu_torch.examples.run_demo --frames 4 \
        --width 320 --height 180 --path rt --out frames [--device cpu]

Scripted input: push forward from frame 1, turn from frame 3. Each frame's
u8 image is copied to the host and written as ``frame_NNN.png`` (8-bit RGB,
written with ``zlib`` and ``struct``); the last line reports the player's
position, whether it is grounded and its locomotion state.
"""

from __future__ import annotations

import argparse
import os
import struct
import tempfile
import time
import zlib

import numpy as np

from . import ASSETS

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data +
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, u8: np.ndarray):
    """(H, W, 3) uint8 -> an 8-bit RGB PNG: IHDR, one IDAT of the rows each
    behind filter byte 0, IEND."""
    h, w, _ = u8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(u8).reshape(h, w * 3)], 1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE +
                _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def main(argv=None):
    """Returns the frames written, (H, W, 3) uint8 arrays."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--path", choices=["rt", "raster"], default="rt")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "frames"))
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--shadow-layers", type=int, default=4)
    ap.add_argument("--no-assets", action="store_true",
                    help="skip imported static assets (smaller scene)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..scene.demo_scene import build_demo_scene
    from ..scene.engine import Engine
    from ..scene.input import InputFrame

    t0 = time.time()
    scene = build_demo_scene(ASSETS, device=args.device,
                             include_imported_assets=not args.no_assets)
    print(f"scene build: {time.time() - t0:.1f}s — "
          f"{scene.geometry.tri.shape[0]} render tris, "
          f"{int(scene.collision.valid.sum())} collision tris, "
          f"{scene.spec.n_entities} entities", flush=True)
    eng = Engine(scene, width=args.width, height=args.height, path=args.path,
                 max_layers=args.layers, shadow_layers=args.shadow_layers,
                 device=args.device)

    os.makedirs(args.out, exist_ok=True)
    frames = []
    for i in range(args.frames):
        pad = InputFrame(ly=1.0 if i > 0 else 0.0, rx=0.2 if i > 2 else 0.0)
        t0 = time.time()
        u8 = eng.frame(1.0 / 60.0, pad).cpu().numpy()
        wall = time.time() - t0
        p = os.path.join(args.out, f"frame_{i:03d}.png")
        write_png(p, u8)
        frames.append(u8)
        print(f"frame {i}: {wall * 1000:.0f} ms -> {p}", flush=True)
    e = eng.player
    print("player pos:", eng.state.body_pos[e].cpu().numpy(),
          "grounded:", bool(eng.state.ctrl.grounded[e]),
          "loco state:", int(eng.state.loco.state[e]), flush=True)
    return frames


if __name__ == "__main__":
    main()
