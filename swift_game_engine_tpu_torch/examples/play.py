"""Interactive demo shell: live keyboard input -> Engine frames -> the
terminal (examples/play.py).

    python -m swift_game_engine_tpu_torch.examples.play [--width 192]
        [--height 108] [--path rt] [--device cpu]
    python -m swift_game_engine_tpu_torch.examples.play --frames 60
                                                   # scripted, no TTY needed

A host loop polls the keyboard in raw mode, makes an InputFrame per frame,
runs ``Engine.frame``, copies its u8 image to the host and draws it as
24-bit ANSI half-blocks (2 pixels per character cell) under an EMA FPS
line.

Keys:
  w/a/s/d  move (camera-relative)     arrows   camera look
  space    jump                       x        dodge
  r        toggle run (hold-style)    +/-      exposure
  q / ESC  quit
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np

from . import ASSETS


def ansi_frame(img: np.ndarray) -> str:
    """(H, W, 3) u8 -> ANSI half-block string (H/2 rows)."""
    h = img.shape[0] - (img.shape[0] % 2)
    rows = []
    for ti, bi in zip(img[0:h:2], img[1:h:2]):
        cells = []
        prev = None
        for (tr, tg, tb), (br, bg, bb) in zip(ti, bi):
            code = (f"\x1b[38;2;{tr};{tg};{tb}m"
                    f"\x1b[48;2;{br};{bg};{bb}m")
            cells.append((code if code != prev else "") + "▀")
            prev = code
        rows.append("".join(cells))
    return "\x1b[H" + "\x1b[0m\n".join(rows) + "\x1b[0m"


class Keyboard:
    """Raw-mode non-blocking key poller with hold emulation. A terminal
    delivers key repeats, not press and release, so a key counts as held
    for ``hold_s`` after its last repeat."""

    ARROWS = {"[A": "UP", "[B": "DOWN", "[C": "RIGHT", "[D": "LEFT"}

    def __init__(self, hold_s=0.25):
        import termios
        import tty
        self.hold_s = hold_s
        self.last = {}
        self.edges = set()
        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)

    def restore(self):
        import termios
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def _ready(self):
        return select.select([sys.stdin], [], [], 0)[0]

    def poll(self):
        now = time.time()
        while self._ready():
            c = os.read(self.fd, 1).decode(errors="ignore")
            if c == "\x1b":  # escape or an arrow's sequence
                seq = ""
                while self._ready() and len(seq) < 2:
                    seq += os.read(self.fd, 1).decode(errors="ignore")
                c = self.ARROWS.get(seq, "ESC")
            if c == " ":
                c = "SPACE"
            self.last[c] = now
            self.edges.add(c)

    def held(self, key):
        return time.time() - self.last.get(key, -1e9) < self.hold_s

    def edge(self, key):
        if key in self.edges:
            self.edges.discard(key)
            return True
        return False


def _pad(kb, run_mode):
    """The InputFrame of the keys held and pressed."""
    from ..scene.input import InputFrame
    mag = 1.0 if run_mode else 0.6
    return InputFrame(
        lx=(kb.held("d") - kb.held("a")) * mag,
        ly=(kb.held("w") - kb.held("s")) * mag,
        rx=(kb.held("RIGHT") - kb.held("LEFT")) * 1.0,
        ry=(kb.held("UP") - kb.held("DOWN")) * 1.0,
        jump=kb.edge("SPACE"),
        dodge=kb.edge("x"),
        # +/- drive the exposure axis (InputSystem.exposureDelta)
        exposure_delta=(kb.held("=") or kb.held("+")) * 1.0
        - kb.held("-") * 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=108)
    ap.add_argument("--path", choices=["rt", "raster"], default="rt")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--shadow-layers", type=int, default=4)
    ap.add_argument("--no-assets", action="store_true")
    ap.add_argument("--frames", type=int, default=0,
                    help="scripted frame count (no TTY needed)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.frames and not sys.stdin.isatty():
        ap.error("the interactive shell needs a terminal; pass --frames N")

    from ..scene.demo_scene import build_demo_scene
    from ..scene.engine import Engine
    from ..scene.input import InputFrame

    print("building scene...", flush=True)
    scene = build_demo_scene(ASSETS, device=args.device,
                             include_imported_assets=not args.no_assets)
    eng = Engine(scene, width=args.width, height=args.height, path=args.path,
                 max_layers=args.layers, shadow_layers=args.shadow_layers,
                 device=args.device)
    print("capturing the frame program...", flush=True)
    eng.frame(1.0 / 60.0, InputFrame())

    if args.frames:  # scripted
        t0 = time.time()
        for _ in range(args.frames):
            u8 = eng.frame(1.0 / 60.0, InputFrame(ly=1.0)).cpu().numpy()
        fps = args.frames / (time.time() - t0)
        print(f"{args.frames} frames, {fps:.2f} fps", flush=True)
        return u8

    kb = Keyboard()
    ema = None
    try:
        sys.stdout.write("\x1b[2J")  # clear
        last = time.time()
        run_mode = False
        while True:
            kb.poll()
            if kb.edge("q") or kb.edge("ESC"):
                break
            if kb.edge("r"):
                run_mode = not run_mode
            pad = _pad(kb, run_mode)
            now = time.time()
            dt, last = now - last, now
            u8 = eng.frame(dt, pad).cpu().numpy()
            # EMA FPS (FPSOverlaySystem's 0.9/0.1 smoothing)
            inst = 1.0 / max(time.time() - now, 1e-6)
            ema = inst if ema is None else 0.9 * ema + 0.1 * inst
            sys.stdout.write(ansi_frame(u8))
            sys.stdout.write(
                f"\x1b[0m\n{ema:5.1f} fps   wasd move, arrows look, space "
                f"jump, x dodge, r run[{'on' if run_mode else 'off'}], +/- "
                f"exposure[{eng.tone_mapping_exposure:.2f}], q quit  ")
            sys.stdout.flush()
    finally:
        kb.restore()
        sys.stdout.write("\x1b[0m\n")


if __name__ == "__main__":
    main()
